"""CUDA kernels of the port on an NVIDIA GPU (marker ``cuda``; skipped without one).

The kernels have no CPU mode: on the CPU their plain versions run and are held
against retr_tpu in the other test_torch_* files. Here each kernel is held
against its plain version on the card, greedy and beam decoding through the
kernels against the plain path on the CPU, the full-width eval step
through the attention kernel against the plain attention path, and the
serving surface (sampling at temperature 0 equal to greedy, a seed's
determinism, f32 prefix and sample-greedy buffers against the CPU's under
the f32_parity rule, ``score`` through the attention kernel and
``predict_with_attention`` without it); a dp=2 world of two processes on
the one card over gloo, whose two f32 train steps equal the world of one's.
Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

import chip_smoke
from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.data.pipeline import Batch
from retr_tpu_torch.models import weights
from retr_tpu_torch.ops import attention as fa
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.precision import matmul_precision
from retr_tpu_torch.train import state as tstate

pytestmark = pytest.mark.cuda

C, H, D, F, T, S, L = 256, 8, 32, 512, 24, 37, 2
B = 13  # not a multiple of the kernels' row tiles: the ragged last tile runs too
S_MEMORY, S_MEMORY_TT = 196, 2 * 196 + 5  # the served memory lengths: 14x14 features, the (T,T) variant


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the plain versions are tested on the CPU")
    return torch.device("cuda")


def _decoder(gen, dev, dtype, nl=L, c=C, f=F):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def lin(i, o):
        return {"w": rn(nl, i, o, scale=(2.0 / (i + o)) ** 0.5), "b": rn(nl, o, scale=0.02)}

    def norm():
        return {"scale": (1 + rn(nl, c, scale=0.1).float()).to(dtype), "bias": rn(nl, c, scale=0.1)}

    def mha():
        return {k: lin(c, c) for k in ("q", "k", "v", "out")}

    return {"self_attn": {"norm": norm(), "mha": mha()}, "cross_attn": {"norm": norm(), "mha": mha()},
            "ff": {"norm": norm(), "lin1": lin(c, f), "lin2": lin(f, c)}}


def _close_to_plain(got, want, tol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = max(1.0, float(want[0].float().abs().max()))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
def test_kernels_match_plain_versions(dev, dtype, tol):
    """Tolerance as a fraction of max(1, max|plain|): f32 differs by summation
    order only; bf16 rounds at the same points, an order difference may flip one."""
    gen = torch.Generator(device=dev).manual_seed(0)
    slp = _decoder(gen, dev, dtype)
    lp = dk.layer_params(slp, 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x, qpos = rn(B, C), rn(C)
    kc, vc, ck, cv = rn(L, B, H, T, D), rn(L, B, H, T, D), rn(L, B, H, S, D), rn(L, B, H, S, D)
    pad = torch.rand(B, S, generator=gen, device=dev) < 0.3
    pad[:, 0] = False
    kb = torch.where(pad, float("-inf"), 0.0)
    step = torch.tensor(9, dtype=torch.int32, device=dev)
    caches = [t.clone() for t in (kc, vc, kc, vc)]
    pairs = [
        (dk.ff_block(lp["ff"], x), dk.ff_block_plain(lp["ff"], x)),
        (dk.cross_attn_block(lp["cross_attn"], x, qpos, ck[1], cv[1], kb, num_heads=H),
         dk.cross_attn_block_plain(lp["cross_attn"], x, qpos, ck[1], cv[1], kb, num_heads=H)),
        (dk.self_attn_block(lp["self_attn"], x, qpos, caches[0][1], caches[1][1], step, num_heads=H),
         dk.self_attn_block_plain(lp["self_attn"], x, qpos, caches[2][1], caches[3][1], step, num_heads=H)),
    ]
    dk.reset_launches()
    with matmul_precision(torch.float32):
        pairs.append((dk.fused_stack_step(slp, x, qpos, caches[0], caches[1], ck, cv, kb, step, num_heads=H),
                      dk.fused_stack_step_plain(slp, x, qpos, caches[2], caches[3], ck, cv, kb, step,
                                                num_heads=H)))
    torch.cuda.synchronize()
    assert dk.LAUNCHES["fused_stack_step"] == 1
    for got, want in pairs:
        _close_to_plain(got, want, tol)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = {"norm": {"scale": torch.ones(64, device=dev), "bias": torch.zeros(64, device=dev)},
         "lin1": {"w": torch.zeros(64, 0, device=dev), "b": torch.zeros(0, device=dev)},
         "lin2": {"w": torch.zeros(0, 64, device=dev), "b": torch.zeros(64, device=dev)}}
    with pytest.raises(ValueError, match="width"):                  # an empty FF width
        dk.ff_block(p, torch.zeros(4, 64, device=dev))
    q = {"norm": {"scale": torch.ones(C, device=dev), "bias": torch.zeros(C, device=dev)},
         "lin1": {"w": torch.zeros(C, F, device=dev), "b": torch.zeros(F, device=dev)},
         "lin2": {"w": torch.zeros(F, C, device=dev), "b": torch.zeros(C, device=dev)}}
    with pytest.raises(ValueError, match="float16"):
        dk.ff_block(q, torch.zeros(4, C, device=dev, dtype=torch.float16))
    bad_w2 = {**q, "lin2": {"w": torch.zeros(F, C + 8, device=dev), "b": q["lin2"]["b"]}}
    with pytest.raises(ValueError, match="shape"):
        dk.ff_block(bad_w2, torch.zeros(4, C, device=dev))
    with pytest.raises(ValueError, match="aligned"):
        dk.ff_block(q, torch.zeros(4, C + 1, device=dev)[:, 1:])
    old = dk._block_rows
    dk._block_rows = 24                    # no kernel is built for 24-row tiles
    try:
        with pytest.raises(RuntimeError, match="rt_ff_block"):
            dk.ff_block(q, torch.zeros(4, C, device=dev))
    finally:
        dk._block_rows = old
    m = {"norm": q["norm"], "mha": {k: {"w": torch.zeros(C, C, device=dev), "b": torch.zeros(C, device=dev)}
                                    for k in ("q", "out")}}
    kv = torch.zeros(4, H, 7, D, device=dev)
    with pytest.raises(ValueError, match="do not match"):
        dk.cross_attn_block(m, torch.zeros(4, C, device=dev), torch.zeros(C, device=dev), kv, kv,
                            torch.zeros(4, 8, device=dev), num_heads=H)
    with pytest.raises(ValueError, match="float32"):
        dk.cross_attn_block(m, torch.zeros(4, C, device=dev), torch.zeros(C, device=dev), kv, kv,
                            torch.zeros(4, 7, device=dev, dtype=torch.bfloat16), num_heads=H)


@pytest.mark.parametrize("layer_grid", [True, False])
def test_greedy_through_kernels_matches_cpu(dev, layer_grid):
    cfg = Config(backbone="ResNet18", dilation=False, hidden_dim=C, nheads=H, enc_layers=1, dec_layers=L,
                 dim_feedforward=F, vocab_size=96, max_position_embeddings=20, dropout=0.0, image_size=64)
    torch.manual_seed(0)
    state = weights.reference_module(cfg).state_dict()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(5, 3, 64, 64, generator=gen)
    mask = torch.zeros(5, 64, 64, dtype=torch.bool)
    mask[2, :, 40:] = True
    old = dk.LAYER_GRID
    dk.LAYER_GRID = layer_grid
    try:
        cpu = decode.greedy(weights.to_params(state, cfg, device="cpu"), cfg, Masked(img, mask),
                            max_len=20, bos_token=1, eos_token=3)
        dk.reset_launches()
        gpu = decode.greedy(weights.to_params(state, cfg, device=dev), cfg, Masked(img.to(dev), mask.to(dev)),
                            max_len=20, bos_token=1, eos_token=3)
    finally:
        dk.LAYER_GRID = old
    assert (dk.LAUNCHES["fused_stack_step"] > 0) == layer_grid
    assert (dk.LAUNCHES["ff_block"] > 0) != layer_grid
    assert torch.equal(gpu.cpu(), cpu)



@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("beams", [2, 3, 5, 7])
def test_beam_block_matches_plain_version(dev, dtype, tol, beams):
    """Groups of 2, 3, 5 and 7 rows (4-, 3-, 5- and 7-row tiles); the ancestry
    crosses rows at earlier positions and at ``step``."""
    gen = torch.Generator(device=dev).manual_seed(2)
    lp = dk.layer_params(_decoder(gen, dev, dtype), 0)["self_attn"]
    bk = 3 * beams
    x = torch.randn(bk, C, generator=gen, device=dev).to(dtype)
    qpos = torch.randn(C, generator=gen, device=dev).to(dtype)
    kc = torch.randn(bk, H, T, D, generator=gen, device=dev).to(dtype)
    vc = torch.randn(bk, H, T, D, generator=gen, device=dev).to(dtype)
    anc = torch.randint(0, beams, (bk, T), generator=gen, device=dev, dtype=torch.int32)
    step = torch.tensor(11, dtype=torch.int32, device=dev)
    caches = [t.clone() for t in (kc, vc, kc, vc)]
    dk.reset_launches()
    got = dk.self_attn_block_beam(lp, x, anc, qpos, caches[0], caches[1], step, num_heads=H, num_beams=beams)
    with matmul_precision(torch.float32):
        want = dk.self_attn_block_beam_plain(lp, x, anc, qpos, caches[2], caches[3], step, num_heads=H,
                                             num_beams=beams)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["self_attn_block_beam"] == 1
    _close_to_plain(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
def test_fused_layer_step_matches_plain_version(dev, dtype, tol):
    gen = torch.Generator(device=dev).manual_seed(3)
    lp = dk.layer_params(_decoder(gen, dev, dtype), 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x, qpos, ck, cv = rn(B, C), rn(C), rn(B, H, S, D), rn(B, H, S, D)
    kc, vc = rn(B, H, T, D), rn(B, H, T, D)
    kb = torch.zeros(B, S, device=dev)
    kb[:, -3:] = float("-inf")
    step = torch.tensor(7, dtype=torch.int32, device=dev)
    caches = [t.clone() for t in (kc, vc, kc, vc)]
    dk.reset_launches()
    got = dk.fused_layer_step(lp, x, qpos, caches[0], caches[1], ck, cv, kb, step, num_heads=H)
    with matmul_precision(torch.float32):
        want = dk.fused_layer_step_plain(lp, x, qpos, caches[2], caches[3], ck, cv, kb, step, num_heads=H)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["fused_layer_step"] == 1 and dk.LAUNCHES["fused_stack_step"] == 0
    _close_to_plain(got, want, tol)


STACK_T = 128  # the served cache length: steps 0, 63 and T - 1 below


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("step", [0, 63, STACK_T - 1])
@pytest.mark.parametrize("batch", [1, 5, 32, 33, 512])
@pytest.mark.parametrize("wrapper", ["fused_stack_step", "fused_layer_step"])
def test_stacked_step_matches_plain_version(dev, wrapper, batch, step, dtype, tol):
    """rt_stack_step (6 layers through fused_stack_step, 1 through
    fused_layer_step) against the plain version: ragged batches (not multiples
    of the 16-row tile), the first and last cache slot, a row whose key bias
    masks all but one memory position. A second launch, and a launch on a
    7-block grid, give the same bits; only the cache slot at ``step`` changes."""
    stacked = wrapper == "fused_stack_step"
    nl = 6 if stacked else 1
    gen = torch.Generator(device=dev).manual_seed(10 + batch + step)
    slp = _decoder(gen, dev, dtype, nl)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x, qpos = rn(batch, C), rn(C)
    kc, vc = rn(nl, batch, H, STACK_T, D), rn(nl, batch, H, STACK_T, D)
    ck, cv = rn(nl, batch, H, S, D), rn(nl, batch, H, S, D)
    pad = torch.rand(batch, S, generator=gen, device=dev) < 0.3
    pad[:, 0] = False
    pad[0, 1:] = True                      # row 0 sees one memory position
    kb = torch.where(pad, float("-inf"), 0.0)
    st = torch.tensor(step, dtype=torch.int32, device=dev)

    def run(caches, fn):
        k, v = caches
        if stacked:
            return fn(slp, x, qpos, k, v, ck, cv, kb, st, num_heads=H)[0]
        return fn(dk.layer_params(slp, 0), x, qpos, k[0], v[0], ck[0], cv[0], kb, st, num_heads=H)[0]

    runs = [(kc.clone(), vc.clone()) for _ in range(4)]
    dk.reset_launches()
    got = run(runs[0], getattr(dk, wrapper))
    assert dk.LAUNCHES[wrapper] == 1
    again = run(runs[1], getattr(dk, wrapper))
    old = dk._stack_max_blocks
    dk._stack_max_blocks = 7
    try:
        small_grid = run(runs[2], getattr(dk, wrapper))
    finally:
        dk._stack_max_blocks = old
    with matmul_precision(torch.float32):
        want = run(runs[3], getattr(dk, wrapper + "_plain"))
    torch.cuda.synchronize()
    assert dk.LAUNCHES[wrapper] == 3 and sum(dk.LAUNCHES.values()) == 3
    _close_to_plain(got, want, tol)
    for other in (again, small_grid):
        assert torch.equal(got, other)
    keep = torch.arange(STACK_T, device=dev) != step
    for i, orig in enumerate((kc, vc)):
        assert torch.equal(runs[0][i], runs[1][i]) and torch.equal(runs[0][i], runs[2][i])
        assert torch.equal(runs[0][i][:, :, :, keep].view(torch.uint8), orig[:, :, :, keep].view(torch.uint8))
        _close_to_plain(runs[0][i][:, :, :, step], runs[3][i][:, :, :, step], tol)


BLOCK_ROWS = [1, 5, 16, 17, 32, 160, 512, 2560]   # ragged tiles; the beam path's 160 and 2560


def _check_block_kernel(wrapper, tiles, call, args, tol):
    """Launch ``call`` (the kernel) and its plain version on ``args``: within
    tolerance of each other, one launch counted per call, a second launch and a
    launch at every row tile in ``tiles`` bit-equal, the inputs unwritten."""
    before = [a.clone() for a in args]
    dk.reset_launches()
    got, again = call(dk, wrapper), call(dk, wrapper)
    forced = []
    old = dk._block_rows
    try:
        for r in tiles:
            dk._block_rows = r
            forced.append(call(dk, wrapper))
    finally:
        dk._block_rows = old
    with matmul_precision(torch.float32):
        want = call(dk, wrapper + "_plain")
    torch.cuda.synchronize()
    assert dk.LAUNCHES[wrapper] == 2 + len(tiles) and sum(dk.LAUNCHES.values()) == 2 + len(tiles)
    _close_to_plain(got, want, tol)
    for other in [again, *forced]:
        assert torch.equal(got.view(torch.int16 if got.element_size() == 2 else torch.int32),
                           other.view(torch.int16 if got.element_size() == 2 else torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("f", [256, 2048])
@pytest.mark.parametrize("rows", BLOCK_ROWS)
def test_ff_block_matches_plain_version(dev, rows, f, dtype, tol):
    """rt_ff_block (clusters of min(8, F/256) blocks) against the plain
    version; the result does not depend on the row tile (16, 32 or 64)."""
    gen = torch.Generator(device=dev).manual_seed(20 + rows + f)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    p = {"norm": {"scale": (1 + rn(C, scale=0.1).float()).to(dtype), "bias": rn(C, scale=0.1)},
         "lin1": {"w": rn(C, f, scale=(2.0 / (C + f)) ** 0.5), "b": rn(f, scale=0.02)},
         "lin2": {"w": rn(f, C, scale=(2.0 / (C + f)) ** 0.5), "b": rn(C, scale=0.02)}}
    x = rn(rows, C)
    _check_block_kernel("ff_block", (16, 32, 64), lambda m, fn: getattr(m, fn)(p, x), [x], tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("s", [1, S_MEMORY, S_MEMORY_TT])
@pytest.mark.parametrize("rows", BLOCK_ROWS)
def test_cross_attn_block_matches_plain_version(dev, rows, s, dtype, tol):
    """rt_cross_attn_block (clusters of 8 blocks, one per head) against the
    plain version at the memory lengths the decoders run (1, 196 and the
    (T,T) variant's 397); row 0 sees only its first memory position; the result
    does not depend on the row tile (4, 8, 16 or 32)."""
    gen = torch.Generator(device=dev).manual_seed(30 + rows + s)
    lp = dk.layer_params(_decoder(gen, dev, dtype, 1), 0)["cross_attn"]

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x, qpos, ck, cv = rn(rows, C), rn(C), rn(rows, H, s, D), rn(rows, H, s, D)
    pad = torch.rand(rows, s, generator=gen, device=dev) < 0.3
    pad[:, 0] = False
    pad[0, 1:] = True
    kb = torch.where(pad, float("-inf"), 0.0)
    _check_block_kernel("cross_attn_block", (4, 8, 16, 32),
                        lambda m, fn: getattr(m, fn)(lp, x, qpos, ck, cv, kb, num_heads=H),
                        [x, qpos, ck, cv, kb], tol)


def test_stacked_step_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    slp = _decoder(gen, dev, torch.float32)
    x, qpos = torch.zeros(4, C, device=dev), torch.zeros(C, device=dev)
    kc, ck = torch.zeros(L, 4, H, T, D, device=dev), torch.zeros(L, 4, H, S, D, device=dev)
    kb, st = torch.zeros(4, S, device=dev), torch.zeros((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="width"):                  # 256 is not a whole number of 3 heads
        dk.fused_stack_step(slp, x, qpos, kc, kc.clone(), ck, ck.clone(), kb, st, num_heads=3)
    with pytest.raises(ValueError, match="shapes"):
        dk.fused_stack_step(slp, x, qpos, kc[:, :3], kc[:, :3].clone(), ck, ck.clone(), kb, st, num_heads=H)
    with pytest.raises(ValueError, match="float16"):
        dk.fused_stack_step(slp, x.half(), qpos, kc, kc.clone(), ck, ck.clone(), kb, st, num_heads=H)
    with pytest.raises(ValueError, match="int32"):
        dk.fused_layer_step(dk.layer_params(slp, 0), x, qpos, kc[0], kc[0].clone(), ck[0], ck[0].clone(), kb,
                            st.long(), num_heads=H)
    with pytest.raises(ValueError, match="aligned"):
        dk.fused_layer_step(dk.layer_params(slp, 0), torch.zeros(4, C + 1, device=dev)[:, 1:], qpos, kc[0],
                            kc[0].clone(), ck[0], ck[0].clone(), kb, st, num_heads=H)


def _head(gen, dev, dtype, vocab, ties=()):
    def lin(i, o):
        return {"w": (torch.randn(i, o, generator=gen, device=dev) * i ** -0.5).to(dtype),
                "b": (torch.randn(o, generator=gen, device=dev) * 0.1).to(dtype)}
    p = {"layers": [lin(C, 512), lin(512, 512), lin(512, vocab)]}
    for col in ties:
        p["layers"][2]["w"][:, col] = 1.0
        p["layers"][2]["b"][col] = 5.0
    return p


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("vocab", [5000, 30522])
@pytest.mark.parametrize("rows", [1, 5, 19, 32, 160, 512, 2560])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernels_match_plain_versions(dev, dtype, rows, vocab, k, ties):
    """Vocab 5000 and 30522 (ragged last slabs of 8 and 58 columns), rows 1 to
    2560 (row tiles of 32, 64 and 128, ragged), k 1, 5 and 8: the checks of
    chip_smoke.head_case (tokens within summation-order tolerance of the plain
    choice, exactly the lowest tied indices where ties are built in across
    slab boundaries and in the last slab; scores within 1e-4 of max(1, |s|);
    a second launch gives the same bits)."""
    gen = torch.Generator(device=dev).manual_seed(4 + rows + vocab + k)
    tie_cols = chip_smoke.head_ties(vocab) if ties else ()
    p = _head(gen, dev, dtype, vocab, tie_cols)
    x = torch.randn(rows, C, generator=gen, device=dev).to(dtype)
    dk.reset_launches()
    got = chip_smoke.head_case(p, dk.pack_head(p), x, k, tie_cols)   # 30522 -> 30528 columns
    assert dk.LAUNCHES["mlp_head_argmax"] == 2 and dk.LAUNCHES["mlp_head_topk"] == 2
    assert got["err"] <= got["tol"] and got["same"] and got["lowest"], got


def test_head_kernels_reject_what_they_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    p = _head(gen, dev, torch.float32, 5000)
    x = torch.randn(4, C, generator=gen, device=dev)
    hidden = {"layers": [{"w": torch.zeros(C, 500, device=dev), "b": torch.zeros(500, device=dev)},
                         {"w": torch.zeros(500, 500, device=dev), "b": torch.zeros(500, device=dev)},
                         {"w": torch.zeros(500, 5000, device=dev), "b": torch.zeros(5000, device=dev)}]}
    with pytest.raises(ValueError, match="width"):                  # unpacked: pack_head pads it to 512
        dk.mlp_head_topk(hidden, x, 5)
    for k in (0, 257):
        with pytest.raises(ValueError, match=f"k = {k}"):
            dk.mlp_head_topk(p, x, k)
    half = {"layers": [{n: t.half() for n, t in lp.items()} for lp in p["layers"]]}
    with pytest.raises(ValueError, match="float16"):
        dk.mlp_head_argmax(half, x.half())
    with pytest.raises(ValueError, match="aligned"):
        dk.mlp_head_argmax(p, torch.zeros(4, C + 1, device=dev)[:, 1:])
    odd = _head(gen, dev, torch.bfloat16, 4999)
    with pytest.raises(ValueError, match="aligned"):
        dk.mlp_head_topk(odd, x.bfloat16(), 5)       # unpacked: W3's rows are 9998 bytes apart
    got = dk.mlp_head_topk(dk.pack_head(odd), x.bfloat16(), 5)
    with matmul_precision(torch.float32):
        want = dk.mlp_head_topk_plain(odd, x.bfloat16(), 5)
    assert float((got[0] - want[0]).abs().max()) <= 1e-4 * max(1.0, float(want[0].abs().max()))


TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=16, dropout=0.0, image_size=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [9, 40, 256])
@pytest.mark.parametrize("widths", [(48, 500), (36, 512), (C, 512)])
def test_head_kernels_take_any_width_and_k(dev, widths, k, dtype):
    """Input widths 48 and 36 (rows not 16-byte aligned in bf16: copied
    element by element), hidden 500 (pack_head pads it to 512), k up to 256
    (two slabs' worth of rounds): the checks of chip_smoke.head_case."""
    c, hd = widths
    gen = torch.Generator(device=dev).manual_seed(6 + c + k)

    def lin(i, o):
        return {"w": (torch.randn(i, o, generator=gen, device=dev) * i ** -0.5).to(dtype),
                "b": (torch.randn(o, generator=gen, device=dev) * 0.1).to(dtype)}
    p = {"layers": [lin(c, hd), lin(hd, hd), lin(hd, 5000)]}
    x = torch.randn(37, c, generator=gen, device=dev).to(dtype)
    dk.reset_launches()
    got = chip_smoke.head_case(p, dk.pack_head(p), x, k)
    assert dk.LAUNCHES["mlp_head_argmax"] == 2 and dk.LAUNCHES["mlp_head_topk"] == 2
    assert got["err"] <= got["tol"] and got["same"], got


WIDTHS = [(64, 4, 128), (96, 3, 200), (128, 2, 256), (256, 4, 512), (512, 16, 1024)]  # (C, heads, F)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("widths", WIDTHS)
def test_width_kernels_match_plain_versions(dev, widths, dtype, tol):
    """csrc/width_kernels.cu, which the wrappers launch at every width but the
    tuned one (head dims 16, 32, 64 and 32 at 16 heads; F not a multiple of
    256): each decoder-layer wrapper against its plain version, one launch
    counted per call, a second launch bit-equal; beam groups of 3 and 11 (past
    the tuned kernel's 8), the ancestry crossing rows at ``step`` too."""
    c, h, f = widths
    d = c // h
    gen = torch.Generator(device=dev).manual_seed(c + h + f)
    slp = _decoder(gen, dev, dtype, 2, c, f)
    lp = dk.layer_params(slp, 1)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    b = 33
    x, qpos = rn(b, c), rn(c)
    kc, vc, ck, cv = rn(2, b, h, T, d), rn(2, b, h, T, d), rn(2, b, h, S, d), rn(2, b, h, S, d)
    pad = torch.rand(b, S, generator=gen, device=dev) < 0.3
    pad[:, 0] = False
    pad[0, 1:] = True
    kb = torch.where(pad, float("-inf"), 0.0)
    step = torch.tensor(9, dtype=torch.int32, device=dev)
    assert not dk.decode_kernels_fit(c, h, f)
    # (wrapper, call(module, suffix, (k cache, v cache)), the caches it updates)
    cases = [
        ("ff_block", lambda m, sfx, kv: getattr(m, "ff_block" + sfx)(lp["ff"], x), (kc, vc)),
        ("cross_attn_block", lambda m, sfx, kv: getattr(m, "cross_attn_block" + sfx)(
            lp["cross_attn"], x, qpos, ck[1], cv[1], kb, num_heads=h), (kc, vc)),
        ("self_attn_block", lambda m, sfx, kv: getattr(m, "self_attn_block" + sfx)(
            lp["self_attn"], x, qpos, kv[0][1], kv[1][1], step, num_heads=h)[0], (kc, vc)),
        ("fused_stack_step", lambda m, sfx, kv: getattr(m, "fused_stack_step" + sfx)(
            slp, x, qpos, kv[0], kv[1], ck, cv, kb, step, num_heads=h)[0], (kc, vc)),
        ("fused_layer_step", lambda m, sfx, kv: getattr(m, "fused_layer_step" + sfx)(
            lp, x, qpos, kv[0][1], kv[1][1], ck[1], cv[1], kb, step, num_heads=h)[0], (kc, vc)),
    ]
    for beams in (3, 11):
        bk = 3 * beams
        anc = torch.randint(0, beams, (bk, T), generator=gen, device=dev, dtype=torch.int32)
        xb, kcb, vcb = rn(bk, c), rn(bk, h, T, d), rn(bk, h, T, d)
        cases.append(("self_attn_block_beam", lambda m, sfx, kv, xb=xb, anc=anc, beams=beams: getattr(
            m, "self_attn_block_beam" + sfx)(lp["self_attn"], xb, anc, qpos, kv[0], kv[1], step, num_heads=h,
                                             num_beams=beams)[0], (kcb, vcb)))
    for wrapper, call, caches in cases:
        runs = [tuple(t.clone() for t in caches) for _ in range(3)]
        dk.reset_launches()
        got, again = call(dk, "", runs[0]), call(dk, "", runs[1])
        with matmul_precision(torch.float32):
            want = call(dk, "_plain", runs[2])
        torch.cuda.synchronize()
        assert dk.LAUNCHES[wrapper] == 2 and sum(dk.LAUNCHES.values()) == 2, (wrapper, dk.LAUNCHES)
        _close_to_plain(got, want, tol)
        assert torch.equal(got.view(torch.uint8), again.view(torch.uint8)), wrapper
        for i in (0, 1):                                 # only the slot at `step` is written
            assert torch.equal(runs[0][i].view(torch.uint8), runs[1][i].view(torch.uint8)), wrapper
            _close_to_plain(runs[0][i][..., 9, :], runs[2][i][..., 9, :], tol)


@pytest.mark.parametrize("decoder", ["greedy", "greedy trio", "greedy merged", "beam", "beam 11"])
def test_decode_at_a_width_the_kernels_do_not_take_matches_cpu(dev, decoder):
    """Hidden 64 with 4 heads (the CPU tests' width), which the tuned kernels
    do not take: the wrappers launch csrc/width_kernels.cu (launches counted
    under their names), with the head kernels on; f32 tokens equal the CPU
    run's. Greedy with the stacked step, the trio and MERGED_LAYER; beam 3,
    and beam 11 (a group the tuned beam kernel does not take)."""
    cfg = Config(**TINY)
    torch.manual_seed(0)
    state = weights.reference_module(cfg).state_dict()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(3, 3, 32, 32, generator=gen)
    mask = torch.zeros(3, 32, 32, dtype=torch.bool)
    mask[1, :, 20:] = True
    greedy = decoder.startswith("greedy")
    run = decode.greedy if greedy else decode.beam_search
    kw = dict(max_len=16, bos_token=1, eos_token=6,
              **({} if greedy else {"beam_size": 11 if decoder.endswith("11") else 3}))
    flags = {"LAYER_GRID": decoder == "greedy", "MERGED_LAYER": decoder == "greedy merged",
             "HEAD_KERNEL": True, "BEAM_TOPK_KERNEL": True}
    old = {n: getattr(dk, n) for n in flags}
    try:
        for n, v in flags.items():
            setattr(dk, n, v)
        cpu = run(weights.to_params(state, cfg, device="cpu"), cfg, Masked(img, mask), **kw)
        dk.reset_launches()
        gpu = run(weights.to_params(state, cfg, device=dev), cfg, Masked(img.to(dev), mask.to(dev)), **kw)
        torch.cuda.synchronize()
    finally:
        for n, v in old.items():
            setattr(dk, n, v)
    assert not dk.decode_kernels_fit(cfg.hidden_dim, cfg.nheads, cfg.dim_feedforward)
    layer = {"greedy": "fused_stack_step", "greedy trio": "ff_block", "greedy merged": "fused_layer_step"}
    launched = {n for n, v in dk.LAUNCHES.items() if v > 0}
    if greedy:
        assert launched == {layer[decoder], "mlp_head_argmax"} | (
            {"self_attn_block", "cross_attn_block"} if decoder == "greedy trio" else set()), dk.LAUNCHES
        assert torch.equal(gpu.cpu(), cpu)
    else:
        assert launched == {"self_attn_block_beam", "cross_attn_block", "ff_block", "mlp_head_topk"}, dk.LAUNCHES
        assert torch.equal(gpu[0].cpu(), cpu[0]) and float((gpu[1].cpu() - cpu[1]).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("d,sq,sk,causal", [(48, 9, 13, False), (8, 40, 37, True), (128, 33, 200, False),
                                            (32, 70, 4000, False), (64, 5, 30000, True)])
def test_attention_at_a_head_dim_the_kernel_does_not_take_runs_the_plain_version(dev, d, sq, sk, causal, dtype, tol):
    """Head dims the tiled kernel is not built for (8, 48, 128) and key counts
    whose 32-row score block does not fit shared memory (4000, 30000: 8 and 1
    query rows per block): the dispatch launches the any-width kernel (one
    launch), within tolerance of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(8 + d + sk)
    q, k, v = (torch.randn(2, 3, s, d, generator=gen, device=dev).to(dtype) for s in (sq, sk, sk))
    kb = torch.where(torch.rand(2, sk, generator=gen, device=dev) < 0.3, float("-inf"), 0.0)
    kb[:, 0] = 0.0
    dk.reset_launches()
    out, _ = fa.attention(q, k, v, None, use_pallas=True, causal=causal, key_bias=kb)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["fused_attention"] == 1
    with matmul_precision(torch.float32):
        _close_to_plain(out, fa.fused_attention_plain(q, k, v, kb, causal=causal), tol)


@pytest.mark.parametrize("topk_kernel", [False, True])
def test_beam_through_kernels_matches_cpu(dev, topk_kernel):
    cfg = Config(backbone="ResNet18", dilation=False, hidden_dim=C, nheads=H, enc_layers=1, dec_layers=L,
                 dim_feedforward=F, vocab_size=96, max_position_embeddings=20, dropout=0.0, image_size=64)
    torch.manual_seed(0)
    state = weights.reference_module(cfg).state_dict()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(3, 3, 64, 64, generator=gen)
    mask = torch.zeros(3, 64, 64, dtype=torch.bool)
    mask[1, :, 40:] = True
    kw = dict(max_len=20, bos_token=1, eos_token=3, beam_size=3, length_penalty=0.7)
    old = dk.BEAM_TOPK_KERNEL
    dk.BEAM_TOPK_KERNEL = topk_kernel
    try:
        cpu_t, cpu_s = decode.beam_search(weights.to_params(state, cfg, device="cpu"), cfg, Masked(img, mask), **kw)
        dk.reset_launches()
        gpu_t, gpu_s = decode.beam_search(weights.to_params(state, cfg, device=dev), cfg,
                                          Masked(img.to(dev), mask.to(dev)), **kw)
    finally:
        dk.BEAM_TOPK_KERNEL = old
    assert dk.LAUNCHES["self_attn_block_beam"] > 0 and dk.LAUNCHES["fused_stack_step"] == 0
    assert (dk.LAUNCHES["mlp_head_topk"] > 0) == topk_kernel
    assert torch.equal(gpu_t.cpu(), cpu_t)
    assert float((gpu_s.cpu() - cpu_s).abs().max()) <= 1e-4


ATTN_CASES = [  # (b, h, sq, sk, causal, pad rate): the model's shapes and ragged ones
    (3, 2, 37, 53, False, 0.3),
    (2, 3, 45, 45, True, 0.2),
    (2, 8, 196, 196, False, 0.1),
    (2, 8, 128, 196, False, 0.1),
    (1, 2, 5, 1024, False, 0.5),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_fused_attention_matches_plain_version(dev, dtype, tol, d, case):
    """Tolerance as a fraction of max(1, max|plain|), as above; the rows where
    every key is masked (the second row of each case) give the mean of V on
    both sides."""
    b, h, sq, sk, causal, rate = case
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype) for s in (sq, sk, sk))
    pad = torch.rand(b, sk, generator=gen, device=dev) < rate
    pad[:, 0] = False
    pad[1 % b] = b > 1
    kb = torch.where(pad, float("-inf"), 0.0)
    # split_heads-style views: the wrapper makes them contiguous
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    dk.reset_launches()
    got = fa.fused_attention(qv, k, v, kb, causal=causal)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["fused_attention"] == 1
    with matmul_precision(torch.float32):
        want = fa.fused_attention_plain(q, k, v, kb, causal=causal)
    _close_to_plain(got, want, tol)
    nobias = fa.fused_attention(q, k, v, None, causal=causal)
    with matmul_precision(torch.float32):
        _close_to_plain(nobias, fa.fused_attention_plain(q, k, v, None, causal=causal), tol)


@pytest.mark.parametrize("edge", list(chip_smoke.ATTN_EDGES))
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_edges_match_plain_version(dev, dtype, d, edge):
    """chip_smoke.py's attention_edges cases: one query, 1/15/17/397 keys,
    causal tiles the diagonal crosses, padding from a tile boundary,
    all-masked rows (with and without the causal skip), 1718 keys (the
    untiled kernel); within TOL of the plain version, repeats bit-equal."""
    gen = torch.Generator(device=dev).manual_seed(11)
    dk.reset_launches()
    got = chip_smoke.attention_case(dev, gen, dtype, d, *chip_smoke.ATTN_EDGES[edge])
    assert dk.LAUNCHES["fused_attention"] == 2
    assert got["err"] <= got["tol"] and got["same"], got
    untiled = "1718" in edge and not (d == 16 and dtype == torch.bfloat16)   # past the mma kernel's limit
    assert got["plan"]["path"] == ("any" if untiled else "mma")


@pytest.mark.parametrize("ancestry", chip_smoke.BEAM_EDGE_ANCESTRY)
@pytest.mark.parametrize("step", [0, 63, 127])
@pytest.mark.parametrize("groups", [1, 33])
@pytest.mark.parametrize("beams", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_block_edges_match_plain_version(dev, dtype, beams, groups, step, ancestry):
    """chip_smoke.py's beam_edges cases at the served width and T = 128: the
    cluster kernel within TOL of the plain version (output and the written
    slot), repeats bit-equal, no other cache slot changed."""
    gen = torch.Generator(device=dev).manual_seed(13 + beams)
    lp = dk.layer_params(chip_smoke.random_decoder(gen, dev, dtype), 0)["self_attn"]
    dk.reset_launches()
    got = chip_smoke.beam_case(dev, gen, lp, beams, groups, step, ancestry)
    assert dk.LAUNCHES["self_attn_block_beam"] == 2
    assert got["err"] <= got["tol"] and got["same"] and got["untouched"], {k: v for k, v in got.items() if k != "out"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("beams", [1, 5, 8])
def test_beam_block_rows_per_tile_do_not_change_the_bits(dev, dtype, beams):
    """Every row tile the cluster kernel takes (whole groups up to 32 rows)
    gives the bits of its own choice; a tile that is not whole groups, or
    past 32 rows, is refused."""
    outs = {}
    for rows in [0] + [beams * g for g in range(1, 33) if beams * g <= 32]:
        gen = torch.Generator(device=dev).manual_seed(21)
        lp = dk.layer_params(chip_smoke.random_decoder(gen, dev, dtype), 0)["self_attn"]
        got = chip_smoke.beam_case(dev, gen, lp, beams, 33, 63, "permutation", rows=rows)
        assert got["err"] <= got["tol"] and got["same"]
        outs[rows] = chip_smoke._bits(got["out"])
    assert all(torch.equal(o, outs[0]) for o in outs.values())
    gen = torch.Generator(device=dev).manual_seed(21)
    lp = dk.layer_params(chip_smoke.random_decoder(gen, dev, dtype), 0)["self_attn"]
    for rows in ([beams + 1] if beams > 1 else []) + [beams * (32 // beams + 1)]:
        with pytest.raises(RuntimeError, match="rt_self_attn_block_beam"):
            chip_smoke.beam_case(dev, gen, lp, beams, 33, 63, "permutation", rows=rows)


@pytest.mark.parametrize("step", [0, 63, 127, "T-1"])
@pytest.mark.parametrize("t", ["128", "longest"])
@pytest.mark.parametrize("rows", chip_smoke.SELF_EDGE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_block_edges_match_plain_version(dev, dtype, rows, t, step):
    """chip_smoke.py's self_edges cases at the served width: the cluster
    kernel at T = 128 and at the longest T it takes, at its own row tile and
    every tile of its rule on the same inputs, within TOL of the plain
    version (output and the written slot), repeats bit-equal, the same bits
    at every tile, no other cache slot and not x written."""
    tmax = chip_smoke.T if t == "128" else chip_smoke.self_max_t(dtype)
    step = tmax - 1 if step == "T-1" else step
    gen = torch.Generator(device=dev).manual_seed(14)
    lp = dk.layer_params(chip_smoke.random_decoder(gen, dev, dtype), 0)["self_attn"]
    first = None
    for tile in (0,) + chip_smoke.SELF_TILES:
        dk.reset_launches()
        got = chip_smoke.self_case(dev, 100 + rows + step, lp, rows, step, tmax, tile)
        assert dk.LAUNCHES["self_attn_block"] == 2 and dk.LAUNCHES["self_attn_block_beam"] == 0
        assert got["err"] <= got["tol"] and got["same"] and got["untouched"], \
            {k: v for k, v in got.items() if k != "out"}
        assert got["plan"]["rows"] == (tile or got["plan"]["rows"]) and got["plan"]["cluster"] == 8
        first = got["out"] if first is None else first
        assert torch.equal(chip_smoke._bits(got["out"]), chip_smoke._bits(first)), tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_block_is_the_beam_block_with_groups_of_one(dev, dtype):
    """rt_self_attn_block gives rt_self_attn_block_beam's bits at beam groups
    of one with an all-zero ancestry (33 rows, step 63); a cache one position
    past the longest T is refused, and the next launch runs."""
    gen = torch.Generator(device=dev).manual_seed(15)
    lp = dk.layer_params(chip_smoke.random_decoder(gen, dev, dtype), 0)["self_attn"]
    x = torch.randn(33, C, generator=gen, device=dev).to(dtype)
    qpos = torch.randn(C, generator=gen, device=dev).to(dtype)
    caches = [torch.randn(33, H, 128, D, generator=gen, device=dev).to(dtype) for _ in range(2)]
    kc, vc, kc_b, vc_b = (c.clone() for c in caches + caches)
    step = torch.tensor(63, dtype=torch.int32, device=dev)
    anc = torch.zeros(33, 128, dtype=torch.int32, device=dev)
    dk.reset_launches()
    got = dk.self_attn_block(lp, x, qpos, kc, vc, step, num_heads=H)[0]
    beam = dk.self_attn_block_beam(lp, x, anc, qpos, kc_b, vc_b, step, num_heads=H, num_beams=1)[0]
    torch.cuda.synchronize()
    assert dk.LAUNCHES["self_attn_block"] == 1 and dk.LAUNCHES["self_attn_block_beam"] == 1
    for a, b in ((got, beam), (kc, kc_b), (vc, vc_b)):
        assert torch.equal(chip_smoke._bits(a), chip_smoke._bits(b))
    longest = chip_smoke.self_max_t(dtype)
    over = torch.zeros(2, H, longest + 1, D, device=dev, dtype=dtype)
    with pytest.raises(RuntimeError, match="rt_self_attn_block"):
        dk.self_attn_block(lp, x[:2], qpos, over, over.clone(), step, num_heads=H)
    again = dk.self_attn_block(lp, x, qpos, kc.clone(), vc.clone(), step, num_heads=H)[0]
    torch.cuda.synchronize()
    assert torch.equal(chip_smoke._bits(again), chip_smoke._bits(got))


def test_fused_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="do not match"):
        fa.fused_attention(q, q, q[..., :32])
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        fa.fused_attention(q, torch.zeros(1, 2, 60000, 32, device=dev), torch.zeros(1, 2, 60000, 32, device=dev))
    with pytest.raises(ValueError, match="expected torch.float32"):
        fa.fused_attention(q, q, q, torch.zeros(1, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError):
        fa.fused_attention(q.clone().requires_grad_(True), q, q)


def test_full_width_eval_step_kernel_matches_plain(dev):
    """The served model at full width (ResNet-50 dilated, 6+6 layers, d=256,
    vocab 30522), bf16 compute, batch 4: the validation loss through the
    fused kernel (18 launches: 6 encoder, 6 causal decoder, 6 cross) equals
    the plain path's within 1e-4 relative (the transformer computes in f32)."""
    cfg = Config(backbone="ResNet50", dilation=True, vocab_size=30522, dropout=0.1, compute_dtype="bfloat16")
    torch.manual_seed(0)
    params = weights.to_params(weights.reference_module(cfg).state_dict(), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    caps = torch.randint(3, cfg.vocab_size, (4, 129), generator=gen, device=dev, dtype=torch.int32)
    caps[:, 0] = 101
    caps[:, 16:] = 0
    mask = torch.zeros(4, 224, 224, dtype=torch.bool, device=dev)
    mask[1, :, 150:] = True
    batch = Batch(torch.randn(4, 3, 224, 224, generator=gen, device=dev), mask, caps, caps == 0)
    plain = tstate.make_eval_step(cfg)(params, batch)
    dk.reset_launches()
    fused = tstate.make_eval_step(cfg.replace(use_pallas_attention=True))(params, batch)
    torch.cuda.synchronize()
    assert dk.LAUNCHES["fused_attention"] == 18
    assert torch.isfinite(fused) and abs(float(fused) - float(plain)) <= 1e-4 * abs(float(plain))


# ---------------------------------------------------------------------------------
# The serving surface on the card: sampling, prefix completion, scores, maps
# ---------------------------------------------------------------------------------

SERVE_CFG = dict(backbone="ResNet18", dilation=False, hidden_dim=C, nheads=H, enc_layers=1, dec_layers=L,
                 dim_feedforward=F, vocab_size=96, max_position_embeddings=20, dropout=0.0, image_size=64)


def _serve_model(dev, **cfg_kw):
    """(cfg, state, cpu params, card params, cpu samples, card samples): 5 images."""
    cfg = Config(**{**SERVE_CFG, **cfg_kw})
    torch.manual_seed(0)
    state = weights.reference_module(cfg).state_dict()
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(5, 3, 64, 64, generator=gen)
    mask = torch.zeros(5, 64, 64, dtype=torch.bool)
    mask[2, :, 40:] = True
    return (cfg, state, weights.to_params(state, cfg, device="cpu"), weights.to_params(state, cfg, device=dev),
            Masked(img, mask), Masked(img.to(dev), mask.to(dev)))


def _equal_but_near_ties(gpu, cpu, params, cfg, samples):
    """The f32_parity rule: the buffers are equal, or a row first differs at a
    slot whose CPU logits (teacher-forced on the CPU buffer) have a top-2 margin
    below 1e-4."""
    from retr_tpu_torch.models import caption

    logits = caption.forward(params, cfg, samples, cpu, cpu == 0)
    top2 = logits.topk(2, dim=-1).values
    for r in range(cpu.shape[0]):
        bad = (gpu[r] != cpu[r]).nonzero().flatten().tolist()
        if bad:
            j = bad[0]
            margin = float(top2[r, j - 1, 0] - top2[r, j - 1, 1])
            assert margin < 1e-4, f"row {r} differs at slot {j} with a CPU top-2 margin of {margin}"


def test_sample_at_temperature_zero_equals_greedy(dev):
    cfg, _, _, params, _, samples = _serve_model(dev)
    kw = dict(max_len=20, bos_token=1, eos_token=3)
    want = decode.greedy(params, cfg, samples, **kw)
    dk.reset_launches()
    got = decode.sample(params, cfg, samples, torch.Generator(device=dev).manual_seed(0), temperature=0.0, **kw)
    assert dk.LAUNCHES["fused_stack_step"] > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (50, 0.9), (0, 0.9)])
def test_sample_is_deterministic_per_seed_on_the_card(dev, top_k, top_p):
    cfg, _, _, params, _, samples = _serve_model(dev, compute_dtype="bfloat16")
    kw = dict(max_len=20, bos_token=1, eos_token=-1, temperature=1.0, top_k=top_k, top_p=top_p,
              compute_dtype=torch.bfloat16)
    runs = [decode.sample(params, cfg, samples, torch.Generator(device=dev).manual_seed(s), **kw)
            for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_prefix_and_sample_greedy_match_cpu_in_f32(dev):
    cfg, _, cpu_params, params, cpu_samples, samples = _serve_model(dev)
    kw = dict(max_len=20, bos_token=1, eos_token=3)
    prefix = torch.randint(4, 96, (5, 6), generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    prefix[3, 1] = 3
    lens = torch.tensor([0, 2, 6, 3, 1], dtype=torch.int32)
    cpu = decode.greedy_with_prefix(cpu_params, cfg, cpu_samples, prefix, lens, **kw)
    gpu = decode.greedy_with_prefix(params, cfg, samples, prefix.to(dev), lens.to(dev), **kw).cpu()
    _equal_but_near_ties(gpu, cpu, cpu_params, cfg, cpu_samples)
    for sampler in (dict(temperature=0.0), dict(top_k=1)):
        cpu = decode.sample(cpu_params, cfg, cpu_samples, torch.Generator().manual_seed(0), **sampler, **kw)
        gpu = decode.sample(params, cfg, samples, torch.Generator(device=dev).manual_seed(0), **sampler, **kw)
        _equal_but_near_ties(gpu.cpu(), cpu, cpu_params, cfg, cpu_samples)


def test_score_launches_fused_attention_and_attention_maps_do_not(dev):
    """Under use_pallas_attention: ``score`` runs every attention core of its
    forward in the kernel (enc_layers + 2 * dec_layers launches a chunk) and
    agrees with the plain path; ``predict_with_attention`` launches none."""
    import numpy as np

    from retr_tpu_torch.data.tokenizer import prepare_tokenizer
    from retr_tpu_torch.predictor import Predictor

    tok, _, _ = prepare_tokenizer()
    cfg = Config(**{**SERVE_CFG, "vocab_size": tok.vocab_size, "use_pallas_attention": True})
    torch.manual_seed(0)
    state = weights.reference_module(cfg).state_dict()
    pred = Predictor(state, cfg, tok, max_batch=4, device=dev)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (80, 90, 3), dtype=np.uint8) for _ in range(3)]
    boxes = [[5, 5, 40, 30]] * 3
    texts = ["red dog", "the man on the left", "chair"]
    dk.reset_launches()
    got = pred.score(imgs, boxes, texts)
    assert dk.LAUNCHES["fused_attention"] == cfg.enc_layers + 2 * cfg.dec_layers
    plain = Predictor(state, cfg.replace(use_pallas_attention=False), tok, max_batch=4, device=dev)
    for g, w in zip(got, plain.score(imgs, boxes, texts)):
        assert g["n_tokens"] == w["n_tokens"] and abs(g["logprob"] - w["logprob"]) <= 1e-3 * max(1, abs(w["logprob"]))
    dk.reset_launches()
    text, atts = pred.predict_with_attention(imgs[0], boxes[0])
    assert dk.LAUNCHES["fused_attention"] == 0 and isinstance(text, str)
    np.testing.assert_allclose(atts["dec_exp_tc_cross_att"].sum(-1), 1.0, atol=1e-3)


def test_apply_color_jitter_on_cuda_equals_cpu(dev):
    """The same draws on the card and on the CPU: within 1e-3 on the 0-255
    scale (the contrast mean is a sum in another order)."""
    from retr_tpu_torch.ops import image as imops

    gen = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (16, 224, 224, 3), generator=gen, dtype=torch.uint8)
    draws = imops.jitter_draws(gen, 16, "cpu")
    want = imops.apply_color_jitter(img.float(), draws)
    got = imops.apply_color_jitter(img.to(dev).float(), imops.JitterDraws(*(d.to(dev) for d in draws)))
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    cuda_draws = imops.jitter_draws(torch.Generator(device=dev).manual_seed(0), 16, dev)
    assert all(d.device.type == "cuda" for d in cuda_draws)


def test_train_epoch_and_eval_model_on_cuda(dev, tmp_path):
    """A tiny-width model on a synthetic RefCOCO (chip_smoke.write_refcoco,
    images saved by np.save): two epochs (inline and staged uploads, whose batches are
    bit-equal), the validation loss through fused_attention, eval_model
    greedy and beam through the decode kernels; losses and metrics finite."""
    import math

    from retr_tpu_torch import engine
    from retr_tpu_torch.data.dataset import DataLoader, build_dataset
    from retr_tpu_torch.data.tokenizer import prepare_tokenizer

    coco_dir, ref_dir = chip_smoke.write_refcoco(str(tmp_path), n_images=12, n_train=10, n_val=5)
    tok = prepare_tokenizer()[0]
    cfg = Config(**{**SERVE_CFG, "vocab_size": tok.vocab_size, "dropout": 0.1, "dir": coco_dir,
                    "ref_dir": ref_dir, "beam_size": 3})

    def loader(mode, unique=False, **kw):
        ds = build_dataset(cfg, mode, tokenizer=tok, return_unique=unique)
        return DataLoader(ds, 4, num_workers=2, **kw)

    train = loader("train", shuffle=True, drop_last=True)
    torch.manual_seed(0)
    params = weights.to_params(weights.reference_module(cfg).state_dict(), cfg, device=dev)
    st = tstate.create_train_state(cfg, params, device=dev, steps_per_epoch=len(train))
    step = tstate.make_train_step(cfg)
    losses = []
    for epoch in (0, 1):
        st, loss = engine.train_one_epoch(st, step, train, 0, epoch=epoch, stage_uploads=epoch == 1)
        losses.append(loss)
    assert all(math.isfinite(x) for x in losses) and st.step == 2 * len(train)

    def record(staged):
        store = []

        def rec(state, batch, seed):
            store.append(batch)
            return state, 0.0

        engine.train_one_epoch(st, rec, train, 7, epoch=3, stage_uploads=staged)
        torch.cuda.synchronize()
        return store

    for a, b in zip(record(False), record(True)):
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))

    val = loader("val")
    dk.reset_launches()
    val_loss = engine.evaluate(st.params, cfg.replace(use_pallas_attention=True), val)
    assert math.isfinite(val_loss)
    assert dk.LAUNCHES["fused_attention"] == (cfg.enc_layers + 2 * cfg.dec_layers) * len(val)
    unique = loader("val", unique=True)
    for decoder, kernels in (("greedy", ["fused_stack_step"]),
                             ("beam", ["self_attn_block_beam", "cross_attn_block", "ff_block"])):
        dk.reset_launches()
        metrics, hyps = engine.eval_model(st.params, cfg, unique, tok, decoder=decoder)
        assert all(dk.LAUNCHES[k] > 0 for k in kernels), (decoder, dk.LAUNCHES)
        assert len(hyps) == len(unique.dataset) and len(metrics) == 7
        assert all(math.isfinite(v) for v in metrics.values())


def test_checkpoint_moves_between_the_card_and_the_cpu(dev, tmp_path):
    """A checkpoint saved from the card loads with device "cpu" to the same
    parameters, AdamW moments, step and grad_norm, and one saved from the CPU
    loads on the card alike; AdamW's step counters stay on the host."""
    from retr_tpu_torch.models import caption
    from retr_tpu_torch.train import checkpoints as ckpt

    cfg = Config(**SERVE_CFG)

    def template(device, seed):
        params, _ = caption.build_model(cfg, seed=seed, device=device)
        return tstate.create_train_state(cfg, params, device=device, steps_per_epoch=1)

    def same(a, b):
        la, lb = list(tstate.tree_leaves_with_path(a.params)), list(tstate.tree_leaves_with_path(b.params))
        assert all(torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(la, lb))
        assert a.step == b.step and torch.equal(a.grad_norm.cpu(), b.grad_norm.cpu())
        sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[i][k].cpu(), sb[i][k].cpu()) for i in sb for k in sb[i])

    g = torch.Generator().manual_seed(0)
    batch = Batch(torch.randn(2, 3, 64, 64, generator=g), torch.zeros(2, 64, 64, dtype=torch.bool),
                  torch.randint(1, 96, (2, 12), generator=g, dtype=torch.int32), torch.zeros(2, 12, dtype=torch.bool))
    st = template(dev, 0)
    st, _ = tstate.make_train_step(cfg)(st, Batch(*(t.to(dev) if t is not None else None for t in batch)), 1)
    on_cpu, _ = ckpt.load_checkpoint(ckpt.save_checkpoint(str(tmp_path / "card"), st, cfg, epoch=0), template("cpu", 1))
    same(on_cpu, st)
    back, _ = ckpt.load_checkpoint(ckpt.save_checkpoint(str(tmp_path / "cpu"), on_cpu, cfg, epoch=0), template(dev, 2))
    same(back, st)
    step_device = next(iter(st.opt_state.state.values()))["step"].device   # where a fresh AdamW keeps it
    assert all(s["exp_avg"].device.type == "cuda" and s["step"].device == step_device
               for s in back.opt_state.state.values())


def test_dp2_world_on_one_card_over_gloo_matches_the_world_of_one(dev, tmp_path):
    """Two ranks share cuda:0 (NCCL refuses that; gloo carries the port's
    all_reduces on CUDA tensors): two f32 steps at dropout 0 on a global
    batch of 4, losses within 1e-4 relative of the world of one's."""
    import json
    import os

    from retr_tpu_torch.data import dataset
    from retr_tpu_torch.data.pipeline import device_batch
    from retr_tpu_torch.data.tokenizer import prepare_tokenizer
    from retr_tpu_torch.models import caption
    # by its own name, as pytest puts tests/ on sys.path: a package named
    # "tests" installed elsewhere would shadow the repository's directory
    from torch_parallel_worker import run_world

    coco_dir, ref_dir = chip_smoke.write_refcoco(str(tmp_path / "refcoco"), n_images=8, n_train=8, n_val=4)
    kw = dict(dir=coco_dir, ref_dir=ref_dir, backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4,
              enc_layers=1, dec_layers=1, dim_feedforward=128, vocab_size=chip_smoke.V, max_position_embeddings=16,
              dropout=0.0, image_size=64, batch_size=2, num_workers=1,
              vocab_file=chip_smoke.write_vocab(str(tmp_path / "vocab.txt")), device="cuda")
    cfg = Config(**kw)
    sd = weights.to_state_dict(caption.build_model(cfg, seed=0, device="cpu")[0], cfg)
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    torch.save(sd, in_dir / "init.pt")
    with open(in_dir / "setup.json", "w") as f:
        json.dump({"cfg": kw, "global_batch": 4, "device": "cuda:0"}, f)
    ranks = run_world("2x1_train", 2, str(in_dir), str(out_dir))

    tok = prepare_tokenizer(cfg.vocab_file)[0]
    ds = dataset.build_dataset(cfg, "training", tokenizer=tok)
    batch = device_batch(next(iter(dataset.DataLoader(ds, 4, num_workers=1))), dev)
    st = tstate.create_train_state(cfg, weights.to_params(sd, cfg, device="cpu"), device=dev, steps_per_epoch=4)
    step = tstate.make_train_step(cfg)
    want = [float(step(st, batch, 5)[1]) for _ in range(2)]
    for r in ranks:
        assert all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(r["losses"], want)), (r["losses"], want)
    assert os.path.exists(out_dir / "2x1_train.r1.pt")
