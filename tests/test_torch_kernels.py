"""The port's decode-step kernels (plain PyTorch versions, the CPU path) held
against the Pallas kernels of retr_tpu run in interpret mode.

Same seeded numpy inputs through both; the TPU-layout caches [H, B, D, T] /
[L, H, B, D, T] are transposed to the port's [B, H, T, D] / [L, B, H, T, D].

Tolerances: f32 atol 3e-5 (the JAX package's own kernel tests; the two sides
sum in different orders). bf16 storage: both sides round at the same points
(activation cast to bf16 at each product, per-head residual rounding in the
split blocks) and accumulate in f32, so outputs may differ only where an f32
sum order difference flips one bf16 rounding: atol of one bf16 ulp at the
output's magnitude (2**-8 relative, 0.0625 at |x| < 16).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu.models import layers
from retr_tpu.ops import decoder_kernels as dk
from retr_tpu_torch.ops import decoder_kernels as tk

C, H, F, B, S, T, L = 64, 4, 128, 8, 23, 12, 2
D = C // H
STEP = 5
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 0.0625)}


def _norm(rng):
    return {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(C), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.standard_normal(C), jnp.float32)}


def _layer(rng, seed):
    return {
        "self_attn": {"norm": _norm(rng), "mha": layers.mha_init(jax.random.key(seed), C)},
        "cross_attn": {"norm": _norm(rng), "mha": layers.mha_init(jax.random.key(seed + 1), C)},
        "ff": {"norm": _norm(rng),
               "lin1": layers.xavier_linear_init(jax.random.key(seed + 2), C, F),
               "lin2": layers.xavier_linear_init(jax.random.key(seed + 3), F, C)},
    }


def _torch_tree(p, dtype):
    if isinstance(p, dict):
        return {k: _torch_tree(v, dtype) for k, v in p.items()}
    if isinstance(p, list):
        return [_torch_tree(v, dtype) for v in p]
    return torch.tensor(np.asarray(p, np.float32)).to(dtype)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


@pytest.fixture(params=sorted(DTYPES))
def case(request):
    jdt, tdt, atol = DTYPES[request.param]
    rng = np.random.default_rng(7)
    lps = [jax.tree.map(lambda a: a.astype(jdt), _layer(rng, 10 * (i + 1))) for i in range(L)]
    pad = rng.random((B, S)) < 0.3
    pad[:, 0] = False
    arr = lambda *shape: jnp.asarray(rng.standard_normal(shape), jdt)  # noqa: E731
    return dict(
        jdt=jdt, tdt=tdt, atol=atol, lps=lps,
        x=arr(B, C), qpos=arr(C),
        kc=arr(L, H, B, D, T), vc=arr(L, H, B, D, T),   # TPU layout
        ck=arr(L, B, H, S, D), cv=arr(L, B, H, S, D),
        kb=jnp.where(jnp.asarray(pad), -jnp.inf, 0.0).astype(jnp.float32),
    )


def _close(got, ref, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol, rtol=0)


def _block_inputs(case, rows, s):
    """x [rows, C] and the memory K/V [rows, H, s, D] with their key bias: the
    case's own at its shape, else drawn from a seeded rng (pad rate 0.3, key 0
    of every row kept)."""
    if (rows, s) == (B, S):
        return case["x"], case["ck"][0], case["cv"][0], case["kb"]
    rng = np.random.default_rng(100 + rows + s)
    arr = lambda *shape: jnp.asarray(rng.standard_normal(shape), case["jdt"])  # noqa: E731
    pad = rng.random((rows, s)) < 0.3
    pad[:, 0] = False
    return (arr(rows, C), arr(rows, H, s, D), arr(rows, H, s, D),
            jnp.where(jnp.asarray(pad), -jnp.inf, 0.0).astype(jnp.float32))


# rows: the case's batch and a beam-shaped one (8 x beam 5; Pallas takes multiples of 8)
BEAM_ROWS = 8 * 5


@pytest.mark.parametrize("rows", [B, BEAM_ROWS])
def test_ff_block_plain_matches_pallas(case, rows):
    p = case["lps"][0]["ff"]
    x = _block_inputs(case, rows, S)[0]
    ref = dk.ff_block(p, x, interpret=True)
    got = tk.ff_block(_torch_tree(jax.tree.map(np.asarray, p), case["tdt"]), _t(x, case["tdt"]))
    assert got.dtype == case["tdt"] and got.shape == (rows, C)
    _close(got, ref, case["atol"])


@pytest.mark.parametrize("rows", [B, BEAM_ROWS])
@pytest.mark.parametrize("s", [S, 1])   # S = 1: one memory position, its softmax weight exactly 1
def test_cross_attn_block_plain_matches_pallas(case, rows, s):
    p, tdt = case["lps"][0]["cross_attn"], case["tdt"]
    x, ck, cv, kb = _block_inputs(case, rows, s)
    ref = dk.cross_attn_block(p, x, case["qpos"], ck, cv, kb, num_heads=H, interpret=True)
    got = tk.cross_attn_block(_torch_tree(jax.tree.map(np.asarray, p), tdt), _t(x, tdt),
                              _t(case["qpos"], tdt), _t(ck, tdt), _t(cv, tdt), _t(kb), num_heads=H)
    assert got.dtype == tdt and got.shape == (rows, C)
    _close(got, ref, case["atol"])


def test_self_attn_block_plain_matches_pallas(case):
    p, tdt = case["lps"][0]["self_attn"], case["tdt"]
    ref, kc_ref, vc_ref = dk.self_attn_block(p, case["x"], case["qpos"], case["kc"][0], case["vc"][0],
                                             jnp.int32(STEP), num_heads=H, interpret=True)
    kc = _t(case["kc"][0], tdt).permute(1, 0, 3, 2).contiguous()   # [H,B,D,T] -> [B,H,T,D]
    vc = _t(case["vc"][0], tdt).permute(1, 0, 3, 2).contiguous()
    got, kc_out, vc_out = tk.self_attn_block(
        _torch_tree(jax.tree.map(np.asarray, p), tdt), _t(case["x"], tdt), _t(case["qpos"], tdt),
        kc, vc, torch.tensor(STEP, dtype=torch.int32), num_heads=H)
    _close(got, ref, case["atol"])
    assert kc_out is kc and vc_out is vc  # updated in place
    _close(kc.permute(1, 0, 3, 2), kc_ref, case["atol"])
    _close(vc.permute(1, 0, 3, 2), vc_ref, case["atol"])


# the first slot, a middle one and the last: the edges the CUDA kernel is held to
EDGE_STEPS = [0, STEP, T - 1]


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("step", EDGE_STEPS)
def test_self_attn_block_is_the_beam_block_with_groups_of_one(case, step):
    """self_attn_block_beam_plain with beam groups of one row and an all-zero
    ancestry (every row reads its own cache) gives self_attn_block_plain's
    bits, output and caches, so one CUDA kernel serves both wrappers; both
    match the Pallas self_attn_block in interpret mode."""
    p, tdt = case["lps"][0]["self_attn"], case["tdt"]
    ref, kc_ref, vc_ref = dk.self_attn_block(p, case["x"], case["qpos"], case["kc"][0], case["vc"][0],
                                             jnp.int32(step), num_heads=H, interpret=True)
    tp = _torch_tree(jax.tree.map(np.asarray, p), tdt)
    x, qpos, at = _t(case["x"], tdt), _t(case["qpos"], tdt), torch.tensor(step, dtype=torch.int32)
    kc, vc, kc_b, vc_b = (_t(case[n][0], tdt).permute(1, 0, 3, 2).contiguous() for n in ("kc", "vc", "kc", "vc"))
    got, _, _ = tk.self_attn_block(tp, x, qpos, kc, vc, at, num_heads=H)
    beam, _, _ = tk.self_attn_block_beam(tp, x, torch.zeros(B, T, dtype=torch.int32), qpos, kc_b, vc_b, at,
                                         num_heads=H, num_beams=1)
    for a, b in ((got, beam), (kc, kc_b), (vc, vc_b)):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in ((got, ref), (kc.permute(1, 0, 3, 2), kc_ref), (vc.permute(1, 0, 3, 2), vc_ref)):
        _close(a, b, case["atol"])


@pytest.mark.parametrize("step", EDGE_STEPS)
def test_fused_stack_step_plain_matches_pallas(case, step):
    tdt = case["tdt"]
    slp = dk.stack_layer_params(case["lps"])
    ref, kc_ref, vc_ref = dk.fused_stack_step(
        slp, case["x"], case["qpos"], case["kc"], case["vc"], case["ck"], case["cv"], case["kb"],
        jnp.int32(step), num_heads=H, interpret=True)
    tslp = tk.stack_layer_params([_torch_tree(jax.tree.map(np.asarray, lp), tdt) for lp in case["lps"]])
    kc = _t(case["kc"], tdt).permute(0, 2, 1, 4, 3).contiguous()   # -> [L,B,H,T,D]
    vc = _t(case["vc"], tdt).permute(0, 2, 1, 4, 3).contiguous()
    got, _, _ = tk.fused_stack_step(tslp, _t(case["x"], tdt), _t(case["qpos"], tdt), kc, vc,
                                    _t(case["ck"], tdt), _t(case["cv"], tdt), _t(case["kb"]),
                                    torch.tensor(step, dtype=torch.int32), num_heads=H)
    _close(got, ref, case["atol"])
    _close(kc.permute(0, 2, 1, 4, 3), kc_ref, case["atol"])
    _close(vc.permute(0, 2, 1, 4, 3), vc_ref, case["atol"])


def test_plain_calls_do_not_count_as_launches(case):
    tk.reset_launches()
    p = case["lps"][0]["ff"]
    tk.ff_block(_torch_tree(jax.tree.map(np.asarray, p), case["tdt"]), _t(case["x"], case["tdt"]))
    assert tk.LAUNCHES == {k: 0 for k in tk.LAUNCHES}


def test_build_needs_nvcc_and_keys_the_library_by_source(monkeypatch, tmp_path):
    """The CUDA sources are built only on first launch, with nvcc; without it the
    build raises. The library's name carries a hash of source and flags."""
    from retr_tpu_torch.ops import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.nvcc_path()
    path = cuda_build.library_path("block_kernels")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("libblock_kernels-")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build.library_path("block_kernels") != path


def _struct_fields(source: str, name: str):
    """Field names of ``struct <name>`` in a CUDA source, in order."""
    import re

    body = re.search(r"struct " + name + r" \{(.*?)\n\};", source, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        for part in decl.split(","):
            words = re.findall(r"\w+", part)
            if words:
                fields.append(words[-1])
    return fields


def test_ctypes_structs_mirror_the_cuda_argument_structs():
    """Every ``struct ...Args`` of csrc/*.cu and its ctypes mirror in
    ops/decoder_kernels.py name the same fields in the same order: a field
    out of place would pass every pointer one slot off, silently, on the card."""
    import glob
    import re

    from retr_tpu_torch.ops import cuda_build

    mirrors = {"StackArgs": tk._StackArgs, "HeadArgs": tk._HeadArgs,
               "AttnArgs": tk._AttnArgs, "BlockArgs": tk._BlockArgs, "WidthArgs": tk._WidthArgs}
    seen = set()
    for path in sorted(glob.glob(os.path.join(cuda_build.CSRC_DIR, "*.cu"))):
        source = open(path).read()
        for name in re.findall(r"^struct (\w*Args) \{", source, re.M):
            assert name in mirrors, f"{name} ({os.path.basename(path)}) has no ctypes mirror"
            assert [f[0] for f in mirrors[name]._fields_] == _struct_fields(source, name), name
            seen.add(name)
    assert seen == set(mirrors)


def test_block_plan_kinds_match_the_cuda_source():
    """``_PLAN_KIND`` gives each wrapper of csrc/block_kernels.cu the kind
    ``rt_block_plan`` takes for its entry point (the numbers the source's
    comment on rt_block_plan lists), and every such wrapper has one."""
    import re

    from retr_tpu_torch.ops import cuda_build

    source = open(os.path.join(cuda_build.CSRC_DIR, "block_kernels.cu")).read()
    doc = source[:source.index("int rt_block_plan(")].rsplit("\n\n", 1)[-1]
    kinds = {entry: int(k) for entry, k in re.findall(r"(rt_\w+) \((?:kind )?(\d+)\)", doc)}
    assert kinds == {tk._ENTRY[w][1]: k for w, k in tk._PLAN_KIND.items()}
    assert set(kinds) == set(tk._LIBS["block_kernels"][1])
    assert {w for w, (src, _) in tk._ENTRY.items() if src == "block_kernels"} == set(tk._PLAN_KIND)


def test_library_name_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a csrc/*.cuh header renames every library (each source may
    include it), so a stale build is never loaded."""
    import shutil

    from retr_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    names = ("stack_kernels", "width_kernels", "block_kernels")
    before = {n: cuda_build.library_path(n) for n in names}
    assert before == {n: cuda_build.library_path(n) for n in names}      # stable
    header = csrc / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)


def test_layer_params_views_share_the_stack():
    rng = np.random.default_rng(3)
    lps = [_torch_tree(jax.tree.map(np.asarray, _layer(rng, 10 * (i + 1))), torch.float32)
           for i in range(L)]
    slp = tk.stack_layer_params(lps)
    one = tk.layer_params(slp, 1)
    assert one["ff"]["lin1"]["w"].data_ptr() == slp["ff"]["lin1"]["w"][1].data_ptr()
    torch.testing.assert_close(one["self_attn"]["mha"]["q"]["w"], lps[1]["self_attn"]["mha"]["q"]["w"],
                               rtol=0, atol=0)


def test_self_attn_block_beam_plain_matches_pallas(case):
    """Two groups of 4 beams; the ancestry crosses rows inside each group, at
    earlier positions and at ``step`` itself (where the Pallas kernel reads
    the other row's fresh, unrounded k/v)."""
    p, tdt, k = case["lps"][0]["self_attn"], case["tdt"], 4
    anc = np.random.default_rng(9).integers(0, k, (B, T)).astype(np.int32)
    anc[:, STEP] = [1, 0, 3, 3, 2, 2, 0, 1]
    ref, kc_ref, vc_ref = dk.self_attn_block_beam(
        p, case["x"], jnp.asarray(anc), case["qpos"], case["kc"][0], case["vc"][0], jnp.int32(STEP),
        num_heads=H, num_beams=k, interpret=True)
    kc = _t(case["kc"][0], tdt).permute(1, 0, 3, 2).contiguous()
    vc = _t(case["vc"][0], tdt).permute(1, 0, 3, 2).contiguous()
    got, kc_out, vc_out = tk.self_attn_block_beam(
        _torch_tree(jax.tree.map(np.asarray, p), tdt), _t(case["x"], tdt), torch.from_numpy(anc),
        _t(case["qpos"], tdt), kc, vc, torch.tensor(STEP, dtype=torch.int32), num_heads=H, num_beams=k)
    _close(got, ref, case["atol"])
    assert kc_out is kc and vc_out is vc
    _close(kc.permute(1, 0, 3, 2), kc_ref, case["atol"])
    _close(vc.permute(1, 0, 3, 2), vc_ref, case["atol"])


@pytest.mark.parametrize("beams,step,ancestry", [
    (1, 0, "random"), (1, T - 1, "one ancestor"), (2, 0, "one ancestor"), (2, T - 1, "random"),
    (5, 0, "one ancestor"), (5, T - 1, "random"), (8, 0, "random"), (8, T - 1, "one ancestor")])
def test_self_attn_block_beam_plain_matches_pallas_at_edges(case, beams, step, ancestry):
    """Two groups of 1, 2, 5 and 8 beams at the first and the last cache slot;
    the ancestry random (crossing rows at ``step`` too) or every row of a
    group reading one ancestor at every position."""
    p, tdt = case["lps"][0]["self_attn"], case["tdt"]
    bk = 2 * beams
    rng = np.random.default_rng(30 + beams + step)
    arr = lambda *shape: jnp.asarray(rng.standard_normal(shape), case["jdt"])  # noqa: E731
    x, kc0, vc0 = arr(bk, C), arr(H, bk, D, T), arr(H, bk, D, T)
    if ancestry == "random":
        anc = rng.integers(0, beams, (bk, T)).astype(np.int32)
    else:
        anc = np.repeat(rng.integers(0, beams, (2, 1, 1)), beams, axis=1).repeat(T, axis=2)
        anc = anc.reshape(bk, T).astype(np.int32)
    ref, kc_ref, vc_ref = dk.self_attn_block_beam(
        p, x, jnp.asarray(anc), case["qpos"], kc0, vc0, jnp.int32(step), num_heads=H, num_beams=beams,
        interpret=True)
    kc = _t(kc0, tdt).permute(1, 0, 3, 2).contiguous()
    vc = _t(vc0, tdt).permute(1, 0, 3, 2).contiguous()
    got, _, _ = tk.self_attn_block_beam(
        _torch_tree(jax.tree.map(np.asarray, p), tdt), _t(x, tdt), torch.from_numpy(anc),
        _t(case["qpos"], tdt), kc, vc, torch.tensor(step, dtype=torch.int32), num_heads=H, num_beams=beams)
    _close(got, ref, case["atol"])
    _close(kc.permute(1, 0, 3, 2), kc_ref, case["atol"])
    _close(vc.permute(1, 0, 3, 2), vc_ref, case["atol"])


@pytest.mark.parametrize("step", EDGE_STEPS)
def test_fused_layer_step_plain_matches_pallas(case, step):
    tdt, lp = case["tdt"], case["lps"][1]
    ref, kc_ref, vc_ref = dk.fused_layer_step(
        lp, case["x"], case["qpos"], case["kc"][1], case["vc"][1], case["ck"][1], case["cv"][1], case["kb"],
        jnp.int32(step), num_heads=H, interpret=True)
    kc = _t(case["kc"][1], tdt).permute(1, 0, 3, 2).contiguous()
    vc = _t(case["vc"][1], tdt).permute(1, 0, 3, 2).contiguous()
    got, _, _ = tk.fused_layer_step(_torch_tree(jax.tree.map(np.asarray, lp), tdt), _t(case["x"], tdt),
                                    _t(case["qpos"], tdt), kc, vc, _t(case["ck"][1], tdt),
                                    _t(case["cv"][1], tdt), _t(case["kb"]), torch.tensor(step, dtype=torch.int32),
                                    num_heads=H)
    assert got.dtype == tdt
    _close(got, ref, case["atol"])
    _close(kc.permute(1, 0, 3, 2), kc_ref, case["atol"])
    _close(vc.permute(1, 0, 3, 2), vc_ref, case["atol"])


def _head(rng, vocab, ties=()):
    """MLP head 64 -> 96 -> 96 -> vocab (the JAX package's kernel tests); the
    ``ties`` columns of the last layer are made equal."""
    def lin(i, o):
        return {"w": rng.standard_normal((i, o)).astype(np.float32) * (1 / np.sqrt(i)),
                "b": 0.1 * rng.standard_normal(o).astype(np.float32)}
    p = {"layers": [lin(C, 96), lin(96, 96), lin(96, vocab)]}
    for col in ties:
        p["layers"][2]["w"][:, col] = 1.0
        p["layers"][2]["b"][col] = 5.0
    return p, rng.standard_normal((12, C)).astype(np.float32)


# vocab 5000 (not a multiple of either kernel's block); equal best columns
# straddling the Pallas kernel's 2048-wide blocks and the CUDA kernel's 256-wide ones
HEAD_CASES = {"random": (), "ties": (3, 2047, 2048, 4096, 4999)}


@pytest.mark.parametrize("ties", sorted(HEAD_CASES))
def test_mlp_head_argmax_plain_matches_pallas(case, ties):
    jdt, tdt = case["jdt"], case["tdt"]
    p, x = _head(np.random.default_rng(11), 5000, HEAD_CASES[ties])
    ref = dk.mlp_head_argmax(jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(x, jdt), interpret=True)
    got = tk.mlp_head_argmax(_torch_tree(p, tdt), torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if HEAD_CASES[ties]:
        assert (got.numpy() == 3).all()


@pytest.mark.parametrize("ties", sorted(HEAD_CASES))
def test_mlp_head_topk_plain_matches_pallas(case, ties):
    """Tokens equal (first index on ties, across blocks); log-softmax scores
    within 1e-5 (the Pallas kernel combines its blocks' logsumexp online)."""
    jdt, tdt = case["jdt"], case["tdt"]
    p, x = _head(np.random.default_rng(12), 5000, HEAD_CASES[ties])
    ref_s, ref_t = dk.mlp_head_topk(jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(x, jdt), 5,
                                    interpret=True)
    got_s, got_t = tk.mlp_head_topk(_torch_tree(p, tdt), torch.from_numpy(x).to(tdt), 5)
    assert got_s.dtype == torch.float32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5, rtol=0)
    if HEAD_CASES[ties]:
        assert (got_t.numpy() == [3, 2047, 2048, 4096, 4999]).all()


def test_topk_first_orders_ties_by_index():
    """lax.top_k's order: value descending, equal values by ascending index,
    0.0 above -0.0; torch.topk does not promise it."""
    v = torch.tensor([[0.5, -1e9, 2.0, -1e9, 2.0, -0.0, 0.0, -1e9 + 1, float("-inf")]])
    vals, idx = tk.topk_first(v, 9)
    assert idx.tolist() == [[2, 4, 0, 6, 5, 1, 3, 7, 8]]
    assert torch.equal(vals, v[:, idx[0]])
    _, jidx = jax.lax.top_k(jnp.asarray(v.numpy()), 9)
    assert idx.tolist() == np.asarray(jidx).tolist()


@pytest.mark.parametrize("c,heads,f,beams,fits", [
    (256, 8, 2048, 1, True), (256, 8, 256, 5, True), (256, 8, 2048, 8, True),
    (64, 4, 128, 1, False), (256, 4, 2048, 1, False), (512, 8, 2048, 1, False),
    (256, 8, 1000, 1, False), (256, 8, 2048, 9, False), (256, 8, 2048, 0, False)])
def test_decode_kernels_fit_rule(c, heads, f, beams, fits):
    """The tuned decoder-layer kernels take width 256 with 8 heads, an FF width
    that is a multiple of 256 and beam groups of 1..8; the wrappers launch the
    any-width kernels elsewhere."""
    assert tk.decode_kernels_fit(c, heads, f, beams) == fits


@pytest.mark.parametrize("c,hd,v,k,dtype,fits", [
    (256, 512, 30522, 1, torch.bfloat16, True), (256, 512, 30522, 8, torch.bfloat16, True),
    (64, 512, 96, 5, torch.float32, True), (256, 512, 30521, 5, torch.bfloat16, True),
    (256, 512, 30522, 256, torch.bfloat16, True), (256, 512, 30522, 257, torch.bfloat16, False),
    (256, 512, 4, 5, torch.float32, False), (256, 512, 30522, 0, torch.float32, False),
    (48, 500, 30522, 1, torch.float32, True), (256, 512, 30522, 1, torch.float16, False)])
def test_head_kernels_fit_rule(c, hd, v, k, dtype, fits):
    """The head kernels take any widths (pack_head pads the hidden width and
    W3's rows for them), 1 <= k <= min(V, 256), f32 or bf16."""
    p = {"layers": [{"w": torch.empty(c, hd, dtype=dtype)}, {"w": torch.empty(hd, hd, dtype=dtype)},
                    {"w": torch.empty(hd, v, dtype=dtype)}]}
    assert tk.head_kernels_fit(p, k) == fits


@pytest.mark.parametrize("ties", sorted(HEAD_CASES))
def test_packed_head_plain_matches_pallas(case, ties):
    """pack_head pads vocab 5003 to 5008 (zero weights, a -inf bias): both
    heads' plain versions on the packed head give the Pallas kernels' tokens
    (lowest tied index first) and scores on the head as it is."""
    jdt, tdt = case["jdt"], case["tdt"]
    p, x = _head(np.random.default_rng(13), 5003, HEAD_CASES[ties])
    packed = tk.pack_head(_torch_tree(p, tdt))
    assert packed["layers"][2]["w"].shape == (96, 5008) and packed["layers"][2]["b"].shape == (5008,)
    assert torch.isneginf(packed["layers"][2]["b"][5003:]).all()
    assert not packed["layers"][2]["w"][:, 5003:].any()
    jp, jx = jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(tk.mlp_head_argmax(packed, tx).numpy(),
                                  np.asarray(dk.mlp_head_argmax(jp, jx, interpret=True)))
    ref_s, ref_t = dk.mlp_head_topk(jp, jx, 5, interpret=True)
    got_s, got_t = tk.mlp_head_topk(packed, tx, 5)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5, rtol=0)
    if HEAD_CASES[ties]:
        assert (got_t.numpy() == [3, 2047, 2048, 4096, 4999]).all()
    assert tk.pack_head(packed) is packed            # already aligned: returned as it is


@pytest.mark.parametrize("k", [1, 5, 40])
def test_pack_head_pads_the_hidden_width(case, k):
    """A head of input width 36 and hidden width 100 (neither a multiple of 32):
    pack_head pads the hidden width to 128 with zero units (W1, b1, W2's rows
    and columns, b2, W3's rows) and the vocab 1000 stays; both heads' plain
    versions on the packed head give the Pallas kernels' tokens and scores on
    the head as it is, at k up to 40."""
    jdt, tdt = case["jdt"], case["tdt"]
    rng = np.random.default_rng(14)

    def lin(i, o):
        return {"w": rng.standard_normal((i, o)).astype(np.float32) * (1 / np.sqrt(i)),
                "b": 0.1 * rng.standard_normal(o).astype(np.float32)}
    p = {"layers": [lin(36, 100), lin(100, 100), lin(100, 1000)]}
    x = rng.standard_normal((12, 36)).astype(np.float32)
    packed = tk.pack_head(_torch_tree(p, tdt))
    l1, l2, l3 = packed["layers"]
    assert l1["w"].shape == (36, 128) and l2["w"].shape == (128, 128) and l3["w"].shape == (128, 1000)
    assert not l1["w"][:, 100:].any() and not l1["b"][100:].any() and not l2["w"][100:].any()
    assert not l2["w"][:, 100:].any() and not l2["b"][100:].any() and not l3["w"][100:].any()
    jp, jx = jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(x, jdt)
    tx = torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(tk.mlp_head_argmax(packed, tx).numpy(),
                                  np.asarray(dk.mlp_head_argmax(jp, jx, interpret=True)))
    ref_s, ref_t = dk.mlp_head_topk(jp, jx, k, interpret=True)
    got_s, got_t = tk.mlp_head_topk(packed, tx, k)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5, rtol=0)
