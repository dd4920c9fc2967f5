"""CUDA kernels of the port on an NVIDIA GPU (marker ``cuda``; skipped without one).

The kernels have no CPU mode: on the CPU their plain versions run and are held
against retr_tpu in the other test_torch_* files. Here each kernel is held
against its plain version on the card, and greedy decoding through the kernels
against the plain path on the CPU. Run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from retr_tpu_torch import decode
from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import weights
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.precision import matmul_precision

pytestmark = pytest.mark.cuda

C, H, D, F, T, S, L = 256, 8, 32, 512, 24, 37, 2
B = 13  # not a multiple of the 4-row tile: the ragged last tile runs too


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the plain versions are tested on the CPU")
    return torch.device("cuda")


def _decoder(gen, dev, dtype):
    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def lin(i, o):
        return {"w": rn(L, i, o, scale=(2.0 / (i + o)) ** 0.5), "b": rn(L, o, scale=0.02)}

    def norm():
        return {"scale": (1 + rn(L, C, scale=0.1).float()).to(dtype), "bias": rn(L, C, scale=0.1)}

    def mha():
        return {k: lin(C, C) for k in ("q", "k", "v", "out")}

    return {"self_attn": {"norm": norm(), "mha": mha()}, "cross_attn": {"norm": norm(), "mha": mha()},
            "ff": {"norm": norm(), "lin1": lin(C, F), "lin2": lin(F, C)}}


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
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        scale = max(1.0, float(want[0].float().abs().max()))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert float((g.float() - w.float()).abs().max()) <= tol * scale


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    p = {"norm": {"scale": torch.ones(64, device=dev), "bias": torch.zeros(64, device=dev)},
         "lin1": {"w": torch.zeros(64, 256, device=dev), "b": torch.zeros(256, device=dev)},
         "lin2": {"w": torch.zeros(256, 64, device=dev), "b": torch.zeros(64, device=dev)}}
    with pytest.raises(ValueError, match="width"):
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
