"""The port's fused attention (ops/attention.py) held against retr_tpu's Pallas
kernel in interpret mode, on the same seeded numpy inputs.

Tolerances: f32 2e-5 (both compute the same f32 expressions; the products and
sums run in other orders); bf16 one bf16 ulp of max |out| (both round the
probabilities and the output at the same points, and an order difference may
flip one rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retr_tpu.ops import attention as jattn
from retr_tpu_torch.models import layers
from retr_tpu_torch.ops import attention as tattn
from retr_tpu_torch.ops import decoder_kernels as dk

NEG = float("-inf")


def _inputs(b, h, sq, sk, d, seed, pad_rate=0.0, tail=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))
    pad = rng.random((b, sk)) < pad_rate
    if tail:
        pad[:, -tail:] = True
    pad[:, 0] = False
    bias = np.where(pad, NEG, 0.0).astype(np.float32)
    return q, k, v, bias


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


CASES = {  # name -> (b, h, sq, sk, d, pad_rate, tail, causal, bias)
    "no_mask": (2, 4, 37, 53, 32, 0.0, 0, False, False),
    "key_padding": (2, 4, 37, 53, 32, 0.3, 0, False, True),
    "causal_padding": (2, 4, 24, 24, 32, 0.0, 5, True, True),
    "not_128_multiples": (1, 2, 130, 197, 32, 0.2, 0, False, True),
    "d16": (2, 2, 20, 29, 16, 0.2, 0, False, True),
    "d16_causal": (1, 3, 17, 17, 16, 0.0, 3, True, True),
    # shapes the tensor-core kernel's tiling makes risky
    "one_query": (2, 2, 1, 40, 32, 0.2, 0, False, True),
    "keys_below_one_mma_step": (2, 2, 9, 15, 32, 0.2, 0, False, True),
    "causal_129": (1, 2, 129, 129, 32, 0.1, 3, True, True),          # the diagonal crosses 64-row tiles
    "d64": (1, 2, 40, 70, 64, 0.2, 0, False, True),
    "padding_to_a_tile_boundary": (1, 2, 30, 128, 32, 0.0, 64, False, True),   # keys 64.. masked
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(name, dtype):
    b, h, sq, sk, d, rate, tail, causal, with_bias = CASES[name]
    q, k, v, bias = _inputs(b, h, sq, sk, d, seed=len(name), pad_rate=rate, tail=tail)
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    ref = np.asarray(jattn.fused_attention(jq, jk, jv, jb, causal=causal, interpret=True), np.float32)
    got = tattn.fused_attention_plain(tq, tk, tv, tb, causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, sq, d)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)
    # on the CPU the wrapper is the plain version, and launches nothing
    dk.reset_launches()
    torch.testing.assert_close(tattn.fused_attention(tq, tk, tv, tb, causal=causal), got, rtol=0, atol=0)
    assert dk.LAUNCHES["fused_attention"] == 0


def test_all_masked_row_averages_v_over_real_keys():
    """Deviation: the TPU kernel averages V over its 128-padded key length and
    the plain attention core gives NaN; the port (plain version and kernel)
    gives the mean of V over the real Sk keys."""
    q, k, v, _ = _inputs(2, 2, 5, 7, 32, seed=3)
    bias = np.zeros((2, 7), np.float32)
    bias[1] = NEG
    got = tattn.fused_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, bias)))
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1].mean(axis=1, keepdims=True), (2, 5, 32)),
                               atol=1e-6)
    assert np.isfinite(got.numpy()).all()
    ref = np.asarray(jattn.fused_attention(*(jnp.asarray(x) for x in (q, k, v, bias)), interpret=True))
    np.testing.assert_allclose(got[0].numpy(), ref[0], atol=2e-5)       # unmasked rows agree
    padded_mean = v[1].sum(axis=1, keepdims=True) / 128.0                 # the TPU padding artifact
    np.testing.assert_allclose(ref[1], np.broadcast_to(padded_mean, (2, 5, 32)), atol=1e-5)


def test_raises_where_autograd_needs_the_gradient():
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(1, 2, 4, 6, 16, seed=4))
    qg = q.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no VJP"):
        tattn.fused_attention(qg, k, v, bias)
    with torch.no_grad():
        tattn.fused_attention(qg, k, v, bias)           # no gradient needed: runs
    with pytest.raises(NotImplementedError):
        tattn.attention(q, k, v.clone().requires_grad_(True), None, use_pallas=True, key_bias=bias)


@pytest.mark.parametrize("use_pallas,need_weights,dropout,train,fused", [
    (True, False, 0.0, False, True),
    (True, False, 0.1, False, True),    # dropout set but not training: kernel
    (True, False, 0.0, True, True),     # training without dropout: kernel
    (True, False, 0.1, True, False),    # attention dropout active: plain path
    (True, True, 0.0, False, False),    # attention maps asked for: plain path
    (False, False, 0.0, False, False),
])
def test_dispatch_takes_the_kernel_where_retr_tpu_does(monkeypatch, use_pallas, need_weights, dropout,
                                                       train, fused):
    """layers.multi_head_attention goes to the fused wrapper exactly when
    retr_tpu/models/layers.py:182 goes to its Pallas kernel."""
    calls = []
    real = tattn.fused_attention

    def spy(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "fused_attention", spy)
    rng = np.random.default_rng(5)
    e, h = 32, 2
    p = {n: {"w": torch.from_numpy(rng.standard_normal((e, e)).astype(np.float32) * 0.2),
             "b": torch.zeros(e)} for n in ("q", "k", "v", "out")}
    x = torch.from_numpy(rng.standard_normal((2, 6, e)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out, w = layers.multi_head_attention(p, x, x, x, num_heads=h, need_weights=need_weights,
                                             dropout_rate=dropout, generator=gen, train=train,
                                             use_pallas=use_pallas, causal=True,
                                             key_pad_bias=torch.zeros(2, 6))
    assert calls == ([True] if fused else [])
    assert (w is not None) == need_weights
    assert tuple(out.shape) == (2, 6, e)


@pytest.mark.parametrize("d,sk,fits", [(16, 53, True), (32, 397, True), (64, 1024, True), (32, 1718, True),
                                       (32, 58080, True), (32, 58081, False), (48, 53, True)])
def test_attention_kernel_fits_rule(d, sk, fits):
    """The kernel takes any head dim and the key counts whose one-query score
    row fits a block's shared memory (58080 keys at D = 32)."""
    assert tattn.attention_kernel_fits(d, sk) == fits


# (d, sk) -> {dtype: (path, rows per block, threads, shared bytes)}: the
# tensor-core kernel at head dims 16/32/64 (32-row tiles of 8 warps, 4 at
# D = 16), the untiled kernel at 48 and past the limit
PLANS = {
    (16, 17): {"float32": ("mma", 32, 128, 23440), "bfloat16": ("mma", 32, 128, 14224)},
    (16, 397): {"float32": ("mma", 32, 128, 72592), "bfloat16": ("mma", 32, 128, 63376)},
    (16, 1718): {"float32": ("any", 32, 256, 221952), "bfloat16": ("mma", 32, 128, 231312)},
    (32, 17): {"float32": ("mma", 32, 256, 35984), "bfloat16": ("mma", 32, 256, 20624)},
    (32, 397): {"float32": ("mma", 32, 256, 85136), "bfloat16": ("mma", 32, 256, 69776)},
    (32, 1718): {"float32": ("any", 32, 256, 224000), "bfloat16": ("any", 32, 256, 224000)},
    (48, 17): {"float32": ("any", 32, 256, 8320), "bfloat16": ("any", 32, 256, 8320)},
    (48, 397): {"float32": ("any", 32, 256, 56960), "bfloat16": ("any", 32, 256, 56960)},
    (48, 1718): {"float32": ("any", 32, 256, 226048), "bfloat16": ("any", 32, 256, 226048)},
    (64, 17): {"float32": ("mma", 32, 256, 60560), "bfloat16": ("mma", 32, 256, 33424)},
    (64, 397): {"float32": ("mma", 32, 256, 109712), "bfloat16": ("mma", 32, 256, 82064)},
    (64, 1718): {"float32": ("any", 32, 256, 228096), "bfloat16": ("any", 32, 256, 228096)},
}


@pytest.mark.parametrize("d,sk", sorted(PLANS))
def test_attention_plan(d, sk):
    """The launch the wrapper asks rt_fused_attention for: path, query rows
    and threads per block and shared bytes (the CUDA source's formula),
    within a block's limit; every shape here is one attention_kernel_fits
    takes."""
    assert tattn.attention_kernel_fits(d, sk)
    for dname, (path, rows, threads, nbytes) in PLANS[(d, sk)].items():
        dtype = getattr(torch, dname)
        plan = tattn.attention_plan(dtype, d, 128, sk)
        assert plan == {"path": path, "rows": rows, "threads": threads, "smem_bytes": nbytes}
        assert nbytes <= tattn._SMEM_MAX
        assert path == "any" or d in (16, 32, 64)
        assert tattn.attention_plan(dtype, d, 1, sk) == plan         # the query count does not matter


def test_dispatch_runs_the_plain_version_where_the_kernel_does_not_fit(monkeypatch):
    """use_pallas at head dim 48, which the tiled CUDA kernel is not built for:
    the dispatch still calls the wrapper (the any-width kernel takes it on the
    card; on the CPU the wrapper runs the plain version); a gradient is still
    refused."""
    calls = []
    real = tattn.fused_attention
    monkeypatch.setattr(tattn, "fused_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(2, 2, 5, 9, 48, seed=6, pad_rate=0.3))
    out, w = tattn.attention(q, k, v, None, use_pallas=True, causal=True, key_bias=bias)
    assert calls == [1] and w is None
    torch.testing.assert_close(out, tattn.fused_attention_plain(q, k, v, bias, causal=True), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="no VJP"):
        tattn.attention(q.clone().requires_grad_(True), k, v, None, use_pallas=True, key_bias=bias)
