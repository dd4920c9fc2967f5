"""Full-sequence fused attention: hand-written CUDA on the GPU, plain PyTorch on
the CPU, and the dispatch between it and the plain attention core
(retr_tpu/ops/attention.py).

:func:`fused_attention` replaces the Pallas kernel ``fused_attention``
(``_attn_kernel``): q ``[B, H, Sq, D]`` against k/v ``[B, H, Sk, D]``, an additive
``[B, Sk]`` f32 key bias and an optional causal mask. The kernel is
csrc/attention_kernels.cu, built with the decoder kernels
(``decoder_kernels.build()``); its launches are counted in
``decoder_kernels.LAUNCHES["fused_attention"]``.

A CPU tensor goes to :func:`fused_attention_plain`, which repeats the TPU
kernel's arithmetic; a CUDA tensor launches the kernel or raises. The wrapper
makes the ``split_heads`` views contiguous before the launch (the kernel takes
no strides). The TPU's padding of Sq and Sk to multiples of 128 was a tiling
rule and is not copied: an all-masked row averages V over the real Sk keys.

There is no backward: retr_tpu defines no VJP for its Pallas kernel (its train
step sends dropout-active attention to the XLA path, and ``jax.grad`` through
the kernel fails). Where autograd would need the gradient, the wrapper raises
``NotImplementedError`` on both devices.
"""

from __future__ import annotations

from typing import Optional

import torch

from retr_tpu_torch.ops import decoder_kernels as dk

NEG_INF = -1e30  # finite sentinel: an all-masked row stays finite
_SMEM_MAX = 232448  # a block's shared-memory limit on Hopper
_MMA_DIMS = (16, 32, 64)  # head dims of the tensor-core kernel
_QT, _KT, _NSTG = 32, 64, 3  # its query rows per block, keys per ring stage, ring stages


def fused_attention_plain(q, k, v, key_bias: Optional[torch.Tensor] = None, *,
                          causal: bool = False) -> torch.Tensor:
    """_attn_kernel's arithmetic: q upcast to f32 and scaled by D**-0.5, f32
    scores, + the bias clamped at -1e30, the causal mask (-1e30) after it, the
    exact softmax (max, exp, sum, e / sum), probabilities rounded to v's type
    before a PV product accumulated in f32, output in q's type."""
    d = q.shape[-1]
    scale = float(d) ** -0.5
    scores = torch.matmul(q.float() * scale, k.float().transpose(-2, -1))
    if key_bias is not None:
        scores = scores + torch.clamp_min(key_bias.float(), NEG_INF)[:, None, None, :]
    if causal:
        sq, sk = scores.shape[-2:]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_kernel_fits(d: int, sk: int) -> bool:
    """Whether rt_fused_attention takes head dim ``d`` and ``sk`` keys: any
    whose one-query row (q and the ``sk`` scores, f32) fits a block's shared
    memory. The tensor-core kernel takes head dims 16, 32 and 64 up to the key
    count whose 32-row score block fits beside its ring (1536 at D = 32 in f32);
    the untiled kernel the rest (:func:`attention_plan`)."""
    return d >= 1 and sk >= 1 and (d + sk) * 4 <= _SMEM_MAX


def _mma_smem(d: int, sk: int, bf16: bool) -> int:
    """mma_kernel's shared bytes (``mma_smem`` in csrc/attention_kernels.cu): the
    f32 score block with its padded row stride and the K/V ring (or, if
    larger, the warps' partial outputs), the row maxima (of each strip
    warp's key share and the whole), a flag."""
    ld = -(-sk // 32) * 32 + 4
    passes = _QT * ld * 4 + _NSTG * _KT * (d + 8) * (2 if bf16 else 4)
    parts = _strip_warps(d) * _QT * d * 4      # the warps' partial outputs, over the same bytes
    return max(passes, parts) + _QT * 4 * (_strip_warps(d) + 1) + 16


def _strip_warps(d: int) -> int:
    """mma_kernel's warps per 16-row strip of query rows (``strip_warps``)."""
    return 4 if d >= 32 else 2


def attention_plan(dtype: torch.dtype, d: int, sq: int, sk: int) -> dict:
    """The launch rt_fused_attention makes for q [.., sq, d] against sk keys:
    ``path`` "mma" (the tensor-core kernel, head dims 16, 32 and 64) or "any"
    (the untiled kernel), ``rows`` (query rows per block), ``threads`` (per
    block) and ``smem_bytes`` (shared bytes per block). The tensor-core
    kernel takes 32-row tiles of 8 warps (4 at D = 16) wherever their score
    block fits; the untiled kernel 256 threads and the largest power of two
    up to 32 rows whose score rows fit. ``sq`` does not change the plan."""
    bf16 = dtype == torch.bfloat16
    if d in _MMA_DIMS:
        n = _mma_smem(d, sk, bf16)
        if n <= _SMEM_MAX:
            return {"path": "mma", "rows": _QT, "threads": 2 * _strip_warps(d) * 32, "smem_bytes": n}
    qt = 32
    while qt > 1 and qt * (d + sk) * 4 > _SMEM_MAX:
        qt //= 2
    return {"path": "any", "rows": qt, "threads": 256, "smem_bytes": qt * (d + sk) * 4}


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_attention(q, k, v, key_bias: Optional[torch.Tensor] = None, *,
                    causal: bool = False) -> torch.Tensor:
    """Fused scaled-dot-product attention; returns ``[B, H, Sq, D]`` in q's type.

    Bound on the card: at the model's shapes (S <= 397, D = 32) bytes in bf16,
    the operations of the 3xTF32 products in f32. Design
    (csrc/attention_kernels.cu): one block of 8 warps (4 at D = 16) per (b, h,
    32 query rows; :func:`attention_plan`) keeps its whole f32 score block in
    shared memory, streams K then V through a cp.async ring in 64-key tiles in
    their own type, multiplies on tensor cores (bf16 mma.sync; f32 as 3xTF32),
    skips the key tiles a causal tile cannot see, and normalises exactly once
    between the two passes. Other head dims, and key counts whose 32-row score
    block does not fit, run the same passes untiled on CUDA cores with fewer
    query rows per block (down to 1).
    """
    if _needs_grad(q, k, v, key_bias):
        raise NotImplementedError(
            "fused_attention has no backward: retr_tpu defines no VJP for its Pallas kernel "
            "(retr_tpu/ops/attention.py), so neither package differentiates it. Train with "
            "attention dropout on (the plain path), or with use_pallas_attention off.")
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, key_bias, causal=causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"fused_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if not attention_kernel_fits(d, sk):
        raise ValueError(f"fused_attention: head dim {d} and {sk} keys need {(d + sk) * 4} bytes of shared "
                         f"memory for one query row (at most {_SMEM_MAX})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    t = dict(q=q, k=k, v=v)
    shapes = {}
    if key_bias is not None:
        key_bias = key_bias.contiguous()
        t["key_bias"] = key_bias
        shapes["key_bias"] = (b, sk)
    dk._check("fused_attention", q.dtype, shapes, **t)
    out = torch.empty_like(q)
    plan = attention_plan(q.dtype, d, sq, sk)
    dk._run("attention_kernels", "rt_fused_attention", q, B=b, H=h, Sq=sq, Sk=sk, D=d,
            causal=int(causal), tile=plan["rows"], mma=int(plan["path"] == "mma"), scale=float(d) ** -0.5,
            key_bias=0 if key_bias is None else key_bias,
            q=q, k=k, v=v, out=out)
    dk._count("fused_attention")
    return out


def attention(q, k, v, bias: Optional[torch.Tensor], *, need_weights: bool = False,
              use_pallas: bool = False, causal: bool = False,
              key_bias: Optional[torch.Tensor] = None):
    """Dispatch: the fused kernel when asked for and no attention map is wanted,
    the plain attention core otherwise; returns (out, head-averaged weights or None).

    ``bias`` is the general additive [B or 1, 1, Sq or 1, Sk] form of the plain
    path; the fused path takes the decomposed (``key_bias`` [B, Sk], ``causal``)
    form instead. Unlike retr_tpu there is no CPU-backend test: on the CPU the
    wrapper runs the kernel's plain version."""
    from retr_tpu_torch.models.layers import attention_core

    if use_pallas and not need_weights:
        return fused_attention(q, k, v, key_bias, causal=causal), None
    return attention_core(q, k, v, bias, need_weights=need_weights)
