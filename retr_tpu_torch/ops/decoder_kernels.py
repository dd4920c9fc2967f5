"""Decode-step kernels: hand-written CUDA on the GPU, plain PyTorch on the CPU.

Eight functions, one per Pallas kernel of retr_tpu/ops/decoder_kernels.py that
the greedy and beam serving paths run:

- :func:`fused_stack_step` <- ``fused_stack_step`` (all decoder layers, one launch)
- :func:`self_attn_block`  <- ``self_attn_block``
- :func:`cross_attn_block` <- ``cross_attn_block``
- :func:`ff_block`         <- ``ff_block``
- :func:`self_attn_block_beam` <- ``self_attn_block_beam`` (ancestry-addressed caches)
- :func:`mlp_head_argmax`  <- ``mlp_head_argmax`` (flag ``HEAD_KERNEL``)
- :func:`mlp_head_topk`    <- ``mlp_head_topk`` (flag ``BEAM_TOPK_KERNEL``)
- :func:`fused_layer_step` <- ``fused_layer_step`` (flag ``MERGED_LAYER``; the
  stacked kernel with one layer)

The stacked step (``fused_stack_step``, ``fused_layer_step``) is
csrc/stack_kernels.cu, the cross-attention, FF and self-attention blocks
(greedy and beam) csrc/block_kernels.cu, the head kernels
csrc/head_kernels.cu. Those decoder-layer kernels are tuned for the served
width (:func:`decode_kernels_fit`: C = 256, 8 heads, F a multiple of 256, beam
groups of 1..8); at any other width the same wrappers launch
csrc/width_kernels.cu, which takes the widths, head count, FF width and
lengths at run time, as the Pallas kernels take any width. The library
registry here (``_LIBS``, ``build()``) also holds csrc/attention_kernels.cu,
the full-sequence attention kernel of ops/attention.py, whose launches
``LAUNCHES["fused_attention"]`` counts.

Each takes the JAX package's parameter dicts (linear weights ``[in, out]``) and
its XLA-path layouts: self caches ``[B, H, T, D]`` (stacked ``[L, B, H, T, D]``),
cross K/V ``[B, H, S, D]``, key bias ``[B, S]``. The TPU kernels' ``[H, B, D, T]``
lane layout, batch blocking and ``b <= 32`` limit were VMEM rules and are not
copied: the CUDA kernels take any batch.

Dispatch: a CPU tensor goes to the plain version (``*_plain``), which repeats
the TPU kernel's arithmetic with torch ops; a CUDA tensor launches a kernel or
raises. ``LAUNCHES`` counts kernel launches per wrapper (plain calls never
count); a launch captured into a CUDA graph counts each time the graph is
replayed (ops/graphs.py).

Numerics shared by both versions (the TPU kernels'): products cast the
activation to the weight's type and accumulate in f32; LayerNorm (eps 1e-5) and
softmax run in f32; q is ``(x @ Wq + bq) * D**-0.5``; the key bias is clamped at
-1e30 and positions after ``step`` are masked; the current position attends
with the unrounded f32 k/v while the cache stores them rounded. The split blocks
return ``x.dtype`` and round after each head's out-projection part; the stacked
step carries the residual in f32 across all layers.

The self-attention functions update the caches IN PLACE (only the slot at
``step`` is written) and return them, where the JAX functions return new arrays.

Tensor parallelism (``partial=True`` on the four split blocks): ``p`` holds one
rank's slice of the block as ``parallel/mesh.param_specs`` cuts it (q/k/v and
FF1 by column, the out-projection and FF2 by row), ``num_heads`` is the slice's
head count and the caches and cross K/V hold those heads only; ``x`` and the
LayerNorm are whole. The block then returns the f32 sum of its heads'
out-projection parts (FF: of FF2) ``[B, C]``, without the bias and without the
residual, and the self blocks write their heads' cache slot at ``step``. The
caller all-reduces that sum over the mp group and finishes the block with
:func:`attn_block_epilogue` or :func:`ff_block_epilogue`, which repeat the
unsharded block's rounding on the sum, so in f32 the sharded block equals the
unsharded one up to the order of the head sum.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np
import torch

Params = Dict

# Decode dispatch (models/transformer.decode_step): True runs all decoder layers
# in one fused_stack_step launch per position, False runs the per-layer trio.
LAYER_GRID = True
# With LAYER_GRID off: one fused_layer_step launch per layer instead of the trio.
MERGED_LAYER = False
# Greedy tail (decode.greedy_from_memory): mlp_head_argmax instead of the MLP
# head's products and an argmax.
HEAD_KERNEL = False
# Beam tail (decode.beam_search_from_memory): mlp_head_topk instead of the MLP
# head, a top-k and a log-softmax over the whole vocabulary.
BEAM_TOPK_KERNEL = False
# The three flags default to False, as in the JAX package.

# Kernel launches per wrapper since the last reset_launches(); a split block's
# launches with partial=True count under "<wrapper>_partial".
LAUNCHES = {"fused_stack_step": 0, "self_attn_block": 0, "cross_attn_block": 0, "ff_block": 0,
            "self_attn_block_beam": 0, "mlp_head_argmax": 0, "mlp_head_topk": 0,
            "fused_layer_step": 0, "fused_attention": 0,   # the last: ops/attention.py
            "self_attn_block_partial": 0, "cross_attn_block_partial": 0, "ff_block_partial": 0,
            "self_attn_block_beam_partial": 0}

WIDTH, HEADS = 256, 8  # the widths the tuned decoder-layer kernels are written for
MAX_BEAMS = 8          # the largest beam group the tuned self_attn_block_beam takes
WIDTH_MAX_BEAMS = 16   # the largest beam group csrc/width_kernels.cu takes
HEAD_KMAX = 256        # the most top-k entries per row the head kernels return
HEAD_ALIGN = 8         # the head kernels read W3 rows padded to a multiple of 8 columns (pack_head)
HEAD_HIDDEN_ALIGN = 32  # ... and a hidden width padded to a multiple of 32 (pack_head)


# While ops/graphs.py captures a CUDA graph on a thread, that thread's wrappers
# count into ``_capture.tally`` instead: a captured kernel runs only when the
# graph is replayed, and each replay adds the tally to LAUNCHES.
_capture = threading.local()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add the launches of a replayed graph (its capture's tally) to LAUNCHES."""
    for k, n in counts.items():
        LAUNCHES[k] += n


def decode_kernels_fit(c: int, num_heads: int, f: int = 256, num_beams: int = 1, inner=None) -> bool:
    """Whether the tuned decoder-layer kernels take a model of width ``c`` with
    ``num_heads`` heads over a q/k/v width ``inner`` (default ``c``; an mp
    slice's is narrower: its heads are whole, of the model's head width), FF
    width ``f`` and beam groups of ``num_beams``; the wrappers launch
    csrc/width_kernels.cu elsewhere."""
    inner = c if inner is None else inner
    return (c == WIDTH and inner == num_heads * (WIDTH // HEADS) and HEADS % num_heads == 0 and f >= 256
            and f % 256 == 0 and 1 <= num_beams <= MAX_BEAMS)


def head_kernels_fit(p: Params, k: int = 1) -> bool:
    """Whether the head kernels take the MLP head ``p``, once packed
    (:func:`pack_head`), with ``k`` tokens per row: f32 or bf16 storage and
    1 <= k <= min(vocab, HEAD_KMAX); any widths."""
    v = p["layers"][2]["w"].shape[1]
    return 1 <= k <= min(v, HEAD_KMAX) and p["layers"][2]["w"].dtype in (torch.float32, torch.bfloat16)


def _pad_cols(t: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, n), value=value) if n else t


def pack_head(p: Params) -> Params:
    """The MLP head as the head kernels read it: the hidden width padded to a
    multiple of HEAD_HIDDEN_ALIGN (zero columns of W1, b1, W2 and b2, zero
    rows of W2 and W3: the padded hidden units are ReLU(0) = 0 and add
    nothing), and W3 and b3 padded to a multiple of HEAD_ALIGN vocab columns
    (zero weights, a -inf bias), so that each W3 row starts on a 16-byte
    boundary. The padding is never chosen and adds nothing to a sum of
    exponentials, so every function of the head (the plain versions too) gives
    the same tokens and scores on the packed head. A copy of W3 (31 MB in bf16
    at 512 x 30522): made once per decode call, where the decode loop prepares
    its parameters. Returns ``p`` itself where nothing needs padding."""
    l1, l2, l3 = p["layers"]
    hp = -l1["w"].shape[1] % HEAD_HIDDEN_ALIGN
    vp = -l3["w"].shape[1] % HEAD_ALIGN
    if hp == 0 and vp == 0:
        return p
    w2 = _pad_cols(l2["w"], hp)
    return {**p, "layers": [
        {**l1, "w": _pad_cols(l1["w"], hp), "b": _pad_cols(l1["b"], hp)},
        {**l2, "w": torch.nn.functional.pad(w2, (0, 0, 0, hp)), "b": _pad_cols(l2["b"], hp)},
        {**l3, "w": torch.nn.functional.pad(_pad_cols(l3["w"], vp), (0, 0, 0, hp)),
         "b": _pad_cols(l3["b"], vp, float("-inf"))}]}


# ---------------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are held against)
# ---------------------------------------------------------------------------------


def _ln(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _dot(a, w):
    """a cast to w's type, product accumulated in f32 (retr_tpu ``_dot``)."""
    return a.to(w.dtype).float() @ w.float()


def _scale(d: int) -> float:
    return float(np.float32(d) ** np.float32(-0.5))


def _add_heads(x, out_p, attn, partial=False):
    """x + bo + sum_h attn_h @ Wo[h], accumulated head by head in x's type;
    ``partial``: sum_h attn_h @ Wo[h] alone, head by head in f32."""
    h, d = attn.shape[1], attn.shape[2]
    w = out_p["w"]
    out = None
    for hi in range(h):
        part = _dot(attn[:, hi], w[hi * d:(hi + 1) * d])
        if partial:
            out = part if hi == 0 else out + part
        else:
            out = (x + out_p["b"] + part).to(x.dtype) if hi == 0 else out + part.to(x.dtype)
    return out


def attn_block_epilogue(p: Params, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """An attention block from the all-reduced f32 sum ``s`` of its heads'
    out-projection parts: rnd(rnd(x + bo) + s), rnd the rounding to x's type
    (the unsharded block's first head step, :func:`_add_heads`)."""
    return (x + p["mha"]["out"]["b"] + s).to(x.dtype)


def ff_block_epilogue(p: Params, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The FF block from the all-reduced f32 FF2 sum ``s``: x + rnd(s + b2)."""
    return x + (s + p["lin2"]["b"].float()).to(x.dtype)


def ff_block_plain(p: Params, x: torch.Tensor, *, partial: bool = False) -> torch.Tensor:
    nx = _ln(x, p["norm"]["scale"], p["norm"]["bias"])
    hmid = torch.relu(_dot(nx, p["lin1"]["w"]) + p["lin1"]["b"].float())
    if partial:
        return _dot(hmid, p["lin2"]["w"])
    return x + (_dot(hmid, p["lin2"]["w"]) + p["lin2"]["b"].float()).to(x.dtype)


def _head_dim(m: Params, num_heads: int) -> int:
    """The head width: q's output width (the model's, or an mp slice's) over the heads."""
    return m["q"]["w"].shape[1] // num_heads


def cross_attn_block_plain(p: Params, x, qpos, k, v, key_bias, *, num_heads: int, partial: bool = False):
    b, c = x.shape
    h = num_heads
    m = p["mha"]
    d = _head_dim(m, h)
    nx = _ln(x, p["norm"]["scale"], p["norm"]["bias"])
    q = (_dot(nx + qpos.float(), m["q"]["w"]) + m["q"]["b"].float()) * _scale(d)
    scores = torch.einsum("bhd,bhsd->bhs", q.view(b, h, d), k.float())
    scores = scores + key_bias.clamp_min(-1e30)[:, None, :]
    attn = torch.einsum("bhs,bhsd->bhd", torch.softmax(scores, dim=-1), v.float())
    return _add_heads(x, m["out"], attn, partial)


def self_attn_block_plain(p: Params, x, qpos, k_cache, v_cache, step, *, num_heads: int, partial: bool = False):
    b, c = x.shape
    h = num_heads
    t = k_cache.shape[2]
    m = p["mha"]
    d = _head_dim(m, h)
    nx = _ln(x, p["norm"]["scale"], p["norm"]["bias"])
    qk_in = nx + qpos.float()
    q = (_dot(qk_in, m["q"]["w"]) + m["q"]["b"].float()) * _scale(d)
    k_new = (_dot(qk_in, m["k"]["w"]) + m["k"]["b"].float()).view(b, h, 1, d)
    v_new = (_dot(nx, m["v"]["w"]) + m["v"]["b"].float()).view(b, h, 1, d)
    at = step.reshape(1).long()
    k_cache.index_copy_(2, at, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, at, v_new.to(v_cache.dtype))

    pos = torch.arange(t, device=x.device)
    cur = (pos == step)[None, None, :, None]
    kc = torch.where(cur, k_new, k_cache.float())
    vc = torch.where(cur, v_new, v_cache.float())
    scores = torch.einsum("bhd,bhtd->bht", q.view(b, h, d), kc)
    scores = torch.where(pos <= step, scores, -1e30)
    attn = torch.einsum("bht,bhtd->bhd", torch.softmax(scores, dim=-1), vc)
    return _add_heads(x, m["out"], attn, partial), k_cache, v_cache


def self_attn_block_beam_plain(p: Params, x, anc, qpos, k_cache, v_cache, step, *, num_heads: int,
                              num_beams: int, partial: bool = False):
    """As self_attn_block_plain, but row i reads position t from row
    ``anc[i, t]`` of its beam group (rows ``(i // K) * K ..``); the slot at
    ``step`` of any row holds that row's unrounded f32 k/v, as the TPU kernel
    updated the whole group's cache before reading it."""
    bk, c = x.shape
    h = num_heads
    t = k_cache.shape[2]
    m = p["mha"]
    d = _head_dim(m, h)
    nx = _ln(x, p["norm"]["scale"], p["norm"]["bias"])
    qk_in = nx + qpos.float()
    q = (_dot(qk_in, m["q"]["w"]) + m["q"]["b"].float()) * _scale(d)
    k_new = (_dot(qk_in, m["k"]["w"]) + m["k"]["b"].float()).view(bk, h, 1, d)
    v_new = (_dot(nx, m["v"]["w"]) + m["v"]["b"].float()).view(bk, h, 1, d)
    at = step.reshape(1).long()
    k_cache.index_copy_(2, at, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, at, v_new.to(v_cache.dtype))

    pos = torch.arange(t, device=x.device)
    cur = (pos == step)[None, None, :, None]
    kc = torch.where(cur, k_new, k_cache.float())
    vc = torch.where(cur, v_new, v_cache.float())
    # source row of each (row, position); positions after `step` are masked below
    own = torch.arange(bk, device=x.device)[:, None]
    src = torch.where(pos <= step, own // num_beams * num_beams + anc.long(), own)
    src = src[:, None, :, None].expand(bk, h, t, d)
    scores = torch.einsum("bhd,bhtd->bht", q.view(bk, h, d), kc.gather(0, src))
    scores = torch.where(pos <= step, scores, -1e30)
    attn = torch.einsum("bht,bhtd->bhd", torch.softmax(scores, dim=-1), vc.gather(0, src))
    return _add_heads(x, m["out"], attn, partial), k_cache, v_cache


def topk_first(values: torch.Tensor, k: int):
    """Top ``k`` along the last dim, largest first, ties to the lowest index:
    ``jax.lax.top_k``'s order, which also puts 0.0 above -0.0 (``torch.topk``
    promises no order on ties). Ranks an int64 key (the f32 value's bits made
    order-preserving, then the reversed index), whose entries are all distinct.
    Returns (values, int64 indices)."""
    v = values.float()
    bits = v.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    n = v.shape[-1]
    key = key * (1 << 32) + (n - 1 - torch.arange(n, device=v.device))
    idx = key.topk(k, dim=-1).indices
    return values.gather(-1, idx), idx


def topk_log_softmax(logits: torch.Tensor, k: int):
    """f32 logits [N, V] -> (log-softmax of the top ``k`` [N, k], their ids
    int32), with the exact log_softmax association ``(v - max) - log(sum(exp(x - max)))``."""
    vals, idx = topk_first(logits, k)
    m = logits.max(dim=-1, keepdim=True).values
    log_z = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    return (vals - m) - log_z, idx.to(torch.int32)


def _head_trunk(p: Params, x):
    """mlp_head_argmax's trunk: ReLU(ReLU(x W1 + b1) W2 + b2), f32."""
    l1, l2 = p["layers"][0], p["layers"][1]
    h1 = torch.relu(_dot(x, l1["w"]) + l1["b"].float())
    return torch.relu(_dot(h1, l2["w"]) + l2["b"].float())


def mlp_head_argmax_plain(p: Params, x) -> torch.Tensor:
    l3 = p["layers"][2]
    logits = _dot(_head_trunk(p, x), l3["w"]) + l3["b"].float()
    return logits.argmax(dim=-1).to(torch.int32)  # first index on ties


def _torch_trunk(p: Params, x):
    """mlp_head_topk's trunk, the MLP head's first two layers in x's type."""
    for lp in p["layers"][:2]:
        x = torch.relu(x @ lp["w"] + lp["b"])
    return x


def mlp_head_topk_plain(p: Params, x, k: int):
    l3 = p["layers"][2]
    return topk_log_softmax(_dot(_torch_trunk(p, x), l3["w"]) + l3["b"].float(), k)


def _lead(tree):
    """A leading axis of 1 on every leaf (views)."""
    if isinstance(tree, dict):
        return {key: _lead(v) for key, v in tree.items()}
    return tree[None]


def fused_layer_step_plain(lp: Params, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias, step,
                           *, num_heads: int):
    y, _, _ = fused_stack_step_plain(_lead(lp), x, qpos, k_cache[None], v_cache[None], cross_k[None],
                                     cross_v[None], key_bias, step, num_heads=num_heads)
    return y, k_cache, v_cache


def layer_params(slp: Params, li: int) -> Params:
    """Layer ``li`` of a leaf-stacked parameter dict (views, no copies)."""
    if isinstance(slp, dict):
        return {k: layer_params(v, li) for k, v in slp.items()}
    return slp[li]


def stack_layer_params(layer_params_list) -> Params:
    """Stack per-layer parameter dicts leaf-wise on a new leading axis."""
    first = layer_params_list[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([lp[k] for lp in layer_params_list]) for k in first}
    return torch.stack(list(layer_params_list)).contiguous()


def fused_stack_step_plain(slp: Params, x, qpos, k_cache, v_cache, cross_k, cross_v,
                           key_bias, step, *, num_heads: int):
    xs = x.float()  # the residual stays f32 across all layers
    for li in range(k_cache.shape[0]):
        lp = layer_params(slp, li)
        xs, _, _ = self_attn_block_plain(lp["self_attn"], xs, qpos, k_cache[li], v_cache[li],
                                         step, num_heads=num_heads)
        xs = cross_attn_block_plain(lp["cross_attn"], xs, qpos, cross_k[li], cross_v[li],
                                    key_bias, num_heads=num_heads)
        xs = ff_block_plain(lp["ff"], xs)
    return xs.to(x.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------------
# CUDA launch plumbing (csrc/*.cu through ctypes)
# ---------------------------------------------------------------------------------

_SELF_PTRS = ("x", "y", "qpos", "ln1s", "ln1b", "swq", "sbq", "swk", "sbk", "swv", "sbv", "swo", "sbo")


class _StackArgs(ctypes.Structure):
    """Mirror of ``struct StackArgs`` in csrc/stack_kernels.cu (same field
    order): every layer parameter, the caches, then the kernel's f32 scratch."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "T", "S", "F", "L", "max_blocks")] + [
        (n, ctypes.c_void_p) for n in _SELF_PTRS + (
            "ln2s", "ln2b", "cwq", "cbq", "cwo", "cbo", "ln3s", "ln3b", "w1", "b1", "w2", "b2",
            "kc", "vc", "ck", "cv", "key_bias", "step", "xres", "qkv", "att", "hid", "part", "trace")
    ]


class _BlockArgs(ctypes.Structure):
    """Mirror of ``struct BlockArgs`` in csrc/block_kernels.cu (same field order)."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "S", "F", "rows", "T", "K", "H", "partial")] + [
        (n, ctypes.c_void_p) for n in ("x", "y", "qpos", "lns", "lnb", "wq", "bq", "wo", "bo",
                                       "w1", "b1", "w2", "b2", "ck", "cv", "key_bias",
                                       "wk", "bk", "wv", "bv", "kc", "vc", "step", "anc")
    ]


class _HeadArgs(ctypes.Structure):
    """Mirror of ``struct HeadArgs`` in csrc/head_kernels.cu (same field order)."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "C", "Hd", "V", "k")] + [
        (n, ctypes.c_void_p) for n in ("x", "w1", "b1", "w2", "b2", "h1", "h2", "w3", "b3",
                                       "vals", "idx", "mx", "se")
    ]


class _AttnArgs(ctypes.Structure):
    """Mirror of ``struct AttnArgs`` in csrc/attention_kernels.cu (same field
    order); the wrapper is ops/attention.fused_attention."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "H", "Sq", "Sk", "D", "causal", "tile", "mma")] + [
        ("scale", ctypes.c_float)] + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "key_bias", "out")]


_WIDTH_PTRS = _SELF_PTRS + ("ln2s", "ln2b", "cwq", "cbq", "cwo", "cbo", "ln3s", "ln3b", "w1", "b1", "w2", "b2",
                            "kc", "vc", "ck", "cv", "key_bias", "step", "anc", "res")


class _WidthArgs(ctypes.Structure):
    """Mirror of ``struct WidthArgs`` in csrc/width_kernels.cu (same field order)."""

    _fields_ = [(n, ctypes.c_int) for n in ("B", "C", "H", "F", "T", "S", "K", "L", "xf32", "yf32", "exact",
                                            "I", "partial")] + [
        (n, ctypes.c_void_p) for n in _WIDTH_PTRS
    ]


# source -> (argument struct, entry points, error-string function)
_LIBS = {
    "block_kernels": (_BlockArgs, ("rt_ff_block", "rt_cross_attn_block", "rt_self_attn_block",
                                   "rt_self_attn_block_beam"), "rt_block_error_string"),
    "stack_kernels": (_StackArgs, ("rt_stack_step",), "rt_stack_error_string"),
    "head_kernels": (_HeadArgs, ("rt_head_trunk", "rt_head_blocks"), "rt_head_error_string"),
    "attention_kernels": (_AttnArgs, ("rt_fused_attention",), "rt_attn_error_string"),
    "width_kernels": (_WidthArgs, ("rt_width_self", "rt_width_cross", "rt_width_ff", "rt_width_stack"),
                      "rt_width_error_string"),
}
# wrapper -> (source, entry point)
_ENTRY = {"fused_stack_step": ("stack_kernels", "rt_stack_step"),
          "fused_layer_step": ("stack_kernels", "rt_stack_step"),
          "self_attn_block": ("block_kernels", "rt_self_attn_block"),
          "cross_attn_block": ("block_kernels", "rt_cross_attn_block"),
          "ff_block": ("block_kernels", "rt_ff_block"),
          "self_attn_block_beam": ("block_kernels", "rt_self_attn_block_beam")}
_handles: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _handles:
        from retr_tpu_torch.ops import cuda_build

        struct, entries, err = _LIBS[name]
        lib = cuda_build.load(name)
        for fn in entries:
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(struct), ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
        getattr(lib, err).argtypes = [ctypes.c_int]
        getattr(lib, err).restype = ctypes.c_char_p
        _handles[name] = lib
    return _handles[name]


def build() -> None:
    """Compile (one nvcc per source, all at once, where not built yet) and load
    the kernels now instead of at first launch."""
    from retr_tpu_torch.ops import cuda_build

    cuda_build.build_all(list(_LIBS))
    for name in _LIBS:
        _lib(name)


def _param_shapes(f: int = WIDTH, nl=None, c: int = WIDTH, inner=None) -> Dict[str, tuple]:
    """Shapes of the Args parameter fields (a leading layer axis when ``nl``);
    ``inner``: the q/k/v width (default ``c``; an mp slice's is narrower)."""
    lead = () if nl is None else (nl,)
    i = c if inner is None else inner
    shapes = {"qpos": (c,), "w1": lead + (c, f), "b1": lead + (f,), "w2": lead + (f, c)}
    for n in ("ln1s", "ln1b", "sbo", "ln2s", "ln2b", "cbo", "ln3s", "ln3b", "b2", "lns", "lnb", "bo"):
        shapes[n] = lead + (c,)
    for n in ("sbq", "sbk", "sbv", "cbq", "bq", "bk", "bv"):
        shapes[n] = lead + (i,)
    for n in ("swq", "swk", "swv", "cwq", "wq", "wk", "wv"):
        shapes[n] = lead + (c, i)
    for n in ("swo", "cwo", "wo"):
        shapes[n] = lead + (i, c)
    return shapes


def _check(kernel: str, dtype: torch.dtype, shapes: Dict[str, tuple], align: int = 16, **tensors) -> None:
    """Device, type, contiguity, alignment (16 bytes: the tuned kernels load 16
    bytes at a time) and, for parameters, shape of every tensor handed to a kernel."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: storage type {dtype} (float32 or bfloat16 only)")
    for name, t in tensors.items():
        if t is None:                     # a field the launch does not read (a partial block's bias)
            continue
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel needs CUDA tensors")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{kernel}: {name} must be contiguous and {align}-byte aligned")
        want = (torch.float32 if name in ("key_bias", "vals", "mx", "se")
                else torch.int32 if name in ("step", "anc", "idx") else dtype)
        if t.dtype != want:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, expected {want}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shapes[name]}")


def _check_width(kernel: str, c: int, num_heads: int, f: int = 256) -> None:
    if num_heads < 1 or c < num_heads or c % num_heads or f < 1:
        raise ValueError(f"{kernel}: width {c} is not a whole number of {num_heads} heads, "
                         f"or the FF width {f} is empty")


def _attn_inner(kernel: str, m: Params, c: int, num_heads: int, partial: bool) -> int:
    """The q/k/v width of attention parameters ``m``, checked: ``c`` for a
    whole block; with ``partial`` an mp slice's, at most ``c``."""
    inner = m["q"]["w"].shape[1]
    _check_width(kernel, inner, num_heads)
    if inner != c and not (partial and inner < c):
        raise ValueError(f"{kernel}: q/k/v width {inner} against the model's {c}: an mp slice of the block "
                         f"runs with partial=True")
    return inner


def _count(kernel: str, partial=False) -> None:
    name = kernel + "_partial" if partial else kernel
    counts = getattr(_capture, "tally", None)
    if counts is None:
        counts = LAUNCHES
    counts[name] = counts.get(name, 0) + 1


def _width_launch(kernel: str, entry: str, ref: torch.Tensor, /, **fields) -> None:
    """Check (element alignment: the width kernels load single elements) and
    launch an entry of csrc/width_kernels.cu for wrapper ``kernel``; count it."""
    tensors = {k: v for k, v in fields.items() if isinstance(v, torch.Tensor) and k not in ("y", "res")}
    shapes = _param_shapes(fields.get("F", 1), fields.get("L") if entry == "rt_width_stack" else None, fields["C"],
                           fields.get("I"))
    _check(kernel, ref.dtype, shapes, align=ref.element_size(), **tensors)
    _run("width_kernels", entry, ref, **fields)
    _count(kernel, fields.get("partial"))


def _run(lib_name: str, entry: str, ref: torch.Tensor, /, **fields) -> None:
    """Launch ``entry`` of ``lib_name`` on the current stream of ``ref``'s device
    (bf16 when ``ref`` is); ``fields`` are the argument struct's members (ints,
    or tensors passed by data pointer)."""
    struct, _, err = _LIBS[lib_name]
    args = struct(**{k: (v.data_ptr() if isinstance(v, torch.Tensor) else v) for k, v in fields.items()})
    lib = _lib(lib_name)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = getattr(lib, entry)(ctypes.byref(args), int(ref.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: {getattr(lib, err)(rc).decode()}")


def _launch(kernel: str, ref: torch.Tensor, /, **fields) -> None:
    """Launch the decoder-layer kernel behind wrapper ``kernel`` and count it."""
    _run(*_ENTRY[kernel], ref, **fields)
    _count(kernel, fields.get("partial"))


# ---------------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------------


# 0, or the row tile both block kernels (ff_block, cross_attn_block) use instead
# of their own choice for the batch; the card tests set it to show that a row's
# result does not depend on the tile, chip_smoke.py to time each tile.
_block_rows = 0
# The same for the self-attention cluster kernel (self_attn_block_beam, and
# self_attn_block with groups of one row): 0, or its rows per tile (a whole
# number of beam groups, at most 32 rows).
_beam_rows = 0


def ff_block(p: Params, x: torch.Tensor, *, partial: bool = False) -> torch.Tensor:
    """x: [B, C] -> x + Linear(F, C)(ReLU(Linear(C, F)(LN(x)))), in x's type;
    ``partial`` (``p`` an mp slice: FF1's columns and FF2's rows of F/mp
    hidden units): the f32 FF2 product alone, for :func:`ff_block_epilogue`.

    Replaces retr_tpu/ops/decoder_kernels.py ``ff_block`` (``_ff_kernel``). Bound
    on the card: bytes below ~300 rows (the two [256, F] weights, 2.1 MB in bf16
    at F = 2048), operations above. Design (csrc/block_kernels.cu): one launch of
    thread-block clusters, one cluster per tile of 16-64 rows (the smallest
    tile whose clusters all fit on the card at once) with one block per
    256-wide slice of the hidden width (up to 8), so a small batch spreads the
    weights over 8x more SMs than one block per tile did; each block keeps its
    LN tile and hidden slice in shared memory, multiplies on tensor cores (bf16)
    and hands its f32 FF2 partial to its peers through distributed shared
    memory, which sum them in slice order. Nothing goes to device memory but y.
    With ``partial`` the same launch over the slice's F/mp hidden units
    writes the f32 sum and skips b2 and the residual. At other widths:
    rt_width_ff (csrc/width_kernels.cu).
    """
    if x.device.type == "cpu":
        return ff_block_plain(p, x, partial=partial)
    b, c = x.shape
    f = p["lin1"]["w"].shape[1]
    y = torch.empty((b, c), dtype=torch.float32 if partial else x.dtype, device=x.device)
    b2 = None if partial else p["lin2"]["b"]
    if not decode_kernels_fit(c, HEADS, f):
        _check_width("ff_block", c, 1, f)
        _width_launch("ff_block", "rt_width_ff", x, B=b, C=c, H=1, I=c, F=f, yf32=int(partial),
                      partial=int(partial), x=x, y=y, ln3s=p["norm"]["scale"], ln3b=p["norm"]["bias"],
                      w1=p["lin1"]["w"], b1=p["lin1"]["b"], w2=p["lin2"]["w"], b2=b2)
        return y
    t = dict(lns=p["norm"]["scale"], lnb=p["norm"]["bias"], w1=p["lin1"]["w"],
             b1=p["lin1"]["b"], w2=p["lin2"]["w"], b2=b2)
    _check("ff_block", x.dtype, _param_shapes(f), x=x, **t)
    _launch("ff_block", x, B=b, F=f, H=HEADS, partial=int(partial), rows=_block_rows, x=x, y=y, **t)
    return y


def cross_attn_block(p: Params, x, qpos, k, v, key_bias, *, num_heads: int, partial: bool = False) -> torch.Tensor:
    """x: [B, C]; k, v: [B, H, S, D] memory keys/values; key_bias: [B, S] f32.
    ``partial`` (``p`` an mp slice of ``num_heads`` heads, k/v its heads):
    the f32 sum of its heads' out-projection parts, for :func:`attn_block_epilogue`.

    Replaces retr_tpu/ops/decoder_kernels.py ``cross_attn_block``
    (``_cross_kernel``), whose sequential grid walks the heads. Bound on the
    card: bytes — the memory K/V (2*B*H*S*D elements), read once for one query
    per head. Design (csrc/block_kernels.cu): one launch of thread-block
    clusters, one cluster of 8 blocks (one per head) per tile of 4-32 rows
    (chosen as for ff_block); a block computes its head's q on tensor cores
    (bf16), attends each row (a warp per row) with 16-byte K loads and V rows
    staged into shared memory during the score pass, and hands its f32
    out-projection part to its peers through distributed shared memory, which
    add the heads in order, rounding after each as the TPU kernel does. With
    ``partial`` the cluster has one block per head of the slice (4 at mp=2, 2
    at mp=4) and its reduction writes the f32 sum of their parts, in head
    order, with neither bo nor the residual. At other widths: rt_width_cross
    (csrc/width_kernels.cu).
    """
    if x.device.type == "cpu":
        return cross_attn_block_plain(p, x, qpos, k, v, key_bias, num_heads=num_heads, partial=partial)
    b, c = x.shape
    m = p["mha"]
    inner = _attn_inner("cross_attn_block", m, c, num_heads, partial)
    s = k.shape[2]
    if k.shape != (b, num_heads, s, inner // num_heads) or v.shape != k.shape or key_bias.shape != (b, s):
        raise ValueError(f"cross_attn_block: k/v {tuple(k.shape)} / key_bias {tuple(key_bias.shape)} "
                         f"do not match x {tuple(x.shape)} and {num_heads} heads of width {inner // num_heads}")
    y = torch.empty((b, c), dtype=torch.float32 if partial else x.dtype, device=x.device)
    bo = None if partial else m["out"]["b"]
    if not decode_kernels_fit(c, num_heads, inner=inner):
        _width_launch("cross_attn_block", "rt_width_cross", x, B=b, C=c, H=num_heads, I=inner, F=1, S=s,
                      yf32=int(partial), partial=int(partial), x=x, y=y, qpos=qpos, ln2s=p["norm"]["scale"],
                      ln2b=p["norm"]["bias"], cwq=m["q"]["w"], cbq=m["q"]["b"], cwo=m["out"]["w"], cbo=bo,
                      ck=k, cv=v, key_bias=key_bias)
        return y
    t = dict(qpos=qpos, lns=p["norm"]["scale"], lnb=p["norm"]["bias"], wq=m["q"]["w"],
             bq=m["q"]["b"], wo=m["out"]["w"], bo=bo, ck=k, cv=v, key_bias=key_bias)
    _check("cross_attn_block", x.dtype, _param_shapes(inner=inner), x=x, **t)
    _launch("cross_attn_block", x, B=b, S=s, H=num_heads, partial=int(partial), rows=_block_rows, x=x, y=y, **t)
    return y


_PLAN_KIND = {"ff_block": 0, "cross_attn_block": 1, "self_attn_block_beam": 2, "self_attn_block": 3}


def block_plan(kernel: str, dtype: torch.dtype, b: int, s: int = 1, f: int = 256, t: int = 1,
               num_beams: int = 1, num_heads: int = HEADS, partial: bool = False) -> Dict[str, int]:
    """The launch ``kernel`` ("ff_block", "cross_attn_block",
    "self_attn_block_beam" or "self_attn_block", whose caches hold ``t``
    positions and whose beam groups have ``num_beams`` rows, one for
    self_attn_block) makes on the current CUDA device for these shapes, over
    ``num_heads`` heads (an attention block's mp slice: ``partial``): rows
    per tile, blocks per cluster, clusters, clusters co-resident on the card,
    shared bytes per block. Raises where the kernel does not take the shapes
    (past the self kernels' longest ``t``)."""
    lib = _lib("block_kernels")
    fn = lib.rt_block_plan
    fn.argtypes = [ctypes.POINTER(_BlockArgs), ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    self_kind = kernel in ("self_attn_block", "self_attn_block_beam")
    args = _BlockArgs(B=b, S=s, F=f, rows=_beam_rows if self_kind else _block_rows, T=t, K=num_beams,
                      H=num_heads, partial=int(partial))
    rc = fn(ctypes.byref(args), _PLAN_KIND[kernel], int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"rt_block_plan: {lib.rt_block_error_string(rc).decode()}")
    return dict(zip(("rows", "cluster", "clusters", "resident_clusters", "smem_bytes"), out))


def self_attn_block(p: Params, x, qpos, k_cache, v_cache, step, *, num_heads: int, partial: bool = False):
    """x: [B, C]; caches [B, H, T, D] updated in place at ``step`` (int32 tensor on
    the device). Returns (x_out, k_cache, v_cache); ``partial`` (``p`` an mp
    slice of ``num_heads`` heads, the caches its heads): x_out is the f32 sum
    of its heads' out-projection parts, for :func:`attn_block_epilogue`.

    Replaces retr_tpu/ops/decoder_kernels.py ``self_attn_block``
    (``_self_kernel``). Bound on the card: bytes — the four [C, C] weights and
    the cache rows up to ``step``. Design: the cluster kernel of
    :func:`self_attn_block_beam` (csrc/block_kernels.cu) with beam groups of
    one row and no ancestry: one cluster of 8 blocks (one per head) per tile
    of up to 32 rows (:func:`block_plan`), each row reading its own cache row,
    only the new cache slot written (the TPU kernel rewrote whole cache
    blocks). Caches longer than the block's shared memory takes for the
    scores (on the H100 T past 6144 in bf16, 5568 in f32) are refused. With
    ``partial``: clusters of one block per head of the slice, the reduction
    as cross_attn_block's. At other widths: rt_width_self
    (csrc/width_kernels.cu).
    """
    if x.device.type == "cpu":
        return self_attn_block_plain(p, x, qpos, k_cache, v_cache, step, num_heads=num_heads, partial=partial)
    b, c = x.shape
    inner = _attn_inner("self_attn_block", p["mha"], c, num_heads, partial)
    tmax = k_cache.shape[2]
    if k_cache.shape != (b, num_heads, tmax, inner // num_heads) or v_cache.shape != k_cache.shape:
        raise ValueError(f"self_attn_block: caches {tuple(k_cache.shape)} do not match x {tuple(x.shape)} "
                         f"and {num_heads} heads of width {inner // num_heads}")
    if not decode_kernels_fit(c, num_heads, inner=inner):
        return _width_self("self_attn_block", p, x, qpos, k_cache, v_cache, step, num_heads, 0, None, partial)
    return _self_cluster("self_attn_block", p, x, qpos, k_cache, v_cache, step, num_heads, 1, None, partial)


def _self_cluster(kernel, p, x, qpos, k_cache, v_cache, step, num_heads, num_beams, anc, partial):
    """Check and launch the self-attention cluster kernel behind ``kernel``:
    rt_self_attn_block (``anc`` None), or rt_self_attn_block_beam."""
    m = p["mha"]
    t = dict(qpos=qpos, lns=p["norm"]["scale"], lnb=p["norm"]["bias"],
             wq=m["q"]["w"], bq=m["q"]["b"], wk=m["k"]["w"], bk=m["k"]["b"],
             wv=m["v"]["w"], bv=m["v"]["b"], wo=m["out"]["w"], bo=None if partial else m["out"]["b"],
             kc=k_cache, vc=v_cache, step=step, **({} if anc is None else {"anc": anc}))
    _check(kernel, x.dtype, _param_shapes(inner=m["q"]["w"].shape[1]), x=x, **t)
    y = torch.empty(x.shape, dtype=torch.float32 if partial else x.dtype, device=x.device)
    _launch(kernel, x, B=x.shape[0], T=k_cache.shape[2], K=num_beams, H=num_heads, partial=int(partial),
            rows=_beam_rows, x=x, y=y, **t)
    return y, k_cache, v_cache


def _width_self(kernel, p, x, qpos, k_cache, v_cache, step, num_heads, num_beams, anc, partial):
    """rt_width_self for self_attn_block (``num_beams`` 0) and self_attn_block_beam."""
    m = p["mha"]
    b, c = x.shape
    y = torch.empty((b, c), dtype=torch.float32 if partial else x.dtype, device=x.device)
    extra = {} if anc is None else {"anc": anc}
    _width_launch(kernel, "rt_width_self", x, B=b, C=c, H=num_heads, I=m["q"]["w"].shape[1], F=1,
                  T=k_cache.shape[2], K=num_beams, yf32=int(partial), partial=int(partial), x=x, y=y, qpos=qpos,
                  ln1s=p["norm"]["scale"], ln1b=p["norm"]["bias"], swq=m["q"]["w"], sbq=m["q"]["b"],
                  swk=m["k"]["w"], sbk=m["k"]["b"], swv=m["v"]["w"], sbv=m["v"]["b"], swo=m["out"]["w"],
                  sbo=None if partial else m["out"]["b"], kc=k_cache, vc=v_cache, step=step, **extra)
    return y, k_cache, v_cache


def fused_stack_step(slp: Params, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias, step,
                     *, num_heads: int):
    """All L decoder layers for one position. slp: leaf-stacked layer params;
    caches [L, B, H, T, D] (updated in place at ``step``); cross K/V
    [L, B, H, S, D]. Returns (x_out [B, C] before the final norm, k_cache, v_cache).

    Replaces retr_tpu/ops/decoder_kernels.py ``fused_stack_step``
    (``_stack_kernel``). Bound on the card: bytes — every layer's weights plus
    the cross K/V and the self caches, against ~2 operations per weight byte per
    row. Design (csrc/stack_kernels.cu): one cooperative launch over as many
    blocks as fit on the card; each layer runs in 8 grid-wide phases (9 at
    small batches, where FF2 is split into hidden chunks) separated by grid
    barriers (products split by 16-row x 32-column tiles, bf16 on
    tensor cores; attention split by (row, head)); the residual, q/k/v, the
    attention output, the FF hidden and FF2's per-chunk products pass between
    phases through scratch allocated here; only the new cache slots are written.
    At other widths: rt_width_stack (csrc/width_kernels.cu), 3 L launches with
    the residual in f32 scratch.
    """
    if x.device.type == "cpu":
        return fused_stack_step_plain(slp, x, qpos, k_cache, v_cache, cross_k, cross_v,
                                      key_bias, step, num_heads=num_heads)
    y = _stack_launch("fused_stack_step", slp, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias,
                      step, num_heads)
    return y, k_cache, v_cache


# A cap on rt_stack_step's grid (0: as many blocks as fit); the card tests set
# it to show that the result does not depend on the grid size.
_stack_max_blocks = 0
# None, or an int64 CUDA tensor of (grid barriers + 2) entries that
# rt_stack_step fills with block 0's clock (ns) at its start, after each grid
# barrier and at its end: the time of each phase (chip_smoke.py's breakdown).
_stack_trace = None


def _stack_launch(kernel, slp, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias, step, num_heads):
    """Check and launch rt_stack_step over the layer-stacked ``slp`` / caches
    (rt_width_stack at the widths it does not take)."""
    b, c = x.shape
    nl, _, _, tmax, _ = k_cache.shape
    s = cross_k.shape[3]
    sp, cp, fp = slp["self_attn"], slp["cross_attn"], slp["ff"]
    f = fp["lin1"]["w"].shape[2]
    _check_width(kernel, c, num_heads, f)
    d = c // num_heads
    if (k_cache.shape != (nl, b, num_heads, tmax, d) or v_cache.shape != k_cache.shape
            or cross_k.shape != (nl, b, num_heads, s, d) or cross_v.shape != cross_k.shape
            or key_bias.shape != (b, s)):
        raise ValueError(f"{kernel}: cache / cross K/V shapes do not match x")
    fits = decode_kernels_fit(c, num_heads, f)
    t = dict(qpos=qpos,
             ln1s=sp["norm"]["scale"], ln1b=sp["norm"]["bias"],
             swq=sp["mha"]["q"]["w"], sbq=sp["mha"]["q"]["b"],
             swk=sp["mha"]["k"]["w"], sbk=sp["mha"]["k"]["b"],
             swv=sp["mha"]["v"]["w"], sbv=sp["mha"]["v"]["b"],
             swo=sp["mha"]["out"]["w"], sbo=sp["mha"]["out"]["b"],
             ln2s=cp["norm"]["scale"], ln2b=cp["norm"]["bias"],
             cwq=cp["mha"]["q"]["w"], cbq=cp["mha"]["q"]["b"],
             cwo=cp["mha"]["out"]["w"], cbo=cp["mha"]["out"]["b"],
             ln3s=fp["norm"]["scale"], ln3b=fp["norm"]["bias"],
             w1=fp["lin1"]["w"], b1=fp["lin1"]["b"], w2=fp["lin2"]["w"], b2=fp["lin2"]["b"],
             kc=k_cache, vc=v_cache, ck=cross_k, cv=cross_v, key_bias=key_bias, step=step)
    y = torch.empty_like(x)
    if not fits:
        res = torch.empty((b, c), dtype=torch.float32, device=x.device)
        _width_launch(kernel, "rt_width_stack", x, B=b, C=c, H=num_heads, F=f, T=tmax, S=s, L=nl, x=x, y=y,
                      res=res, **t)
        return y
    _check(kernel, x.dtype, _param_shapes(f, nl), x=x, **t)
    buf, scratch = _stack_scratch(b, f, x.device)
    _launch(kernel, x, B=b, T=tmax, S=s, F=f, L=nl, max_blocks=_stack_max_blocks, x=x, y=y, **t, **scratch,
            trace=_stack_trace)
    del buf                                       # after the launch is queued
    return y


def _stack_scratch(b: int, f: int, device):
    """rt_stack_step's f32 scratch, one allocation, and the addresses of its
    parts: the residual [2, B, C], q/k/v [B, 3C], the attention output [B, C],
    the FF hidden [B, F] (which the kernel keeps in the storage type, within
    the same bytes) and FF2's products per hidden chunk [min(8, F/256), B, C].
    The caller holds the buffer until the launch is queued; freed then, the
    caching allocator reuses it only for work queued after the kernel."""
    c = WIDTH
    sizes = (2 * b * c, 3 * b * c, b * c, b * f, min(8, f // 256) * b * c)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    at, parts = buf.data_ptr(), {}
    for name, n in zip(("xres", "qkv", "att", "hid", "part"), sizes):
        parts[name] = at
        at += 4 * n
    return buf, parts


def stack_grid(dtype: torch.dtype, b: int, t: int, s: int, f: int, nl: int) -> Dict[str, int]:
    """The grid rt_stack_step launches on the current CUDA device for these
    shapes: blocks, co-resident blocks per SM, grid barriers per launch, and
    the hidden chunks FF2 is split into."""
    lib = _lib("stack_kernels")
    fn = lib.rt_stack_grid
    fn.argtypes = [ctypes.POINTER(_StackArgs), ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    args = _StackArgs(B=b, T=t, S=s, F=f, L=nl, max_blocks=_stack_max_blocks)
    rc = fn(ctypes.byref(args), int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"rt_stack_grid: {lib.rt_stack_error_string(rc).decode()}")
    return {"blocks": out[0], "blocks_per_sm": out[1], "grid_barriers": out[2], "ff2_chunks": out[3]}


def fused_layer_step(lp: Params, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias, step,
                     *, num_heads: int):
    """One whole decoder layer (self + cross + FF) for one position, the f32
    residual rounded only at the output. lp: one layer's params (contiguous,
    e.g. views of the stack); caches [B, H, T, D] updated in place at ``step``;
    cross K/V [B, H, S, D]. Returns (x_out [B, C], k_cache, v_cache).

    Replaces retr_tpu/ops/decoder_kernels.py ``fused_layer_step``
    (``_layer_kernel``), which computes what ``fused_stack_step`` computes for
    one layer; so does this wrapper, launching ``rt_stack_step`` with L = 1 on
    views of the layer (7-8 grid barriers). Bound and design: see fused_stack_step.
    """
    if x.device.type == "cpu":
        return fused_layer_step_plain(lp, x, qpos, k_cache, v_cache, cross_k, cross_v, key_bias,
                                      step, num_heads=num_heads)
    y = _stack_launch("fused_layer_step", _lead(lp), x, qpos, k_cache[None], v_cache[None],
                      cross_k[None], cross_v[None], key_bias, step, num_heads)
    return y, k_cache, v_cache


def self_attn_block_beam(p: Params, x, anc, qpos, k_cache, v_cache, step, *, num_heads: int,
                         num_beams: int, partial: bool = False):
    """x: [B*K, C], rows beam-major within each batch element's group of K;
    anc: [B*K, T] int32, the row within the group that wrote each position
    (entries at positions <= ``step`` must lie in [0, K)); caches [B*K, H, T, D]
    updated in place at ``step`` (each row writes its own slot only). Returns
    (x_out, k_cache, v_cache); ``partial`` as :func:`self_attn_block`'s.

    Replaces retr_tpu/ops/decoder_kernels.py ``self_attn_block_beam``
    (``_make_self_beam_kernel``). Bound on the card: bytes — the four [C, C]
    weights at small batches, the ancestry-gathered cache rows at large ones.
    Design (csrc/block_kernels.cu, as cross_attn_block): one launch of
    thread-block clusters, one cluster of 8 blocks (one per head) per tile of
    whole beam groups (up to 32 rows; :func:`block_plan`), so the fresh slot
    at ``step`` of any ancestor is in the block's shared memory; block h forms
    its head's q, k and v from 32-column weight slices (bf16 on tensor
    cores), writes its head's cache slot, attends each row (a warp per row)
    reading each earlier position from the ancestor's cache row only (the TPU
    kernel formed q.K against all K rows and selected one), and hands its f32
    out-projection part to its peers through distributed shared memory, which
    add the heads in order with the TPU kernel's rounding (``partial``: as
    self_attn_block's). At other widths, or beam groups of 9..16:
    rt_width_self (csrc/width_kernels.cu).
    """
    if x.device.type == "cpu":
        return self_attn_block_beam_plain(p, x, anc, qpos, k_cache, v_cache, step,
                                          num_heads=num_heads, num_beams=num_beams, partial=partial)
    bk, c = x.shape
    inner = _attn_inner("self_attn_block_beam", p["mha"], c, num_heads, partial)
    tmax = k_cache.shape[2]
    if not 1 <= num_beams <= WIDTH_MAX_BEAMS or bk % num_beams:
        raise ValueError(f"self_attn_block_beam: {bk} rows are not whole groups of {num_beams} "
                         f"beams, or the beam is outside 1..{WIDTH_MAX_BEAMS}")
    if (k_cache.shape != (bk, num_heads, tmax, inner // num_heads) or v_cache.shape != k_cache.shape
            or anc.shape != (bk, tmax)):
        raise ValueError(f"self_attn_block_beam: caches {tuple(k_cache.shape)} / anc "
                         f"{tuple(anc.shape)} do not match x {tuple(x.shape)} and {num_heads} heads")
    if not decode_kernels_fit(c, num_heads, 256, num_beams, inner):
        return _width_self("self_attn_block_beam", p, x, qpos, k_cache, v_cache, step, num_heads, num_beams, anc,
                           partial)
    return _self_cluster("self_attn_block_beam", p, x, qpos, k_cache, v_cache, step, num_heads, num_beams, anc,
                         partial)


_SLAB = 128  # vocab columns per block of csrc/head_kernels.cu


def _head_slabs(kernel: str, p: Params, h2, k: int):
    """rt_head_blocks on h2 [N, Hd]: per row and 128-wide vocab slab the top-k
    logits and ids [N, G, k], the slab max and sum(exp(x - max)) [N, G]."""
    l3 = p["layers"][2]
    n, hd = h2.shape
    v = l3["w"].shape[1]
    if not head_kernels_fit(p, k):
        raise ValueError(f"{kernel}: k = {k} is outside 1..min(vocab {v}, {HEAD_KMAX}), or the storage "
                         f"type {l3['w'].dtype} is not float32 or bfloat16")
    if hd % HEAD_HIDDEN_ALIGN:
        raise ValueError(f"{kernel}: hidden width {hd} must be a multiple of {HEAD_HIDDEN_ALIGN} "
                         f"(pack_head pads it)")
    if v % HEAD_ALIGN:
        raise ValueError(f"{kernel}: W3's rows must be 16-byte aligned: a vocab that is a multiple of "
                         f"{HEAD_ALIGN} (got {v}; pack_head pads it)")
    g = (v + _SLAB - 1) // _SLAB
    vals = torch.empty((n, g, k), dtype=torch.float32, device=h2.device)
    idx = torch.empty((n, g, k), dtype=torch.int32, device=h2.device)
    mx = torch.empty((n, g), dtype=torch.float32, device=h2.device)
    se = torch.empty_like(mx)
    t = dict(w3=l3["w"], b3=l3["b"], vals=vals, idx=idx, mx=mx, se=se)
    _check(kernel, h2.dtype, {"w3": (hd, v), "b3": (v,)}, h2=h2, **t)
    _run("head_kernels", "rt_head_blocks", h2, B=n, Hd=hd, V=v, k=k, h2=h2, **t)
    return vals, idx, mx, se


def mlp_head_argmax(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, C] post-final-norm hidden -> greedy token ids [B] int32, equal to
    argmax of the MLP head's f32 logits (first index on ties). On CUDA tensors
    ``p`` must be packed (:func:`pack_head`).

    Replaces retr_tpu/ops/decoder_kernels.py ``mlp_head_argmax``
    (``_head_kernel``). Bound on the card: bytes below ~300 rows (W3, Hd x V,
    against 2 operations per element per row), operations above. Design
    (csrc/head_kernels.cu): two launches of a trunk kernel write h1 and h2
    (one block per 16-row x 8-column tile, bf16 on tensor cores; any input
    width C, zero-filled to a multiple of 32), then the
    vocab kernel multiplies h2 by the packed W3 in tiles of up to 128 rows x one
    128-wide vocab slab (bf16 on tensor cores, W3 from device memory about once) and
    emits each slab's (max, first argmax); the [B, V] logits never reach device
    memory. The pick across slabs (first slab on ties) is one torch argmax.
    """
    if x.device.type == "cpu":
        return mlp_head_argmax_plain(p, x)
    l1, l2 = p["layers"][0], p["layers"][1]
    b, c = x.shape
    hd = l1["w"].shape[1]
    if hd % HEAD_HIDDEN_ALIGN:
        raise ValueError(f"mlp_head_argmax: hidden width {hd} must be a multiple of {HEAD_HIDDEN_ALIGN} "
                         f"(pack_head pads it)")
    t = dict(w1=l1["w"], b1=l1["b"], w2=l2["w"], b2=l2["b"])
    _check("mlp_head_argmax", x.dtype, {"w1": (c, hd), "b1": (hd,), "w2": (hd, hd), "b2": (hd,)},
           x=x, **t)
    h = torch.empty((2, b, hd), dtype=x.dtype, device=x.device)    # h1, h2
    _run("head_kernels", "rt_head_trunk", x, B=b, C=c, Hd=hd, x=x, h1=h[0], h2=h[1], **t)
    vals, idx, _, _ = _head_slabs("mlp_head_argmax", p, h[1], 1)
    best = vals[:, :, 0].argmax(dim=1, keepdim=True)       # first slab on ties
    _count("mlp_head_argmax")
    return idx[:, :, 0].gather(1, best)[:, 0]


def mlp_head_topk(p: Params, x: torch.Tensor, k: int):
    """x: [N, C] hidden -> (log-softmax of the top ``k`` tokens [N, k] f32, their
    ids [N, k] int32), first index on ties; k <= min(vocab, HEAD_KMAX). On CUDA tensors ``p``
    must be packed (:func:`pack_head`).

    Replaces retr_tpu/ops/decoder_kernels.py ``mlp_head_topk``
    (``_head_topk_kernel``). The trunk runs in torch (the MLP head's first two
    layers), as it ran in XLA outside the TPU kernel. Bound on the card: bytes
    below ~300 rows, operations above, as mlp_head_argmax. Design: the vocab
    kernel of mlp_head_argmax emits each 128-wide slab's top-k (value, first
    index), max and sum(exp(x - max)); the combine across slabs (online
    logsumexp, top-k of the G*k candidates in (slab, slot) order) runs in torch.
    Token choice is exact on the f32 logits; the log-softmax differs from the
    flat one only by the logsumexp's summation order.
    """
    if x.device.type == "cpu":
        return mlp_head_topk_plain(p, x, k)
    vals, idx, mx, se = _head_slabs("mlp_head_topk", p, _torch_trunk(p, x).contiguous(), k)
    n = x.shape[0]
    m = mx.max(dim=1, keepdim=True).values
    log_z = torch.log((se * torch.exp(mx - m)).sum(dim=1, keepdim=True))
    # (slab, slot) order is (value desc, id asc) within a slab and ids ascend
    # across slabs, so position ties break as id ties
    top, pos = topk_first(vals.view(n, -1), k)
    _count("mlp_head_topk")
    return (top - m) - log_z, idx.view(n, -1).gather(1, pos)
