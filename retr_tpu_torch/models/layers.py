"""Primitive layers as plain functions on tensors (retr_tpu/models/layers.py).

Parameter dicts keep the JAX package's layout: linear weights are ``[in, out]``
so a layer is ``x @ w + b``; LayerNorm is ``{scale, bias}``.

Dropout draws from an explicit ``torch.Generator``. Its streams are not
``jax.random``'s: the two packages agree exactly only with dropout off, and in
distribution with it on. Callers derive each generator from an integer seed
(:func:`fold_in`, :func:`make_generator`), the counterpart of JAX's key folding, so
a recomputation under ``torch.utils.checkpoint`` draws the same masks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from retr_tpu_torch.ops import attention as fused_ops
from retr_tpu_torch.parallel import mesh as pmesh

Params = dict

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of their mix),
    the counterpart of ``jax.random.fold_in`` for integer seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def make_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None: no dropout)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def tree_to(tree, **kw):
    """Each tensor of a tree of dicts and lists through ``Tensor.to(**kw)``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, **kw) for v in tree]
    return tree.to(**kw)


def maybe_checkpoint(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` is on and
    autograd records (the backward then recomputes fn's activations instead of
    keeping them). Dropout generators are made inside ``fn`` from integer seeds,
    so the default generators' state need not be saved."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Keep each element with probability 1 - rate and scale it by 1/(1 - rate);
    the identity when not training, at rate 0 or without a generator."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


# ---------------------------------------------------------------------------------
# Initialisers (retr_tpu/models/layers.py:26-116): the reference's, so a model
# trained from scratch starts from the same distributions. Each draws from an
# explicit CPU torch.Generator into f32 host tensors, so a seed gives the same
# parameters whatever device they then move to. torch cannot replay jax.random:
# the two packages agree in distribution, not in values.
# ---------------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """nn.init.xavier_uniform_ on an [in, out] weight: U(+-sqrt(6 / (in + out)))."""
    fan_in, fan_out = shape[0], shape[1]
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def torch_linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    """nn.Linear's default: U(+-1/sqrt(fan_in)) for both w and b."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(gen, (in_dim, out_dim), bound), "b": _uniform(gen, (out_dim,), bound)}


def xavier_linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    """A Linear whose weight ConcatTransformer._reset_parameters re-initialises
    (xavier) while its bias keeps nn.Linear's default."""
    return {"w": xavier_uniform(gen, (in_dim, out_dim)),
            "b": _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))}


def layer_norm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def embedding_init(gen: torch.Generator, num: int, dim: int) -> Params:
    """Xavier table: ConcatTransformer._reset_parameters re-initialises every
    parameter of rank > 1, the embedding tables included."""
    return {"table": xavier_uniform(gen, (num, dim))}


def mha_init(gen: torch.Generator, embed_dim: int) -> Params:
    """nn.MultiheadAttention's: q/k/v are slices of one xavier [3E, E] in_proj
    (bound sqrt(6 / 4E)) with zero biases; out_proj xavier again (the reset),
    zero bias."""
    e = embed_dim
    bound = math.sqrt(6.0 / (e + 3 * e))
    p = {k: {"w": _uniform(gen, (e, e), bound), "b": torch.zeros(e)} for k in ("q", "k", "v")}
    p["out"] = {"w": xavier_uniform(gen, (e, e)), "b": torch.zeros(e)}
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch nn.LayerNorm over the last dim (biased variance), computed in f32
    and returned in x's type."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, E] -> [B, H, S, D]"""
    b, s, e = x.shape
    return x.reshape(b, s, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, E]"""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_core(q, k, v, bias: Optional[torch.Tensor], *, need_weights: bool = False):
    """Scaled dot-product attention on [B, H, S, D] tensors with an additive bias:
    q scaled by D**-0.5 before the product, scores and softmax in f32. Returns
    (out, head-averaged probabilities or None). Rows whose bias is all -inf
    give NaN, as in torch and the reference package."""
    probs = _probs(q, k, bias)
    out = torch.matmul(probs.to(v.dtype), v)
    return out, (probs.mean(dim=1) if need_weights else None)


def _probs(q, k, bias):
    d = q.shape[-1]
    scale = float(np.float32(d) ** np.float32(-0.5))
    scores = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores, dim=-1)


def multi_head_attention(p: Params, query, key_, value, *, num_heads: int,
                         bias: Optional[torch.Tensor] = None, need_weights: bool = False,
                         dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
                         train: bool = False, use_pallas: bool = False, causal: bool = False,
                         key_pad_bias: Optional[torch.Tensor] = None):
    """Project, attend, merge, out-project. Inputs [B, S, E]; returns (out,
    head-averaged weights or None).

    With ``use_pallas``, no attention map asked for and no attention dropout,
    the fused kernel (ops/attention.py) takes the mask in its decomposed form
    (``key_pad_bias`` [B, Sk], ``causal``); the plain path covers the rest.
    Attention dropout acts on the probabilities, as torch's MHA does.

    ``num_heads`` is the model's head count. Where q/k/v are column-sharded
    over the active mesh's mp (their width below the out-projection's), this
    rank computes its whole heads, ``num_heads * local width / E`` of them:
    the inputs go through ``copy_to_mp``, the out-projection's partial sums
    through ``reduce_from_mp`` before its bias, and the attention dropout mask
    is the one of all heads, cut to this rank's (so it equals mp=1's)."""
    e = p["out"]["w"].shape[1]
    split = p["q"]["w"].shape[1] != e
    if split:
        if need_weights:
            raise NotImplementedError("attention maps of mp-sharded heads")
        query = pmesh.copy_to_mp(query)
        key_ = query if key_ is query else pmesh.copy_to_mp(key_)
        value = pmesh.copy_to_mp(value)
    heads = num_heads * p["q"]["w"].shape[1] // e
    q = split_heads(linear(p["q"], query), heads)
    k = split_heads(linear(p["k"], key_), heads)
    v = split_heads(linear(p["v"], value), heads)

    def out_proj(x):
        if not split:
            return linear(p["out"], x)
        return pmesh.reduce_from_mp(x @ p["out"]["w"]) + p["out"]["b"]

    if use_pallas and not need_weights and not (dropout_rate > 0.0 and train):
        out, _ = fused_ops.attention(q, k, v, bias, use_pallas=True, causal=causal,
                                     key_bias=key_pad_bias)
        return out_proj(merge_heads(out.to(v.dtype))), None

    if dropout_rate > 0.0 and train:
        probs = _probs(q, k, bias)
        if split and generator is not None:
            b, h, sq, sk = probs.shape
            keep = 1.0 - dropout_rate
            mask = torch.rand((b, num_heads, sq, sk), generator=generator, device=probs.device) < keep
            dropped = torch.where(mask[:, pmesh.mp_slice(h)], probs / keep, 0.0).to(probs.dtype)
        else:
            dropped = dropout(probs, dropout_rate, generator, train)
        out = torch.matmul(dropped.to(v.dtype), v)
        weights = probs.mean(dim=1) if need_weights else None
    else:
        out, weights = attention_core(q, k, v, bias, need_weights=need_weights)
    return out_proj(merge_heads(out)), weights
