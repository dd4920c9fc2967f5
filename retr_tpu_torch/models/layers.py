"""Primitive layers as plain functions on tensors (retr_tpu/models/layers.py).

Parameter dicts keep the JAX package's layout: linear weights are ``[in, out]``
so a layer is ``x @ w + b``; LayerNorm is ``{scale, bias}``. Dropout is absent:
this slice of the port runs inference only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

Params = dict


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


def attention_core(q, k, v, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention on [B, H, S, D] tensors with an additive bias:
    q scaled by D**-0.5 before the product, scores and softmax in f32. Rows whose
    bias is all -inf give NaN, as in torch and the reference package."""
    d = q.shape[-1]
    scale = float(np.float32(d) ** np.float32(-0.5))
    scores = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def multi_head_attention(p: Params, query, key_, value, *, num_heads: int,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project, attend, merge, out-project. Inputs [B, S, E]."""
    q = split_heads(linear(p["q"], query), num_heads)
    k = split_heads(linear(p["k"], key_), num_heads)
    v = split_heads(linear(p["v"], value), num_heads)
    return linear(p["out"], merge_heads(attention_core(q, k, v, bias)))
