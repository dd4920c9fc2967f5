"""Source positional encoding over the flattened feature sequence
(retr_tpu/models/positional.py): the 1-D sine table ("sine"/"v2"), or the
learned table with its LayerNorm and dropout ("learned"/"v3", the reference's
position_encoding.py:38-63, params ``transformer.src_pos``)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from retr_tpu_torch.models import layers


def sine_table(d_model: int, max_len: int = 1024, dtype=torch.float32, device=None) -> torch.Tensor:
    """[max_len, d_model]; pe[p, 2i] = sin(p*w_i), pe[p, 2i+1] = cos(p*w_i),
    w_i = exp(-2i*ln(10000)/d). Built in float64 on the host then cast, as the
    reference package does (f32 sin/cos at angles near 1e3 rad differ across
    math libraries by ~1e-4)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    angles = pos * div[None, :]
    pe = np.zeros((max_len, d_model), np.float64)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return torch.as_tensor(pe.astype(np.float32), device=device).to(dtype)


def learned_init(gen: torch.Generator, d_model: int, max_len: int = 1024) -> dict:
    """The learned table (xavier, as ConcatTransformer's reset re-initialises it)
    and its LayerNorm."""
    return {"table": layers.xavier_uniform(gen, (max_len, d_model)), "norm": layers.layer_norm_init(d_model)}


def positional_encoding(kind: str, seq_len: int, d_model: int, params: Optional[dict] = None, *,
                        dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
                        train: bool = False, device=None) -> torch.Tensor:
    """[S, d] positional encoding. The learned kind is
    ``dropout(LayerNorm(params["table"][:S]))``, with dropout only under
    ``train``."""
    if kind in ("v2", "sine"):
        return sine_table(d_model, max_len=max(seq_len, 1024), device=device)[:seq_len]
    if kind in ("v3", "learned"):
        if params is None:
            raise ValueError("learned source positions need their parameters (transformer.src_pos)")
        emb = layers.layer_norm(params["norm"], params["table"][:seq_len])
        return layers.dropout(emb, dropout_rate, generator, train)
    raise ValueError(f"not supported {kind}")
