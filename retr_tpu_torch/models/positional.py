"""Source positional encoding: the 1-D sine table over the flattened feature
sequence (retr_tpu/models/positional.py)."""

from __future__ import annotations

import math

import numpy as np
import torch


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


def positional_encoding(kind: str, seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """[S, d] positional encoding. Only the sine table is ported; the learned
    table ("v3"/"learned") is not yet."""
    if kind in ("v2", "sine"):
        return sine_table(d_model, max_len=max(seq_len, 1024), device=device)[:seq_len]
    if kind in ("v3", "learned"):
        raise NotImplementedError("learned source positions are not ported yet")
    raise ValueError(f"not supported {kind}")
