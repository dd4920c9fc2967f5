"""Mask substrate: the (tensor, mask) pair and the additive attention biases.

Conventions of retr_tpu/masking.py: masks are bool with ``True == padded``; the
causal mask is additive, 0 on/below the diagonal and -inf above.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")


class Masked(NamedTuple):
    """A tensor plus its padding mask (True = pad)."""

    tensors: torch.Tensor
    mask: torch.Tensor


def causal_mask(sz: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask: 0 where key <= query, -inf above the diagonal."""
    i = torch.arange(sz, device=device)[:, None]
    j = torch.arange(sz, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).to(dtype)


def key_padding_bias(pad_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, S] bool (True = pad) -> [B, 1, 1, S] additive bias (0 / -inf)."""
    return torch.where(pad_mask, NEG_INF, 0.0).to(dtype)[:, None, None, :]


def filler_indices(n: int, seed: int, unmasked_ratio: float = 0.01) -> np.ndarray:
    """The positions :func:`ensure_unmasked_values` unmasks by default:
    ``round(n * unmasked_ratio)`` (at least one) distinct indices drawn with
    ``numpy.random.default_rng(seed)``."""
    n_unmask = max(1, round(n * unmasked_ratio))
    return np.random.default_rng(seed).choice(n, size=n_unmask, replace=False)


def ensure_unmasked_values(mask: torch.Tensor, filler_idx) -> torch.Tensor:
    """Deterministic guard of models/utils.py:60-89 in the reference.

    A sample whose [H, W] mask is entirely True (attention over it would be all
    -inf, hence NaN) gets a mask that is True everywhere except at
    ``filler_idx`` (flat indices, shared by the whole batch like the reference's
    one filler mask). Samples with any visible position are unchanged.

    Deviation from retr_tpu: the JAX package draws the filler inside the
    function with ``jax.random.choice``, whose bits PyTorch cannot reproduce. The
    port takes the index set as an argument; callers default to
    :func:`filler_indices` (numpy ``default_rng(cfg.seed)``). The two packages
    agree whenever they are given the same indices, and on every batch where no
    map is fully masked.
    """
    b, h, w = mask.shape
    flat = mask.reshape(b, -1)
    all_masked = flat.all(dim=1)
    if torch.is_tensor(filler_idx):
        idx = filler_idx.to(device=mask.device, dtype=torch.long)
    else:
        idx = torch.tensor(np.asarray(filler_idx), dtype=torch.long, device=mask.device)
    # index_fill takes the value as a scalar: no host tensor to copy (a CUDA graph cannot)
    filler = torch.ones(flat.shape[1], dtype=torch.bool, device=mask.device).index_fill(0, idx, False)
    out = torch.where(all_masked[:, None], filler[None, :], flat)
    return out.reshape(b, h, w)


def downsample_mask_nearest(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour mask downsample to the feature-map size: source index =
    floor(dst * src/dst_size), computed in f32 like the reference package."""
    h, w = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    rows = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev) * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev) * (w / out_w)).long()
    return mask[..., rows, :][..., :, cols]
