"""Host-side image resizing and padding on numpy arrays (the numpy half of
retr_tpu/ops/image.py).

- :func:`pil_resize_uint8` is bit-exact with PIL ``Image.resize(BILINEAR)`` on
  uint8 images (Pillow's fixed-point coefficients, per-pass rounding + clipping);
- :func:`torch_bilinear_weights` reproduces ``F.interpolate(bilinear,
  align_corners=False)`` for the mask resize;
- the pad helpers keep the reference's two centering rules (PIL's banker's
  rounding for images, floor/ceil for masks), one pixel apart when the size
  difference is 3 mod 4.

Normalization happens on the device (data/pipeline.py); colour jitter belongs
to training and is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c fixed-point precision for 8bpc

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------------
# Weight matrices (host-side, float64)
# ---------------------------------------------------------------------------------


def pil_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] PIL BILINEAR (antialiased triangle) coefficients, normalized rows."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # bilinear filter support = 1
    inv = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        k = 1.0 - np.abs((xs - center + 0.5) * inv)
        k = np.clip(k, 0.0, None)
        ssum = k.sum()
        if ssum != 0:
            k /= ssum
        w[xx, xmin:xmax] = k
    return w


def _quantize_coeffs(w: np.ndarray) -> np.ndarray:
    """Pillow's double->int coefficient conversion (round-half-away-from-zero)."""
    scaled = w * (1 << PRECISION_BITS)
    return np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)


def torch_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] torch bilinear (antialias=False, align_corners=False): 2 taps/row,
    src = (dst + 0.5) * in/out - 0.5 clamped into range."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for xx in range(out_size):
        src = max((xx + 0.5) * scale - 0.5, 0.0)
        x0 = min(int(math.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        frac = src - x0
        w[xx, x0] += 1.0 - frac
        w[xx, x1] += frac
    return w


# ---------------------------------------------------------------------------------
# Apply (host numpy, exact uint8)
# ---------------------------------------------------------------------------------


def pil_resize_uint8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact emulation of PIL Image.resize(..., BILINEAR) on a uint8 HWC image:
    horizontal pass then vertical pass, int fixed-point accumulate, round, clip."""
    in_h, in_w = img.shape[:2]
    kw = _quantize_coeffs(pil_resize_weights(in_w, out_w))  # [out_w, in_w]
    kh = _quantize_coeffs(pil_resize_weights(in_h, out_h))  # [out_h, in_h]
    half = 1 << (PRECISION_BITS - 1)

    x = img.astype(np.int64)                       # [H, W, C]
    # horizontal: [H, out_w, C]
    acc = np.einsum("hwc,ow->hoc", x, kw) + half
    x = np.clip(acc >> PRECISION_BITS, 0, 255)
    # vertical: [out_h, out_w, C]
    acc = np.einsum("hwc,oh->owc", x, kh) + half
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------------
# Padding offsets
# ---------------------------------------------------------------------------------


def pad_image_offset(diff: int) -> int:
    """ImageOps.pad centering=(0.5, 0.5): offset = round(diff * 0.5), Python banker's
    rounding (utils.py:231-239 via PIL.ImageOps.pad)."""
    return round(diff * 0.5)


def pad_mask_offsets(diff: int) -> Tuple[int, int]:
    """pad_mask_to_max: floor(diff/2) leading, ceil(diff/2) trailing
    (utils.py:242-256). NOTE: disagrees with pad_image_offset by 1 when
    diff % 4 == 3 — a reference quirk we keep for parity."""
    return math.floor(diff / 2), math.ceil(diff / 2)


def pad_uint8_to_square(img: np.ndarray, fill: int = 0) -> np.ndarray:
    """pad_img_to_max (utils.py:231-239): black square canvas, PIL centering."""
    h, w = img.shape[:2]
    m = max(h, w)
    if h == w:
        return img
    out = np.full((m, m) + img.shape[2:], fill, dtype=img.dtype)
    if w < m:
        x = pad_image_offset(m - w)
        out[:, x : x + w] = img
    else:
        y = pad_image_offset(m - h)
        out[y : y + h, :] = img
    return out


def pad_mask_to_square(mask: np.ndarray) -> np.ndarray:
    """pad_mask_to_max (utils.py:242-256): pad shorter axis with True, floor/ceil."""
    h, w = mask.shape
    if h == w:
        return mask
    m = max(h, w)
    out = np.ones((m, m), dtype=bool)
    if w < m:
        lead, _ = pad_mask_offsets(m - w)
        out[:, lead : lead + w] = mask
    else:
        lead, _ = pad_mask_offsets(m - h)
        out[lead : lead + h, :] = mask
    return out
