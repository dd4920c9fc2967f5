"""The plain reference's host preprocessing: RE:TR's data_utils in numpy.

From a raw HWC uint8 image and a box [x, y, w, h] to what the model reads:
the target crop (and, for CaptionGlobalLoc, the whole image with the box
blacked out), each padded to a square with the reference's two centering
rules, resized to the model's side with Pillow's BILINEAR filter in its
fixed-point arithmetic, the masks resized as torch's bilinear interpolation
does followed by RE:TR's nonzero-to-True cast, the five location features,
and ImageNet normalization (data_utils/refcoco.py:105-188,
data_utils/utils.py:161-256). Written from the published code; imports
nothing of the measured program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2          # Pillow's fixed-point precision for 8-bit channels
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def pil_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] Pillow BILINEAR (antialiased triangle) coefficients, rows normalized."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    support = max(scale, 1.0)
    inv = 1.0 / support
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        k = np.clip(1.0 - np.abs((np.arange(lo, hi) - center + 0.5) * inv), 0.0, None)
        if k.sum() != 0:
            k /= k.sum()
        w[xx, lo:hi] = k
    return w


def pil_resize(img: np.ndarray, out: int) -> np.ndarray:
    """Pillow's ``Image.resize((out, out), BILINEAR)`` on uint8 HWC: a horizontal
    then a vertical pass, integer coefficients, round and clip after each."""
    def coeffs(n):
        s = pil_weights(n, out) * (1 << PRECISION_BITS)
        return np.where(s < 0, s - 0.5, s + 0.5).astype(np.int64)

    half = 1 << (PRECISION_BITS - 1)
    x = img.astype(np.int64)
    x = np.clip((np.einsum("hwc,ow->hoc", x, coeffs(img.shape[1])) + half) >> PRECISION_BITS, 0, 255)
    x = np.clip((np.einsum("hwc,oh->owc", x, coeffs(img.shape[0])) + half) >> PRECISION_BITS, 0, 255)
    return x.astype(np.uint8)


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of ``F.interpolate(mode="bilinear", align_corners=False)``."""
    w = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for xx in range(out_size):
        src = max((xx + 0.5) * scale - 0.5, 0.0)
        x0 = min(int(math.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        w[xx, x0] += 1.0 - (src - x0)
        w[xx, x1] += src - x0
    return w


def pad_image(img: np.ndarray) -> np.ndarray:
    """``PIL.ImageOps.pad`` onto a black square: offset round(diff / 2), banker's rounding."""
    h, w = img.shape[:2]
    m = max(h, w)
    out = np.zeros((m, m, 3), np.uint8)
    y, x = round((m - h) * 0.5), round((m - w) * 0.5)
    out[y:y + h, x:x + w] = img
    return out


def pad_mask(mask: np.ndarray) -> np.ndarray:
    """RE:TR's pad_mask_to_max: True around, floor(diff / 2) before."""
    h, w = mask.shape
    m = max(h, w)
    out = np.ones((m, m), bool)
    y, x = (m - h) // 2, (m - w) // 2
    out[y:y + h, x:x + w] = mask
    return out


def stream(img: np.ndarray, mask: np.ndarray, side: int):
    """Pad and resize one stream: (uint8 [side, side, 3], bool [side, side])."""
    m = pad_mask(mask)
    w = bilinear_weights(m.shape[0], side)
    return pil_resize(pad_image(img), side), (w @ m.astype(np.float64) @ w.T) != 0.0


def location_features(shape, box) -> np.ndarray:
    ih, iw = shape[:2]
    x, y, w, h = (float(v) for v in box)
    return np.array([x / iw, y / ih, (x + w) / iw, (y + h) / ih, (w * h) / (iw * ih)], np.float32)


def sample(image: np.ndarray, box, side: int, use_global: bool, use_loc: bool) -> dict:
    """One request's model inputs on the host (numpy)."""
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    x, y, w, h = (int(round(float(v))) for v in box)
    target = image[y:y + h, x:x + w]
    out = {}
    out["img"], out["mask"] = stream(target, np.zeros(target.shape[:2], bool), side)
    if use_global:
        context = image.copy()
        context[y:y + h, x:x + w] = 0
        cmask = np.zeros(image.shape[:2], bool)
        cmask[y:y + h, x:x + w] = True
        out["g_img"], out["g_mask"] = stream(context, cmask, side)
    if use_loc:
        out["loc"] = location_features(image.shape, box)
    return out


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] uint8 -> [B, 3, S, S] float32, ToTensor + Normalize."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_u8.device)
    return ((img_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def batch(samples, device) -> dict:
    """Stack host samples into model inputs on ``device`` (images normalized)."""
    out = {}
    for key in samples[0]:
        t = torch.as_tensor(np.stack([s[key] for s in samples])).to(device)
        out[key] = normalize(t) if key in ("img", "g_img") else t
    return out
