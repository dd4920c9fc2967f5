"""Device-side input finishing: uint8 batch -> normalized tensors on the device
(the evaluation half of retr_tpu/data/pipeline.py; colour jitter belongs to
training and is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from retr_tpu_torch.data.dataset import HostBatch
from retr_tpu_torch.ops import image as imops


class Batch(NamedTuple):
    """One model-ready batch on the device."""

    images: torch.Tensor        # [B, 3, H, W] f32 normalized
    image_masks: torch.Tensor   # [B, H, W] bool
    caps: torch.Tensor          # [B, T+1] int32
    cap_masks: torch.Tensor     # [B, T+1] bool (True = pad)
    global_images: Optional[torch.Tensor] = None
    global_masks: Optional[torch.Tensor] = None
    loc_feats: Optional[torch.Tensor] = None


def finish_images(img_u8: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] uint8 -> [B, 3, S, S] f32, ToTensor + Normalize."""
    x = img_u8.float()
    mean = torch.tensor(imops.IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(imops.IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)


def device_batch(host: HostBatch, device: torch.device) -> Batch:
    """HostBatch (numpy, uint8) -> Batch on ``device`` (normalized f32)."""
    def put(a):
        return None if a is None else torch.as_tensor(a).to(device)

    g = host.context_images
    return Batch(
        images=finish_images(put(host.target_images)),
        image_masks=put(host.target_masks),
        caps=put(host.caps),
        cap_masks=put(host.cap_masks),
        global_images=None if g is None else finish_images(put(g)),
        global_masks=put(host.context_masks),
        loc_feats=put(host.loc_feats),
    )
