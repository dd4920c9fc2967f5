"""Device-side input finishing: uint8 batch -> normalized tensors on the device,
with colour jitter when training (retr_tpu/data/pipeline.py).

Order matches the reference transform stack (refcoco.py:147-152): resize (host,
PIL-exact) -> ColorJitter (train only) -> ToTensor+Normalize.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from retr_tpu_torch.data.dataset import HostBatch
from retr_tpu_torch.models import layers
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


def finish_images(img_u8: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, S, S, 3] uint8 -> [B, 3, S, S] f32: colour jitter drawn from
    ``generator`` (when given), then ToTensor + Normalize."""
    x = img_u8.float()
    if generator is not None:
        x = imops.apply_color_jitter(x, imops.jitter_draws(generator, x.shape[0], x.device))
    mean = torch.tensor(imops.IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(imops.IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2)


def device_batch(host: HostBatch, device: torch.device, *, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> Batch:
    """HostBatch (numpy, uint8) -> Batch on ``device`` (normalized f32).

    ``train`` jitters the images, as JAX's ``device_batch(train=True, key=)``
    does, and needs ``generator``: only its seed is read. Target and context
    images draw from two generators made from ``fold_in(seed, 0)`` and
    ``fold_in(seed, 1)``, as JAX splits its key in two."""
    if train and generator is None:
        raise ValueError("training pipeline needs a generator for augmentation")

    def put(a):
        return None if a is None else torch.as_tensor(a).to(device)

    def gen(j):
        return layers.make_generator(layers.fold_in(generator.initial_seed(), j), device) if train else None

    g = host.context_images
    return Batch(
        images=finish_images(put(host.target_images), gen(0)),
        image_masks=put(host.target_masks),
        caps=put(host.caps),
        cap_masks=put(host.cap_masks),
        global_images=None if g is None else finish_images(put(g), gen(1)),
        global_masks=put(host.context_masks),
        loc_feats=put(host.loc_feats),
    )
