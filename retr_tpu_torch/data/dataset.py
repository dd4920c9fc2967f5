"""Batch assembly on the host (the ``collate`` half of retr_tpu/data/dataset.py).

The annotation loader and the prefetching DataLoader belong to the evaluation and
training slices and are not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from retr_tpu_torch.data.preprocess import Sample


class HostBatch(NamedTuple):
    """Stacked numpy arrays, pre-device. None fields per the feature-flag matrix."""

    ann_ids: np.ndarray
    target_images: np.ndarray   # [B, S, S, 3] uint8
    target_masks: np.ndarray    # [B, S, S] bool
    caps: np.ndarray            # [B, T+1] int32
    cap_masks: np.ndarray       # [B, T+1] bool
    context_images: Optional[np.ndarray] = None
    context_masks: Optional[np.ndarray] = None
    loc_feats: Optional[np.ndarray] = None


def collate(samples: List[Sample]) -> HostBatch:
    first = samples[0]
    return HostBatch(
        ann_ids=np.asarray([s.ann_id for s in samples], np.int64),
        target_images=np.stack([s.target_image for s in samples]),
        target_masks=np.stack([s.target_mask for s in samples]),
        caps=np.stack([s.caption_ids for s in samples]),
        cap_masks=np.stack([s.caption_mask for s in samples]),
        context_images=(
            np.stack([s.context_image for s in samples]) if first.context_image is not None else None
        ),
        context_masks=(
            np.stack([s.context_mask for s in samples]) if first.context_mask is not None else None
        ),
        loc_feats=np.stack([s.loc_feats for s in samples]) if first.loc_feats is not None else None,
    )
