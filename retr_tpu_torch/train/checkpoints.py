"""Reference ``.pth`` checkpoints (the interop half of retr_tpu/train/checkpoints.py).

The reference saves ``{"model_state_dict": ..., "epoch": ..., ...}``; the
port's state dict uses the reference's module names (models/weights.py), so
``model_state_dict`` goes to ``weights.to_params`` as it is. The reference
encodes the model variant in the file name, which
:func:`override_config_with_reference_filename` reads. The port's own
checkpoint format comes later (ROADMAP A11).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from retr_tpu_torch.config import Config

METADATA_KEYS = ("epoch", "train_loss", "val_loss", "cider_score")


def override_config_with_reference_filename(cfg: Config, checkpoint_path: str) -> Config:
    """The reference's file-name sniffing for ``.pth`` files: 'loc_glob_checkpoint'
    selects location and global features, 'loc_checkpoint' location only."""
    name = os.path.basename(checkpoint_path)
    if "loc_glob_checkpoint" in name:
        return cfg.replace(use_location_features=True, use_global_features=True)
    if "loc_checkpoint" in name:
        return cfg.replace(use_location_features=True, use_global_features=False)
    return cfg.replace(use_location_features=False, use_global_features=False)


def load_reference_state(pth_path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(model_state_dict, its metadata) of a reference ``.pth`` file, on the
    CPU. A file without ``model_state_dict`` is taken as the state dict itself.
    The file is unpickled as the reference wrote it: load only checkpoints you
    trust."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=False)
    state = blob.get("model_state_dict", blob)
    return state, {k: blob[k] for k in METADATA_KEYS if k in blob}
