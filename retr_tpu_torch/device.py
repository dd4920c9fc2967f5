"""Device choice for the port's entry points: CUDA unless the caller says otherwise."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Asking for CUDA where there is none raises: the
    port never falls back to the CPU on its own (pass ``device="cpu"`` to run the
    plain PyTorch path)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain CPU path"
        )
    return dev
