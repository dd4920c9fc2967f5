"""Matmul/convolution precision and storage-type policy.

Mirrors retr_tpu/precision.py for the GPU:

- ``float32`` is the parity configuration: full f32 products and convolutions.
  PyTorch's matmuls default to full f32, but cuDNN convolutions default to TF32
  (about three decimal digits), so both switches are turned off explicitly.
- ``bfloat16`` is the throughput configuration: the decode loop stores its
  weights, memory and caches in bf16 (decode._cast_for_decode) and the f32
  products left outside it may use TF32, the GPU's counterpart of the TPU's
  DEFAULT precision.

The switches are process-wide PyTorch state; :func:`matmul_precision` sets them
for the duration of a call and restores them after.
"""

from __future__ import annotations

import contextlib

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    """Config.compute_dtype string (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[name]


@contextlib.contextmanager
def matmul_precision(compute_dtype):
    allow_tf32 = dtype_of(compute_dtype) != torch.float32
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
