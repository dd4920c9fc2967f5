"""retr_tpu_torch — the PyTorch/CUDA port of retr_tpu for NVIDIA Hopper.

Serves greedy referring expressions: host preprocessing, a ResNet backbone,
the 6-layer encoder run once, and a KV-cached greedy loop whose decoder layers
run in hand-written CUDA kernels (``ops/decoder_kernels.py``,
``csrc/decoder_kernels.cu``). Module names follow ``retr_tpu`` so each piece
has an obvious counterpart; the JAX package is the reference the tests hold
this one against. Nothing here imports ``jax`` or ``retr_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

from retr_tpu_torch.config import Config

__all__ = ["Config"]
