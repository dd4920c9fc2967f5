"""retr_tpu_torch — the PyTorch/CUDA port of retr_tpu for NVIDIA Hopper.

Serves referring expressions (greedy, beam, sampling, prefix completion,
scores and attention maps; ``predictor.Predictor``, the batching
``predictor.ServingQueue`` and the HTTP server ``serve``): host preprocessing
in a C++ core (``native/``, built with g++ on first use), a ResNet backbone,
the 6-layer encoder run once, and a KV-cached loop whose decoder layers run in
hand-written CUDA kernels (``ops/decoder_kernels.py``,
``csrc/stack_kernels.cu``, ``csrc/block_kernels.cu``, ``csrc/head_kernels.cu``,
and ``csrc/width_kernels.cu`` at other widths). Trains and evaluates
the teacher-forced model (``train/state.py``); with
``Config.use_pallas_attention`` every attention core without attention dropout
runs in the fused attention kernel (``ops/attention.py``,
``csrc/attention_kernels.cu``). Module names follow ``retr_tpu`` so each piece
has an obvious counterpart; the JAX package is the reference the tests hold
this one against. Nothing here imports ``jax`` or ``retr_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

from retr_tpu_torch.config import Config

__all__ = ["Config"]
