"""retr_tpu_torch — the PyTorch/CUDA port of retr_tpu for NVIDIA Hopper.

Serves referring expressions (greedy, beam, sampling, prefix completion,
scores and attention maps; ``predictor.Predictor``, the batching
``predictor.ServingQueue`` and the HTTP server ``serve``): host preprocessing
in a C++ core (``native/``, built with g++ on first use), a ResNet backbone,
the 6-layer encoder run once, and a KV-cached loop whose decoder layers run in
hand-written CUDA kernels (``ops/decoder_kernels.py``,
``csrc/stack_kernels.cu``, ``csrc/block_kernels.cu``, ``csrc/head_kernels.cu``,
and ``csrc/width_kernels.cu`` at other widths). Trains and evaluates
the teacher-forced model (``train/state.py``) on RefCOCO (``data/dataset.py``,
colour jitter in ``data/pipeline.py``) through ``engine.py``, which scores
generated expressions with BLEU, METEOR, ROUGE-L and CIDEr (``metrics/``); with
``Config.use_pallas_attention`` every attention core without attention dropout
runs in the fused attention kernel (``ops/attention.py``,
``csrc/attention_kernels.cu``). Module names follow ``retr_tpu`` so each piece
has an obvious counterpart; the JAX package is the reference the tests hold
this one against. Nothing here imports ``jax`` or ``retr_tpu``.

Trains from scratch (``models/caption.build_model``) or from a reference
``.pth``, saves and resumes its own checkpoint directories
(``train/checkpoints.py``) and exports them as reference ``.pth`` files; the
command lines are ``main`` (train), ``eval_model`` and ``export_pth``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

from retr_tpu_torch.config import Config

_LAZY = {  # top-level name -> module that defines it, imported on first use
    "Predictor": "predictor", "ServingQueue": "predictor",
    "build_model": "models.caption",
    **{name: "decode" for name in ("greedy", "beam_search", "sample", "greedy_with_prefix",
                                   "sequence_scores", "greedy_decoding", "greedy_with_attention")},
    "NLGEval": "metrics",
    "Masked": "masking",
}

__all__ = ["Config", *_LAZY]


def __getattr__(name):
    """The lazy top-level API of retr_tpu/__init__.py:33-56: ``import
    retr_tpu_torch`` stays light."""
    if name not in _LAZY:
        raise AttributeError(f"module 'retr_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"retr_tpu_torch.{_LAZY[name]}"), name)
