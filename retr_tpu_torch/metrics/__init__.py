"""The NLG metrics (BLEU 1-4, METEOR, ROUGE-L, CIDEr) that score every
evaluation: a copy of retr_tpu/metrics."""

from retr_tpu_torch.metrics.nlg import NLGEval, compute_metrics  # noqa: F401
