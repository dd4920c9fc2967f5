"""NLGEval-compatible facade over the native metric implementations.

A copy of retr_tpu/metrics/nlg.py: the port imports nothing of retr_tpu.

Mirrors the API the reference uses (engine.py:135-137,184-185):

    nlgeval = NLGEval(no_skipthoughts=True, no_glove=True, metrics_to_omit=[...])
    metrics = nlgeval.compute_metrics(ref_list=transposed_refs, hyp_list=hyps)

``ref_list`` is TRANSPOSED — ref_list[k][i] is the k-th reference of segment i —
exactly the shape the reference produces with ``zip(*references)`` (engine.py:181).
Returns {'Bleu_1'..'Bleu_4', 'METEOR', 'ROUGE_L', 'CIDEr'}.

Skipthoughts/GloVe embedding metrics are disabled in the reference call and are out
of scope (documented; they need pretrained downloads in nlg-eval too).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from retr_tpu_torch.metrics.bleu import corpus_bleu
from retr_tpu_torch.metrics.cider import cider
from retr_tpu_torch.metrics.meteor import meteor
from retr_tpu_torch.metrics.rouge import rouge_l


def compute_metrics(
    ref_list: Sequence[Sequence[str]],
    hyp_list: Sequence[str],
    metrics_to_omit: Optional[Sequence[str]] = None,
    meteor_resources=None,
) -> Dict[str, float]:
    omit = set(metrics_to_omit or ())
    # transpose [n_refs][n_segments] -> per-segment reference lists
    refs_per_seg: List[List[str]] = [list(rs) for rs in zip(*ref_list)]
    hyps = list(hyp_list)
    assert len(refs_per_seg) == len(hyps), (len(refs_per_seg), len(hyps))

    out: Dict[str, float] = {}
    if not {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"} <= omit:
        bleus, _ = corpus_bleu(refs_per_seg, hyps)
        for i, b in enumerate(bleus, 1):
            if f"Bleu_{i}" not in omit:
                out[f"Bleu_{i}"] = b
    if "METEOR" not in omit:
        # meteor_resources=None auto-discovers synonym/paraphrase data via the
        # RETR_METEOR_* environment variables (metrics/meteor.py drop-in path)
        out["METEOR"], _ = meteor(refs_per_seg, hyps, resources=meteor_resources)
    if "ROUGE_L" not in omit:
        out["ROUGE_L"], _ = rouge_l(refs_per_seg, hyps)
    if "CIDEr" not in omit:
        out["CIDEr"], _ = cider(refs_per_seg, hyps)
    return out


class NLGEval:
    """Drop-in for nlgeval.NLGEval as the reference instantiates it."""

    def __init__(self, no_skipthoughts: bool = True, no_glove: bool = True,
                 metrics_to_omit: Optional[Sequence[str]] = None,
                 meteor_resources=None):
        del no_skipthoughts, no_glove  # embedding metrics are out of scope
        self.metrics_to_omit = list(metrics_to_omit or [])
        self.meteor_resources = meteor_resources

    def compute_metrics(self, ref_list, hyp_list) -> Dict[str, float]:
        return compute_metrics(ref_list, hyp_list, self.metrics_to_omit,
                               meteor_resources=self.meteor_resources)
