"""ROUGE-L F-measure, pycocoevalcap-compatible (beta=1.2, max over references).

A copy of retr_tpu/metrics/rouge.py: the port imports nothing of retr_tpu.

Matches pycocoevalcap's rouge.py exactly, including its ``split(" ")``
tokenization (an empty string becomes [''], one token — so an empty hypothesis
against an empty reference scores 1.0, and runs of spaces produce empty tokens).
Differentially tested against a transcription of the upstream scorer in
tests/pycoco_oracle.py (tests/test_metrics_oracle.py).
"""

from __future__ import annotations

from typing import List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(references: List[List[str]], hypotheses: List[str], beta: float = 1.2) -> Tuple[float, List[float]]:
    scores = []
    for refs, hyp in zip(references, hypotheses):
        hw = hyp.split(" ")  # upstream uses split(" "), not split()
        precs, recs = [], []
        for r in refs:
            rw = r.split(" ")
            lcs = _lcs_len(hw, rw)
            precs.append(lcs / float(len(hw)))
            recs.append(lcs / float(len(rw)))
        p, r = max(precs), max(recs)
        if p != 0 and r != 0:
            f = ((1 + beta ** 2) * p * r) / float(r + beta ** 2 * p)
        else:
            f = 0.0
        scores.append(f)
    return sum(scores) / len(scores), scores
