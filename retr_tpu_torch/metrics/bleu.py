"""Corpus BLEU-1..4, pycocoevalcap-compatible (the scorer nlgeval wraps).

A copy of retr_tpu/metrics/bleu.py: the port imports nothing of retr_tpu.

Matches the algorithm used by the reference's metric stack (engine.py:135-137,184-185
via the Maluuba nlg-eval submodule), i.e. pycocoevalcap's BleuScorer with
option='closest' exactly:

  - per-segment effective reference length = the reference length closest to the
    hypothesis length, ties broken toward the SHORTER reference (upstream computes
    ``min((abs(l - testlen), l) for l in reflens)[1]``, so equidistant lengths
    resolve by the second tuple element);
  - corpus totals of clipped n-gram matches with tiny=1e-15 / small=1e-9 smoothing
    and a progressive product over orders;
  - brevity penalty exp(1 - 1/ratio) applied to every order when
    ratio = (testlen + tiny) / (reflen + small) < 1.

Differentially tested against a transcription of the upstream scorer in
tests/pycoco_oracle.py (tests/test_metrics_oracle.py).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i : i + n]) for i in range(len(words) - n + 1))


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    # pycocoevalcap bleu_scorer.py: min((abs(l-testlen), l)) — tie -> shorter ref.
    return min((abs(rl - testlen), rl) for rl in reflens)[1]


def corpus_bleu(
    references: List[List[str]], hypotheses: List[str], max_n: int = 4
) -> Tuple[List[float], List[List[float]]]:
    """references[i] = list of ref strings for segment i; hypotheses[i] = hyp string.

    Returns ([BLEU-1..max_n corpus scores], per-order per-segment scores are not
    tracked individually — nlgeval reports corpus scores only).
    """
    assert len(references) == len(hypotheses)
    correct = [0] * max_n
    guess = [0] * max_n
    testlen_total = 0.0
    reflen_total = 0.0

    for refs, hyp in zip(references, hypotheses):
        hyp_words = hyp.split()
        refs_words = [r.split() for r in refs]
        testlen_total += len(hyp_words)
        reflen_total += _closest_reflen([len(r) for r in refs_words], len(hyp_words))
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp_words, n)
            max_ref: Dict[tuple, int] = {}
            for rw in refs_words:
                for ng, c in _ngrams(rw, n).items():
                    if c > max_ref.get(ng, 0):
                        max_ref[ng] = c
            correct[n - 1] += sum(min(c, max_ref.get(ng, 0)) for ng, c in hyp_ng.items())
            guess[n - 1] += max(0, len(hyp_words) - n + 1)

    tiny, small = 1e-15, 1e-9
    bleus = []
    score = 1.0
    for n in range(max_n):
        score *= (correct[n] + tiny) / (guess[n] + small)
        bleus.append(score ** (1.0 / (n + 1)))
    ratio = (testlen_total + tiny) / (reflen_total + small)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus, []
