"""CIDEr (consensus-based image description evaluation), pycocoevalcap-compatible.

A copy of retr_tpu/metrics/cider.py: the port imports nothing of retr_tpu.

The variant nlgeval computes for the reference's per-epoch early-stopping signal
(main.py:85-87, engine.py:184-185): tf-idf 1-4-gram vectors with corpus document
frequency over the reference sets, min-clipped cosine similarity, Gaussian length
penalty (sigma=6), averaged over orders and references, scaled by 10.

Matches pycocoevalcap's cider_scorer.py exactly, including the upstream quirk
that the sentence "length" used by the Gaussian penalty is the total BIGRAM term
frequency (its counts2vec accumulates ``if n == 1`` where n = len(ngram)-1), not
the word count. Differentially tested against a transcription of the upstream
scorer in tests/pycoco_oracle.py (tests/test_metrics_oracle.py).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple


def _ngram_counts(words: List[str], max_n: int = 4) -> List[Counter]:
    # zip emits the n-gram tuples in C (same tuples as slicing, ~2x faster)
    return [Counter(zip(*[words[i:] for i in range(n)])) for n in range(1, max_n + 1)]


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute(self, references: List[List[str]], hypotheses: List[str]) -> Tuple[float, List[float]]:
        crefs = [[_ngram_counts(r.split(), self.n) for r in refs] for refs in references]
        ctest = [_ngram_counts(h.split(), self.n) for h in hypotheses]

        # document frequency over reference sets: one increment per image per distinct
        # ngram appearing in ANY of its references.
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            seen = set()
            for ref_counts in refs:
                for n_counts in ref_counts:
                    seen.update(n_counts.keys())
            for ng in seen:
                doc_freq[ng] += 1.0

        ref_len = math.log(float(len(crefs)))

        # idf factor per distinct ngram, computed once (identical arithmetic to the
        # per-occurrence log(max(df, 1)) it replaces); unseen ngrams have df=0 -> ref_len
        idf = {ng: ref_len - math.log(max(df, 1.0)) for ng, df in doc_freq.items()}
        idf_get = idf.get

        def counts2vec(counts_per_n):
            vec = [{} for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for n_idx, n_counts in enumerate(counts_per_n):
                v = vec[n_idx]
                acc = 0.0
                for ng, tf in n_counts.items():
                    w = float(tf) * idf_get(ng, ref_len)
                    v[ng] = w
                    acc += w * w
                    if n_idx == 1:  # upstream quirk: length = bigram tf total
                        length += tf
                norm[n_idx] = math.sqrt(acc)
            return vec, norm, length

        def sim(vh, nh, lh, vr, nr, lr):
            delta = float(lh - lr)
            penalty = math.e ** (-(delta ** 2) / (2 * self.sigma ** 2))
            val = [0.0] * self.n
            for n_idx in range(self.n):
                b = vr[n_idx]
                b_get = b.get
                s = 0.0
                # iterate vh in insertion order (upstream order; zero vr entries add
                # exact 0.0 there, so skipping them is bitwise-identical)
                for ng, c in vh[n_idx].items():
                    r = b_get(ng)
                    if r is not None:
                        s += min(c, r) * r
                if nh[n_idx] != 0 and nr[n_idx] != 0:
                    s /= nh[n_idx] * nr[n_idx]
                val[n_idx] = s * penalty
            return val

        scores = []
        for test_counts, refs in zip(ctest, crefs):
            vh, nh, lh = counts2vec(test_counts)
            acc = [0.0] * self.n
            for ref_counts in refs:
                vr, nr, lr = counts2vec(ref_counts)
                s = sim(vh, nh, lh, vr, nr, lr)
                for i in range(self.n):
                    acc[i] += s[i]
            score_avg = sum(acc) / self.n / len(refs) * 10.0
            scores.append(score_avg)

        return sum(scores) / len(scores), scores


def cider(references: List[List[str]], hypotheses: List[str]) -> Tuple[float, List[float]]:
    return CiderScorer().compute(references, hypotheses)
