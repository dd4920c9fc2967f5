"""The plain reference's verdict on beam search's served tokens.

Beam search serves tokens that need not be the best at their prefix, but
each is inside its prefix's top ``beams``: a token with ``beams`` better
siblings from the same prefix cannot survive the combined top-k, and with no
finished beam the length penalty ranks hypotheses of equal length alike. So
a served beam token is judged by how far its reference logit lies below the
reference's ``beams``-th best at that prefix, 0 inside the top ``beams``
(logits and log-probabilities of one prefix differ by the same constant).
Any beam's path passes that test, so it does not see which of the final
beams is served, nor the combined top-k's choice among the rows' top
``beams`` candidates: in bfloat16 the served hypothesis's score moves as far
from a float32 beam search's best as the last beam lies from the first.

The control is ``judge.py``'s (float8 e4m3 weights computed in bfloat16): at
each position of the same prompts and tokens it reads the widest gap among
the tokens the control puts in its top ``beams``, any of which its beams
could keep.
"""

from __future__ import annotations

import torch

from portbench.reference import preprocess
from portbench.reference.judge import _forward


@torch.no_grad()
def beam_gaps(model, samples, served: torch.Tensor, bos: int, beams: int, *, control=None,
              block: int = 16) -> torch.Tensor:
    """[N, T] gaps of the served beam tokens (``served`` [N, T], after BOS)
    below the reference's ``beams``-th best logit at their prefix, 0 inside
    the top ``beams``; with ``control``, at each position the widest such gap
    among the tokens the control model puts in its top ``beams``."""
    device = served.device
    inp = preprocess.batch(samples, device)
    caps = torch.cat([torch.full((served.shape[0], 1), bos, dtype=served.dtype, device=device), served], 1)
    out = []
    for lo in range(0, served.shape[0], block):
        hi = min(lo + block, served.shape[0])
        logits = _forward(model, inp, caps, lo, hi)
        kth = logits.topk(beams, -1).values[..., -1:]
        chosen = served[lo:hi, :, None] if control is None else _forward(control, inp, caps, lo, hi).topk(
            beams, -1).indices
        out.append((kth - logits.gather(-1, chosen.long())).clamp_min(0).amax(-1))
        del logits
    return torch.cat(out)
