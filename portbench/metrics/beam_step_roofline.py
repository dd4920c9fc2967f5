"""One beam-search decode step's share of its roofline, in percent: the mean
roofline time of a step's required work over steps 0-126 at the cell's rows
(batch x beams) and memory length (``beam_work.beam_step_bound_s``: six
layers of self-attention, cross-attention and FF and the top-k head, K/V and
cache prefixes read once per group of beams), over the mean device time of one
step of the profiled pass's decode loops.

The decode loop's device time is told from the encoder's by the host span
that launched it, not by kernel names, so the reading holds whatever kernels
implement the step: each device operation goes with the CUDA call that
launched it (``launches.launched_busy_s``), and those launched inside an
``eval.decode`` span (a batch's decode) but outside its ``decode.encode``
span (the backbone, the encoder and the cast for the decode) are the loop's:
its prologue (the cross K/V), its 127 steps, the stop checks' reads and the
ranking of the finished beams. Their union's seconds over 127 steps a batch
is the step's device time. None where the pass decoded no beams."""

import bisect

from portbench import beam_work, launches, work
from portbench import spans as program


def _intervals_us(spans, name):
    return sorted((s["start_ns"] / 1e3, s["end_ns"] / 1e3) for s in program.named(spans, name))


def _inside(intervals, t):
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def read(ctx):
    prof, spans = ctx.get("profile"), program.recorded()
    if not prof or not spans or ctx["traffic"].get("decoder") != "beam":
        return None
    decodes, encodes = _intervals_us(spans, "eval.decode"), _intervals_us(spans, "decode.encode")
    busy = launches.launched_busy_s(prof, lambda t: _inside(decodes, t) and not _inside(encodes, t))
    if not busy:
        return None
    cfg, beams = ctx["cfg"], ctx["beams"]
    bound = beam_work.beam_step_bound_s(ctx["traffic"]["batch"] * beams, work.memory_tokens(cfg), beams=beams,
                                   steps=ctx["steps"], dtype=cfg["compute_dtype"], layers=cfg["dec_layers"],
                                   c=cfg["hidden_dim"], heads=cfg["nheads"], f=cfg["dim_feedforward"],
                                   t=cfg["max_position_embeddings"], vocab=cfg["vocab_size"])
    return 100.0 * bound / (busy / (len(decodes) * ctx["steps"]))
