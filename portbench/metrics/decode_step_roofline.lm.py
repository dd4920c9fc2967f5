"""One decode step of the LM decoder against its roofline, in percent: the
mean least time of a step's required work over steps 0..30 at the cell's rows
and prefix (``lm_work.decode_step_bound_s``: every weight once, each row's
cached latents once, the head; operations of the absorbed form and the
routed pairs alone) over the mean device time of one step of the profiled
pass's decode loops.

The loop's device time is the union of the operations launched inside an
``eval.decode`` span (a batch's decode) but outside its ``decode.encode``
(the RE:TR encoder) and ``decode.prefill`` (the prefix) spans: the steps, the
stop checks' reads and the prologue's token buffer; over the loop's steps a
batch. No kernel name is read. None where the pass ran no LM decode."""

import bisect

from portbench import launches, lm_work, work
from portbench import spans as program


def _intervals_us(spans, name):
    return sorted((s["start_ns"] / 1e3, s["end_ns"] / 1e3) for s in program.named(spans, name))


def _inside(intervals, t):
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def read(ctx):
    prof, spans = ctx.get("profile"), program.recorded()
    if not prof or not spans or ctx["cfg"].get("decoder_kind") != "lm":
        return None
    decodes = _intervals_us(spans, "eval.decode")
    others = _intervals_us(spans, "decode.encode"), _intervals_us(spans, "decode.prefill")
    if not others[1]:
        return None
    busy = launches.launched_busy_s(prof, lambda t: _inside(decodes, t) and not any(_inside(o, t) for o in others))
    if not busy:
        return None
    c = ctx["cfg"]
    bound = lm_work.decode_step_bound_s(c, ctx["traffic"]["batch"], work.memory_tokens(c), ctx["steps"])
    return 100.0 * bound / (busy / (len(decodes) * ctx["steps"]))
