"""The LM decoder's prefill against its roofline, in percent: the least time
the card could take for the prefills of the profiled pass's batches
(``lm_work.prefill_bound_s`` at each ``decode.prefill`` span's rows and the
cell's prefix length: max(operations / 989 TFLOP/s, bytes / 3.35 TB/s),
counting the routed (token, expert) pairs alone) over the device time of the
operations launched inside those spans (``launches.launched_busy_s``). No
kernel name is read, so the reading holds whatever kernels run the prefill.
None where the pass ran no prefill."""

import bisect

from portbench import launches, lm_work, work
from portbench import spans as program


def _inside(intervals, t):
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def read(ctx):
    prof, spans = ctx.get("profile"), program.recorded()
    if not prof or not spans or ctx["cfg"].get("decoder_kind") != "lm":
        return None
    pre = program.named(spans, "decode.prefill")
    intervals = sorted((s["start_ns"] / 1e3, s["end_ns"] / 1e3) for s in pre)
    busy = launches.launched_busy_s(prof, lambda t: _inside(intervals, t))
    if not busy:
        return None
    c = ctx["cfg"]
    bound = sum(lm_work.prefill_bound_s(c, s["attrs"]["rows"], work.memory_tokens(c)) for s in pre)
    return 100.0 * bound / busy
