"""The device's side of a traced run, from ``torch.profiler`` (CUPTI).

``trace(fn)`` profiles one call and reduces it: the union of the CUDA kernel
and copy intervals gives the busy time over the span from the first device
operation's start to the last one's end (the idle share is the rest); device
time is summed by operation name; each idle gap between device intervals is
named by the host operation that overlaps it most, which says what the host
was doing while the card waited.
"""

from __future__ import annotations

from collections import defaultdict


class Trace:
    """A profiler session that can start and stop inside a loop. Start and
    stop it only while no other thread launches CUDA work: started and stopped
    while a serving queue's threads replayed graphs, the profiler stalled the
    offering thread by seconds and hung one run in three. Threads that start
    after it and end before it stops are traced."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> dict:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        # the raw events: the profiler's own post-processing into an event
        # tree takes minutes once a slice holds hundreds of thousands of ops
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            start = e.start_ns() / 1e3
            span = (start, start + e.duration_ns() / 1e3, e.name())
            (dev if e.device_type() == DeviceType.CUDA else host).append(span)
        return reduce(dev, host)


def trace(fn) -> dict:
    """Profile one call of ``fn``."""
    t = Trace()
    t.start()
    try:
        fn()
    finally:
        summary = t.stop()
    return summary


def reduce(dev, host) -> dict:
    """(start_us, end_us, name) intervals of the device and of the host -> the
    summary the metric readers use."""
    if not dev:
        return {"kernels": {}, "busy_s": 0.0, "window_s": 0.0, "gaps": []}
    dev = sorted(dev)
    by_name, count = defaultdict(float), defaultdict(int)
    for s, e, n in dev:
        by_name[n] += e - s
        count[n] += 1
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = dev[-1][1] - dev[0][0]
    named = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        # the shortest host operation among those that cover (nearly) most of the gap
        cands = [(min(e, ge) - max(s, gs), e - s, n) for s, e, n in host if s < ge and e > gs]
        name = "no host operation"
        if cands:
            most = max(c[0] for c in cands)
            name = min((c for c in cands if c[0] >= 0.9 * most), key=lambda c: c[1])[2]
        named.append([name[:120], (ge - gs) / 1e6])
    return {"kernels": {n: {"s": t / 1e6, "count": count[n]} for n, t in by_name.items()},
            "busy_s": busy / 1e6, "window_s": span / 1e6, "gaps": named}


def breakdown(summary: dict) -> dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["s"])[:10]
    return {"device_ops": [[n[:120], v["s"]] for n, v in top], "idle_gaps": summary["gaps"]}


def kernel_time(summary: dict, fragment: str) -> tuple:
    """(seconds, launches) of every device operation whose name holds ``fragment``."""
    hits = [v for n, v in summary["kernels"].items() if fragment in n]
    return sum(v["s"] for v in hits), sum(v["count"] for v in hits)
