"""A traced slice whose device operations keep the host time of the CUDA
call that launched them (matched by CUPTI's correlation id; a graph's
kernels carry their ``cudaGraphLaunch``'s), so a reader can take the device
time of the work a host span launched. Otherwise the summary is
``portbench/profiler.py``'s."""

from __future__ import annotations

from portbench import profiler


class Trace(profiler.Trace):
    def stop(self) -> dict:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        dev, host, dev_corr, launch_at = [], [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            start = e.start_ns() / 1e3
            span = (start, start + e.duration_ns() / 1e3, e.name())
            if e.device_type() == DeviceType.CUDA:
                dev.append(span)
                dev_corr.append(e.correlation_id())
            else:
                host.append(span)
                if e.name().startswith("cu"):       # a CUDA runtime or driver call
                    launch_at[e.correlation_id()] = start
        summary = profiler.reduce(dev, host)
        summary["launched"] = [(s, e, launch_at[c]) for (s, e, _), c in zip(dev, dev_corr) if c in launch_at]
        return summary


def trace(fn) -> dict:
    """Profile one call of ``fn``, keeping each device operation's launch."""
    t = Trace()
    t.start()
    try:
        fn()
    finally:
        summary = t.stop()
    return summary


def busy_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        s = max(s, reach)
        if e > s:
            busy += e - s
            reach = e
    return busy / 1e6


def launched_busy_s(summary: dict, inside) -> float:
    """Device seconds (their intervals' union) of the operations whose
    launching API call started at a host time ``inside(t_us)`` accepts."""
    return busy_s((s, e) for s, e, at in summary.get("launched", ()) if inside(at))
