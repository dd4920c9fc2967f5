"""Profiling and debug guards (retr_tpu/utils/profiling.py).

- :class:`PhaseTimer`: wall-clock time per named phase (host wait, input,
  decode, fetch, score), with count, total, mean, median and max per phase.
  A phase that ends in a device read (``fetch``) is the barrier; the others
  time the host's enqueue.
- :func:`trace`: a ``torch.profiler`` context (CPU and, where there is a card,
  CUDA activity) that writes a Chrome trace into ``logdir`` on exit.
- :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``, so the
  backward op that makes a NaN raises where it happens instead of surfacing
  as a poisoned loss.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, List


class PhaseTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "p50_s": statistics.median(xs),
                "max_s": max(xs),
            }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block; the trace lands in
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    import torch

    torch.autograd.set_detect_anomaly(enable)
