"""Profiling, tracing and debug guards (retr_tpu/utils/profiling.py).

- :class:`PhaseTimer`: wall-clock time per named phase (host wait, input,
  decode, fetch, score), with count, total, mean, median and max per phase.
  A phase that ends in a device read (``fetch``) is the barrier; the others
  time the host's enqueue. Each phase is also the span ``eval.<phase>``.
- The program's tracer: :func:`span` (a context manager), :func:`record`
  (a span whose start was stamped elsewhere, by :func:`now`) and
  :func:`count` (a counter); :func:`enable` / :func:`disable`,
  :func:`spans`, :func:`counters` and :func:`reset` for whoever reads them.
- :func:`trace`: a ``torch.profiler`` context (CPU and, where there is a card,
  CUDA activity) that writes a Chrome trace into ``logdir`` on exit.
- :func:`enable_nan_debugging`: ``torch.autograd.set_detect_anomaly``, so the
  backward op that makes a NaN raises where it happens instead of surfacing
  as a poisoned loss.

Spans record while a ``torch.profiler`` session is active or after
:func:`enable`; otherwise :func:`span` checks two flags and returns a shared
no-op context. A recorded span keeps its name, start and end in
``time.time_ns()`` (the clock the profiler stamps its CPU events with), its
id and its parent's (the innermost span open on the same thread), the
thread and its attributes (``batch``, ``request``, ``rows``, ``step``).
While a profiler is active it is also a ``torch.profiler.record_function``
range, so it shows on the Chrome trace beside the kernels. Spans stay in
memory, at most ``CAP`` of them (the oldest go first, counted in
``dropped``), until :func:`reset`. Counters always count: an integer add
under the tracer's lock.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 200_000  # spans kept in memory


class _Off:
    """The span of a tracer that is not recording: enters, exits, keeps nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def cancel(self) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "start", "annotation", "cancelled")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs, self.cancelled = tracer, name, attrs, False

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.tracer._ids)
        stack.append(self.id)
        self.annotation = None
        self.start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        self.tracer._stack().pop()
        if not self.cancelled:
            self.tracer._keep((self.name, self.start, end, self.id, self.parent, threading.get_ident(), self.attrs))
        return False

    def cancel(self) -> None:
        """Keep no record of this span (the wait it timed turned out to be for nothing)."""
        self.cancelled = True


class Tracer:
    """Spans and counters of one process (the module's docstring)."""

    def __init__(self, cap: int = CAP):
        self.on = False
        self.dropped = 0
        self._store: deque = deque(maxlen=cap)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._counters: Dict[str, float] = {}

    def recording(self) -> bool:
        return self.on or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, **attrs):
        if self.on or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name, attrs)
        return _OFF

    def record(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A span from ``start_ns`` to ``end_ns`` with no parent, kept if the
        tracer is recording: a wait that starts on one thread and ends on
        another."""
        if self.recording():
            self._keep((name, start_ns, end_ns, next(self._ids), None, threading.get_ident(), attrs))

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> List[dict]:
        with self._lock:
            kept = list(self._store)
        return [{"name": n, "start_ns": s, "end_ns": e, "id": i, "parent": p, "thread": t, "attrs": a}
                for n, s, e, i, p, t, a in kept]

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._store.clear()
            self.dropped = 0
            self._counters.clear()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: tuple) -> None:
        with self._lock:
            if len(self._store) == self._store.maxlen:
                self.dropped += 1
            self._store.append(rec)


TRACER = Tracer()
span = TRACER.span
record = TRACER.record
count = TRACER.count
recording = TRACER.recording
spans = TRACER.spans
counters = TRACER.counters
reset = TRACER.reset
now = time.time_ns


def enable() -> None:
    """Record spans with no profiler running."""
    TRACER.on = True


def disable() -> None:
    """Record spans only while a profiler runs (the default)."""
    TRACER.on = False


class PhaseTimer:
    """``eval_model``'s phases: host-clock seconds per phase, each phase also
    the span ``eval.<phase>``."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span("eval." + name):
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
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing), the
    program's spans on it as user annotations."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
