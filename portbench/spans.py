"""The program's own spans (``retr_tpu_torch/utils/profiling.py``), as the
per-layer readers of ``portbench/metrics/`` read them.

The program records its spans while a ``torch.profiler`` session runs, so a
``--trace 1`` run holds those of its traced slice, in this process, after
the window. A program without the tracer gives None, and so does each
reader. A span's self time is its duration less the part of it that the
named descendants (on its thread, by parent id) cover.
"""

from __future__ import annotations


def recorded():
    """Every span the program kept, or None where it keeps none."""
    try:
        from retr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def named(spans, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def mean_ms(spans, name: str):
    """The mean duration of the spans named ``name``, in ms, or None."""
    hits = named(spans or [], name)
    return sum(ms(s) for s in hits) / len(hits) if hits else None


def self_ms(spans, s: dict, less: str) -> float:
    """``s``'s duration less the union of its descendants named ``less``, in ms."""
    parent = {x["id"]: x["parent"] for x in spans}
    cuts = []
    for x in named(spans, less):
        p = x["parent"]
        while p is not None and p != s["id"]:
            p = parent.get(p)
        if p is not None:
            cuts.append((max(x["start_ns"], s["start_ns"]), min(x["end_ns"], s["end_ns"])))
    covered, reach = 0, s["start_ns"]
    for a, b in sorted(cuts):
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return ms(s) - covered / 1e6
