"""The readers of the program's spans (``portbench/metrics/*.py`` with
``"source": "program_span"``) on hand-made span lists against hand-worked
values: children inside parents, two threads, the self-time subtraction,
and None where the program kept no span or has no tracer; and a traced run
of each tiny CPU cell, whose new metrics are read from the spans of its
traced slice."""

import builtins
import os

import pytest
import torch

from portbench import harness
from portbench import spans as program

MS = 1_000_000  # ns


def _reader(name):
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    return harness.load_module(path, "spans_test_" + name.replace(".", "_"))


def _span(i, name, start_ms, end_ms, parent=None, thread=1, **attrs):
    return {"name": name, "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS), "id": i, "parent": parent,
            "thread": thread, "attrs": attrs}


@pytest.fixture
def kept(monkeypatch):
    box = []
    monkeypatch.setattr(program, "recorded", lambda: box)
    return box


# the serving queue: two batches on the dispatcher (thread 1), their
# detokenizing on the collector (thread 2), four requests' waits
SERVE = [
    _span(1, "serve.queue_wait", 0, 10, request=0, batch=0),
    _span(2, "serve.queue_wait", 2, 10, request=1, batch=0),
    _span(3, "serve.queue_wait", 11, 14, request=2, batch=1),
    _span(4, "serve.queue_wait", 12, 14, request=3, batch=1),
    _span(5, "serve.preprocess", 10, 12, batch=0, rows=2),
    _span(6, "serve.dispatch", 12, 30, batch=0, rows=2),
    _span(7, "decode.encode", 12, 15, parent=6, rows=2),
    _span(8, "decode.loop", 15, 30, parent=6),
    _span(9, "decode.stop_check", 15, 15.5, parent=8),
    _span(10, "decode.stop_check", 20, 25, parent=8),
    _span(11, "serve.preprocess", 30, 31, batch=1, rows=2),
    _span(12, "serve.dispatch", 31, 41, batch=1, rows=2),
    _span(13, "decode.loop", 32, 41, parent=12),
    _span(14, "decode.stop_check", 35, 39, parent=13),
    # a stop check of another thread's loop, inside batch 1's interval: not its child
    _span(15, "decode.loop", 33, 40, thread=2),
    _span(16, "decode.stop_check", 36, 38, parent=15, thread=2),
    _span(17, "serve.detokenize", 31, 32, thread=2, batch=0, rows=2),
]


def test_queue_wait_p95_inverted_cdf(kept):
    kept.extend(SERVE)
    # waits 10, 8, 3, 2 ms: the 95th percentile by inverted_cdf is the largest
    assert _reader("queue_wait_ms.serve").read({}) == pytest.approx(10.0)
    kept[:] = [_span(i, "serve.queue_wait", 0, i + 1) for i in range(100)]
    assert _reader("queue_wait_ms.serve").read({}) == pytest.approx(95.0)


def test_dispatch_is_preprocess_plus_dispatch_less_its_own_stop_checks(kept):
    kept.extend(SERVE)
    # batch 0: 2 + (18 - 0.5 - 5) = 14.5; batch 1: 1 + (10 - 4) = 7 (thread 2's check not subtracted)
    assert _reader("dispatch_ms.serve").read({}) == pytest.approx((14.5 + 7.0) / 2)


def test_self_time_takes_the_union_of_overlapping_children():
    spans = [_span(1, "p", 0, 10), _span(2, "c", 1, 4, parent=1), _span(3, "m", 2, 6, parent=2),
             _span(4, "m", 3, 8, parent=1), _span(5, "m", 9, 12, parent=1)]
    # covered by "m" descendants: [2, 8] and [9, 10] -> 7 ms of 10
    assert program.self_ms(spans, spans[0], "m") == pytest.approx(3.0)
    assert program.self_ms(spans, spans[0], "absent") == pytest.approx(10.0)


def test_eval_readers(kept):
    kept.extend([
        _span(1, "eval.decode", 0, 20),
        _span(2, "decode.encode", 0, 6, parent=1, rows=512),
        _span(3, "decode.loop", 6, 20, parent=1),
        _span(4, "eval.decode", 20, 30),
        _span(5, "decode.encode", 20, 24, parent=4, rows=512),
        _span(6, "eval.collect", 30, 130, rows=512),
        _span(7, "eval.fetch", 30, 50, parent=6),
        _span(8, "eval.collect", 130, 190, rows=300),
        _span(9, "eval.fetch", 130, 135, parent=8),
        _span(10, "eval.fetch", 140, 150, thread=2),
    ])
    assert _reader("encode_ms.eval").read({}) == pytest.approx(5.0)
    # (100 - 20) and (60 - 5): another thread's fetch is no child
    assert _reader("collect_ms.eval").read({}) == pytest.approx((80.0 + 55.0) / 2)


def test_train_readers(kept):
    kept.extend([
        _span(1, "train.loader_wait", 0, 0.5, thread=1),
        _span(2, "train.device_batch", 0.5, 3.5, step=6),
        _span(3, "train.step", 3.5, 10, step=6),
        _span(4, "train.loader_wait", 10, 11.5, thread=1),
        _span(5, "train.device_batch", 11.5, 13.5, step=7),
        _span(6, "train.loader_wait", 1, 2, thread=3),
    ])
    assert _reader("loader_span_ms.train").read({}) == pytest.approx(1.0)
    assert _reader("device_batch_ms.train").read({}) == pytest.approx(2.5)


READERS = ["queue_wait_ms.serve", "dispatch_ms.serve", "encode_ms.eval", "collect_ms.eval",
           "loader_span_ms.train", "device_batch_ms.train"]


@pytest.mark.parametrize("name", READERS)
def test_no_span_reads_none(kept, name):
    kept.append(_span(1, "something.else", 0, 1))
    assert _reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_tracer_reads_none(monkeypatch, name):
    """The parent commit's program: ``profiling`` has no ``spans``, or the
    package is not there at all."""
    import retr_tpu_torch.utils.profiling as prof

    monkeypatch.delattr(prof, "spans")
    assert program.recorded() is None
    assert _reader(name).read({}) is None
    monkeypatch.undo()
    real = builtins.__import__

    def no_package(mod, *a, **kw):
        if mod.startswith("retr_tpu_torch"):
            raise ImportError(mod)
        return real(mod, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_package)
    assert program.recorded() is None
    assert _reader(name).read({}) is None


NEW = {"tiny-serve": ("latency_p95_ms", ["queue_wait_ms.serve", "dispatch_ms.serve"]),
       "tiny-sweep": ("captions_per_s", ["encode_ms.eval", "collect_ms.eval"]),
       "tiny-train": ("train_samples_per_s", ["loader_span_ms.train", "device_batch_ms.train"])}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_tiny_run_reads_its_spans(tmp_path, monkeypatch, name):
    """``run.execute`` with the trace on, at the tiny CPU size: the cell's new
    metrics are read, and the spans kept are those of the traced slice alone
    (one ``serve.queue_wait`` per request the traced window admitted, one
    ``eval.collect`` per batch of the profiled pass, one
    ``train.device_batch`` per profiled step after the first)."""
    from portbench import run, synth
    from portbench.drivers import train_epochs
    from portbench.tests import tiny
    from retr_tpu_torch.utils import profiling

    monkeypatch.setattr(synth, "POOL_IMAGES", 12)
    profiling.reset()
    root, bench = tiny.files(str(tmp_path / "files"))
    moves, metrics = NEW[name]
    bench["per_layer"] += [{"name": m, "unit": "ms", "moves": moves, "workloads": [name]} for m in metrics]
    work = next(w for w in bench["workloads"] if w["name"] == name)
    # train_epochs profiles from window step 5 on: fewer profiled steps, one thread each
    # (several test workers share the host), and a window long enough to reach them
    monkeypatch.setattr(train_epochs, "PROFILED_STEPS", 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    seconds = 10.0 if name == "tiny-train" else 1.5
    try:
        res = run.execute(work, bench, 2 ** 32 + 5, seconds, True, device="cpu", files=root,
                          checkout=str(tmp_path / "checkout"))
    finally:
        torch.set_num_threads(threads)
    assert res["correct"]
    for m in metrics:
        assert res["metrics"][m]["value"] > 0, m
    counts = {}
    for s in profiling.spans():
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    traffic = tiny.TRAFFIC[name]
    if name == "tiny-serve":
        # correct: no errors and none unanswered, so every request not shed waited in the queue
        assert counts["serve.queue_wait"] == res["attempted"] - res["failed"] > 0
    elif name == "tiny-sweep":
        split = traffic["split"]
        assert counts["eval.collect"] == -(-split["objects"] // traffic["batch"])
    else:
        assert counts["train.device_batch"] == train_epochs.PROFILED_STEPS - 1
    assert profiling.counters().get("graphs.captures", 0) == 0  # CPU decodes capture no graph
    profiling.reset()
