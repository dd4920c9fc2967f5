"""The port's tracer (retr_tpu_torch/utils/profiling.py) and the spans and
counters the program records with it.

- off by default: a span records nothing and enters no ``record_function``;
  counters count anyway; the off cost of a span is timed into the junit
  properties (``span_off_ns``);
- ``enable()``: nested spans carry their parent's id, their thread and
  attributes; the cap drops the oldest and counts the drops; a cancelled
  span is not kept; ``record`` keeps a span stamped elsewhere; threads lose
  no count and no span;
- under a CPU ``torch.profiler`` session, without ``enable()``: spans
  record, each is a user annotation of its name starting within 1 ms of the
  span, and a profiler stopped inside an open span leaves it whole;
- ``PhaseTimer``: its samples as before, each phase an ``eval.<phase>`` span;
- ``eval_model`` on a tiny CPU model at pipeline depth 1 and 2: one
  ``eval.input`` / ``decode`` / ``fetch`` / ``collect`` span per batch,
  ``decode.encode`` per batch, the PhaseTimer's counts;
- ``ServingQueue`` on a tiny CPU ``Predictor``: one ``serve.queue_wait`` per
  answered request, in a batch that has a ``serve.coalesce``, a
  ``serve.dispatch`` and a ``serve.decode``; a malformed request fails alone
  and is not in ``stats()["rows"]``; the benchmark's ``decode_overlap.serve``
  reader on hand-made spans: overlapping batches read 100, batches in series
  0, no ``serve.decode`` span None;
- ``train_one_epoch`` inline and staged: one ``train.loader_wait`` and one
  ``train.device_batch`` per step.

Marked ``cuda`` (skipped without a card): a graph key's first greedy call
counts one capture and the second only replays (its kernels counted in
``LAUNCHES``, no capture); a span's GPU-side
annotation is a user annotation on the card's profiler.
"""

import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from retr_tpu_torch import engine
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.models import caption, weights
from retr_tpu_torch.predictor import Predictor, ServingQueue
from retr_tpu_torch.train import state as tstate
from retr_tpu_torch.utils import profiling
from retr_tpu_torch.utils.profiling import PhaseTimer, Tracer


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _names(spans=None):
    return Counter(s["name"] for s in (profiling.spans() if spans is None else spans))


# ---------------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------------


def test_off_records_nothing_and_counters_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.recording()
    with profiling.span("a", batch=1) as s:
        with profiling.span("b"):
            s.cancel()
    profiling.record("c", profiling.now(), profiling.now())
    profiling.count("n")
    profiling.count("n", 4)
    assert profiling.spans() == [] and profiling.TRACER.dropped == 0
    assert profiling.counters() == {"n": 5}
    profiling.reset()
    assert profiling.counters() == {}


def test_off_cost_per_span(record_property):
    """The off path hands out one shared context and keeps nothing; its cost
    goes to the run's junit properties, not into an assertion."""
    span, n = profiling.span, 200_000
    assert span("x") is span("y", batch=2)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("x", batch=1):
            pass
    off_ns = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    loop_ns = (time.perf_counter_ns() - t0) / n
    record_property("span_off_ns", round(off_ns - loop_ns, 1))
    print(f"span off: {off_ns - loop_ns:.1f} ns per span")
    assert profiling.spans() == []


def test_enabled_spans_nest_per_thread_with_attrs():
    profiling.enable()
    assert profiling.recording()
    with profiling.span("outer", batch=3, rows=7):
        with profiling.span("inner", request=11):
            pass
        done = threading.Event()

        def other():
            with profiling.span("other"):
                pass
            done.set()

        threading.Thread(target=other).start()
        assert done.wait(10)
    t0 = profiling.now()
    profiling.record("stamped", t0, t0 + 5, batch=4)
    by = {s["name"]: s for s in profiling.spans()}
    assert set(by) == {"outer", "inner", "other", "stamped"}
    outer, inner, other = by["outer"], by["inner"], by["other"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert other["parent"] is None and other["thread"] != outer["thread"] == threading.get_ident()
    assert outer["attrs"] == {"batch": 3, "rows": 7} and inner["attrs"] == {"request": 11}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert by["stamped"]["end_ns"] - by["stamped"]["start_ns"] == 5 and by["stamped"]["parent"] is None
    assert len({s["id"] for s in by.values()}) == 4
    # the clock is the epoch's, as the profiler's CPU events are
    assert abs(outer["start_ns"] - time.time_ns()) < 60e9


def test_cap_drops_the_oldest_and_counts_them():
    tr = Tracer(cap=3)
    tr.on = True
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [s["name"] for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.dropped == 2
    with tr.span("gone") as s:
        s.cancel()
    assert [s["name"] for s in tr.spans()] == ["s2", "s3", "s4"] and tr.dropped == 2
    tr.reset()
    assert tr.spans() == [] and tr.dropped == 0


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, a short switch interval: every count and every
    span of every thread is kept, the oldest past the cap counted as dropped."""
    tr = Tracer(cap=1000)
    tr.on = True
    threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                tr.count("n")
                with tr.span("outer"):
                    with tr.span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert tr.counters() == {"n": threads * per}
    kept = tr.spans()
    assert len(kept) == 1000 and tr.dropped == 2 * threads * per - 1000
    ids = {s["id"]: s for s in kept}
    for s in kept:
        if s["name"] == "inner" and s["parent"] in ids:
            parent = ids[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"]


def _user_annotations(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_profiler_session_records_spans_as_annotations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("tracing.outer", batch=1):
            with profiling.span("tracing.inner"):
                torch.ones(64).sum()
    assert not profiling.recording()
    with profiling.span("after"):
        pass
    kept = {s["name"]: s for s in profiling.spans()}
    assert set(kept) == {"tracing.outer", "tracing.inner"}
    notes = {e.name(): e for e in _user_annotations(prof)}
    for name, s in kept.items():
        assert name in notes, sorted(notes)
        assert abs(notes[name].start_ns() - s["start_ns"]) < 1_000_000


def test_profiler_stopped_inside_an_open_span():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with profiling.span("open"):
        prof.__exit__(None, None, None)
        with profiling.span("after stop"):
            pass
    assert _names() == {"open": 1}


def test_phase_timer_samples_and_spans():
    profiling.enable()
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase("decode"):
            pass
    with timer.phase("fetch"):
        time.sleep(0.01)
    assert {k: len(v) for k, v in timer.samples.items()} == {"decode": 3, "fetch": 1}
    assert timer.samples["fetch"][0] >= 0.01
    assert _names() == {"eval.decode": 3, "eval.fetch": 1}
    fetch = next(s for s in profiling.spans() if s["name"] == "eval.fetch")
    assert abs((fetch["end_ns"] - fetch["start_ns"]) / 1e9 - timer.samples["fetch"][0]) < 2e-3


# ---------------------------------------------------------------------------------
# Where the program records them (tiny CPU model)
# ---------------------------------------------------------------------------------


TINY = dict(verbose=False, backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1,
            dec_layers=1, dim_feedforward=128, max_position_embeddings=12, dropout=0.0, image_size=64,
            batch_size=2, num_workers=2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tests.synth_refcoco import make_synth_refcoco  # Pillow: the CPU tests only

    root = tmp_path_factory.mktemp("tracing")
    coco_dir, ref_dir = make_synth_refcoco(str(root), n_images=12, sents_per_ann=[2, 1, 3])
    tok = prepare_tokenizer()[0]
    cfg = Config(dir=coco_dir, ref_dir=ref_dir, vocab_size=tok.vocab_size, **TINY)
    params, _ = caption.build_model(cfg, seed=0, device="cpu")
    return cfg, tok, params


@pytest.mark.parametrize("depth", [1, 2])
def test_eval_model_spans_one_per_batch(tiny, depth):
    cfg, tok, params = tiny
    loader = dataset.DataLoader(dataset.build_dataset(cfg, "validation", tok, return_unique=True), 2,
                                num_workers=2)
    n = len(loader)
    assert n >= 2
    profiling.enable()
    timer = PhaseTimer()
    engine.eval_model(params, cfg, loader, tok, metrics_to_omit=["METEOR"], timer=timer, pipeline_depth=depth)
    names = _names()
    assert {k: len(v) for k, v in timer.samples.items()} == {"host_wait": n + 1, "input": n, "decode": n,
                                                             "fetch": n, "score": 1}
    for phase, samples in timer.samples.items():
        assert names["eval." + phase] == len(samples), phase
    assert names["eval.collect"] == names["decode.encode"] == n and names["decode.stop_check"] >= n
    spans = profiling.spans()
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "eval.fetch":
            assert ids[s["parent"]]["name"] == "eval.collect"
        if s["name"] in ("decode.encode", "decode.stop_check"):
            assert ids[s["parent"]]["name"] == "eval.decode"
    assert sum(s["attrs"]["rows"] for s in spans if s["name"] == "eval.collect") == len(loader.dataset)


@pytest.fixture(scope="module")
def predictor(tiny):
    cfg, tok, params = tiny
    return Predictor(weights.to_state_dict(params, cfg), cfg, tok, max_batch=2, device="cpu")


def _img(seed, shape=(60, 60, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_serving_queue_spans_and_counts(predictor):
    profiling.enable()
    q = ServingQueue(predictor, max_wait_s=0.05)
    futs = [q.submit(_img(i), [5, 5, 30 + i, 25]) for i in range(5)]
    texts = [f.result(timeout=120) for f in futs]
    q.close()
    assert len(texts) == 5
    spans = profiling.spans()
    waits = [s for s in spans if s["name"] == "serve.queue_wait"]
    assert sorted(s["attrs"]["request"] for s in waits) == list(range(5))
    dispatched = {s["attrs"]["batch"]: s["attrs"]["rows"] for s in spans if s["name"] == "serve.dispatch"}
    assert {s["attrs"]["batch"] for s in waits} == set(dispatched)
    assert sum(dispatched.values()) == 5
    names = _names(spans)
    for per_batch in ("serve.coalesce", "serve.preprocess", "decode.encode", "serve.decode"):
        assert names[per_batch] == len(dispatched), per_batch
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "decode.encode":
            assert ids[s["parent"]]["name"] == "serve.dispatch"
        if s["name"] == "decode.stop_check":
            assert ids[s["parent"]]["name"] == "serve.decode"
    st = q.stats()
    assert st["batches"] == len(dispatched) and st["rows"] == 5 and st["accepted"] == 5
    assert st["graph_captures"] == st["graph_evictions"] == 0  # CPU decodes run eagerly


def test_serving_queue_counts_no_row_for_a_malformed_request(predictor):
    q = ServingQueue(predictor, max_wait_s=0.3)  # a long window: the three coalesce
    bad = q.submit(_img(0), "not-a-bbox")
    good = [q.submit(_img(1), [5, 5, 30, 30]) for _ in range(2)]
    answered = [f.result(timeout=120) for f in good]
    with pytest.raises(Exception):
        bad.result(timeout=120)
    q.close()
    st = q.stats()
    assert st["rows"] == len(answered) == 2 and st["accepted"] == 3
    assert profiling.spans() == []  # off: the queue kept no span


MS = 1_000_000  # ns


def _overlap_reading(monkeypatch, spans):
    from portbench import harness
    from portbench import spans as program

    monkeypatch.setattr(program, "recorded", lambda: spans)
    return harness.load_module(f"{harness.HERE}/metrics/decode_overlap.serve.py", "overlap_tracing_test").read({})


def _batch(b, coalesce_ms, decode_ms):
    """Batch ``b``'s ``serve.coalesce`` and ``serve.decode`` spans, (start, end) in ms."""
    return [{"name": name, "start_ns": int(a * MS), "end_ns": int(z * MS), "id": 2 * b + k, "parent": None,
             "thread": 1 + k, "attrs": {"batch": b, "rows": 2}}
            for k, (name, (a, z)) in enumerate([("serve.coalesce", coalesce_ms), ("serve.decode", decode_ms)])]


@pytest.mark.parametrize("case,want", [
    # each batch is begun while the previous batch decodes
    ("overlap", 100.0),
    # each batch is begun after the previous decode ended
    ("series", 0.0),
    # batch 1 (all its requests malformed) has no spans: 3 follows 2, 2 follows 0; one of two overlaps
    ("gap", 50.0),
    # the parent's program: its dispatcher decodes, no serve.decode span
    ("parent", None),
])
def test_decode_overlap_reader(monkeypatch, case, want):
    spans = {
        "overlap": _batch(0, (0, 10), (10, 60)) + _batch(1, (12, 40), (60, 110)) + _batch(2, (62, 90), (110, 160)),
        "series": _batch(0, (0, 10), (10, 60)) + _batch(1, (61, 90), (90, 140)) + _batch(2, (141, 170), (170, 220)),
        "gap": _batch(0, (0, 10), (10, 60)) + _batch(2, (70, 90), (90, 140)) + _batch(3, (100, 120), (140, 190)),
        "parent": _batch(0, (0, 60), (0, 0))[:1] + _batch(1, (61, 120), (0, 0))[:1],   # serve.coalesce alone
    }[case]
    got = _overlap_reading(monkeypatch, spans)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("stage_uploads", [False, True])
def test_train_one_epoch_spans_one_per_step(tiny, stage_uploads):
    cfg, tok, params = tiny
    loader = dataset.DataLoader(dataset.build_dataset(cfg, "training", tok), 2, shuffle=True, drop_last=True,
                                num_workers=2)
    st = tstate.create_train_state(cfg, {k: v for k, v in params.items()}, device="cpu",
                                   steps_per_epoch=len(loader))

    def step(state, batch, seed):
        state.step += 1
        return state, torch.tensor(1.0)

    profiling.enable()
    st, _ = engine.train_one_epoch(st, step, loader, 1, stage_uploads=stage_uploads)
    n = len(loader)
    assert st.step == n >= 2
    names = _names()
    assert {k: names[k] for k in ("train.loader_wait", "train.device_batch")} \
        == dict.fromkeys(("train.loader_wait", "train.device_batch"), n)
    steps = sorted(s["attrs"]["step"] for s in profiling.spans() if s["name"] == "train.device_batch")
    assert steps == list(range(1, n + 1))


# ---------------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU paths are tested above")
    return torch.device("cuda")


@pytest.mark.cuda
def test_first_greedy_call_captures_once_then_replays(dev):
    from retr_tpu_torch import decode
    from retr_tpu_torch.masking import Masked
    from retr_tpu_torch.ops import decoder_kernels as dk
    from retr_tpu_torch.ops import graphs

    cfg = Config(vocab_size=96, **TINY)
    params, _ = caption.build_model(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(0)
    samples = Masked(torch.randn(3, 3, 64, 64, generator=g).to(dev), torch.zeros(3, 64, 64, dtype=torch.bool,
                                                                                    device=dev))
    graphs.clear()
    before = profiling.counters()
    kw = dict(max_len=cfg.max_position_embeddings, bos_token=1, eos_token=6)  # ids inside the vocabulary
    decode.greedy(params, cfg, samples, **kw)
    first = profiling.counters()
    launches = sum(dk.LAUNCHES.values())
    decode.greedy(params, cfg, samples, **kw)
    second = profiling.counters()
    assert first.get("graphs.captures", 0) - before.get("graphs.captures", 0) == 1
    assert second.get("graphs.captures", 0) == first.get("graphs.captures", 0)
    assert sum(dk.LAUNCHES.values()) > launches  # the second call replayed the captured chunks
    graphs.clear()


@pytest.mark.cuda
def test_card_annotations_are_user_annotations(dev):
    x = torch.randn(1024, 1024, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("tracing.card"):
            (x @ x).sum()
        torch.cuda.synchronize()
    span = next(s for s in profiling.spans() if s["name"] == "tracing.card")
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "tracing.card"]
    assert events and all(e.is_user_annotation() for e in events)
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    assert cpu and abs(cpu[0].start_ns() - span["start_ns"]) < 1_000_000
