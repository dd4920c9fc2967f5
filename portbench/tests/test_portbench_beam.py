"""The beam-search cell's yardstick and judge at tiny sizes on the CPU: the
beam step's bytes and operations against PERF.md's kernel table and by hand,
the readers of ``beam_step_roofline`` and ``mfu.beam``, whole runs of the
``eval_beam`` driver (correct for the program; not correct with a token
altered where beam search produces it; its float8 control failing), and the
metrics each cell that came with the beam cell resolves to."""

import json
import os

import pytest

from portbench import beam_work, harness, synth, work
from portbench.tests import tiny

R101 = harness.load_json(harness.HERE, "configs", "retr-r101.json")["config"]
VARIANTS = pytest.mark.parametrize("globloc", [False, True], ids=["caption", "globloc"])
BEAM = {"driver": "eval_beam", "split": {"images": 6, "objects": 10, "expressions": 20, "partition": "val"},
        "batch": 4, "decoder": "beam", "judge_captions": 6}


@pytest.fixture(autouse=True)
def _pool_size():
    full = synth.POOL_IMAGES
    synth.POOL_IMAGES = 12
    yield
    synth.POOL_IMAGES = full


def _execute(tmp_path, globloc=False, control=False):
    """A run of the tiny beam cell: ``tiny``'s files and a ``tiny-beam`` cell."""
    from portbench import run

    root, bench = tiny.files(str(tmp_path / "files"), globloc=globloc)
    for kind, body in (("traffic", BEAM), ("limits", {"beam_gap": 1e-3, "unreadable": 0, "missing": 0})):
        with open(os.path.join(root, kind, "tiny-beam.json"), "w") as f:
            json.dump(body, f)
    work_ = {"name": "tiny-beam", "config": "tiny", "traffic": "tiny-beam", "chips": 1}
    bench["workloads"].append(work_)
    next(m for m in bench["end_to_end"] if m["name"] == "captions_per_s")["workloads"].append("tiny-beam")
    return run.execute(work_, bench, 2 ** 33 + 17, 1.5, False, device="cpu", files=root,
                       checkout=str(tmp_path / "checkout"), control=control)


@VARIANTS
def test_a_beam_run_on_the_cpu_is_correct(tmp_path, globloc):
    res = _execute(tmp_path, globloc)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["captions_per_s"]["value"] > 0


def test_a_token_altered_where_beam_search_produces_it(tmp_path, monkeypatch):
    from retr_tpu_torch import decode

    real = decode.beam_search

    def altered(*a, **k):
        tokens, scores = real(*a, **k)       # [B, beams, T], BOS first
        tokens = tokens.clone()
        tokens[..., 5] = 104 + (tokens[..., 5] - 103) % (tiny.TINY["vocab_size"] - 104)
        return tokens, scores

    monkeypatch.setattr(decode, "beam_search", altered)
    res = _execute(tmp_path)
    assert not res["correct"]
    assert res["checks"]["beam_gap"]["value"] > res["checks"]["beam_gap"]["limit"]


def test_the_beam_control_fails_where_the_program_passes(tmp_path):
    """The control (float8 e4m3 weights, computed in bfloat16) at the
    program's served hypotheses: its top-5 tokens fall below the reference's
    5th best by more than the limit the program keeps."""
    res = _execute(tmp_path, control=True)
    assert res["correct"], res["checks"]
    assert res["control"]["control_beam_gap"] > res["checks"]["beam_gap"]["limit"]


@pytest.mark.parametrize("kind,bound_ms", [("cross_attn_block", 0.1548), ("ff_block", 0.00543),
                                           ("self_attn_block_beam", 0.0514), ("mlp_head_topk", 0.0809)])
def test_beam_blocks_as_the_kernels_run_give_the_perf_tables_bounds(kind, bound_ms):
    """PERF.md's kernel table at 2,560 rows (512 x 5 beams), step 63, S 196, bf16."""
    assert work.roofline_s(*beam_work.beam_block_work(kind, 2560, 63, 196), "bfloat16") == \
        pytest.approx(bound_ms * 1e-3, rel=3e-3)


def test_required_beam_work_by_hand():
    # the cross block's K/V (2 x 8 x 196 x 32 bf16) and f32 key bias once per group of 5 rows
    nbytes, ops = beam_work.beam_block_work("cross_attn_block", 10, 7, 196, required=True)
    assert nbytes == (2 * 65536 + 256 + 256 + 768) * 2 + 2 * 2 * 8 * 196 * 32 * 2 + 2 * 196 * 4
    assert ops == beam_work.beam_block_work("cross_attn_block", 10, 7, 196)[1]
    # the self cache's prefix once a group, each row's slot written, no ancestry
    nbytes, _ = beam_work.beam_block_work("self_attn_block_beam", 10, 7, 196, required=True)
    assert nbytes == (4 * 65536 + 4 * 256 + 512) * 2 + 2 * 2 * 8 * 7 * 32 * 2 + 2 * 10 * 8 * 32 * 2 + 4
    # one beam's caption is a greedy caption
    assert beam_work.beam_caption_flops(R101, 1) == work.caption_flops(R101)
    # byte-bound: a step at 2,560 rows needs far less than the kernels' own ~1.35 ms
    assert 0.2e-3 < beam_work.beam_step_bound_s(2560, 196) < 0.35e-3


def _reader(name):
    return harness.load_module(f"{harness.HERE}/metrics/{name}.py", "b_" + name.replace(".", "_"))


def test_beam_step_roofline_takes_the_device_time_the_decode_launched(monkeypatch):
    """Two batches' decodes (eval.decode spans, each with a decode.encode
    child): only device work launched inside a decode and outside its encode
    counts, busy time as the union of its intervals."""
    from portbench import spans as program

    ms = 1_000_000
    spans = [{"name": n, "start_ns": a * ms, "end_ns": b * ms, "id": i, "parent": p, "thread": 1, "attrs": {}}
             for i, (n, a, b, p) in enumerate([("eval.decode", 0, 100, None), ("decode.encode", 0, 10, 0),
                                               ("eval.decode", 200, 300, None), ("decode.encode", 200, 230, 2)])]
    monkeypatch.setattr(program, "recorded", lambda: spans)
    us = 1000.0
    launched = [(5 * us, 400 * us, 1 * us),                          # the encoder's
                (400 * us, 900 * us, 20 * us), (800 * us, 1000 * us, 30 * us),   # overlapping: 600 ms busy
                (2000 * us, 2400 * us, 250 * us),                    # the second batch's loop
                (2500 * us, 2600 * us, 150 * us)]                    # launched between the decodes
    ctx = {"cfg": R101, "traffic": {"batch": 512, "decoder": "beam"}, "steps": 127, "beams": 5,
           "profile": {"launched": launched}}
    step_s = 1.0 / (2 * 127)
    assert _reader("beam_step_roofline").read(ctx) == \
        pytest.approx(100.0 * beam_work.beam_step_bound_s(2560, 196) / step_s)
    assert _reader("beam_step_roofline").read({**ctx, "traffic": {"batch": 512, "decoder": "greedy"}}) is None
    assert _reader("beam_step_roofline").read({**ctx, "profile": None}) is None


def test_mfu_beam_reaches_100_percent_only_at_the_peak():
    ctx = {"cfg": R101, "traffic": {"batch": 512, "decoder": "beam"}, "steps": 127, "beams": 5}
    peak_rate = work.PEAK_FLOPS["bfloat16"] / beam_work.beam_caption_flops(R101, 5)
    for share in (100.0, 50.0):
        assert _reader("mfu.beam").read({**ctx, "e2e": {"captions_per_s": peak_rate * share / 100}}) == \
            pytest.approx(share)
    assert _reader("mfu.beam").read({**ctx, "traffic": {"decoder": "greedy"},
                                     "e2e": {"captions_per_s": peak_rate}}) is None


def test_each_added_cell_resolves_to_its_listed_metrics():
    from portbench import run

    bench = harness.load_json(harness.CHECKOUT, "BENCHMARK.json")
    per_layer = {w: {m["name"] for m in run.metric_entries(bench, w, "per_layer")}
                 for w in ("r101-train-bf16", "r101-eval-beam5")}
    assert per_layer["r101-train-bf16"] == {"idle_share.train", "mfu.train", "loader_span_ms.train",
                                            "device_batch_ms.train"}
    assert per_layer["r101-eval-beam5"] == {"idle_share.eval", "encode_ms.eval", "collect_ms.eval",
                                            "loader_wait_ms.eval", "beam_step_roofline", "mfu.beam"}
    assert {m["name"] for m in run.metric_entries(bench, "r101-train-bf16", "end_to_end")} == \
        {"train_samples_per_s", "setup_s"}
    assert {m["name"] for m in run.metric_entries(bench, "r101-eval-beam5", "end_to_end")} == \
        {"captions_per_s", "setup_s"}
