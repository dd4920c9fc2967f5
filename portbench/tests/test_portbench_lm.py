"""The LM-decoder cell's yardstick and reference on the CPU:

- ``lm_work``'s counts at Kimi-VL-A3B's published widths equal the hand sums
  (15.96 B parameters; 1,152 B of latent a position and layer in bfloat16);
- ``portbench/reference/lm.py`` (a layer at a time) gives the logits of
  ``tests/lm_oracle.py`` (the whole model at once) on the same state dict;
- a tiny ``eval_lm`` run (ResNet-18 at 64 px, an LM of width 64 with 8
  experts) comes out correct, a token altered where it is produced does not,
  nor do routed experts dropped or swapped (``portbench/lm_faults.py``), and
  with the control the control's numbers are read;
- ``eval_lm`` fails at once, at import, on a program whose ``Config`` has no
  ``decoder_kind``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, lm_faults, lm_weights, lm_work, synth
from portbench.reference import lm as ref_lm
from portbench.tests import tiny

KIMI = json.load(open(os.path.join(harness.HERE, "configs", "kimivl-a3b-globloc.json")))["config"]
TINY_LM = dict(tiny.TINY, use_global_features=True, use_location_features=True, vocab_size=400,
               decoder_kind="lm", lm_hidden_size=64, lm_layers=3, lm_heads=4, lm_kv_lora_rank=16,
               lm_qk_nope_head_dim=8, lm_qk_rope_head_dim=4, lm_v_head_dim=8, lm_intermediate_size=96,
               lm_moe_intermediate_size=32, lm_n_routed_experts=8, lm_n_shared_experts=1,
               lm_num_experts_per_tok=2, lm_first_k_dense_replace=1, lm_routed_scaling_factor=2.446,
               lm_rms_norm_eps=1e-5, lm_rope_theta=10000.0)


def test_the_yardstick_counts_the_published_widths():
    n = lm_work.param_counts(KIMI)
    assert n["embed"] == n["head"] == 163840 * 2048 == 335_544_320
    assert n["mla"] == 2048 * 16 * 192 + 2048 * 576 + 512 + 512 * 16 * 256 + 16 * 128 * 2048 == 13_763_072
    assert n["dense_layer"] == n["mla"] + 2 * 2048 + 3 * 2048 * 11264 == 82_973_184
    assert n["experts"] == 64 * 3 * 2048 * 1408 == 553_648_128
    assert n["shared"] == 3 * 2048 * 2816 == 17_301_504 and n["router"] == 64 * 2049
    assert n["moe_layer"] == n["mla"] + 2 * 2048 + n["experts"] + n["shared"] + n["router"] == 584_847_936
    assert n["total"] == 2 * 335_544_320 + 2048 + 82_973_184 + 26 * 584_847_936 == 15_960_110_208
    assert lm_work.cache_bytes(KIMI) == 1152 and lm_work.cache_bytes(KIMI, 4) == 2304
    # a decode step at 512 rows reads every weight once: the roofline is bandwidth-bound
    nbytes, ops = lm_work.decode_step_work(KIMI, 512, 397, 0)
    assert nbytes > (n["total"] - n["embed"]) * 2 and nbytes / 3.35e12 > ops / 989e12
    nbytes, ops = lm_work.prefill_work(KIMI, 512, 397)
    assert ops / 989e12 > nbytes / 3.35e12 and 0.8e15 < ops < 1.1e15      # about 0.94 PFLOP, compute-bound


def test_the_card_reference_gives_the_oracles_logits():
    from tests import lm_oracle

    torch.manual_seed(0)
    oracle = lm_oracle.LMOracle(TINY_LM).eval()
    sd = lm_weights.state_dict(TINY_LM, 3, "cpu")
    oracle.load_state_dict({k: v for k, v in sd.items() if k.startswith(("projector.", "language_model."))})
    mem = torch.randn(2, 9, 64)
    mask = torch.zeros(2, 9, dtype=torch.bool)
    mask[1, 6:] = True
    tokens = torch.randint(103, 400, (2, 5))
    want = oracle(mem, mask, tokens)
    got = ref_lm.lm_logits(TINY_LM, sd, mem, mask, tokens)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (sd["language_model.lm_head.weight"][[0, 101, 102]] == 0).all()


@pytest.fixture
def files(tmp_path):
    root, bench = tiny.files(str(tmp_path / "files"))
    with open(os.path.join(root, "configs", "tiny-lm.json"), "w") as f:
        json.dump({"source": "test", "reduced": [], "config": TINY_LM}, f)
    with open(os.path.join(root, "traffic", "tiny-lm.json"), "w") as f:
        json.dump({**tiny.TRAFFIC["tiny-sweep"], "driver": "eval_lm"}, f)
    with open(os.path.join(root, "limits", "tiny-lm.json"), "w") as f:
        json.dump({"token_gap": 1e-3, "expert_gap": 1e-3, "unreadable": 0, "missing": 0}, f)
    bench["workloads"].append({"name": "tiny-lm", "config": "tiny-lm", "traffic": "tiny-lm", "chips": 1})
    bench["end_to_end"][0]["workloads"].append("tiny-lm")
    for name in ("prefill_roofline.lm", "decode_step_roofline.lm", "mfu.lm", "encode_ms.eval"):
        bench["per_layer"].append({"name": name, "unit": "%", "moves": "captions_per_s", "workloads": ["tiny-lm"]})
    full = synth.POOL_IMAGES
    synth.POOL_IMAGES = 12
    yield root, bench, tmp_path
    synth.POOL_IMAGES = full


def _run(files, trace=False, control=False):
    from portbench import run
    from portbench.drivers import common

    root, bench, tmp_path = files
    work = next(w for w in bench["workloads"] if w["name"] == "tiny-lm")
    try:
        return run.execute(work, bench, 2 ** 32 + 9, 1.0, trace, device="cpu", files=root,
                           checkout=str(tmp_path / "checkout"), control=control)
    finally:
        common.release()


def test_a_tiny_lm_run_is_correct_and_reads_its_metrics(files):
    res = _run(files, trace=True, control=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["token_gap"]["value"] < 1e-4 and res["checks"]["expert_gap"]["value"] < 1e-4
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["control"]) == {"control_gap", "control_expert_gap", "control_bf16_expert_flips"}
    assert res["control"]["control_expert_gap"] > 1e-3
    assert 0.0 <= res["control"]["control_bf16_expert_flips"] <= 1.0
    # no device trace on the CPU: the device's readers give nothing, the host's do
    assert "mfu.lm" in res["metrics"] and "encode_ms.eval" in res["metrics"]
    assert "prefill_roofline.lm" not in res["metrics"]


def test_a_token_altered_where_it_is_produced_is_not_correct(files, monkeypatch):
    from retr_tpu_torch import decode

    real = decode.greedy

    def altered(*a, **k):
        ids = real(*a, **k).clone()
        ids[:, 3] = 104 + (ids[:, 3] - 103) % (TINY_LM["vocab_size"] - 104)
        return ids

    monkeypatch.setattr(decode, "greedy", altered)
    res = _run(files)
    assert not res["correct"] and res["checks"]["token_gap"]["value"] > 1e-3


@pytest.mark.parametrize("fault", lm_faults.FAULTS)
def test_a_routed_expert_fault_is_not_correct(files, monkeypatch, fault):
    """Dropped routed experts, or pairs through the next expert's weights:
    ``expert_gap`` reads the fault at the size of the routed experts' output."""
    from retr_tpu_torch.models import lm

    monkeypatch.setattr(lm, "_grouped", lm._grouped)        # undone after the test
    lm_faults.plant(fault)
    res = _run(files)
    assert not res["correct"] and res["checks"]["expert_gap"]["value"] > 0.5


def test_eval_lm_fails_at_once_on_a_program_without_the_lm(tmp_path):
    """A stand-in package whose Config has no decoder_kind, first on the path."""
    pkg = tmp_path / "retr_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "config.py").write_text("import dataclasses\n\n\n@dataclasses.dataclass\nclass Config:\n"
                                   "    vocab_size: int = 30522\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{harness.CHECKOUT}"}
    out = subprocess.run([sys.executable, "-c", "import portbench.drivers.eval_lm"], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "has no decoder_kind" in out.stderr
