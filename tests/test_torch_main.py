"""The training entry point and the command lines of the port
(retr_tpu_torch/main.py, eval_model.py, export_pth.py) held against retr_tpu's
on the CPU, on the synthetic RefCOCO (tests/synth_refcoco.py) at the JAX CLI
tests' config (ResNet18, 64 px, 1+1 layers, hidden 64, batch 2).

One module-scoped run of each package: ``main`` for two epochs from the same
JAX-exported ``--init_pth``, at dropout 0, with the port's ``jitter_draws``
patched to return the draws JAX makes for each batch, then ``main(...,
resume=True)`` to three epochs. Against retr_tpu's run:
- the events of ``metrics.jsonl`` in the same order, the same parameter count;
- each epoch's ``train_loss``, ``val_loss`` and each step's loss within 1e-4
  relative, the ``epoch_end`` CIDEr equal;
- the resumed run logs ``resume`` at epoch 2 and trains epoch 2 only.
Also: the early stop fires on the same epoch for stubbed CIDEr sequences; a
mesh in a world of one and ``--distributed`` without torchrun's variables
raise, saying why (multi-process runs: tests/test_torch_parallel.py); the eval CLI
(``--override_config``, ``--batch``, ``--store_results``, ``--decoder beam``,
``--profile_dir``, a ``.pth``) and ``export_pth`` on the checkpoint ``main``
wrote; ``Predictor.from_checkpoint`` of the directory and of its ``.pth``
caption alike; ``serve --checkpoint DIR``; the lazy top-level names, and
``import retr_tpu_torch`` importing none of them (nor torch).
"""

import json
import math
import os
import subprocess
import sys
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax

import retr_tpu_torch
from retr_tpu import main as jmain
from retr_tpu.config import Config as JaxConfig
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.models import caption as jcaption
from retr_tpu.train import checkpoints as jckpt
from retr_tpu_torch import eval_model as em
from retr_tpu_torch import export_pth
from retr_tpu_torch import main as tmain
from retr_tpu_torch import predictor as tpredictor
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.models import layers, weights
from retr_tpu_torch.ops import image as imops
from retr_tpu_torch.train import checkpoints as ckpt
from tests.synth_refcoco import make_synth_refcoco
from tests.test_torch_dataset import jax_batch_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1,
            dim_feedforward=128, max_position_embeddings=16, dropout=0.0, image_size=64, batch_size=2,
            num_workers=2, epochs=2, early_stopping=False, async_checkpoints=True, verbose=False,
            device="cpu", seed=3)
LAZY_NAMES = ["Predictor", "ServingQueue", "build_model", "greedy", "beam_search", "sample",
              "greedy_with_prefix", "sequence_scores", "greedy_decoding", "greedy_with_attention", "NLGEval",
              "Masked"]


def _events(cfg):
    with open(os.path.join(cfg.checkpoint_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_draws_by_seed(cfg, steps, rows, epochs):
    """Port generator seed of each batch's target images -> JAX's draws for that batch."""
    key = jax.random.key(cfg.seed)
    out = {}
    for e in epochs:
        for i in range(steps):
            port_seed = layers.fold_in(layers.fold_in(layers.fold_in(cfg.seed, e), i), 0)
            out[port_seed] = jax_batch_draws(jax.random.fold_in(jax.random.fold_in(key, e), i), rows, False)[0]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("main")
    coco_dir, ref_dir = make_synth_refcoco(str(root), n_images=8)
    tok = prepare_tokenizer()[0]
    assert tok.vocab_size == jax_prepare_tokenizer()[0].vocab_size
    kw = dict(ARCH, dir=coco_dir, ref_dir=ref_dir, vocab_size=tok.vocab_size)
    jcfg = JaxConfig(**kw, project_data_path=str(root / "jax"))
    cfg = Config(**kw, project_data_path=str(root / "port"))
    pth = str(root / "init.pth")
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    jckpt.export_reference_checkpoint(params, jcfg, pth)

    steps = 4   # 8 training expressions at batch 2
    draws = _jax_draws_by_seed(cfg, steps, 2, epochs=(0, 1, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(imops, "jitter_draws", lambda gen, n, dev: draws[gen.initial_seed()])
        jmain.main(jcfg, init_pth=pth)
        tmain.main(cfg, init_pth=pth)
        jmain.main(jcfg.replace(epochs=3), resume=True, init_pth=pth)
        tmain.main(cfg.replace(epochs=3), resume=True, init_pth=pth)
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, tok=tok, got=_events(cfg), want=_events(jcfg),
                                 latest=ckpt.latest_checkpoint(cfg.checkpoint_path, cfg), cfg_path=cfg_path,
                                 steps=steps)


def _close(got, want, rel=1e-4):
    return math.isfinite(got) and abs(got - want) <= rel * abs(want)


def test_events_are_the_reference_sequence(runs):
    names = [e["event"] for e in runs.got]
    assert names == [e["event"] for e in runs.want]
    assert names.count("init_from_pth") == 2 and names.count("epoch_end") == 3 and names.count("resume") == 1
    inits = [(g["n_parameters"], w["n_parameters"]) for g, w in zip(runs.got, runs.want) if g["event"] == "init"]
    assert all(g == w for g, w in inits)
    datasets = [(g, w) for g, w in zip(runs.got, runs.want) if g["event"] == "datasets"]
    assert all({k: g[k] for k in ("train", "val", "cider")} == {k: w[k] for k in ("train", "val", "cider")}
               for g, w in datasets)


def test_epoch_losses_and_cider_match_reference(runs):
    ends = [(g, w) for g, w in zip(runs.got, runs.want) if g["event"] == "epoch_end"]
    assert [g["epoch"] for g, _ in ends] == [0, 1, 2]
    for g, w in ends:
        assert _close(g["train_loss"], w["train_loss"]), (g["epoch"], g["train_loss"], w["train_loss"])
        assert _close(g["val_loss"], w["val_loss"]), (g["epoch"], g["val_loss"], w["val_loss"])
        assert g["cider"] == w["cider"] and g["metrics"] == w["metrics"]


def test_step_losses_match_reference(runs):
    steps = [(g, w) for g, w in zip(runs.got, runs.want) if g["event"] == "train_step"]
    assert len(steps) == 3 * runs.steps
    for g, w in steps:
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        assert _close(g["loss"], w["loss"]), (g["step"], g["loss"], w["loss"])


def test_resume_trains_the_next_epoch_only(runs):
    resumed = runs.got[[e["event"] for e in runs.got].index("resume"):]
    assert resumed[0]["epoch"] == 2
    assert resumed[0]["checkpoint"].endswith(ckpt.checkpoint_name(runs.cfg, 1))
    assert [e["epoch"] for e in resumed if e["event"] == "epoch_start"] == [2]
    assert [e["step"] for e in resumed if e["event"] == "train_step"] == list(range(2 * runs.steps + 1,
                                                                                   3 * runs.steps + 1))
    names = set(os.listdir(runs.cfg.checkpoint_path))
    assert names == {"metrics.jsonl", *(ckpt.checkpoint_name(runs.cfg, e) for e in range(3))}
    assert runs.latest.endswith(ckpt.checkpoint_name(runs.cfg, 2))
    assert ckpt.read_metadata(runs.latest)["step"] == 3 * runs.steps


# the stubbed CIDEr of each epoch -> the epoch the early stop fires on (None: never)
CIDER_RUNS = {"falls below the last five": ([0.2, 0.3, 0.25, 0.4, 0.5, 0.1, 0.6, 0.7], 5),
              "rises": ([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], None),
              "the first score leaves the window": ([0.3, 0.2, 0.9, 0.8, 0.7, 0.6, 0.19, 0.9], 6)}


def _stub_loop(mp, module, ciders, saved):
    mp.setattr(module, "train_one_epoch", lambda state, *a, **k: (state, 1.0))
    mp.setattr(module, "evaluate", lambda *a, **k: 1.0)
    it = iter(ciders)
    mp.setattr(module, "eval_model", lambda *a, **k: ({"CIDEr": next(it)}, []))
    mp.setattr(module.ckpt, "save_checkpoint", lambda directory, state, cfg, **kw: saved.append(kw["epoch"]))


@pytest.mark.parametrize("case", list(CIDER_RUNS))
def test_early_stop_fires_on_the_reference_epoch(runs, tmp_path, case):
    ciders, stop = CIDER_RUNS[case]
    kw = dict(epochs=len(ciders), early_stopping=True, async_checkpoints=False)
    jcfg = runs.jcfg.replace(project_data_path=str(tmp_path / "jax"), checkpoint_path="", **kw)
    cfg = runs.cfg.replace(project_data_path=str(tmp_path / "port"), checkpoint_path="", **kw)
    pth = str(tmp_path / "m.pth")
    export_pth.main(["--checkpoint", runs.latest, "--out", pth])
    jsaved, saved = [], []
    with pytest.MonkeyPatch.context() as mp:
        _stub_loop(mp, jmain, ciders, jsaved)
        jmain.main(jcfg, init_pth=pth)
    with pytest.MonkeyPatch.context() as mp:
        _stub_loop(mp, tmain, ciders, saved)
        tmain.main(cfg, init_pth=pth)
    got, want = _events(cfg), _events(jcfg)
    assert [e["event"] for e in got] == [e["event"] for e in want]
    stops = [e["epoch"] for e in got if e["event"] == "early_stop"]
    assert stops == [e["epoch"] for e in want if e["event"] == "early_stop"] == ([] if stop is None else [stop])
    assert saved == jsaved == list(range(len(ciders) if stop is None else stop + 1))


@pytest.mark.parametrize("launch", ["mesh", "--distributed"])
def test_multi_gpu_raises_naming_a13(runs, launch, monkeypatch):
    """dp_size=2 in a world of one has no process group to make a mesh of;
    --distributed without torchrun's RANK / WORLD_SIZE (and no store) names them."""
    if launch == "mesh":
        with pytest.raises(ValueError, match="needs an initialised process group"):
            tmain.main(runs.cfg.replace(dp_size=2))
    else:
        for var in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(RuntimeError, match="RANK and WORLD_SIZE"):
            tmain.cli(["--distributed", "--config", runs.cfg_path])


def _last_cider(runs):
    return [e for e in runs.got if e["event"] == "epoch_end"][-1]["cider"]


def test_eval_cli_stores_results_and_scores_as_the_epoch_end(runs, capsys):
    em.cli(["--split", "val", "--checkpoint", runs.latest, "--override_config", "--store_results",
            "--config", runs.cfg_path, "--batch", "1"])
    assert "CIDEr" in capsys.readouterr().out
    base = os.path.join(runs.cfg.project_data_path, "results", os.path.basename(runs.latest))
    with open(f"{base}_val_metrics.json") as f:
        metrics = json.load(f)
    with open(f"{base}_val_generated.json") as f:
        generated = json.load(f)
    assert metrics["CIDEr"] == _last_cider(runs)
    assert generated and all(set(h) == {"ann_id", "expression"} for h in generated)


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_eval_cli_decoders_on_the_checkpoint(runs, decoder):
    args = em.build_argparser().parse_args(["--checkpoint", runs.latest, "--override_config",
                                            "--decoder", decoder, "--batch", "1"])
    # the CLI's own Config() is full width: --override_config takes the checkpoint's
    metrics, hyps = em.main_val_set(args, Config(device="cpu"))
    assert len(metrics) == 7 and all(math.isfinite(v) for v in metrics.values()) and hyps
    if decoder == "greedy":
        assert metrics["CIDEr"] == _last_cider(runs)


def test_eval_cli_profile_dir_and_pth(runs, tmp_path):
    pth = export_pth.main(["--checkpoint", runs.latest, "--out", str(tmp_path / os.path.basename(runs.latest))
                           + ".pth"])
    args = em.build_argparser().parse_args(["--checkpoint", pth, "--override_config", "--device", "cpu",
                                            "--profile_dir", str(tmp_path / "prof")])
    metrics, _ = em.main_val_set(args, runs.cfg.replace(device="cuda"))
    assert metrics["CIDEr"] == _last_cider(runs)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_export_pth_carries_weights_and_metadata(runs, tmp_path):
    out = export_pth.main(["--checkpoint", runs.latest])
    assert out == runs.latest + ".pth" and os.path.exists(out)
    state, meta = ckpt.load_reference_state(out)
    want, dir_meta = ckpt.load_model_state(runs.latest)
    assert meta == {k: dir_meta[k] for k in ("epoch", "train_loss", "val_loss", "cider_score")}
    assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)
    jparams, jmeta = jckpt.import_reference_checkpoint(out, runs.jcfg)
    assert jmeta == meta
    sd = weights.to_state_dict(jax.tree.map(np.asarray, jparams), runs.cfg)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    os.remove(out)


def test_predictor_from_directory_captions_as_from_its_pth(runs, tmp_path):
    pth = export_pth.main(["--checkpoint", runs.latest, "--out", str(tmp_path / "Concat_refcoco_checkpoint_2.pth")])
    from_dir = tpredictor.Predictor.from_checkpoint(runs.latest, tokenizer=runs.tok, max_batch=2, device="cpu")
    # from_checkpoint(.pth) would take the rest of the config from Config(), the full width
    from_pth = tpredictor.Predictor(ckpt.load_reference_state(pth)[0], runs.cfg, runs.tok, max_batch=2, device="cpu")
    assert from_dir.cfg == runs.cfg.replace(epochs=3)   # the config the resumed run trained with
    sd_dir, sd_pth = (weights.to_state_dict(p.params, runs.cfg) for p in (from_dir, from_pth))
    assert sd_dir.keys() == sd_pth.keys() and all(torch.equal(sd_dir[k], sd_pth[k]) for k in sd_dir)
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (60 + 10 * i, 80, 3), dtype=np.uint8) for i in range(4)]
    boxes = [[5, 5, 30 + i, 25] for i in range(4)]
    assert from_dir.predict_batch(imgs, boxes) == from_pth.predict_batch(imgs, boxes)


def test_serve_takes_a_checkpoint_directory(runs):
    """``python -m retr_tpu_torch.serve --checkpoint DIR`` on the CPU: /healthz
    answers, SIGTERM drains and exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "retr_tpu_torch.serve", "--checkpoint", runs.latest,
                             "--port", "0", "--device", "cpu", "--max-batch", "2"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split()[2]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.load(r)["ok"] is True
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("name", LAZY_NAMES)
def test_lazy_top_level_name_resolves_to_its_module(name):
    import retr_tpu

    obj = getattr(retr_tpu_torch, name)
    assert obj.__name__ == getattr(retr_tpu, name).__name__ and obj.__module__.startswith("retr_tpu_torch.")
    assert name in retr_tpu_torch.__all__


def test_import_stays_light():
    code = ("import sys, retr_tpu_torch; "
            "heavy = [m for m in ('retr_tpu_torch.predictor', 'retr_tpu_torch.decode', 'retr_tpu_torch.models.caption', "
            "'retr_tpu_torch.metrics', 'torch') if m in sys.modules]; print(heavy)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, check=True)
    assert out.stdout.strip() == "[]"
    with pytest.raises(AttributeError):
        retr_tpu_torch.not_a_name
