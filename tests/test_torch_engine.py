"""The port's engine (retr_tpu_torch/engine.py) held against retr_tpu.engine on
the CPU, on the synthetic RefCOCO fixture with the JAX e2e tests' config
(ResNet18, 64 px, 1+1 layers, hidden 64, max_position_embeddings 16), f32,
dropout 0, the JAX parameters moved across by ``weights.to_state_dict``.

- two epochs of ``train_one_epoch``: epoch losses within 1e-4 relative, with
  the port's ``jitter_draws`` patched to return the draws JAX makes for the
  same batch (``fold_in(fold_in(key, epoch), i)``, split as device_batch does);
- a recording step function sees the same batches in the same order
  (inline and staged);
- ``NonFiniteLossError.last_good_step`` and the steps run before the raise
  equal JAX's at pipeline depth 1, 2 and 3;
- staged and inline uploads bit-equal;
- ``evaluate`` within 1e-5 relative (attention kernel flag off and on);
- ``eval_model``: greedy ids_hypotheses and metrics equal, a ragged last
  batch, beam top hypotheses equal, sample at top_k=1 equal;
- a ``mesh`` that is not a ``parallel.mesh.Mesh`` raises ``TypeError`` (the
  mesh itself: tests/test_torch_parallel.py); ``use_pallas_attention`` cannot
  train and says so;
- ``pack_encoder_inputs``, ``MetricLogger`` and ``PhaseTimer`` as retr_tpu's;
  ``trace`` and ``enable_nan_debugging`` on torch's profiler and anomaly mode.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import engine as jengine
from retr_tpu.config import Config as JaxConfig
from retr_tpu.data import dataset as jdataset
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.models import caption as jcaption
from retr_tpu.train import state as jstate
from retr_tpu_torch import engine
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.models import layers, weights
from retr_tpu_torch.ops import image as imops
from retr_tpu_torch.train import state as tstate
from retr_tpu_torch.utils.profiling import PhaseTimer
from tests.synth_refcoco import make_synth_refcoco
from tests.test_torch_dataset import jax_batch_draws

SEED = 1          # the epoch loop's seed (JAX: jax.random.key(SEED))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine")
    coco_dir, ref_dir = make_synth_refcoco(str(root), n_images=12, sents_per_ann=[2, 1, 3])
    tok, jtok = prepare_tokenizer()[0], jax_prepare_tokenizer()[0]
    kw = dict(dir=coco_dir, ref_dir=ref_dir, verbose=False, backbone="ResNet18", dilation=False,
              hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=128,
              vocab_size=tok.vocab_size, max_position_embeddings=16, dropout=0.0, image_size=64,
              batch_size=2, num_workers=2, beam_size=3)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, tok=tok, jtok=jtok, params=params, sd=sd,
                                 tp=weights.to_params(sd, cfg, device="cpu"))


def _loaders(env, mode="training", unique=False, batch=2, **kw):
    ds = dataset.build_dataset(env.cfg, mode, tokenizer=env.tok, return_unique=unique)
    jds = jdataset.build_dataset(env.jcfg, mode, tokenizer=env.jtok, return_unique=unique)
    return dataset.DataLoader(ds, batch, num_workers=2, **kw), jdataset.DataLoader(jds, batch, num_workers=2, **kw)


def _jax_draws_by_seed(n_batches, rows, epochs=(0, 1)):
    """Port generator seed of each batch's target images -> the draws JAX's
    engine makes for that batch."""
    key = jax.random.key(SEED)
    out = {}
    for e in epochs:
        for i in range(n_batches):
            port_seed = layers.fold_in(layers.fold_in(layers.fold_in(SEED, e), i), 0)
            out[port_seed] = jax_batch_draws(jax.random.fold_in(jax.random.fold_in(key, e), i), rows, False)[0]
    return out


def _patch_jax_draws(monkeypatch, by_seed):
    monkeypatch.setattr(imops, "jitter_draws", lambda gen, n, dev: by_seed[gen.initial_seed()])


def test_two_epochs_match_reference(env, monkeypatch):
    loader, jloader = _loaders(env, shuffle=True, drop_last=True)
    assert len(loader) >= 4
    _patch_jax_draws(monkeypatch, _jax_draws_by_seed(len(loader), 2))
    tx = jstate.make_optimizer(env.jcfg, len(jloader), memo=False)
    jst = jstate.TrainState(env.params, tx.init(env.params), jnp.int32(0))
    jstep = jstate.make_train_step(env.jcfg, tx, donate=False, memo=False)
    st = tstate.create_train_state(env.cfg, env.tp, device="cpu", steps_per_epoch=len(loader))
    step = tstate.make_train_step(env.cfg)
    for epoch in (0, 1):
        jst, want = jengine.train_one_epoch(jst, jstep, jloader, jax.random.key(SEED), epoch=epoch)
        st, got = engine.train_one_epoch(st, step, loader, SEED, epoch=epoch, stage_uploads=epoch == 1)
        assert math.isfinite(got) and abs(got - want) <= 1e-4 * abs(want), (epoch, got, want)
    assert st.step == int(jst.step) == 2 * len(loader)


def _recorder(store, losses=None):
    """A step function for either engine: records the batch, returns the next loss."""
    def step(state, batch, seed):
        store.append(batch)
        loss = 1.0 if losses is None else losses[len(store) - 1]
        state.step += 1
        return state, loss
    return step


@pytest.mark.parametrize("stage_uploads", [False, True])
def test_recorded_step_sees_the_same_batches(env, monkeypatch, stage_uploads):
    loader, jloader = _loaders(env, shuffle=True, seed=4)
    _patch_jax_draws(monkeypatch, _jax_draws_by_seed(len(loader), 2, epochs=(1,)))
    got, want = [], []
    engine.train_one_epoch(types.SimpleNamespace(step=0, params=env.tp), _recorder(got), loader, SEED,
                           epoch=1, stage_uploads=stage_uploads)
    jengine.train_one_epoch(types.SimpleNamespace(step=0), _recorder(want), jloader, jax.random.key(SEED),
                            epoch=1)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        for name in ("image_masks", "caps", "cap_masks"):
            np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(w, name)))
        np.testing.assert_allclose(g.images.numpy(), np.asarray(w.images), atol=1e-5, rtol=0)


def _host_batches(env, n=6):
    loader, _ = _loaders(env)
    return list(loader)[:n]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_non_finite_loss_stops_as_reference(env, depth):
    """A NaN at step 3 of 6: the same last_good_step, message and number of
    steps dispatched before the raise."""
    hosts = _host_batches(env)
    losses = [1.0, 2.0, float("nan"), 1.0, 1.0, 1.0]
    got_calls, want_calls = [], []
    with pytest.raises(engine.NonFiniteLossError) as got:
        engine.train_one_epoch(types.SimpleNamespace(step=10, params=env.tp), _recorder(got_calls, losses),
                               hosts, SEED, pipeline_depth=depth)
    with pytest.raises(jengine.NonFiniteLossError) as want:
        jengine.train_one_epoch(types.SimpleNamespace(step=10), _recorder(want_calls, losses), hosts,
                                jax.random.key(SEED), pipeline_depth=depth)
    assert got.value.last_good_step == want.value.last_good_step == 12
    assert str(got.value) == str(want.value)
    assert len(got_calls) == len(want_calls) == 2 + depth


def test_staged_and_inline_uploads_bit_equal(env):
    loader, _ = _loaders(env, shuffle=True, seed=2)
    runs = []
    for staged in (False, True):
        store = []
        engine.train_one_epoch(types.SimpleNamespace(step=0, params=env.tp), _recorder(store), loader, 5,
                               epoch=3, stage_uploads=staged)
        runs.append(store)
    assert len(runs[0]) == len(runs[1]) == len(loader)
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("pallas", [False, True])
def test_evaluate_matches_reference(env, pallas):
    loader, jloader = _loaders(env, "validation", batch=3)
    want = jengine.evaluate(env.params, env.jcfg, jloader, eval_step=jstate.make_eval_step(env.jcfg, memo=False))
    got = engine.evaluate(env.tp, env.cfg.replace(use_pallas_attention=pallas), loader, pipeline_depth=3)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.fixture(scope="module")
def unique_val(env):
    """The validation split's unique annotations at batch 2: 3 of them, so the
    last batch is ragged."""
    loader, jloader = _loaders(env, "validation", unique=True)
    assert len(loader.dataset) % 2 == 1
    return loader, jloader


def test_eval_model_greedy_matches_reference(env, unique_val):
    loader, jloader = unique_val
    timer = PhaseTimer()
    got, got_h = engine.eval_model(env.tp, env.cfg, loader, env.tok, timer=timer)
    want, want_h = jengine.eval_model(env.params, env.jcfg, jloader, env.jtok)
    assert got_h == want_h and len(got_h) == len(loader.dataset)
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    phases = timer.summary()
    assert set(phases) == {"host_wait", "input", "decode", "fetch", "score"}
    assert phases["decode"]["count"] == len(loader)


def test_eval_model_ragged_batches_and_depth(env, unique_val):
    """Batch 2 (a ragged last batch) serial, and batch 3 pipelined: the same
    hypotheses and metrics."""
    loader, _ = unique_val
    one = engine.eval_model(env.tp, env.cfg, loader, env.tok, pipeline_depth=1)
    loader3, _ = _loaders(env, "validation", unique=True, batch=3)
    assert one == engine.eval_model(env.tp, env.cfg, loader3, env.tok)


def test_eval_model_beam_matches_reference(env, unique_val):
    loader, jloader = unique_val
    got, got_h = engine.eval_model(env.tp, env.cfg, loader, env.tok, decoder="beam")
    want, want_h = jengine.eval_model(env.params, env.jcfg, jloader, env.jtok, decoder="beam")
    assert got_h == want_h and got == want


def test_eval_model_sample_at_top_k_1_matches_reference(env, unique_val):
    loader, jloader = unique_val
    got = engine.eval_model(env.tp, env.cfg.replace(sample_top_k=1), loader, env.tok, decoder="sample")
    want = jengine.eval_model(env.params, env.jcfg.replace(sample_top_k=1), jloader, env.jtok, decoder="sample")
    assert got == want
    assert got == engine.eval_model(env.tp, env.cfg, loader, env.tok)   # argmax: greedy's


def test_mesh_and_unknown_decoder_raise(env, unique_val):
    hosts = _host_batches(env, 1)
    state = types.SimpleNamespace(step=0, params=env.tp)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        engine.train_one_epoch(state, _recorder([]), hosts, SEED, mesh=object())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        engine.evaluate(env.tp, env.cfg, hosts, mesh=object())
    with pytest.raises(ValueError, match="decoder"):
        engine.eval_model(env.tp, env.cfg, unique_val[0], env.tok, decoder="nucleus")


def test_training_with_the_attention_kernel_flag_raises(env):
    """fused_attention has no backward: train_one_epoch surfaces the wrapper's
    NotImplementedError instead of training on another path."""
    cfg = env.cfg.replace(use_pallas_attention=True)
    st = tstate.create_train_state(cfg, env.tp, device="cpu")
    with pytest.raises(NotImplementedError, match="VJP"):
        engine.train_one_epoch(st, tstate.make_train_step(cfg), _host_batches(env, 2), SEED)


@pytest.mark.parametrize("variant", [(False, False), (True, False), (False, True), (True, True)])
def test_pack_encoder_inputs_matches_reference(variant):
    g, loc = variant
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((2, 3, 8, 8)).astype(np.float32), rng.random((2, 8, 8)) > 0.5]
    if g:
        arrays += [rng.standard_normal((2, 3, 8, 8)).astype(np.float32), rng.random((2, 8, 8)) > 0.5]
    if loc:
        arrays.append(rng.random((2, 5)).astype(np.float32))
    got = engine.pack_encoder_inputs(tuple(arrays), g, loc)
    want = jengine.pack_encoder_inputs(tuple(arrays), g, loc)
    flat = [x for part in got if part is not None for x in (part if isinstance(part, tuple) else (part,))]
    jflat = [x for part in want if part is not None for x in (part if isinstance(part, tuple) else (part,))]
    assert [p is None for p in got] == [p is None for p in want]
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_logger_timer_trace_and_nan_debugging(tmp_path, capsys):
    """MetricLogger writes the JSONL lines retr_tpu's writes (timestamps
    aside); PhaseTimer summarises as retr_tpu's; trace writes a torch.profiler
    trace; enable_nan_debugging turns autograd's anomaly mode on and off."""
    import json

    from retr_tpu.utils.logging import MetricLogger as JMetricLogger
    from retr_tpu.utils.profiling import PhaseTimer as JPhaseTimer
    from retr_tpu_torch.utils import profiling
    from retr_tpu_torch.utils.logging import MetricLogger

    for cls, name in ((MetricLogger, "port.jsonl"), (JMetricLogger, "ref.jsonl")):
        with cls(str(tmp_path / name)) as logger:
            logger.log("train_step", step=1, loss=2.5)
            logger.log("epoch", epoch=0, val_loss=np.float32(1.5))
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["event"] for x in printed] == ["epoch", "epoch"]   # step lines stay in the file

    def records(name):
        return [{k: v for k, v in json.loads(x).items() if k != "t"} for x in open(tmp_path / name)]

    assert records("port.jsonl") == records("ref.jsonl") and len(records("port.jsonl")) == 2
    timers = []
    for cls in (PhaseTimer, JPhaseTimer):
        timer = cls()
        for _ in range(3):
            with timer.phase("decode"):
                pass
        timers.append(timer.summary())
    assert timers[0].keys() == timers[1].keys() and timers[0]["decode"].keys() == timers[1]["decode"].keys()
    assert timers[0]["decode"]["count"] == 3
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
