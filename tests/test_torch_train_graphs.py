"""The train and eval steps as the CUDA graphs of ops/graphs.py need them, on
the CPU (the graphs themselves are held against the eager steps on the card,
tests/test_torch_cuda.py), at the tiny config of tests/test_torch_graphs.py:

- the clip on the device (no host read) against optax's clip_by_global_norm
  below and above the threshold, then two AdamW updates against retr_tpu's
  optimizer chain (norms within 1e-6 relative, parameters within 5e-5 as
  tests/test_torch_train.py holds them);
- three steps against retr_tpu.train.state.make_train_step at dropout 0,
  accumulation 1 and 2 (losses within 1e-4);
- a step reads nothing back: Tensor.__float__, __int__, item, cpu, tolist
  and numpy raise inside it (torch's CPU AdamW reads its step counters with
  item(); the CUDA one, capturable, does not, so torch.optim may);
- the seed plan: the fold_in chains recorded in step s's make_generator
  calls, applied to step s+1's root, are the seeds the eager step s+1 asks
  for, with remat on and off and accumulation 1 and 2;
- the session key changes with each input a capture reads, and after
  load_checkpoint; a CPU step makes no session;
- run_step's protocol (warm-up, capture, replays, the plan's generators
  reseeded for each step, a resume's new key and the stale session
  dropped) with a stand-in for the CUDA graph (_StandIn), against the
  eager steps bit for bit.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from retr_tpu.config import Config as JaxConfig
from retr_tpu.models import caption as jcaption
from retr_tpu.train import state as jstate
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.pipeline import Batch
from retr_tpu_torch.models import layers, weights
from retr_tpu_torch.ops import graphs
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train import state as tstate

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=21, dropout=0.0, image_size=32,
            clip_max_norm=0.1, lr=1e-3, lr_backbone=1e-4, weight_decay=1e-4)
ROWS = 4


@pytest.fixture(scope="module")
def model():
    """retr_tpu's seeded tiny parameters (built under jax.jit) and the port's copy."""
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(3))
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, params=params, tp=tp)


def _batch_np(cfg, b=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    s, t = cfg.image_size, cfg.max_position_embeddings + 1
    img = rng.standard_normal((b, 3, s, s)).astype(np.float32)
    mask = np.zeros((b, s, s), bool)
    mask[0, :, s // 2:] = True
    caps = rng.integers(3, cfg.vocab_size, (b, t)).astype(np.int32)
    caps[:, 0] = 1
    caps[0, 6:] = 0
    caps[-1, 9:] = 0
    return dict(images=img, image_masks=mask, caps=caps, cap_masks=caps == 0)


def _tbatch(nb):
    return Batch(**{k: torch.from_numpy(v) for k, v in nb.items()})


def _state(model, cfg=None):
    return tstate.create_train_state(cfg or model["cfg"], model["tp"], device="cpu", steps_per_epoch=1000)


def _path(keypath):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in keypath)


@pytest.fixture(scope="module")
def jax_update(model):
    """retr_tpu's optimizer chain and one jitted update: (params, state,
    optax.clip_by_global_norm of the masked gradients) from gradients."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    labels = dict(tstate.tree_leaves_with_path(tstate.param_labels(model["tp"])))
    keep = {p: np.full(t.shape, labels[p] != "frozen", np.float32) for p, t in tstate.tree_leaves_with_path(model["tp"])}
    keep[("transformer", "embeddings", "word", "table")][cfg.pad_token_id] = 0.0
    mask = jax.tree_util.tree_map_with_path(lambda kp, _: jnp.asarray(keep[_path(kp)]), model["params"])
    tx = jstate.make_optimizer(jcfg, 1000, memo=False)

    @jax.jit
    def update(grads, opt, params):
        updates, opt = tx.update(grads, opt, params)
        masked = jax.tree.map(lambda g, m: g * m, grads, mask)
        return optax.apply_updates(params, updates), opt, optax.clip_by_global_norm(cfg.clip_max_norm).update(
            masked, None)[0]

    return tx, update


@pytest.mark.parametrize("side", ["below", "above"])
def test_device_clip_matches_optax(model, jax_update, side):
    """Gradients scaled to a global norm of half the threshold, or left at
    thousands: the port's pre-clip norm within 1e-6 relative of the norm of
    retr_tpu's masked gradients (PAD row and frozen leaves zeroed), its
    clipped gradients within 1e-7 of optax.clip_by_global_norm's (bit-equal
    below: g / 1 * 1), and the parameters after two AdamW updates within
    5e-5 of retr_tpu's make_optimizer chain."""
    cfg = model["cfg"]
    st = _state(model)
    labels = dict(tstate.tree_leaves_with_path(tstate.param_labels(st.params)))
    tx, jupdate = jax_update
    jparams = model["params"]
    jopt = tx.init(jparams)
    rng = np.random.default_rng(4)
    for update in range(2):
        grads = {p: rng.standard_normal(t.shape).astype(np.float32) for p, t in tstate.tree_leaves_with_path(st.params)}
        masked = {p: (np.zeros_like(g) if labels[p] == "frozen" else g.copy()) for p, g in grads.items()}
        masked[("transformer", "embeddings", "word", "table")][cfg.pad_token_id] = 0.0
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in masked.values()))
        if side == "below":
            scale = np.float32(0.5 * cfg.clip_max_norm / norm)
            grads = {p: g * scale for p, g in grads.items()}
            masked = {p: g * scale for p, g in masked.items()}
            norm *= float(scale)
        assert (norm < cfg.clip_max_norm) == (side == "below")
        for p, t in tstate.tree_leaves_with_path(st.params):
            if t.requires_grad:
                t.grad = torch.from_numpy(grads[p].copy())
        tstate.set_learning_rates(st)
        got = float(tstate._update(cfg, st))
        st.step += 1
        assert got == pytest.approx(norm, rel=1e-6)
        jgrads = jax.tree_util.tree_map_with_path(lambda kp, _: jnp.asarray(grads[_path(kp)]), jparams)
        jparams, jopt, clipped = jupdate(jgrads, jopt, jparams)
        want = {_path(kp): np.asarray(v) for kp, v in jax.tree_util.tree_flatten_with_path(clipped)[0]}
        for p, t in tstate.tree_leaves_with_path(st.params):
            if t.requires_grad:
                np.testing.assert_allclose(t.grad.numpy(), want[p], rtol=0, atol=1e-7, err_msg=str(p))
                if side == "below":
                    np.testing.assert_array_equal(t.grad.numpy(), masked[p], err_msg=str(p))
    ref = {_path(kp): np.asarray(v) for kp, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for p, t in tstate.tree_leaves_with_path(st.params):
        np.testing.assert_allclose(t.detach().numpy(), ref[p], rtol=0, atol=5e-5, err_msg=str(p))


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_reference(model, accum):
    """Three steps at dropout 0 on one batch of 4 rows: each loss within 1e-4
    of retr_tpu's compiled step's (accumulation 2: two micro-batches of 2)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    nb = _batch_np(cfg, seed=5)
    tx = jstate.make_optimizer(jcfg, 1000, memo=False)
    jst = jstate.TrainState(model["params"], tx.init(model["params"]), jnp.int32(0))
    jstep = jstate.make_train_step(jcfg, tx, donate=False, memo=False, accum_steps=accum)
    st = _state(model)
    step = tstate.make_train_step(cfg, accum_steps=accum)
    for i in range(3):
        jst, jloss = jstep(jst, jstate.Batch(**{k: jnp.asarray(v) for k, v in nb.items()}), jax.random.key(0))
        st, loss = step(st, _tbatch(nb), 0)
        assert abs(float(loss) - float(jloss)) < 1e-4, (i, float(loss), float(jloss))
    assert st.step == 3 and float(st.grad_norm) > 0


HOST_READS = ("__float__", "__int__", "item", "cpu", "tolist", "numpy")


@pytest.mark.parametrize("accum,remat", [(1, False), (2, True)])
def test_step_reads_nothing_back(model, accum, remat, monkeypatch):
    """Two train steps (dropout 0.1) and an eval step with every host read of
    HOST_READS raising inside them, except where torch.optim's CPU AdamW
    reads its own step counters; the loss is read after the step."""
    cfg = model["cfg"].replace(dropout=0.1, remat=remat)
    st = _state(model, cfg)
    step = tstate.make_train_step(cfg, accum_steps=accum)
    batch = _tbatch(_batch_np(cfg, seed=6))
    inside = {"on": False}

    def guard(name, orig):
        def read(self, *a, **kw):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if inside["on"] and not caller.startswith("torch.optim"):
                raise AssertionError(f"Tensor.{name} inside the step (from {caller})")
            return orig(self, *a, **kw)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    eval_step = tstate.make_eval_step(cfg)
    losses = []
    for _ in range(2):
        inside["on"] = True
        st, loss = step(st, batch, 1)
        inside["on"] = False
        losses.append(float(loss))
    inside["on"] = True
    val = eval_step(st.params, batch)
    inside["on"] = False
    assert all(np.isfinite(losses)) and np.isfinite(float(val)) and st.step == 2


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_seed_plan_replays_the_next_step(model, accum, remat, monkeypatch):
    """Step s runs under a SeedRecorder of its root; plan_seeds of its chains
    at step s+1's root are the seeds step s+1 passes to make_generator, in
    order: per micro-batch the source positions, the encoder layer, the
    decoder embedding and the two decoder layers, and under remat each
    layer again in the backward."""
    cfg = model["cfg"].replace(dropout=0.1, remat=remat)
    st = _state(model, cfg)
    step = tstate.make_train_step(cfg, accum_steps=accum)
    batch = _tbatch(_batch_np(cfg, seed=7))
    root = tstate.step_seed(11, st)
    recorder = layers.SeedRecorder(root)
    with layers.seed_hook(recorder):
        step(st, batch, 11)
    chains = recorder.chains
    assert len(chains) == accum * (5 + 3 * remat)
    planned = layers.plan_seeds(chains, tstate.step_seed(11, st))
    assert planned != layers.plan_seeds(chains, root)
    asked = []
    make = layers.make_generator

    def spy(seed, device):
        if seed is not None:
            asked.append(seed)
        return make(seed, device)

    monkeypatch.setattr(layers, "make_generator", spy)
    step(st, batch, 11)
    assert asked == planned


def test_step_generators_follow_the_plan():
    """StepGenerators hands out a seed's generators in call order, an
    ordinary one past the plan, and raises where a planned one went
    unused; a recorder ignores seeds not derived from its root."""
    root = 5
    a, b = layers.fold_in(root, 0), layers.fold_in(layers.fold_in(root, 1), 3)
    recorder = layers.SeedRecorder(root)
    with layers.seed_hook(recorder):
        for seed in (layers.fold_in(root, 0), layers.fold_in(layers.fold_in(root, 1), 3), layers.fold_in(9, 0)):
            layers.make_generator(seed, "cpu")
        layers.make_generator(a, "cpu")
    assert recorder.chains == [(0,), (1, 3), (0,)]
    assert layers.plan_seeds(recorder.chains, root) == [a, b, a]
    gens = [torch.Generator() for _ in range(3)]
    hook = layers.StepGenerators([a, b, a], gens)
    with layers.seed_hook(hook):
        assert layers.make_generator(a, "cpu") is gens[0]
        assert layers.make_generator(b, "cpu") is gens[1]
        assert layers.make_generator(a, "cpu") is gens[2]
        extra = layers.make_generator(a, "cpu")
        assert extra not in gens and extra.initial_seed() == a
        with pytest.raises(RuntimeError, match="already active"):
            layers.seed_hook(hook).__enter__()
    hook.check()
    with pytest.raises(RuntimeError, match="fewer dropout generators"):
        layers.StepGenerators([a], [torch.Generator()]).check()


def _key(cfg, st, batch, dtype=torch.float32, accum=1):
    return tstate.train_session_key(cfg, st, batch, dtype, accum)


KEY_INPUTS = ["rows", "image size", "compute dtype", "accum", "remat", "dropout", "use_pallas_attention",
              "config", "CE_IMPL", "a parameter", "a moment", "cudnn.deterministic"]


@pytest.mark.parametrize("what", KEY_INPUTS)
def test_session_key_changes_with_each_input(model, what, monkeypatch):
    """A train step's key, after one update (AdamW's state exists), against
    the key with one input changed; the eval step's key takes the batch's
    rows too (its ragged last batch has a session of its own)."""
    cfg = model["cfg"]
    st = _state(model)
    batch = _tbatch(_batch_np(cfg, seed=8))
    st, _ = tstate.make_train_step(cfg)(st, batch, 0)
    before = _key(cfg, st, batch)
    assert _key(cfg, st, batch) == before
    kw = dict(cfg=cfg, st=st, batch=batch)
    if what == "rows":
        kw["batch"] = _tbatch(_batch_np(cfg, b=2, seed=8))
    elif what == "image size":
        kw["batch"] = _tbatch(_batch_np(cfg.replace(image_size=48), seed=8))
    elif what == "compute dtype":
        kw["dtype"] = torch.bfloat16
    elif what == "accum":
        kw["accum"] = 2
    elif what == "remat":
        kw["cfg"] = cfg.replace(remat=True)
    elif what == "dropout":
        kw["cfg"] = cfg.replace(dropout=0.1)
    elif what == "use_pallas_attention":
        kw["cfg"] = cfg.replace(use_pallas_attention=True)
    elif what == "config":
        kw["cfg"] = cfg.replace(lr_drop=7)
    elif what == "CE_IMPL":
        monkeypatch.setattr(tstate, "CE_IMPL", "logsoftmax")
    elif what == "a parameter":
        st.params["mlp"]["layers"][0]["w"] = st.params["mlp"]["layers"][0]["w"].detach().clone().requires_grad_(True)
    elif what == "a moment":
        one = st.opt_state.state[st.opt_state.param_groups[0]["params"][0]]
        one["exp_avg"] = one["exp_avg"].clone()
    elif what == "cudnn.deterministic":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", not torch.backends.cudnn.deterministic)
    assert _key(**kw) != before
    if what == "rows":
        leaves = [t for _, t in tstate.tree_leaves_with_path(st.params)]
        keys = {graphs.step_session_key("eval", "cpu", torch.float32, b, accum_steps=1, cfg=cfg, tensors=leaves)
                for b in (batch, kw["batch"])}
        assert len(keys) == 2


def test_session_key_changes_after_load_checkpoint(model, tmp_path):
    """load_checkpoint copies the parameters in place but replaces AdamW's
    moments and step counters: the key changes, the parameters' part not."""
    cfg = model["cfg"]
    st = _state(model)
    batch = _tbatch(_batch_np(cfg, seed=9))
    st, _ = tstate.make_train_step(cfg)(st, batch, 0)
    before = _key(cfg, st, batch)
    params_before = [(id(t), t.data_ptr()) for _, t in tstate.tree_leaves_with_path(st.params)]
    path = ckpt.save_checkpoint(str(tmp_path), st, cfg, epoch=0)
    st, _ = ckpt.load_checkpoint(path, st)
    assert _key(cfg, st, batch) != before
    assert [(id(t), t.data_ptr()) for _, t in tstate.tree_leaves_with_path(st.params)] == params_before


def test_cpu_steps_make_no_session(model):
    """Train and eval steps on the CPU run eagerly, CUDA_GRAPHS on or not."""
    graphs.clear()
    cfg = model["cfg"]
    st = _state(model)
    batch = _tbatch(_batch_np(cfg, seed=10))
    assert tstate.CUDA_GRAPHS and not tstate._graphed(torch.device("cpu"), None)
    st, loss = tstate.make_train_step(cfg)(st, batch, 0)
    val = tstate.make_eval_step(cfg)(st.params, batch)
    assert graphs.sessions() == [] and np.isfinite(float(loss)) and np.isfinite(float(val))
    assert all(not torch.is_tensor(g["lr"]) and not g["capturable"] for g in st.opt_state.param_groups)


class _StandIn(graphs.StepSession):
    """run_step's protocol on the CPU: a StepSession whose graph is its body.
    Its capture runs the body once under the capture's generator hook and
    puts back what the body wrote (a CUDA capture records and runs
    nothing); a replay runs the body again with the session's generators
    handed out by the capture's seeds (a graph keeps the calls it
    recorded), seeded from the new step's plan as a replay reads them."""

    def __init__(self, kind, device, tensors, owner=None):
        self.loop, self.trees, self.device, self.generators, self.graphs = None, list(tensors), device, [], {}
        self.lock = threading.Lock()
        self.kind, self.owner, self.identities = kind, owner, graphs._identities(tensors)
        self.warm, self.plan, self.inputs, self.outputs = False, [], None, ()

    def warm_up(self, run):
        return run()

    def capture(self, chunks):
        ((i0, body),) = chunks
        self.capture_seeds = [g.initial_seed() for g in self.generators]
        saved = [(t, t.detach().clone()) for t in self.trees]
        body()
        with torch.no_grad():
            for t, copy in saved:
                t.copy_(copy)
        self.graphs[i0] = (body, {})

    def replay(self, i0):
        body, _ = self.graphs[i0]
        with layers.seed_hook(layers.StepGenerators(self.capture_seeds, self.generators)):
            body()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "StepSession", _StandIn)
    monkeypatch.setattr(tstate, "_graphed", lambda device, mesh: tstate.CUDA_GRAPHS and mesh is None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tstate, "CUDA_GRAPHS", True)
    graphs.clear()
    yield
    graphs.clear()


def _run(cfg, model, batches, graphed, accum=1, resume_at=None, tmp=None):
    tstate.CUDA_GRAPHS = graphed
    st = _state(model, cfg)
    step = tstate.make_train_step(cfg, accum_steps=accum)
    out = []
    for i, b in enumerate(batches):
        if i == resume_at:
            st, _ = ckpt.load_checkpoint(ckpt.save_checkpoint(tmp, st, cfg, epoch=0), st)
        st, loss = step(st, b, 3)
        out += [loss, st.grad_norm]
    tstate.CUDA_GRAPHS = True
    return st, out


@pytest.mark.parametrize("accum,remat,resume", [(1, False, False), (2, True, False), (1, False, True)])
def test_run_step_protocol_equals_the_eager_step(model, stand_in, accum, remat, resume, tmp_path):
    """Four steps at dropout 0.1 through run_step with _StandIn graphs (the
    warm-up, the capture and its replay, two replays; with ``resume`` a
    checkpoint loaded back before the third, whose new key warms up and
    captures anew and drops the stale session) against the eager steps:
    losses, grad norms and parameters equal bit for bit, one session."""
    cfg = model["cfg"].replace(dropout=0.1, remat=remat)
    batches = [_tbatch(_batch_np(cfg, seed=20 + i)) for i in range(4)]
    want_st, want = _run(cfg, model, batches, graphed=False, accum=accum)
    assert graphs.sessions() == []
    got_st, got = _run(cfg, model, batches, graphed=True, accum=accum, resume_at=2 if resume else None,
                       tmp=str(tmp_path))
    (session,) = graphs.sessions()
    assert session.kind == "train" and list(session.graphs) == [0] and session.owner is got_st.opt_state
    assert len(session.generators) == len(session.plan) == accum * (5 + 3 * remat)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    for (_, a), (_, b) in zip(tstate.tree_leaves_with_path(want_st.params), tstate.tree_leaves_with_path(got_st.params)):
        assert torch.equal(a, b)


def test_run_step_protocol_for_the_eval_step(model, stand_in):
    """The eval step through run_step with _StandIn graphs: three calls give
    the eager loss, and a ragged batch gets a session of its own."""
    cfg = model["cfg"]
    st = _state(model)
    batch, ragged = _tbatch(_batch_np(cfg, seed=30)), _tbatch(_batch_np(cfg, b=3, seed=31))
    step = tstate.make_eval_step(cfg)
    tstate.CUDA_GRAPHS = False
    want = step(st.params, batch)
    tstate.CUDA_GRAPHS = True
    assert all(torch.equal(step(st.params, batch), want) for _ in range(3))
    step(st.params, ragged)
    assert sorted((s.kind, s.inputs is None, len(s.graphs)) for s in graphs.sessions()) == \
        [("eval", False, 1), ("eval", True, 0)]
