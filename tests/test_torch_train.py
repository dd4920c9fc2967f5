"""The port's training slice held against retr_tpu on a tiny config (ResNet18,
64 px, one encoder and one decoder layer, hidden 64, vocab 96), with the JAX
parameters moved across by ``weights.to_state_dict`` and the same seeded
numpy batch fed to both.

Tolerances: logits 1e-4 (f32; the two frameworks sum convolutions and products
in other orders); losses 2e-5 and parameters after two AdamW updates 5e-5 (as
tests/test_train_parity.py holds retr_tpu against torch); port-against-port
checks as tests/test_train.py holds retr_tpu against itself. The JAX side
compiles two programs here (one train step, one eval step); the forward checks
run eagerly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import retr_tpu.ops.attention as jattn
from retr_tpu.config import Config as JaxConfig
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.train import state as jstate
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.pipeline import Batch
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, layers, weights
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.train import state as tstate

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1,
            dim_feedforward=128, vocab_size=96, max_position_embeddings=10, dropout=0.0, image_size=64,
            clip_max_norm=0.1, lr=1e-3, lr_backbone=1e-4, weight_decay=1e-4)
B = 2


def _cfgs(**kw):
    return JaxConfig(**{**TINY, **kw}), Config(**{**TINY, **kw})


def _model(jcfg, cfg, seed=0):
    params, _ = jcaption.build_model(jcfg, jax.random.key(seed))
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    return params, weights.to_params(sd, cfg, device="cpu")


def _batch_np(cfg, b=B, seed=0):
    rng = np.random.default_rng(seed)
    s, t = cfg.image_size, cfg.max_position_embeddings + 1
    img = rng.standard_normal((b, 3, s, s)).astype(np.float32)
    mask = np.zeros((b, s, s), bool)
    mask[0, :, s // 2:] = True
    caps = rng.integers(3, cfg.vocab_size, (b, t)).astype(np.int32)
    caps[:, 0] = 1
    caps[0, 6:] = 0
    caps[-1, 8:] = 0
    out = dict(images=img, image_masks=mask, caps=caps, cap_masks=caps == 0)
    if cfg.use_global_features:
        gimg = rng.standard_normal((b, 3, s, s)).astype(np.float32)
        gmask = np.zeros((b, s, s), bool)
        gmask[-1, s * 3 // 4:, :] = True
        out.update(global_images=gimg, global_masks=gmask)
    if cfg.use_location_features:
        out["loc_feats"] = rng.random((b, 5)).astype(np.float32)
    return out


def _jbatch(nb):
    return jstate.Batch(**{k: jnp.asarray(v) for k, v in nb.items()})


def _tbatch(nb):
    return Batch(**{k: torch.from_numpy(v) for k, v in nb.items()})


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("variant", [(False, False), (False, True), (True, True)])
def test_forward_logits_match(variant, pallas, monkeypatch):
    """Teacher-forced logits [B, T, V]; with the flag on, JAX runs its Pallas
    kernel in interpret mode and the port the kernel's plain version."""
    g, loc = variant
    jcfg, cfg = _cfgs(use_global_features=g, use_location_features=loc, use_pallas_attention=pallas)
    params, tp = _model(jcfg, cfg, seed=1)
    nb = _batch_np(cfg, seed=2)
    jb, tb = _jbatch(nb), _tbatch(nb)
    monkeypatch.setattr(jattn, "FORCE_INTERPRET", pallas)
    ref = jcaption.forward(
        params, jcfg, JMasked(jb.images, jb.image_masks), jb.caps[:, :-1], jb.cap_masks[:, :-1],
        global_samples=JMasked(jb.global_images, jb.global_masks) if g else None, loc_feats=jb.loc_feats)
    dk.reset_launches()
    with torch.no_grad():
        got = caption.forward(
            tp, cfg, Masked(tb.images, tb.image_masks), tb.caps[:, :-1], tb.cap_masks[:, :-1],
            global_samples=Masked(tb.global_images, tb.global_masks) if g else None, loc_feats=tb.loc_feats)
    t = cfg.max_position_embeddings
    assert tuple(got.shape) == (B, t, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert dk.LAUNCHES["fused_attention"] == 0      # the CPU runs the plain version


def test_eval_step_matches():
    """Validation loss, flag off (JAX's eval program) and on (the port's kernel
    path on the CPU against the same JAX value)."""
    jcfg, cfg = _cfgs()
    params, tp = _model(jcfg, cfg, seed=3)
    nb = _batch_np(cfg, seed=4)
    ref = float(jstate.make_eval_step(jcfg, memo=False)(params, _jbatch(nb)))
    got = tstate.make_eval_step(cfg)(tp, _tbatch(nb))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - ref) < 2e-5
    got_p = tstate.make_eval_step(cfg.replace(use_pallas_attention=True))(tp, _tbatch(nb))
    assert abs(float(got_p) - ref) < 2e-5


# the leaves compared after two updates: head (rest), encoder FF (rest),
# backbone layer2 conv (backbone group); conv1 is frozen
COMPARED = [("mlp", "layers", 0, "w"), ("transformer", "encoder", "layers", 0, "ff", "lin1", "w"),
            ("backbone", "layer2", 0, "conv1", "w")]


def test_two_train_steps_match_reference():
    """Two updates at dropout 0: losses within 2e-5, parameters within 5e-5 of
    retr_tpu's make_train_step. Step 2 is the one a clip mismatch would show:
    AdamW's first update is sign(g) whatever the clip factor."""
    jcfg, cfg = _cfgs()
    params, tp = _model(jcfg, cfg, seed=5)
    nb = _batch_np(cfg, seed=6)
    tx = jstate.make_optimizer(jcfg, 1000, memo=False)
    jst = jstate.TrainState(params, tx.init(params), jnp.int32(0))
    jstep = jstate.make_train_step(jcfg, tx, donate=False, memo=False)
    st = tstate.create_train_state(cfg, tp, device="cpu", steps_per_epoch=1000)
    step = tstate.make_train_step(cfg)
    conv1 = st.params["backbone"]["conv1"]["w"].clone()
    for i in range(2):
        jst, jloss = jstep(jst, _jbatch(nb), jax.random.key(0))
        st, loss = step(st, _tbatch(nb), 0)
        assert abs(float(loss) - float(jloss)) < 2e-5, (i, float(loss), float(jloss))
        for path in COMPARED:
            np.testing.assert_allclose(_leaf(st.params, path).detach().numpy(),
                                       np.asarray(_leaf(jst.params, path)), atol=5e-5, err_msg=str(path))
    assert st.step == 2 and int(jst.step) == 2
    torch.testing.assert_close(st.params["backbone"]["conv1"]["w"], conv1, rtol=0, atol=0)
    np.testing.assert_array_equal(st.params["backbone"]["conv1"]["w"].numpy(),
                                  np.asarray(jst.params["backbone"]["conv1"]["w"]))
    table = st.params["transformer"]["embeddings"]["word"]["table"]
    assert not table.grad[cfg.pad_token_id].any()           # PAD row: zero gradient
    assert table.grad[nb["caps"][0, 1]].abs().sum() > 0
    assert st.params["backbone"]["layer2"][0]["bn1"]["scale"].grad is None   # frozen BN affine


def test_param_labels_equal_reference_by_name():
    jcfg, cfg = _cfgs(use_global_features=True, use_location_features=True)
    params, tp = _model(jcfg, cfg)
    ref = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): lab
           for path, lab in jax.tree_util.tree_flatten_with_path(jstate.param_labels(params))[0]}
    got = dict(tstate.tree_leaves_with_path(tstate.param_labels(tp)))
    assert got == ref
    assert set(got.values()) == {"frozen", "backbone", "rest"}


@pytest.mark.parametrize("kw", [dict(lr_schedule="step", lr_drop=2), dict(lr_schedule="step", warmup_steps=7),
                                dict(lr_schedule="cosine", epochs=3), dict(lr_schedule="cosine", warmup_steps=5)])
def test_schedule_equals_reference(kw):
    """Equal up to the f32 rounding of optax's schedules (the port's are f64)."""
    jcfg, cfg = _cfgs(**kw)
    jsched = jstate.build_schedule(jcfg, 3e-4, 10)
    sched = tstate.build_schedule(cfg, 3e-4, 10)
    for count in (0, 1, 4, 5, 6, 9, 10, 19, 20, 29, 30, 45, 100):
        assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-6, abs=1e-6 * 3e-4), count


def test_accumulation_equals_full_batch():
    """accum_steps=2 gives the full batch's update (port against port)."""
    cfg = Config(**TINY)
    _, tp = _model(JaxConfig(**TINY), cfg, seed=7)
    nb = _batch_np(cfg, b=4, seed=8)
    states = {}
    for accum in (1, 2):
        st = tstate.create_train_state(cfg, tp, device="cpu")
        st, loss = tstate.make_train_step(cfg, accum_steps=accum)(st, _tbatch(nb), 3)
        states[accum] = (st, float(loss))
    assert states[2][1] == pytest.approx(states[1][1], rel=1e-6)
    full = dict(tstate.tree_leaves_with_path(states[1][0].params))
    for path, leaf in tstate.tree_leaves_with_path(states[2][0].params):
        np.testing.assert_allclose(leaf.detach().numpy(), full[path].detach().numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=str(path))
    with pytest.raises(ValueError, match="not divisible"):
        tstate.make_train_step(cfg, accum_steps=3)(states[1][0], _tbatch(nb), 3)


def test_remat_gradients_equal_plain_with_dropout():
    """cfg.remat recomputes each backbone block and transformer layer in the
    backward; dropout generators are made inside the recomputed functions from
    integer seeds, so the masks and every gradient are the same (port against
    port, dropout 0.1, one seed)."""
    cfg = Config(**{**TINY, "dropout": 0.1})
    _, tp = _model(JaxConfig(**TINY), cfg, seed=9)
    batch = _tbatch(_batch_np(cfg, seed=10))
    grads, losses = {}, {}
    for name, c in (("plain", cfg), ("remat", cfg.replace(remat=True))):
        st = tstate.create_train_state(c, tp, device="cpu")
        loss = tstate.loss_fn(st.params, c, batch, 11, train=True)
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {p: t.grad for p, t in tstate.tree_leaves_with_path(st.params) if t.requires_grad}
    assert losses["plain"] == losses["remat"]
    assert grads["plain"].keys() == grads["remat"].keys()
    for path, g in grads["plain"].items():
        np.testing.assert_allclose(grads["remat"][path].numpy(), g.numpy(), atol=1e-6, err_msg=str(path))
    # dropout is on: another seed gives another loss
    st = tstate.create_train_state(cfg, tp, device="cpu")
    assert float(tstate.loss_fn(st.params, cfg, batch, 12, train=True).detach()) != losses["plain"]


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000)
    y = layers.dropout(x, 0.1, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert float(kept.float().mean()) == pytest.approx(0.9, abs=0.003)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert layers.dropout(x, 0.1, torch.Generator().manual_seed(0), False) is x
    assert layers.dropout(x, 0.1, None, True) is x
    a = layers.dropout(x, 0.5, layers.make_generator(layers.fold_in(7, 3), "cpu"), True)
    b = layers.dropout(x, 0.5, layers.make_generator(layers.fold_in(7, 3), "cpu"), True)
    c = layers.dropout(x, 0.5, layers.make_generator(layers.fold_in(7, 4), "cpu"), True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_step_with_the_kernel_and_no_dropout_raises():
    """Flag on and dropout 0: autograd would need the fused kernel's gradient,
    which neither package defines."""
    cfg = Config(**{**TINY, "use_pallas_attention": True})
    _, tp = _model(JaxConfig(**TINY), cfg, seed=12)
    st = tstate.create_train_state(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="no backward"):
        tstate.make_train_step(cfg)(st, _tbatch(_batch_np(cfg, seed=13)), 0)
    # with attention dropout on, training takes the plain path and runs
    cfg_d = cfg.replace(dropout=0.1)
    st = tstate.create_train_state(cfg_d, tp, device="cpu")
    _, loss = tstate.make_train_step(cfg_d)(st, _tbatch(_batch_np(cfg, seed=13)), 0)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("impl", ["fused", "logsoftmax"])
def test_cross_entropy_forms_equal_reference(impl, monkeypatch):
    """Both CE_IMPL forms: the mean over all positions, PAD included, equal to
    retr_tpu's in value and gradient."""
    rng = np.random.default_rng(14)
    logits = rng.normal(size=(4, 7, 33)).astype(np.float32) * 5.0
    targets = rng.integers(0, 33, (4, 7)).astype(np.int32)
    targets[:, 5:] = 0
    monkeypatch.setattr(jstate, "CE_IMPL", impl)
    monkeypatch.setattr(tstate, "CE_IMPL", impl)
    ref, ref_g = jax.value_and_grad(jstate._cross_entropy)(jnp.asarray(logits), jnp.asarray(targets))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tstate.cross_entropy(lt, torch.from_numpy(targets))
    got.backward()
    assert abs(float(got.detach()) - float(ref)) < 1e-6
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_g), atol=1e-7)
