"""The port's checkpoints (retr_tpu_torch/train/checkpoints.py) and the weight
bridge's inverse (``weights.to_state_dict``), held against retr_tpu on the CPU
at the JAX CLI tests' config (ResNet18, 1+1 layers, hidden 64, 64 px):

- ``to_params(to_state_dict(p)) == p`` bit for bit, for every variant, and
  ``to_state_dict`` of a JAX tree equals ``retr_tpu.models.torch_export``'s;
- a ``.pth`` the port exports imports into retr_tpu bit for bit, and one
  retr_tpu exports loads into the port and decodes greedy tokens equal to
  ``retr_tpu.decode.greedy``'s;
- save and load, inline and through ``AsyncSaver``: parameters, AdamW moments
  and step counters, ``step`` and ``grad_norm`` come back equal, the groups keep
  their schedules, the metadata has the JAX package's keys; a failed save
  re-raises at the next ``submit`` and at ``wait``; a save cut before its
  metadata never becomes ``latest_checkpoint``;
- ``config_from_checkpoint`` reads a directory retr_tpu wrote, its "tpu"
  device mapped to the port's default;
- resume is step-exact: two epochs against one, a save, a load into another
  model and one more epoch, dropout on, parameters and moments bit-equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import decode as jdecode
from retr_tpu.config import Config as JaxConfig
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.models import torch_export
from retr_tpu.train import checkpoints as jckpt
from retr_tpu.train import state as jstate
from retr_tpu_torch import decode, engine
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset
from retr_tpu_torch.data.pipeline import Batch
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, weights
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train import state as tstate
from tests.synth_refcoco import make_synth_refcoco

TINY = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1,
            dim_feedforward=128, vocab_size=97, max_position_embeddings=16, dropout=0.0, image_size=64,
            batch_size=2, device="cpu")
VARIANTS = {"plain": {}, "loc, learned": dict(use_location_features=True, position_embedding="learned"),
            "loc, glob": dict(use_location_features=True, use_global_features=True)}


def _leaves(tree):
    return list(tstate.tree_leaves_with_path(tree))


def _tensor(x):
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(_tensor(x), _tensor(y)), p


def _jax_leaves(tree):
    """(path, numpy leaf) in the port's path form."""
    return [(tuple(k.key if hasattr(k, "key") else k.idx for k in kp), np.asarray(leaf))
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def jax_model():
    jcfg, cfg = JaxConfig(**TINY), Config(**TINY)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    return jcfg, cfg, params


def _batch(seed=0, b=2, t=17, vocab=97, size=64):
    g = torch.Generator().manual_seed(seed)
    caps = torch.randint(1, vocab, (b, t), generator=g, dtype=torch.int32)
    cap_masks = torch.zeros((b, t), dtype=torch.bool)
    caps[1, 9:], cap_masks[1, 9:] = 0, True
    return Batch(torch.randn(b, 3, size, size, generator=g), torch.zeros(b, size, size, dtype=torch.bool),
                 caps, cap_masks)


def _trained_state(cfg, seed=0, steps=2):
    params, _ = caption.build_model(cfg, device="cpu")
    st = tstate.create_train_state(cfg, params, device="cpu", steps_per_epoch=1)
    step = tstate.make_train_step(cfg)
    for i in range(steps):
        st, _ = step(st, _batch(seed + i), 7)
    return st


def _new_template(cfg):
    params, _ = caption.build_model(cfg, seed=cfg.seed + 100, device="cpu")
    return tstate.create_train_state(cfg, params, device="cpu", steps_per_epoch=1)


def _assert_states_equal(got, want):
    _assert_trees_equal(got.params, want.params)
    assert got.step == want.step
    assert (got.grad_norm is None) == (want.grad_norm is None)
    if want.grad_norm is not None:
        assert torch.equal(got.grad_norm, want.grad_norm)
    gs, ws = got.opt_state.state_dict()["state"], want.opt_state.state_dict()["state"]
    assert gs.keys() == ws.keys() and len(ws) > 0
    for i in ws:
        for k in ws[i]:
            assert torch.equal(gs[i][k], ws[i][k]) and gs[i][k].device == ws[i][k].device, (i, k)


# ---------------------------------------------------------------------------------
# The weight bridge's inverse and .pth interop
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_round_trip_is_bit_exact(variant):
    cfg = Config(**TINY, **VARIANTS[variant])
    params, _ = caption.build_model(cfg, device="cpu")
    sd = weights.to_state_dict(params, cfg)
    weights.reference_module(cfg).load_state_dict(sd, strict=True)
    _assert_trees_equal(weights.to_params(sd, cfg), params)


def test_to_state_dict_of_a_jax_tree_equals_torch_export(jax_model):
    jcfg, cfg, params = jax_model
    want = torch_export.export_caption_model(params, jcfg)
    got = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    # and through the port's tree
    again = weights.to_state_dict(weights.to_params(got, cfg), cfg)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_port_pth_imports_into_retr_tpu_bit_exact(jax_model, tmp_path):
    jcfg, cfg, _ = jax_model
    st = _trained_state(cfg)
    path = ckpt.export_reference_checkpoint(st.params, cfg, str(tmp_path / "m.pth"), epoch=3, cider_score=0.5)
    jparams, meta = jckpt.import_reference_checkpoint(path, jcfg)
    assert meta == {"epoch": 3, "train_loss": meta["train_loss"], "val_loss": meta["val_loss"], "cider_score": 0.5}
    got = dict(_leaves(st.params))
    want = _jax_leaves(jparams)
    assert sorted(got) == sorted(p for p, _ in want)
    for p, x in want:
        assert np.array_equal(got[p].detach().numpy(), x), p
    blob = torch.load(path, weights_only=False)
    assert blob["optimizer_state_dict"] == {} and blob["lr_scheduler_state_dict"] == {}


def test_retr_tpu_pth_loads_and_decodes_as_retr_tpu_greedy(jax_model, tmp_path):
    jcfg, cfg, params = jax_model
    path = jckpt.export_reference_checkpoint(params, jcfg, str(tmp_path / "j.pth"), epoch=2, val_loss=1.5)
    tp, meta = ckpt.import_reference_checkpoint(path, cfg, device="cpu")
    assert meta["epoch"] == 2 and meta["val_loss"] == 1.5
    _assert_trees_equal(tp, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(3)
    img = rng.standard_normal((3, 3, 64, 64)).astype(np.float32)
    mask = np.zeros((3, 64, 64), bool)
    mask[1, :, 40:] = True
    want = np.asarray(jdecode.greedy(params, jcfg, JMasked(jnp.asarray(img), jnp.asarray(mask)),
                                     max_len=16, bos_token=1, eos_token=-1))
    got = decode.greedy(tp, cfg, Masked(torch.from_numpy(img), torch.from_numpy(mask)), max_len=16,
                        bos_token=1, eos_token=-1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkpoint_name_is_the_reference_template(variant):
    kw = dict(TINY, **VARIANTS[variant])
    assert ckpt.checkpoint_name(Config(**kw), 7) == jckpt.checkpoint_name(JaxConfig(**kw), 7)


# ---------------------------------------------------------------------------------
# The port's checkpoint directories
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("saver", ["sync", "async"])
def test_save_and_load_round_trip(tmp_path, saver):
    cfg = Config(**TINY)
    st = _trained_state(cfg)
    meta = dict(epoch=4, train_loss=2.5, val_loss=2.25, cider_score=0.125)
    if saver == "async":
        s = ckpt.AsyncSaver()
        w = st.params["mlp"]["layers"][0]["w"]
        kept = w.detach().clone()
        s.submit(str(tmp_path), st, cfg, **meta)
        # the snapshot is taken at submit: training on does not reach the files
        with torch.no_grad():
            w.add_(1.0)
        s.wait()
        with torch.no_grad():
            w.copy_(kept)
    else:
        ckpt.save_checkpoint(str(tmp_path), st, cfg, **meta)
    path = ckpt.latest_checkpoint(str(tmp_path), cfg)
    assert os.path.basename(path) == ckpt.checkpoint_name(cfg, 4)
    assert sorted(os.listdir(path)) == [ckpt.METADATA_FILE, ckpt.STATE_FILE]
    got_meta = ckpt.read_metadata(path)
    assert set(got_meta) == {"epoch", "step", "train_loss", "val_loss", "cider_score", "config"}
    assert {k: got_meta[k] for k in meta} == meta and got_meta["step"] == st.step == 2
    assert ckpt.config_from_checkpoint(path) == cfg

    restored, rmeta = ckpt.load_checkpoint(path, _new_template(cfg))
    assert rmeta == got_meta
    _assert_states_equal(restored, st)
    # the groups got their schedules back: one more step is the same on both
    step = tstate.make_train_step(cfg)
    _, want = step(st, _batch(9), 7)
    _, got = step(restored, _batch(9), 7)
    assert torch.equal(got, want)
    _assert_states_equal(restored, st)


def test_async_saver_failure_reraises_at_submit_and_at_wait(tmp_path):
    cfg = Config(**TINY)
    st = _trained_state(cfg, steps=1)
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    s = ckpt.AsyncSaver()
    s.submit(str(blocker), st, cfg, epoch=0)
    with pytest.raises(OSError):
        s.submit(str(tmp_path / "ok"), st, cfg, epoch=1)
    with pytest.raises(OSError):
        s.wait()


def test_latest_checkpoint_skips_directories_without_metadata(tmp_path):
    cfg = Config(**TINY)
    st = _trained_state(cfg, steps=1)
    for epoch in (0, 2):
        ckpt.save_checkpoint(str(tmp_path), st, cfg, epoch=epoch)
    os.makedirs(tmp_path / ckpt.checkpoint_name(cfg, 5))               # no metadata
    loc = cfg.replace(use_location_features=True)
    os.makedirs(tmp_path / ckpt.checkpoint_name(loc, 9))               # another variant
    open(tmp_path / ckpt.checkpoint_name(loc, 9) / ckpt.METADATA_FILE, "w").write("{}")
    assert ckpt.latest_checkpoint(str(tmp_path), cfg) == str(tmp_path / ckpt.checkpoint_name(cfg, 2))
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / ckpt.checkpoint_name(loc, 9))
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_save_cut_before_its_metadata_never_becomes_latest(tmp_path, monkeypatch):
    cfg = Config(**TINY)
    st = _trained_state(cfg, steps=1)
    ckpt.save_checkpoint(str(tmp_path), st, cfg, epoch=0)

    def cut(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.json, "dump", cut)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(str(tmp_path), st, cfg, epoch=1)
    half = tmp_path / ckpt.checkpoint_name(cfg, 1)
    assert os.listdir(half) == [ckpt.STATE_FILE]                       # weights first, no temporary left
    assert ckpt.latest_checkpoint(str(tmp_path), cfg) == str(tmp_path / ckpt.checkpoint_name(cfg, 0))


def test_config_from_a_retr_tpu_checkpoint_directory(jax_model, tmp_path):
    """retr_tpu writes an Orbax directory and its retr_metadata.json; the port
    reads the metadata (the weights come across as a .pth, not from Orbax)."""
    jcfg, _, params = jax_model
    jcfg = jcfg.replace(device="tpu", use_location_features=True)
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    tx = jstate.make_optimizer(jcfg, steps_per_epoch=1, memo=False)
    path = jckpt.save_checkpoint(str(tmp_path), jstate.TrainState(params, tx.init(params), jnp.int32(3)), jcfg,
                                 epoch=6, train_loss=1.0, val_loss=2.0, cider_score=0.25)
    assert ckpt.latest_checkpoint(str(tmp_path), Config(**TINY, use_location_features=True)) == path
    meta = ckpt.read_metadata(path)
    assert meta == jckpt.read_metadata(path) and meta["config"]["device"] == "tpu"
    cfg = ckpt.config_from_checkpoint(path)
    assert cfg.device == Config().device == "cuda"
    assert cfg.replace(device="tpu").to_dict() == jckpt.config_from_checkpoint(path).to_dict()


# ---------------------------------------------------------------------------------
# Step-exact resume
# ---------------------------------------------------------------------------------


def test_resume_is_step_exact(tmp_path):
    """Dropout on: the step's seeds come from ``state.step``, the epoch's
    shuffle and jitter from (seed, epoch), so a restored state continues the
    run bit for bit."""
    coco_dir, ref_dir = make_synth_refcoco(str(tmp_path / "data"), n_images=8)
    tok = prepare_tokenizer()[0]
    cfg = Config(**{**TINY, "vocab_size": tok.vocab_size, "dropout": 0.1, "dir": coco_dir, "ref_dir": ref_dir})
    loader = dataset.DataLoader(dataset.build_dataset(cfg, "training", tokenizer=tok), 2, shuffle=True,
                                drop_last=True, seed=cfg.seed, num_workers=2)
    step = tstate.make_train_step(cfg)
    params, _ = caption.build_model(cfg, device="cpu")

    def fresh(p):
        return tstate.create_train_state(cfg, p, device="cpu", steps_per_epoch=len(loader))

    straight = fresh(params)
    for epoch in (0, 1):
        straight, _ = engine.train_one_epoch(straight, step, loader, cfg.seed, epoch=epoch)

    first = fresh(params)
    first, _ = engine.train_one_epoch(first, step, loader, cfg.seed, epoch=0)
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), first, cfg, epoch=0)
    resumed, meta = ckpt.load_checkpoint(path, fresh(caption.build_model(cfg, seed=5, device="cpu")[0]))
    assert meta["epoch"] == 0 and resumed.step == len(loader)
    resumed, _ = engine.train_one_epoch(resumed, step, loader, cfg.seed, epoch=meta["epoch"] + 1)
    assert resumed.step == straight.step == 2 * len(loader)
    _assert_states_equal(resumed, straight)
