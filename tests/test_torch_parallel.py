"""The port's (dp, mp) mesh (retr_tpu_torch/parallel/mesh.py), its
tensor-parallel model, train step, evaluate, checkpoints and main held
against retr_tpu on the CPU, on worlds of real processes over gloo
(tests/torch_parallel_worker.py, a FileStore under tmp_path).

The JAX e2e tests' config: ResNet18, 64 px, 1+1 layers, hidden 64, 4 heads,
FF 128, vocab 342 (so the head splits at mp=2 and falls back to replicated
at mp=4), dropout 0, f32, the synthetic RefCOCO of tests/synth_refcoco.py.
Each world (dp=2, mp=2, dp=2 x mp=2) runs once for the module; the tests
read what its ranks wrote.

- ``param_shardings`` equals JAX's specs after ``fit``, leaf for leaf (mp 2
  and 4, with and without ``loc_proj`` and ``src_pos``); ``shard_params``
  slices equal the JAX arrays' shards on the devices at the same mesh
  position (JAX's 8-device CPU mesh); ``gather_params`` gives the tree back
  bit for bit; the rank layout is JAX's ``make_mesh(dp, mp).devices``;
- ``validate_multihost_launch`` raises as JAX's, with its message;
- ``caption.forward`` logits under mp=2 (kernel flag off and on) within
  1e-5 of max(1, max|logit|) of JAX's;
- two train steps on each world: losses within 1e-5 relative and
  parameters within 1e-5 of max(1, max|leaf|) of the world of one at the
  global batch and of retr_tpu's ``make_train_step``, ``grad_norm`` within
  1e-5 relative of the world of one's (retr_tpu keeps none); at dropout 0.1
  mp=2's step equals the world of one's;
- ``evaluate`` on dp=2 (batches of 2, and 3 + a ragged 1) within 1e-6
  relative of retr_tpu's;
- ``main`` on dp=2 for 2 epochs: epoch losses within 1e-4 of the world of one
  at twice the batch, rank 0 alone moves checkpoint files into place, rank 1
  logs to ``metrics.p1.jsonl``; a launch whose mesh is not the world raises
  on every rank before any step; a checkpoint saved under mp=2 restores into
  a world of one and trains a step.
"""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retr_tpu import engine as jengine
from retr_tpu import main as jmain
from retr_tpu.config import Config as JaxConfig
from retr_tpu.data import dataset as jdataset
from retr_tpu.data import pipeline as jpipeline
from retr_tpu.data.tokenizer import prepare_tokenizer as jax_prepare_tokenizer
from retr_tpu.masking import Masked as JMasked
from retr_tpu.models import caption as jcaption
from retr_tpu.parallel import mesh as jmesh
from retr_tpu.train import state as jstate
from retr_tpu_torch import main as tmain
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset
from retr_tpu_torch.data.pipeline import device_batch
from retr_tpu_torch.data.tokenizer import DEFAULT_TEST_WORDS, WordPieceTokenizer, prepare_tokenizer
from retr_tpu_torch.models import caption, weights
from retr_tpu_torch.ops import image as imops
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train import state as tstate
from tests.synth_refcoco import make_synth_refcoco
from tests.torch_parallel_worker import neutral_jitter, run_world

VOCAB = 342
GLOBAL_BATCH = 4


def make_env(root):
    """The synthetic RefCOCO (16 images, one sentence each: 8 training, 4
    validation and 4 testA annotations), a 342-word vocabulary file, the JAX
    parameters and their state dict, and ``setup.json`` for the workers."""
    coco_dir, ref_dir = make_synth_refcoco(root, n_images=16, sents_per_ann=1)
    tok = WordPieceTokenizer.synthetic(DEFAULT_TEST_WORDS, vocab_size=VOCAB)
    vocab_file = os.path.join(root, "vocab.txt")
    with open(vocab_file, "w") as f:
        f.writelines(t + "\n" for t, _ in sorted(tok.vocab.items(), key=lambda kv: kv[1]))
    kw = dict(dir=coco_dir, ref_dir=ref_dir, ref_base=os.path.dirname(ref_dir), backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4,
              enc_layers=1, dec_layers=1, dim_feedforward=128, vocab_size=VOCAB, max_position_embeddings=16,
              dropout=0.0, image_size=64, batch_size=2, num_workers=1, beam_size=3, vocab_file=vocab_file,
              verbose=False, project_data_path=os.path.join(root, "data"))
    jcfg, cfg = JaxConfig(**kw), Config(**kw, device="cpu")
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    sd = weights.to_state_dict(jax.tree.map(np.asarray, params), cfg)
    in_dir = os.path.join(root, "in")
    os.makedirs(in_dir)
    torch.save(sd, os.path.join(in_dir, "init.pt"))
    setup = {"cfg": {**kw, "device": "cpu"}, "root": root, "global_batch": GLOBAL_BATCH, "sweep_batch": 3,
             "main": {"epochs": 2, "early_stopping": False, "async_checkpoints": True, "seed": 3}}
    return types.SimpleNamespace(root=root, in_dir=in_dir, setup=setup, jcfg=jcfg, cfg=cfg, params=params, sd=sd,
                                 tok=prepare_tokenizer(vocab_file)[0], jtok=jax_prepare_tokenizer(vocab_file)[0],
                                 tp=weights.to_params(sd, cfg, device="cpu"))


def write_setup(env, **extra):
    env.setup.update(extra)
    with open(os.path.join(env.in_dir, "setup.json"), "w") as f:
        json.dump(env.setup, f)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    env = make_env(str(tmp_path_factory.mktemp("parallel")))
    write_setup(env)
    out_dir = os.path.join(env.root, "out")
    os.makedirs(out_dir)
    env.worlds = {shape: run_world(f"{shape}_parallel", n, env.in_dir, out_dir)
                  for shape, n in (("2x1", 2), ("1x2", 2), ("2x2", 4))}
    return env


def _close(got, want, rel):
    return math.isfinite(got) and abs(got - want) <= rel * abs(want)


def _leaf_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and float(np.abs(a - b).max(initial=0.0)) <= rel * max(1.0, float(np.abs(b).max(initial=0.0)))


# -- specs, shards, layout, launch rules (no world needed) -----------------------------


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("variant", [("sine", False), ("learned", True)])
def test_param_shardings_equal_jax_specs_after_fit(mp, variant):
    pos, loc = variant
    kw = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
              dim_feedforward=128, vocab_size=VOCAB, max_position_embeddings=16, image_size=64,
              position_embedding=pos, use_location_features=loc)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    shapes = jax.eval_shape(lambda k: jcaption.build_model(jcfg, k)[0], jax.random.key(0))
    want = [tuple(s.spec) for s in jax.tree.leaves(jmesh.param_shardings(shapes, jmesh.make_mesh(8 // mp, mp)))]
    tp = caption.init(torch.Generator().manual_seed(0), cfg)
    got = pmesh.leaves(pmesh.param_shardings(tp, mp, cfg.nheads))
    assert [tuple(x.shape) for x in pmesh.leaves(tp)] == [tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert ("src_pos" in tp["transformer"]) == (pos == "learned") and ("loc_proj" in tp) == loc
    assert got == want
    head = pmesh.param_shardings(tp, mp)["mlp"]["layers"][-1]["w"]
    assert head == ((None, "mp") if VOCAB % mp == 0 else ())   # the vocab head falls back at mp=4


@pytest.fixture(scope="module")
def tiny():
    """JAX parameters and the port's tree of the same values (no worlds)."""
    root_kw = dict(backbone="ResNet18", dilation=False, hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1,
                   dim_feedforward=128, vocab_size=VOCAB, max_position_embeddings=16, image_size=64)
    jcfg, cfg = JaxConfig(**root_kw), Config(**root_kw, device="cpu")
    params = jax.jit(lambda k: jcaption.build_model(jcfg, k)[0])(jax.random.key(0))
    tp = weights.to_params(weights.to_state_dict(jax.tree.map(np.asarray, params), cfg), cfg, device="cpu")
    return jcfg, cfg, params, tp


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_params_slices_equal_jax_shards(tiny, mp):
    jcfg, cfg, params, tp = tiny
    jm = jmesh.make_mesh(8 // mp, mp)
    placed = jax.tree.leaves(jmesh.shard_params(params, jm))
    specs = pmesh.param_shardings(tp, mp, cfg.nheads)
    position = {d.id: (i, j) for (i, j), d in np.ndenumerate(jm.devices)}
    for dev in jm.devices.flat:
        i, j = position[dev.id]
        m = pmesh.Mesh(8 // mp, mp, i * mp + j, i, j, None, None, None, torch.device("cpu"))
        local = pmesh.leaves(pmesh.shard_params(tp, m, specs))
        for x, arr in zip(local, placed):
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(x.numpy(), np.asarray(shard.data))


def test_rank_layout_is_jax_mesh_layout(env):
    """Rank r sits where JAX's make_mesh puts the r-th device."""
    for shape, ranks in env.worlds.items():
        dp, mp = (int(x) for x in shape.split("x"))
        devices = jmesh.make_mesh(dp, mp).devices
        want = [tuple(int(v) for v in np.argwhere(devices == d)[0]) for d in jax.devices()[: dp * mp]]
        assert [tuple(r["layout"]) for r in ranks] == want, shape


GRID = [(p, n, dp, mp, b, mesh) for p, n in ((1, 1), (2, 2), (2, 4), (4, 4)) for dp, mp in ((1, 1), (2, 1), (2, 2), (4, 1))
        for b in (2, 3) for mesh in (True, False)]


@pytest.mark.parametrize("grid", [GRID[i::4] for i in range(4)], ids=[f"part{i}" for i in range(4)])
def test_validate_multihost_launch_as_jax(grid):
    for p, n, dp, mp, b, has_mesh in grid:
        outcome = []
        for fn, config in ((jmain.validate_multihost_launch, JaxConfig), (tmain.validate_multihost_launch, Config)):
            try:
                fn(config(dp_size=dp, mp_size=mp, batch_size=b), p, n, has_mesh=has_mesh)
                outcome.append(None)
            except ValueError as exc:
                outcome.append(str(exc))
        assert outcome[0] == outcome[1], (p, n, dp, mp, b, has_mesh, outcome)


# -- the worlds ------------------------------------------------------------------


def test_gather_params_returns_the_tree_bit_for_bit(env):
    for shape, ranks in env.worlds.items():
        assert all(r["gather_bit_equal"] for r in ranks), shape
        # mp=2: three attention blocks of 7 sharded leaves, two FF blocks of 3, the head's 2
        assert ranks[0]["sharded_leaves"] == (0 if shape == "2x1" else 3 * 7 + 2 * 3 + 2), shape


def _jax_batch(env, n):
    jds = jdataset.build_dataset(env.jcfg, "training", tokenizer=env.jtok)
    return jpipeline.device_batch(next(iter(jdataset.DataLoader(jds, n, num_workers=1))), train=False)


def _port_batch(env, n):
    ds = dataset.build_dataset(env.cfg, "training", tokenizer=env.tok)
    return device_batch(next(iter(dataset.DataLoader(ds, n, num_workers=1))), torch.device("cpu"))


@pytest.mark.parametrize("pallas", [False, True])
def test_forward_logits_under_mp2_match_jax(env, pallas):
    """The port's flag on runs the kernel's plain version on each rank's 2 heads."""
    jb = _jax_batch(env, GLOBAL_BATCH)
    want = np.asarray(jcaption.forward(env.params, env.jcfg, JMasked(jb.images, jb.image_masks),
                                       jb.caps[:, :-1], jb.cap_masks[:, :-1]))
    got = torch.cat([r[f"logits_pallas_{pallas}"] for r in env.worlds["1x2"]], dim=-1).numpy()
    assert env.worlds["1x2"][0][f"logits_pallas_{pallas}"].shape[-1] == VOCAB // 2    # the head is split
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.fixture(scope="module")
def one(env):
    """Two train steps of the world of one (the port without a mesh) and of
    retr_tpu at the global batch, and one port step at dropout 0.1."""
    batch = _port_batch(env, GLOBAL_BATCH)
    st = tstate.create_train_state(env.cfg, env.tp, device="cpu", steps_per_epoch=4)
    step = tstate.make_train_step(env.cfg)
    losses, norms = [], []
    for _ in range(2):
        st, loss = step(st, batch, 5)
        losses.append(float(loss))
        norms.append(float(st.grad_norm))
    drop = tstate.create_train_state(env.cfg.replace(dropout=0.1), env.tp, device="cpu", steps_per_epoch=4)
    _, drop_loss = tstate.make_train_step(env.cfg.replace(dropout=0.1))(drop, batch, 5)

    tx = jstate.make_optimizer(env.jcfg, 4, memo=False)
    jst = jstate.TrainState(env.params, tx.init(env.params), jnp.int32(0))
    jstep = jstate.make_train_step(env.jcfg, tx, donate=False, memo=False)
    jb = _jax_batch(env, GLOBAL_BATCH)
    jlosses = []
    for _ in range(2):
        jst, jloss = jstep(jst, jb, jax.random.key(5))
        jlosses.append(float(jloss))
    return types.SimpleNamespace(
        losses=losses, norms=norms, params=weights.to_state_dict(st.params, env.cfg), drop_loss=float(drop_loss),
        jlosses=jlosses,
        jparams=weights.to_state_dict(jax.tree.map(np.asarray, jst.params), env.cfg))


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_two_train_steps_match_the_world_of_one_and_jax(env, one, shape):
    ranks = env.worlds[shape]
    for r in ranks:
        for got, a, b in zip(r["losses"], one.losses, one.jlosses):
            assert _close(got, a, 1e-5) and _close(got, b, 1e-5), (shape, got, a, b)
        for got, want in zip(r["norms"], one.norms):   # retr_tpu's step keeps no norm
            assert _close(got, want, 1e-5), (shape, got, want)
    got = ranks[0]["params"]
    assert set(got) == set(one.params)
    for k in got:
        assert _leaf_close(got[k].numpy(), one.params[k].detach().numpy(), 1e-5), (shape, k)
        assert _leaf_close(got[k].numpy(), one.jparams[k], 1e-5), (shape, k)


def test_dropout_step_under_mp2_equals_the_world_of_one(env, one):
    """The attention dropout mask of all heads cut to each rank's heads, the
    replicated activations' masks drawn alike: mp=2 draws what mp=1 draws."""
    for r in env.worlds["1x2"]:
        assert _close(r["dropout_losses"][0], one.drop_loss, 1e-5), (r["dropout_losses"], one.drop_loss)
    assert not _close(one.drop_loss, one.losses[0], 1e-4)   # dropout did act


@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("pallas", [False, True])
def test_evaluate_on_dp2_matches_jax(env, batch, pallas):
    """Batch 2 splits 1 + 1 over dp; batch 3 gives 3 and a ragged 1, each
    computed whole on both ranks. The port's flag on runs the kernel's plain
    version; JAX's reference is its XLA path."""
    jds = jdataset.build_dataset(env.jcfg, "validation", tokenizer=env.jtok)
    assert len(jds) == 4
    want = jengine.evaluate(env.params, env.jcfg, jdataset.DataLoader(jds, batch, num_workers=1),
                            eval_step=jstate.make_eval_step(env.jcfg, memo=False))
    for r in env.worlds["2x1"]:
        got = r[f"evaluate_{batch}_{pallas}"]
        assert _close(got, want, 1e-6), (got, want)


@pytest.fixture(scope="module")
def main_one(env):
    """main of the world of one at twice the batch, jitter left neutral as in the dp=2 ranks."""
    cfg = Config(**{**env.setup["cfg"], **env.setup["main"], "batch_size": 2 * env.cfg.batch_size,
                    "project_data_path": os.path.join(env.root, "main_one")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(imops, "jitter_draws", neutral_jitter)
        tmain.main(cfg)
    with open(os.path.join(cfg.checkpoint_path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epoch_ends(events):
    return [e for e in events if e["event"] == "epoch_end"]


def test_main_on_dp2_matches_the_world_of_one(env, main_one):
    path = env.worlds["2x1"][0]["main_checkpoint_path"]
    with open(os.path.join(path, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    got, want = _epoch_ends(events), _epoch_ends(main_one)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0, 1]
    for g, w in zip(got, want):
        for key in ("train_loss", "val_loss"):
            assert _close(g[key], w[key], 1e-4), (key, g[key], w[key])
    mesh = next(e for e in events if e["event"] == "mesh")
    assert (mesh["dp"], mesh["mp"], mesh["devices"]) == (2, 1, 2)
    assert sum(e["event"] == "train_step" for e in events) == 2 * 2    # 8 rows at a global batch of 4


def test_main_rank0_alone_writes_checkpoints_and_rank1_logs_its_own_file(env):
    r0, r1 = env.worlds["2x1"]
    assert r0["main_writes"].count("retr_metadata.json") == 2 and r0["main_writes"].count("state.pth") == 2
    assert r1["main_writes"] == []
    path = r0["main_checkpoint_path"]
    assert os.path.exists(os.path.join(path, "metrics.p1.jsonl"))
    with open(os.path.join(path, "metrics.p1.jsonl")) as f:
        assert any(json.loads(line)["event"] == "epoch_end" for line in f)
    assert ckpt.latest_checkpoint(path).endswith("_checkpoint_1")


def test_bad_launch_raises_on_every_rank_before_any_step(env):
    for r in env.worlds["2x1"]:
        assert r["bad_launch"] is not None and "dp_size * mp_size == global device count (got 4 x 1 over 2 devices)" in r["bad_launch"], r["bad_launch"]
        assert r["bad_launch_files"] == []


def test_checkpoint_saved_under_mp2_restores_into_the_world_of_one(env):
    path = env.worlds["1x2"][0]["checkpoint"]
    assert all(r["checkpoint"] == path for r in env.worlds["1x2"])
    template = tstate.create_train_state(env.cfg, env.tp, device="cpu", steps_per_epoch=4)
    st, meta = ckpt.load_checkpoint(path, template)
    assert st.step == meta["step"] == 2
    saved = env.worlds["1x2"][0]["params"]
    for k, v in weights.to_state_dict(st.params, env.cfg).items():
        assert torch.equal(v, saved[k]), k
    # the moments came back whole: one more step runs and moves every trained leaf
    before = {k: v.detach().clone() for k, v in weights.to_state_dict(st.params, env.cfg).items()}
    st, loss = tstate.make_train_step(env.cfg)(st, _port_batch(env, GLOBAL_BATCH), 5)
    assert math.isfinite(float(loss)) and st.step == 3
    after = weights.to_state_dict(st.params, env.cfg)
    assert not torch.equal(after["mlp.layers.2.weight"], before["mlp.layers.2.weight"])


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_make_mesh_without_a_device_is_on_the_card_not_the_cpu(env, shape):
    """Over gloo with no device named, the mesh is the current card's; where
    there is none it raises naming CUDA instead of training on the CPU."""
    for r in env.worlds[shape]:
        if torch.cuda.is_available():
            assert r["mesh_without_device"].startswith("cuda"), r["mesh_without_device"]
        else:
            assert r["mesh_without_device"].startswith("raised: CUDA was requested"), r["mesh_without_device"]


@pytest.mark.parametrize("device", ["cpu", "cuda:1"])
def test_create_train_state_refuses_a_device_that_is_not_the_mesh_s(env, device):
    mesh = pmesh.Mesh(1, 1, 0, 0, 0, None, None, None, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="is not the mesh's device cuda:0"):
        tstate.create_train_state(env.cfg, env.tp, device=device, mesh=mesh)
