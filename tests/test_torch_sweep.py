"""The port's sharded evaluation sweep (retr_tpu_torch/parallel/sweep.py) and
its CLI (retr_tpu_torch/sweep_cli.py) on gloo worlds of dp=2 and dp=2 x mp=2
(tests/torch_parallel_worker.py), against retr_tpu's eval_model and the
port's world of one, on tests/test_torch_parallel.py's config and synthetic
RefCOCO (4 unique validation annotations at batch 3: a batch of 3 padded to
4, and a ragged 1).

- greedy and beam hypotheses on every rank equal ``retr_tpu.engine.eval_model``'s;
  under mp=2 each rank decodes tensor-parallel on the slices it is given
  (caches of 4/2 heads, ``gather_params`` never called), and its hypotheses
  equal ``retr_tpu.parallel.sweep.eval_model_sharded``'s on the tree
  ``retr_tpu.parallel.mesh.shard_params`` cuts for JAX's dp=2 x mp=2 mesh
  (8 virtual CPU devices);
- ``decoder="sample"`` equals the world of one's with the same seed, which
  equals ``engine.eval_model``'s;
- every rank returns the same metrics, equal to the world of one's;
- ``sweep_cli`` under torchrun's variables on a port checkpoint with
  ``--dp 2 --store-generations`` (``full_eval_sweep`` over val and testA)
  writes the results and generations of the world of one; ``--mp 3``
  raises before the checkpoint is read.
"""

import json
import os

import pytest

from retr_tpu import engine as jengine
from retr_tpu.data import dataset as jdataset
from retr_tpu.parallel import mesh as jmesh
from retr_tpu.parallel import sweep as jsweep
from retr_tpu_torch import engine, sweep_cli
from retr_tpu_torch.data import dataset
from retr_tpu_torch.parallel.sweep import eval_model_sharded
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train import state as tstate
from tests.test_torch_parallel import make_env, write_setup
from tests.torch_parallel_worker import run_world

SHAPES = {"2x1": 2, "2x2": 4}


def _cli_argv(env, out, gen):
    return ["--checkpoint", env.setup["checkpoint"], "--override_config", "--device", "cpu",
            "--datasets", "refcoco:val,testa", "--batch", str(env.setup["sweep_batch"]), "--out", out,
            "--store-generations", gen]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    env = make_env(str(tmp_path_factory.mktemp("sweep")))
    state = tstate.create_train_state(env.cfg, env.tp, device="cpu", steps_per_epoch=1)
    write_setup(env, checkpoint=ckpt.save_checkpoint(os.path.join(env.root, "ckpt"), state, env.cfg, epoch=0))
    out_dir = os.path.join(env.root, "out")
    os.makedirs(out_dir)
    env.worlds = {shape: run_world(f"{shape}_sweep", n, env.in_dir, out_dir) for shape, n in SHAPES.items()}

    loader = dataset.DataLoader(dataset.build_dataset(env.cfg, "validation", tokenizer=env.tok, return_unique=True),
                                env.setup["sweep_batch"], num_workers=1)
    env.loader = loader
    env.one = {d: eval_model_sharded(env.tp, env.cfg, loader, env.tok, None, decoder=d, return_hypotheses=True)
               for d in ("greedy", "beam", "sample")}
    jds = jdataset.build_dataset(env.jcfg, "validation", tokenizer=env.jtok, return_unique=True)
    jloader = jdataset.DataLoader(jds, env.setup["sweep_batch"], num_workers=1)
    env.jax = {d: [h["expression"] for h in jengine.eval_model(env.params, env.jcfg, jloader, env.jtok, decoder=d)[1]]
               for d in ("greedy", "beam")}
    with pytest.MonkeyPatch.context() as mp:
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            mp.delenv(var, raising=False)
        sweep_cli.cli(_cli_argv(env, os.path.join(env.root, "cli_one.json"), os.path.join(env.root, "gen_one.json")))
    return env


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_hypotheses_equal_retr_tpu_eval_model(env, shape, decoder):
    assert len(env.jax[decoder]) == 4
    for r in env.worlds[shape]:
        metrics, hyps = r[decoder]
        assert hyps == env.jax[decoder] == env.one[decoder][1], (shape, decoder)
        assert metrics == env.one[decoder][0]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mp_ranks_decode_on_local_caches_without_gathering(env, shape):
    """4 heads: each rank's self caches and cross K/V hold 4 / mp of them."""
    heads = env.cfg.nheads // (2 if shape == "2x2" else 1)
    for r in env.worlds[shape]:
        assert r["gather_calls"] == 0
        assert r["cache_heads"] == {(heads, heads)}, r["cache_heads"]


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_mp2_hypotheses_equal_jax_sharded_sweep(env, decoder):
    jm = jmesh.make_mesh(2, 2)
    jds = jdataset.build_dataset(env.jcfg, "validation", tokenizer=env.jtok, return_unique=True)
    _, want = jsweep.eval_model_sharded(jmesh.shard_params(env.params, jm), env.jcfg,
                                        jdataset.DataLoader(jds, env.setup["sweep_batch"], num_workers=1), env.jtok,
                                        jm, decoder=decoder, return_hypotheses=True)
    assert len(want) == 4
    for r in env.worlds["2x2"]:
        assert r[decoder][1] == want, (decoder, r[decoder][1], want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sample_equals_the_world_of_one(env, shape):
    for r in env.worlds[shape]:
        assert r["sample"] == env.one["sample"]


def test_world_of_one_sample_equals_engine_eval_model(env):
    """Each row draws the noise engine.eval_model draws for it: the padded
    batch's rows from fold_in(cfg.seed, batch index)."""
    metrics, hyps = engine.eval_model(env.tp, env.cfg, env.loader, env.tok, decoder="sample")
    assert env.one["sample"] == (metrics, [h["expression"] for h in hyps])
    assert env.one["sample"][1] != env.one["greedy"][1]     # the draw is not argmax here


def test_sweep_cli_under_torchrun_variables_equals_the_world_of_one(env):
    def read(name):
        with open(os.path.join(env.root, name)) as f:
            return json.load(f)

    assert read("cli_2x1.json") == read("cli_one.json")
    gen = read("gen_2x1.json")
    assert gen == read("gen_one.json") and set(gen) == {"refcoco/val", "refcoco/testa"}
    assert gen["refcoco/val"] == env.jax["greedy"] and len(gen["refcoco/testa"]) == 4


def test_sweep_cli_mp_must_divide_the_world_before_the_load(env):
    args = sweep_cli.build_argparser().parse_args(["--checkpoint", os.path.join(env.root, "missing"), "--mp", "3",
                                                   "--device", "cpu"])
    with pytest.raises(ValueError, match="must divide the world size"):
        sweep_cli.main(args, env.cfg)
