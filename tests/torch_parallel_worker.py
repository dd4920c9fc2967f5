"""One rank of a gloo world for tests/test_torch_parallel.py and
tests/test_torch_sweep.py (imports no JAX).

    python tests/torch_parallel_worker.py TASK RANK WORLD STORE IN_DIR OUT_DIR

The rank joins the world through a ``FileStore`` at STORE (no port to race
for), reads ``IN_DIR/setup.json`` (the Config keywords, dataset paths, the
worlds to run) and ``IN_DIR/init.pt`` (a reference-named state dict), runs
TASK's scenarios on ``setup["device"]`` (default the CPU; all ranks share
it) and writes what it saw to ``OUT_DIR/<TASK>.r<RANK>.pt``. TASK names a
world, ``<dp>x<mp>``, with a suffix: ``parallel`` (forward, train steps,
evaluate, main, checkpoints), ``sweep`` (eval_model_sharded,
full_eval_sweep, sweep_cli) or ``train`` (two train steps; the card test).
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from retr_tpu_torch.config import Config  # noqa: E402
from retr_tpu_torch.data import dataset  # noqa: E402
from retr_tpu_torch.data.pipeline import device_batch  # noqa: E402
from retr_tpu_torch.data.tokenizer import prepare_tokenizer  # noqa: E402
from retr_tpu_torch.masking import Masked  # noqa: E402
from retr_tpu_torch.models import caption, transformer, weights  # noqa: E402
from retr_tpu_torch.ops import image as imops  # noqa: E402
from retr_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from retr_tpu_torch.train import state as tstate  # noqa: E402


def decode_step_inputs(cfg, b=4, s=9, seed=21):
    """Seeded numpy inputs of a few decode steps: memory [b, s, C], its pad
    mask [b, s], positions [s, C] and tokens [b, 3]."""
    rng = np.random.default_rng(seed)
    mask = rng.random((b, s)) < 0.3
    mask[:, 0] = False
    return (rng.standard_normal((b, s, cfg.hidden_dim)).astype(np.float32), mask,
            rng.standard_normal((s, cfg.hidden_dim)).astype(np.float32),
            rng.integers(1, cfg.vocab_size, (b, 3)).astype(np.int32))


def neutral_jitter(gen, n, dev):
    """Colour jitter that leaves every image as it is (factors 1), so a dp
    world and a world of one see the same pixels."""
    one = torch.ones(n, device=dev)
    return imops.JitterDraws(one, one, one, torch.arange(3, device=dev).repeat(n, 1))


def global_batch(cfg, tok, n, device="cpu"):
    """The first n training samples as one batch, alike on every rank."""
    ds = dataset.build_dataset(cfg, "training", tokenizer=tok)
    return device_batch(next(iter(dataset.DataLoader(ds, n, num_workers=1))), torch.device(device))


def train_steps(cfg, sd, batch, mesh, steps=2):
    st = tstate.create_train_state(cfg, weights.to_params(sd, cfg, device="cpu"), steps_per_epoch=4, mesh=mesh)
    step = tstate.make_train_step(cfg)
    losses, norms = [], []
    for _ in range(steps):
        st, loss = step(st, pmesh.shard_batch(mesh, batch), 5)
        losses.append(float(loss))
        norms.append(float(st.grad_norm))
    return st, losses, norms


def parallel(setup, cfg, sd, mesh, out):
    tok = prepare_tokenizer(cfg.vocab_file)[0]
    batch = global_batch(cfg, tok, setup["global_batch"])

    st, out["losses"], out["norms"] = train_steps(cfg, sd, batch, mesh)
    gathered = pmesh.gather_params(st.params, mesh, st.specs)
    if mesh.rank == 0:
        out["params"] = {k: v.detach().clone() for k, v in weights.to_state_dict(gathered, cfg).items()}
    # gather_params of the slices is the tree the slices came from, bit for bit
    fresh = weights.to_params(sd, cfg, device="cpu")
    specs = pmesh.param_shardings(fresh, mesh, cfg.nheads)
    back = pmesh.gather_params(pmesh.shard_params(fresh, mesh, specs), mesh, specs)
    out["gather_bit_equal"] = all(torch.equal(a, b) for a, b in zip(pmesh.leaves(fresh), pmesh.leaves(back)))
    out["sharded_leaves"] = sum("mp" in s for s in pmesh.leaves(specs))
    # a mesh with no device named is on the card, whatever the backend: with
    # none, it raises rather than fall back to the CPU
    try:
        out["mesh_without_device"] = str(pmesh.make_mesh(mesh.dp, mesh.mp).device)
    except RuntimeError as exc:
        out["mesh_without_device"] = f"raised: {exc}"

    if mesh.dp == 1:
        # logits of caption.forward on this rank's slices, the kernel flag off and on
        local = pmesh.shard_params(fresh, mesh, specs)
        for pallas in (False, True):
            with pmesh.active(mesh), torch.no_grad():
                out[f"logits_pallas_{pallas}"] = caption.forward(
                    local, cfg.replace(use_pallas_attention=pallas), Masked(batch.images, batch.image_masks),
                    batch.caps[:, :-1], batch.cap_masks[:, :-1])
        # three tensor-parallel decode steps on this rank's slices: the hidden states and the cache heads
        mem, mask, pos, tokens = decode_step_inputs(cfg)
        with pmesh.active(mesh), torch.no_grad():
            tparams = transformer.prepare_decoder(local["transformer"])
            cache, cross = transformer.init_decode_state(tparams, torch.from_numpy(mem), torch.from_numpy(mask),
                                                         torch.from_numpy(pos), cfg, 8)
            step, out["tp_decode_hs"] = torch.zeros((), dtype=torch.int32), []
            for i in range(tokens.shape[1]):
                hs, cache = transformer.decode_step(tparams, cache, cross, torch.from_numpy(tokens[:, i]), step, cfg)
                out["tp_decode_hs"].append(hs)
                step += 1
        out["tp_decode_heads"] = (cache.self_k.shape[2], cross.cross_k.shape[2])
        # a step at dropout 0.1: the attention masks of all heads cut to this rank's
        _, out["dropout_losses"], _ = train_steps(cfg.replace(dropout=0.1), sd, batch, mesh, steps=1)
        # a checkpoint saved under this mesh, restored by the world of one in the test
        from retr_tpu_torch.train import checkpoints as ckpt

        out["checkpoint"] = ckpt.save_checkpoint(os.path.join(setup["root"], f"ckpt_{mesh.dp}x{mesh.mp}"), st, cfg,
                                                 epoch=0)

    if mesh.mp == 1:
        from retr_tpu_torch import engine

        local = tstate.create_train_state(cfg, fresh, device="cpu", mesh=mesh).params
        val = dataset.build_dataset(cfg, "validation", tokenizer=tok)
        for b in (2, 3):
            for pallas in (False, True):
                out[f"evaluate_{b}_{pallas}"] = engine.evaluate(
                    local, cfg.replace(use_pallas_attention=pallas), dataset.DataLoader(val, b, num_workers=1),
                    mesh=mesh)
        run_main(setup, cfg, mesh, out)


def run_main(setup, cfg, mesh, out):
    """main for 2 epochs at dp_size x mp_size = this world, recording which
    rank moved each checkpoint file into place; then a launch whose mesh is
    not the world, which must raise before any step."""
    from retr_tpu_torch import main as tmain

    imops.jitter_draws = neutral_jitter
    writes = []
    real_replace = os.replace

    def recording_replace(src, dst):
        writes.append(os.path.basename(str(dst)))
        return real_replace(src, dst)

    os.replace = recording_replace
    try:
        mcfg = Config(**{**setup["cfg"], **setup["main"], "dp_size": mesh.dp, "mp_size": mesh.mp,
                         "project_data_path": os.path.join(setup["root"], f"main_{mesh.dp}x{mesh.mp}")})
        tmain.main(mcfg)
    finally:
        os.replace = real_replace
    out["main_writes"] = writes
    out["main_checkpoint_path"] = mcfg.checkpoint_path
    bad = mcfg.replace(dp_size=mesh.world * 2, checkpoint_path=os.path.join(setup["root"], f"bad_{mesh.rank}"))
    try:
        tmain.main(bad)
        out["bad_launch"] = None
    except ValueError as exc:
        out["bad_launch"] = str(exc)
    out["bad_launch_files"] = os.listdir(bad.checkpoint_path) if os.path.isdir(bad.checkpoint_path) else []


def train(setup, cfg, sd, mesh, out):
    batch = global_batch(cfg, prepare_tokenizer(cfg.vocab_file)[0], setup["global_batch"], mesh.device)
    _, out["losses"], out["norms"] = train_steps(cfg, sd, batch, mesh)


def sweep(setup, cfg, sd, mesh, out):
    from retr_tpu_torch import sweep_cli
    from retr_tpu_torch.parallel.sweep import eval_model_sharded

    tok = prepare_tokenizer(cfg.vocab_file)[0]
    params = weights.to_params(sd, cfg, device="cpu")
    specs = pmesh.param_shardings(params, mesh, cfg.nheads)
    local = pmesh.shard_params(params, mesh, specs)   # mp > 1: decoded as they are, tensor-parallel
    loader = dataset.DataLoader(dataset.build_dataset(cfg, "validation", tokenizer=tok, return_unique=True),
                                setup["sweep_batch"], num_workers=1)
    # record every gather of the tree and the heads of every decode's caches
    out["gather_calls"], out["cache_heads"] = 0, set()
    real_gather, real_init = pmesh.gather_params, transformer.init_decode_state

    def counted_gather(*a, **k):
        out["gather_calls"] += 1
        return real_gather(*a, **k)

    def recorded_init(*a, **k):
        cache, cross = real_init(*a, **k)
        out["cache_heads"].add((cache.self_k.shape[2], cross.cross_k.shape[2]))
        return cache, cross

    pmesh.gather_params, transformer.init_decode_state = counted_gather, recorded_init
    try:
        for decoder in ("greedy", "beam", "sample"):
            out[decoder] = eval_model_sharded(local, cfg, loader, tok, mesh, decoder=decoder,
                                              return_hypotheses=True, specs=specs)
    finally:
        pmesh.gather_params, transformer.init_decode_state = real_gather, real_init
    if mesh.mp == 1:
        os.environ.update(RANK=str(mesh.rank), WORLD_SIZE=str(mesh.world), LOCAL_RANK=str(mesh.rank))
        argv = ["--checkpoint", setup["checkpoint"], "--override_config", "--device", "cpu", "--dp", str(mesh.dp),
                "--datasets", "refcoco:val,testa", "--batch", str(setup["sweep_batch"]),
                "--out", os.path.join(setup["root"], f"cli_{mesh.dp}x{mesh.mp}.json"),
                "--store-generations", os.path.join(setup["root"], f"gen_{mesh.dp}x{mesh.mp}.json")]
        sweep_cli.cli(argv)


def run_world(task, world, in_dir, out_dir, timeout=300):
    """Start the world's ranks at once, wait for all (killing every one that
    is left at the deadline) and return each rank's output, in rank order."""
    store = os.path.join(out_dir, f"{task}.store")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    logs = [os.path.join(out_dir, f"{task}.r{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), task, str(r), str(world),
                                               store, in_dir, out_dir], stdout=log, stderr=subprocess.STDOUT,
                                              env=env))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        text = "".join(f"--- rank {r} (exit {p.returncode}) ---\n" + open(logs[r]).read()[-4000:]
                       for r, p in enumerate(procs))
        raise RuntimeError(f"world {task} failed:\n{text}")
    return [torch.load(os.path.join(out_dir, f"{task}.r{r}.pt"), weights_only=False) for r in range(world)]


def main():
    task, rank, world, store, in_dir, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(in_dir, "setup.json")) as f:
        setup = json.load(f)
    cfg = Config(**setup["cfg"])
    sd = torch.load(os.path.join(in_dir, "init.pt"), weights_only=True)
    shape, kind = task.split("_")
    dp, mp = (int(x) for x in shape.split("x"))
    device = setup.get("device", "cpu")
    pmesh.init_distributed("gloo", device, file_store=store, rank=rank, world_size=world)
    out = {}
    try:
        mesh = pmesh.make_mesh(dp, mp, device=device)
        out["layout"] = (mesh.dp_rank, mesh.mp_rank)
        {"parallel": parallel, "sweep": sweep, "train": train}[kind](setup, cfg, sd, mesh, out)
    except BaseException:
        out["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(out, os.path.join(out_dir, f"{task}.r{rank}.pt"))
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
