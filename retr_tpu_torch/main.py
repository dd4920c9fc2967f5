"""Training entry point (retr_tpu/main.py).

The epoch loop: train, validation loss, CIDEr evaluation, checkpoint, and the
reference's early stop (main.py:96-99): the scores list starts at ``[0.0]`` and
training stops when an epoch's CIDEr falls below the least of the last five.
Fresh parameters come from ``models/caption.build_model``, or from a
reference-format ``.pth`` (``--init_pth``); ``--resume`` restores the latest
checkpoint step-exactly. Every event goes to ``<checkpoint_path>/metrics.jsonl``.

    python -m retr_tpu_torch.main [--config cfg.json] [--resume] [--init_pth X.pth]
    torchrun --nproc_per_node N -m retr_tpu_torch.main --distributed [--config cfg.json]

Runs on ``Config.device`` (``cuda`` unless the config says ``cpu``). With an
initialised process group (``--distributed``, or the caller's) or
``dp_size * mp_size > 1``, every process is one rank of a
``parallel.mesh.Mesh`` of ``dp_size x mp_size`` (the world must be exactly
that): the parameters are cut to each rank's slices, each dp rank loads its
own ``batch_size`` rows (the global batch is ``dp_size * batch_size``, JAX's
multi-host semantics: here every rank is a process), CIDEr goes through the
sharded sweep, rank 0 writes the checkpoints and rank r > 0 logs to
``metrics.p<r>.jsonl``.
"""

from __future__ import annotations

import argparse
import os

import torch

from retr_tpu_torch import device as device_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset as ds
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.engine import eval_model, evaluate, train_one_epoch
from retr_tpu_torch.models import caption
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step, tree_leaves_with_path
from retr_tpu_torch.utils.logging import MetricLogger


def apply_device_config(config: Config) -> torch.device:
    """The device ``config.device`` names ("cuda" or "cpu"); raises where CUDA
    is asked for and absent."""
    return device_mod.resolve(config.device)


def validate_multihost_launch(config: Config, process_count: int, n_devices: int,
                              *, has_mesh: bool) -> None:
    """Refuse silently wrong multi-process launches (retr_tpu/main.py:38-65,
    the same rules and messages; ``main`` passes the world size as both
    ``process_count`` and ``n_devices``, one device per process)."""
    if process_count <= 1:
        return
    # without a mesh spanning every device, each process would train a model of
    # its own on its own data shard, with no gradient sync, and race on the
    # checkpoint path
    if not has_mesh or config.dp_size * config.mp_size != n_devices:
        raise ValueError(
            "multi-host launch requires dp_size * mp_size == global device "
            f"count (got {config.dp_size} x {config.mp_size} over "
            f"{n_devices} devices); set Config.dp_size/mp_size for the whole slice"
        )
    # the global batch must split evenly over dp
    if (config.batch_size * process_count) % config.dp_size:
        raise ValueError(
            f"batch_size * process_count ({config.batch_size} * "
            f"{process_count}) must divide over dp_size "
            f"({config.dp_size}) for multi-host training"
        )


def main(config: Config, resume: bool = False, init_pth: str = "") -> None:
    """Train ``config.epochs`` epochs from ``config.start_epoch`` (or from the
    epoch after the latest checkpoint with ``resume``)."""
    import torch.distributed as dist

    dev = apply_device_config(config)
    mesh = None
    if config.dp_size * config.mp_size > 1 or dist.is_initialized():
        # JAX's launch rules and messages first; then make_mesh needs a process
        # group whose world is dp_size * mp_size
        world = dist.get_world_size() if dist.is_initialized() else 1
        validate_multihost_launch(config, world, world, has_mesh=True)
        mesh = pmesh.make_mesh(dp=config.dp_size, mp=config.mp_size, device=dev)
    rank = 0 if mesh is None else mesh.rank
    logger = MetricLogger(os.path.join(config.checkpoint_path,
                                       "metrics.jsonl" if rank == 0 else f"metrics.p{rank}.jsonl"))
    saver = ckpt.AsyncSaver() if config.async_checkpoints else None
    try:
        if init_pth:
            # fine-tune from a reference-format .pth; the optimizer starts fresh
            params, _ = ckpt.import_reference_checkpoint(init_pth, config, device=dev)
            logger.log("init_from_pth", path=init_pth)
        else:
            params, _ = caption.build_model(config, device=dev)
        n_params = sum(leaf.numel() for _, leaf in tree_leaves_with_path(params))
        logger.log("init", n_parameters=int(n_params), config=config.to_dict())
        if mesh is not None:
            logger.log("mesh", dp=mesh.dp, mp=mesh.mp, devices=mesh.world)

        tokenizer, _, _ = prepare_tokenizer(config.vocab_file)
        dataset_train = ds.build_dataset(config, "training", tokenizer=tokenizer)
        dataset_val = ds.build_dataset(config, "validation", tokenizer=tokenizer)
        dataset_cider = ds.build_dataset(config, "validation", tokenizer=tokenizer, return_unique=True)
        logger.log("datasets", train=len(dataset_train), val=len(dataset_val), cider=len(dataset_cider))
        # each dp rank loads its own rows; the ranks of one mp group load the same
        shard = None if mesh is None or mesh.dp == 1 else (mesh.dp_rank, mesh.dp)
        loader_train = ds.DataLoader(dataset_train, config.batch_size, shuffle=True, drop_last=True,
                                     seed=config.seed, num_workers=config.num_workers, shard=shard)
        loader_val = ds.DataLoader(dataset_val, config.batch_size, num_workers=config.num_workers)
        loader_cider = ds.DataLoader(dataset_cider, config.batch_size, num_workers=config.num_workers)

        state = create_train_state(config, params, device=dev, steps_per_epoch=len(loader_train), mesh=mesh)
        del params
        train_step = make_train_step(config)
        eval_step = make_eval_step(config)

        start_epoch = config.start_epoch
        if resume:
            latest = ckpt.latest_checkpoint(config.checkpoint_path, config)
            if latest is not None:
                state, meta = ckpt.load_checkpoint(latest, state)
                start_epoch = meta["epoch"] + 1
                logger.log("resume", checkpoint=latest, epoch=start_epoch)

        cider_scores = [0.0]
        for epoch in range(start_epoch, config.epochs):
            logger.log("epoch_start", epoch=epoch)
            state, epoch_loss = train_one_epoch(state, train_step, loader_train, config.seed, epoch=epoch,
                                                logger=logger, mesh=mesh)
            validation_loss = evaluate(state.params, config, loader_val, eval_step=eval_step, mesh=mesh)
            # under a mesh each dp rank decodes its rows (the sharded sweep)
            eval_results, _ = eval_model(state.params, config, loader_cider, tokenizer, mesh=mesh,
                                         specs=state.specs)
            cider_score = eval_results["CIDEr"]
            logger.log("epoch_end", epoch=epoch, train_loss=epoch_loss, val_loss=validation_loss,
                       cider=cider_score, metrics=eval_results)

            save_kwargs = dict(epoch=epoch, train_loss=epoch_loss, val_loss=validation_loss,
                               cider_score=cider_score)
            if saver is not None:
                saver.submit(config.checkpoint_path, state, config, **save_kwargs)
            else:
                ckpt.save_checkpoint(config.checkpoint_path, state, config, **save_kwargs)

            if config.early_stopping and cider_score < min(cider_scores[-5:]):
                logger.log("early_stop", epoch=epoch)  # the reference's main.py:96-99
                break
            cider_scores.append(cider_score)
    finally:
        try:
            # the save submitted before a failure (a NaN stop, ^C) still lands
            if saver is not None:
                saver.wait()
        finally:
            logger.close()


def cli(argv=None) -> None:
    """``python -m retr_tpu_torch.main`` (``--distributed`` under torchrun)."""
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description="Train the caption model (retr_tpu_torch).")
    ap.add_argument("--config", default="", help="JSON config file (defaults otherwise)")
    ap.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    ap.add_argument("--init_pth", default="",
                    help="initialise the weights from a reference-format .pth and train from there "
                    "(fine-tuning; the optimizer starts fresh)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process launch under torchrun: initialise the process group from RANK, "
                    "WORLD_SIZE and LOCAL_RANK (one card per process; gloo where Config.device is cpu), "
                    "then train as one rank of the dp_size x mp_size mesh")
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    if args.distributed:
        pmesh.init_distributed(device="cpu" if cfg.device == "cpu" else None)
    try:
        main(cfg, resume=args.resume, init_pth=args.init_pth)
    finally:
        if args.distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
