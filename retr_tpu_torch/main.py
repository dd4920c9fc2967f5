"""Training entry point (retr_tpu/main.py).

The epoch loop: train, validation loss, CIDEr evaluation, checkpoint, and the
reference's early stop (main.py:96-99): the scores list starts at ``[0.0]`` and
training stops when an epoch's CIDEr falls below the least of the last five.
Fresh parameters come from ``models/caption.build_model``, or from a
reference-format ``.pth`` (``--init_pth``); ``--resume`` restores the latest
checkpoint step-exactly. Every event goes to ``<checkpoint_path>/metrics.jsonl``.

    python -m retr_tpu_torch.main [--config cfg.json] [--resume] [--init_pth X.pth]

Runs on ``Config.device`` (``cuda`` unless the config says ``cpu``). Meshes
(``dp_size * mp_size > 1``) and ``--distributed`` raise: multi-GPU is ROADMAP A13.
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
from retr_tpu_torch.train import checkpoints as ckpt
from retr_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step, tree_leaves_with_path
from retr_tpu_torch.utils.logging import MetricLogger

MULTI_GPU = "ROADMAP A13 (multi-GPU) is not ported yet"


def apply_device_config(config: Config) -> torch.device:
    """The device ``config.device`` names ("cuda" or "cpu"); raises where CUDA
    is asked for and absent."""
    return device_mod.resolve(config.device)


def main(config: Config, resume: bool = False, init_pth: str = "") -> None:
    """Train ``config.epochs`` epochs from ``config.start_epoch`` (or from the
    epoch after the latest checkpoint with ``resume``)."""
    if config.dp_size * config.mp_size > 1:
        raise NotImplementedError(f"{MULTI_GPU}: set dp_size = mp_size = 1")
    dev = apply_device_config(config)
    logger = MetricLogger(os.path.join(config.checkpoint_path, "metrics.jsonl"))
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

        tokenizer, _, _ = prepare_tokenizer(config.vocab_file)
        dataset_train = ds.build_dataset(config, "training", tokenizer=tokenizer)
        dataset_val = ds.build_dataset(config, "validation", tokenizer=tokenizer)
        dataset_cider = ds.build_dataset(config, "validation", tokenizer=tokenizer, return_unique=True)
        logger.log("datasets", train=len(dataset_train), val=len(dataset_val), cider=len(dataset_cider))
        loader_train = ds.DataLoader(dataset_train, config.batch_size, shuffle=True, drop_last=True,
                                     seed=config.seed, num_workers=config.num_workers)
        loader_val = ds.DataLoader(dataset_val, config.batch_size, num_workers=config.num_workers)
        loader_cider = ds.DataLoader(dataset_cider, config.batch_size, num_workers=config.num_workers)

        state = create_train_state(config, params, device=dev, steps_per_epoch=len(loader_train))
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
                                                logger=logger)
            validation_loss = evaluate(state.params, config, loader_val, eval_step=eval_step)
            eval_results, _ = eval_model(state.params, config, loader_cider, tokenizer)
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
    """``python -m retr_tpu_torch.main``."""
    ap = argparse.ArgumentParser(description="Train the caption model (retr_tpu_torch).")
    ap.add_argument("--config", default="", help="JSON config file (defaults otherwise)")
    ap.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    ap.add_argument("--init_pth", default="",
                    help="initialise the weights from a reference-format .pth and train from there "
                    "(fine-tuning; the optimizer starts fresh)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process launch: not ported yet (ROADMAP A13)")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(MULTI_GPU)
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    main(cfg, resume=args.resume, init_pth=args.init_pth)


if __name__ == "__main__":
    cli()
