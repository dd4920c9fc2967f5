"""Evaluation CLI (retr_tpu/eval_model.py).

    python -m retr_tpu_torch.eval_model --split {val,testa,testb,test} --checkpoint PATH
        [--override_config] [--decoder {greedy,beam,sample}] [--batch N]
        [--store_results] [--print_samples] [--profile_dir DIR] [--config cfg.json]
        [--device {cuda,cpu}]

- ``PATH`` is a checkpoint directory of ``retr_tpu_torch.main`` or a reference
  ``.pth``. ``--override_config`` takes the model's config from the
  directory's metadata, or, for a ``.pth``, the variant from its file name (the
  reference's sniffing).
- ``--store_results`` writes the generated expressions and the metrics as JSON
  under ``<project_data_path>/results/``.
- ``--profile_dir`` records the evaluation under torch.profiler
  (``utils/profiling.trace``): ``DIR/trace.json`` shows the program's spans
  (``eval.*``, ``decode.*``) above the kernels.
"""

from __future__ import annotations

import argparse
import json
import os

from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset as ds
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.engine import eval_model as run_eval
from retr_tpu_torch.main import apply_device_config
from retr_tpu_torch.models import weights
from retr_tpu_torch.train import checkpoints as ckpt


def prepare_model(args, config: Config, device=None):
    """(params on ``device``, config) for a checkpoint directory or a reference ``.pth``."""
    if args.override_config:
        if args.checkpoint.endswith(".pth"):
            config = ckpt.override_config_with_reference_filename(config, args.checkpoint)
        else:
            config = ckpt.config_from_checkpoint(args.checkpoint)
    state, _ = ckpt.load_model_state(args.checkpoint)
    return weights.to_params(state, config, device=device), config


def setup_val_dataloader(config: Config, split: str, tokenizer, batch_size: int = 0):
    dataset = ds.build_dataset(config, split, tokenizer=tokenizer, return_unique=True)
    return ds.DataLoader(dataset, batch_size or config.batch_size, num_workers=config.num_workers)


def main_val_set(args, config: Config):
    """(metrics, [{"ann_id", "expression"}, ...]) of ``args.split``. The device
    is ``--device`` or the given config's; it wins over the checkpoint's config
    under ``--override_config``, as in the reference."""
    if args.device:
        config = config.replace(device=args.device)
    dev = apply_device_config(config)
    params, config = prepare_model(args, config, device=dev)
    config = config.replace(device=dev.type)
    tokenizer, _, _ = prepare_tokenizer(config.vocab_file)
    loader = setup_val_dataloader(config, args.split, tokenizer, batch_size=args.batch)

    def run():
        return run_eval(params, config, loader, tokenizer, print_samples=args.print_samples, decoder=args.decoder)

    if args.profile_dir:
        from retr_tpu_torch.utils.profiling import trace

        with trace(args.profile_dir):
            return run()
    return run()


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate a checkpoint (retr_tpu_torch).")
    ap.add_argument("--split", default="val", choices=["val", "testa", "testb", "test"])
    ap.add_argument("--checkpoint", required=True, help="a checkpoint directory or a reference .pth")
    ap.add_argument("--config", default="", help="JSON config file")
    ap.add_argument("--print_samples", action="store_true")
    ap.add_argument("--store_results", action="store_true")
    ap.add_argument("--override_config", action="store_true",
                    help="take the model's config from the checkpoint")
    ap.add_argument("--decoder", default="greedy", choices=["greedy", "beam", "sample"])
    ap.add_argument("--device", default="", choices=["", "cuda", "cpu"],
                    help="override Config.device for this run")
    ap.add_argument("--profile_dir", default="",
                    help="write a torch.profiler trace of the evaluation here (trace.json)")
    ap.add_argument("--batch", type=int, default=0,
                    help="evaluation batch size (0: config.batch_size, the reference's)")
    return ap


def cli(argv=None) -> None:
    """``python -m retr_tpu_torch.eval_model``."""
    args = build_argparser().parse_args(argv)
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    else:
        config = Config()
    metrics, ids_hypotheses = main_val_set(args, config)
    print(metrics)

    if args.store_results:
        outdir = os.path.join(config.project_data_path, "results")
        os.makedirs(outdir, exist_ok=True)
        base = os.path.basename(args.checkpoint.rstrip("/")).replace(".pth", "")
        with open(os.path.join(outdir, f"{base}_{args.split}_generated.json"), "w") as f:
            json.dump(ids_hypotheses, f)
        with open(os.path.join(outdir, f"{base}_{args.split}_metrics.json"), "w") as f:
            json.dump(metrics, f)


if __name__ == "__main__":
    cli()
