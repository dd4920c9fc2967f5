"""Multi-dataset evaluation sweep CLI (retr_tpu/sweep_cli.py).

    torchrun --nproc_per_node N -m retr_tpu_torch.sweep_cli --checkpoint PATH \\
        --datasets refcoco:val,testa,testb refcoco+:val,testa,testb refcocog:val,test \\
        [--dp N] [--mp M] [--decoder {greedy,beam,sample}] [--batch B] [--config cfg.json]
        [--out results.json] [--store-generations gen.json] [--override_config] [--device {cuda,cpu}]

``PATH`` is a checkpoint directory of ``retr_tpu_torch.main`` or a reference
``.pth``. Under torchrun (``RANK``/``WORLD_SIZE`` set) every process is one
rank of a ``(dp, mp)`` mesh with ``dp * mp`` = the world; without it the
sweep runs as a world of one. Each prefix's annotations are under
``<ref_base>/<prefix>``; splits follow the reference's names (testa/testb for
refcoco and refcoco+, test for refcocog). Every rank prints the same results;
rank 0 alone writes ``--out`` and ``--store-generations``.
"""

from __future__ import annotations

import argparse
import json
import os

from retr_tpu_torch.config import Config
from retr_tpu_torch.data import dataset as ds
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.eval_model import prepare_model
from retr_tpu_torch.main import apply_device_config
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.parallel.sweep import full_eval_sweep


def parse_datasets(specs):
    """['refcoco:val,testa'] -> [('refcoco', 'val'), ('refcoco', 'testa')]"""
    out = []
    for spec in specs:
        prefix, _, splits = spec.partition(":")
        for split in (splits or "val").split(","):
            out.append((prefix, split))
    return out


def main(args, config: Config):
    """Run the sweep; returns ``{label: metrics}``. A process group, if any,
    must be initialised already (:func:`cli` does it under torchrun)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    mp = max(1, args.mp)
    # checked before the (slow) checkpoint load
    if mp > world or world % mp:
        raise ValueError(f"--mp {mp} must divide the world size ({world}); otherwise dp "
                         "would be 0 or ranks left out of the mesh")
    dp = args.dp or world // mp
    if dp * mp != world:
        raise ValueError(f"--dp {dp} x --mp {mp} must equal the world size ({world})")
    if args.device:
        config = config.replace(device=args.device)
    dev = apply_device_config(config)
    mesh = pmesh.make_mesh(dp=dp, mp=mp, device=dev) if dist.is_initialized() else None
    params, config = prepare_model(args, config, device=dev)
    config = config.replace(device=dev.type)
    tokenizer, _, _ = prepare_tokenizer(config.vocab_file)

    batch = args.batch or config.batch_size
    loaders = {}
    for prefix, split in parse_datasets(args.datasets):
        cfg_d = config.replace(prefix=prefix, ref_dir="")   # ref_dir derived again from the prefix
        dataset = ds.build_dataset(cfg_d, split, tokenizer=tokenizer, return_unique=True)
        loaders[f"{prefix}/{split}"] = ds.DataLoader(dataset, batch, num_workers=config.num_workers)

    store = args.store_generations
    out = full_eval_sweep(params, config, tokenizer, mesh, datasets=loaders, decoder=args.decoder,
                          return_hypotheses=bool(store))
    results, hyps = out if store else (out, None)
    print(json.dumps(results, indent=2))
    if mesh is None or mesh.rank == 0:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
        if store:
            with open(store, "w") as f:
                json.dump(hyps, f, indent=2)
    pmesh.barrier(mesh)
    return results


def build_argparser():
    ap = argparse.ArgumentParser(description="Evaluation sweep over datasets and splits (retr_tpu_torch).")
    ap.add_argument("--checkpoint", required=True, help="a checkpoint directory or a reference .pth")
    ap.add_argument("--config", default="")
    ap.add_argument("--datasets", nargs="+", default=["refcoco:val"], help="prefix:split[,split...] per entry")
    ap.add_argument("--dp", type=int, default=0, help="dp mesh size (default: the world size / mp)")
    ap.add_argument("--mp", type=int, default=1,
                    help="tensor-parallel size, a divisor of the world size; the decode runs on the "
                    "whole tree, so the ranks of one mp group decode the same rows")
    ap.add_argument("--decoder", default="greedy", choices=["greedy", "beam", "sample"])
    ap.add_argument("--batch", type=int, default=0,
                    help="evaluation batch size, split over dp (0: config.batch_size, the reference's)")
    ap.add_argument("--out", default="", help="write the results JSON here")
    ap.add_argument("--store-generations", default="", metavar="PATH",
                    help="also write the generated expressions per dataset/split as JSON")
    ap.add_argument("--override_config", action="store_true", help="take the model's config from the checkpoint")
    ap.add_argument("--device", default="", choices=["", "cuda", "cpu"], help="override Config.device for this run")
    return ap


def cli(argv=None) -> None:
    """``python -m retr_tpu_torch.sweep_cli`` (under torchrun for several ranks)."""
    import torch.distributed as dist

    args = build_argparser().parse_args(argv)
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    else:
        config = Config()
    owned = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if owned:
        pmesh.init_distributed(device="cpu" if (args.device or config.device) == "cpu" else None)
    try:
        main(args, config)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
