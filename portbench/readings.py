#!/usr/bin/env python3
"""Readings behind a cell's limits, and the serving knee, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 --seconds 4 [--control]
    python3 portbench/readings.py --workload <cell> --seeds 11 --seconds 15 --rates 100,150,200

The first form makes a run of the cell (``run.execute``: set-up, a short
window at the cell's own load, the judge) on each seed in turn and prints one
JSON line per seed with the numbers the run compares; with ``--control`` it
also reads the control (the reference one precision below the
configuration's, in the program's place, at the same prompts and tokens), and
with ``--fault half_batch`` the program's training loss leaves out half of
each batch. The second form (serving cells) sets up once and offers each rate
in turn for ``--seconds``, printing the p95 latency and the share of requests
shed at each: the sweep that finds the knee. Neither runs in the benchmark's
own runs.
"""

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

harness.set_cache_dirs()


def plant_half_batch() -> None:
    """The training step's loss over the first half of each batch only, the
    mean taken over that half."""
    from retr_tpu_torch.data.pipeline import Batch
    from retr_tpu_torch.train import state as state_mod

    real = state_mod.loss_fn

    def half(params, cfg, batch, seed, **kw):
        n = batch.images.shape[0] // 2
        return real(params, cfg, Batch(*(None if x is None else x[:n] for x in batch)), seed, **kw)

    state_mod.loss_fn = half


def knee(work: dict, seed: int, seconds: float, rates: list) -> None:
    """One set-up of a serving cell, then each rate offered in turn."""
    import shutil

    from portbench.drivers import common

    config = harness.load_json(harness.HERE, "configs", f"{work['config']}.json")
    traffic = harness.load_json(harness.HERE, "traffic", f"{work['traffic']}.json")
    driver_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    scratch = harness.scratch_dir(work["name"])
    try:
        cell = common.Cell(config, traffic, seed, device="cuda", scratch=scratch, checkout=harness.CHECKOUT)
        drv = driver_mod.Driver(cell)
        drv.setup()
        for i, rate in enumerate(rates):
            if i:
                drv.open_queue()
            cell.traffic["rate"] = rate
            e2e = drv.window(seconds, False)
            attempted, _ = drv.counts()
            print(json.dumps({"workload": work["name"], "seed": seed, "rate": rate, **e2e, "attempted": attempted,
                              "shed": drv.shed, "shed_share": drv.shed / max(attempted, 1)}), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def main(argv=None) -> int:
    import torch

    from portbench import run
    from portbench.drivers import common

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--fault", choices=["half_batch"], help="plant a fault in the program (training cells)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work, bench = harness.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rates:
        knee(work, seeds[0], args.seconds, [float(r) for r in args.rates.split(",")])
        return 0
    if args.fault == "half_batch":
        plant_half_batch()
    for seed in seeds:
        try:
            res = run.execute(work, bench, seed, args.seconds, False, control=args.control)
        finally:
            common.release()
            torch.cuda.reset_peak_memory_stats()
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items() if k != "setup_s"},
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                          **{k: c["value"] for k, c in res["checks"].items()}, **res.get("control", {})}),
              flush=True)
    print(json.dumps({"device": harness.device_record(1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
