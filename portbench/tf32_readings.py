#!/usr/bin/env python3
"""Readings of a float32 cell's program with TF32 on: the control that a
float32 evaluation cell's ``token_gap`` limit is set against (the program
one precision below the configuration's, judged by the same float32
reference).

    python3 portbench/tf32_readings.py --workload globloc-eval-greedy --seeds 11,12,13 --seconds 4

Every ``matmul_precision`` of the program lets TF32 into its float32
products and convolutions; the reference's judge still turns TF32 off for
itself. One JSON line per seed, as ``portbench/readings.py`` prints them.
Not run in the benchmark's own runs.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

harness.set_cache_dirs()


def allow_tf32() -> None:
    """Patch every ``matmul_precision`` of the program to turn TF32 on."""
    import torch

    import retr_tpu_torch.decode  # noqa: F401  (loads the modules that bind matmul_precision)
    import retr_tpu_torch.engine  # noqa: F401
    from retr_tpu_torch import precision

    @contextlib.contextmanager
    def tf32(_compute_dtype):
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    real = precision.matmul_precision
    for name, mod in list(sys.modules.items()):
        if name.startswith("retr_tpu_torch") and getattr(mod, "matmul_precision", None) is real:
            mod.matmul_precision = tf32


def main(argv=None) -> int:
    import torch

    from portbench import run
    from portbench.drivers import common

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    allow_tf32()
    work, bench = harness.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            res = run.execute(work, bench, seed, args.seconds, False)
        finally:
            common.release()
            torch.cuda.reset_peak_memory_stats()
        print(json.dumps({"workload": args.workload, "seed": seed, "tf32": True, "correct": res["correct"],
                          **{k: c["value"] for k, c in res["checks"].items()}}), flush=True)
    print(json.dumps({"device": harness.device_record(1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
