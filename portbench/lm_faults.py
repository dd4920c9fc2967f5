#!/usr/bin/env python3
"""Readings of the LM-decoder cell with a routed-expert fault planted in the
program: the runs that show ``expert_gap`` fails where the routed experts go
wrong, however little they move the logits.

    python3 portbench/lm_faults.py --fault drop --workload kimivl-eval-greedy --seeds 11 --seconds 1

``--fault drop``: every grouped expert product gives zeros, so the routed
experts add nothing. ``--fault shift``: each group of routed pairs runs
through the next expert's weights. The fault is planted in
``retr_tpu_torch.models.lm`` before anything runs, so the served decode and
the judge's reading of the program's MoE layers both have it; the other
arguments are ``portbench/readings.py``'s, which prints one JSON line a seed.
Not run in the benchmark's own runs.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAULTS = ("drop", "shift")


def plant(fault: str) -> None:
    """Replace ``models/lm._grouped`` by its ``fault``-y twin."""
    import torch

    from retr_tpu_torch.models import lm

    real = lm._grouped

    def faulty(x, w, offs):
        if fault == "drop":
            return torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
        return real(x, w.roll(1, 0), offs)

    lm._grouped = faulty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", choices=FAULTS, required=True)
    args, rest = ap.parse_known_args(argv)
    plant(args.fault)
    from portbench import readings

    return readings.main(rest)


if __name__ == "__main__":
    sys.exit(main())
