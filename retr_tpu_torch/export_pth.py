"""Export a checkpoint directory as a reference-format ``.pth`` (retr_tpu/export_pth.py).

    python -m retr_tpu_torch.export_pth --checkpoint DIR [--out model.pth]

The output holds ``model_state_dict`` in the reference's names plus the
checkpoint's epoch, losses and CIDEr (train_utils/checkpoints.py:4-15), loads
in the reference's evaluation and in both packages, and round-trips bit for
bit. The default output, ``<DIR>.pth``, keeps the directory's name, so the
reference's file-name sniffing still finds the model variant.
"""

from __future__ import annotations

import argparse
import math
import os

from retr_tpu_torch.train import checkpoints as ckpt


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Export a retr_tpu_torch checkpoint directory as a .pth.")
    ap.add_argument("--checkpoint", required=True, help="checkpoint directory")
    ap.add_argument("--out", default="", help="output .pth (default: <checkpoint directory>.pth)")
    args = ap.parse_args(argv)

    state, meta = ckpt.load_model_state(args.checkpoint)
    out = args.out or os.path.normpath(args.checkpoint) + ".pth"
    ckpt.export_reference_state(state, out, epoch=meta.get("epoch", 0),
                                **{k: meta.get(k, math.nan) for k in ("train_loss", "val_loss", "cider_score")})
    print(out)
    return out


def cli() -> None:
    """Console entry point: ``main`` returns the path for callers; a script
    wrapper would print a returned string to stderr and exit 1."""
    main()


if __name__ == "__main__":
    cli()
