"""A tiny cell for the CPU tests: ResNet-18 at 64 px, 1+1 layers of width 64,
vocabulary 400, 15 decode steps, a pool of 12 small-content images. The files
(configs, traffic, limits) are written into a directory that ``run.execute``
reads in place of ``portbench/``; the metric readers are the real ones."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

TINY = {
    "prefix": "refcoco", "backbone": "ResNet18", "dilation": True, "hidden_dim": 64, "nheads": 4,
    "enc_layers": 1, "dec_layers": 1, "dim_feedforward": 128, "max_position_embeddings": 16,
    "vocab_size": 400, "image_size": 64, "dropout": 0.1, "batch_size": 4, "num_workers": 2,
    "use_global_features": False, "use_location_features": False, "num_location_features": 5,
    "layer_norm_eps": 1e-12, "compute_dtype": "float32", "pre_norm": True, "position_embedding": "sine",
    "clip_max_norm": 0.1, "lr": 1e-4, "lr_backbone": 1e-5, "weight_decay": 1e-4, "pad_token_id": 0,
}

TRAFFIC = {
    "tiny-sweep": {"driver": "eval_sweep", "split": {"images": 6, "objects": 10, "expressions": 20,
                                                     "partition": "val"},
                   "batch": 4, "decoder": "greedy", "judge_captions": 6},
    "tiny-train": {"driver": "train_epochs", "split": {"images": 6, "objects": 12, "expressions": 24,
                                                       "partition": "train"}},
    "tiny-serve": {"driver": "serve_queue", "rate": 40, "images": 4, "max_batch": 4, "max_wait_s": 0.02,
                   "pipeline_depth": 2, "decoder": "greedy", "grace_s": 30, "judge_captions": 6},
}

LIMITS = {"token_gap": 1e-3, "unreadable": 0, "missing": 0, "unanswered": 0, "errors": 0,
          "loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
KEYS = {"eval_sweep": ("token_gap", "unreadable", "missing"),
        "serve_queue": ("token_gap", "unreadable", "unanswered", "errors"),
        "train_epochs": ("loss_gap", "grad_gap", "change_gap")}


def files(root: str, *, globloc: bool = False) -> tuple:
    """Write the tiny cell's files under ``root``; returns (files dir, bench)."""
    cfg = dict(TINY, use_global_features=globloc, use_location_features=globloc)
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump({"source": "test", "reduced": [], "config": cfg}, f)
    works = []
    for name, traffic in TRAFFIC.items():
        with open(os.path.join(root, "traffic", f"{name}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(root, "limits", f"{name}.json"), "w") as f:
            json.dump({k: LIMITS[k] for k in KEYS[traffic["driver"]]}, f)
        works.append({"name": name, "config": "tiny", "traffic": name, "chips": 1})
    shutil.copytree(os.path.join(harness.HERE, "metrics"), os.path.join(root, "metrics"), dirs_exist_ok=True)
    bench = {"workloads": works, "end_to_end": [
        {"name": "captions_per_s", "unit": "captions/s", "workloads": ["tiny-sweep"]},
        {"name": "latency_p95_ms", "unit": "ms", "workloads": ["tiny-serve"]},
        {"name": "train_samples_per_s", "unit": "samples/s", "workloads": ["tiny-train"]},
        {"name": "setup_s", "unit": "s"}], "per_layer": [
        {"name": "idle_share.eval", "unit": "%", "moves": "captions_per_s", "workloads": ["tiny-sweep"]},
        {"name": "mfu.eval", "unit": "%", "moves": "captions_per_s", "workloads": ["tiny-sweep"]},
        {"name": "loader_wait_ms.eval", "unit": "ms", "moves": "captions_per_s", "workloads": ["tiny-sweep"]},
        {"name": "mfu.train", "unit": "%", "moves": "train_samples_per_s", "workloads": ["tiny-train"]},
        {"name": "loader_wait_ms.train", "unit": "ms", "moves": "train_samples_per_s", "workloads": ["tiny-train"]}]}
    return root, bench
