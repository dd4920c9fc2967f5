"""What every run shares: the checkout, the cell's files, the cache
directories, host-clock spans, the device's record and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "retr_tpu")   # top-level module names, compared whole


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so only
    a checkout's first run builds (the program's own CUDA and g++ libraries
    build into ``retr_tpu_torch/_build/`` there)."""
    root = os.path.join(CHECKOUT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def scratch_dir(name: str) -> str:
    """A fresh directory for this run's files under ``TMPDIR``."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"portbench-{name}-")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str) -> tuple:
    """(workload entry, BENCHMARK.json) of the named cell."""
    bench = load_json(CHECKOUT, "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w, bench
    raise SystemExit(f"unknown workload {workload!r}")


def load_module(path: str, name: str):
    """Import a file whose name need not be an identifier (a metric's reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """Host-clock spans kept in memory: name -> list of seconds."""

    def __init__(self):
        self.samples: dict = {}

    def add(self, name: str, seconds: float) -> None:
        self.samples.setdefault(name, []).append(seconds)


def device_record(count: int) -> dict:
    import subprocess

    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
        rec["power_limit"] = out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        rec["power_limit"] = "not read"
    return rec
