#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``driver`` names the module of
``portbench/drivers/`` that runs it); its limits are
``portbench/limits/<cell>.json`` and each per-layer metric has its reader in
``portbench/metrics/<metric>.py``. A run loads and warms up (``setup_s``),
measures for ``--seconds``, frees the program, holds what the window served
to the plain reference, and prints one JSON line last: the end-to-end metrics
with ``--trace 0``, the per-layer ones (read from a torch.profiler slice of
the window and the harness's spans) with ``--trace 1``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

harness.set_cache_dirs()


def metric_entries(bench: dict, workload: str, kind: str) -> list:
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]


def passes(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def execute(work: dict, bench: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            files: str = harness.HERE, checkout: str = harness.CHECKOUT, control: bool = False) -> dict:
    """Set up, measure, judge: the result line's dict (``checks`` last). ``files``
    holds the cell's configs, traffic, limits and metric readers. ``control``
    (portbench/readings.py, the card's tests; never the benchmark's own runs)
    also reads the control at the same served answers, under ``control``."""
    import torch

    from portbench.drivers import common

    cuda = device == "cuda"
    config = harness.load_json(files, "configs", f"{work['config']}.json")
    traffic = harness.load_json(files, "traffic", f"{work['traffic']}.json")
    limits = harness.load_json(files, "limits", f"{work['name']}.json")
    driver_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    scratch = harness.scratch_dir(work["name"])
    try:
        cell = common.Cell(config, traffic, seed, device=device, scratch=scratch, checkout=checkout)
        drv = driver_mod.Driver(cell)
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0
        e2e = drv.window(seconds, trace)
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        attempted, failed = drv.counts()
        ctx = {**drv.context(), "e2e": e2e}
        drv.release()
        numbers = drv.judge(control=control)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    record = harness.device_record(work["chips"]) if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    result = {"correct": None, "attempted": attempted, "failed": failed, "metrics": {},
              "device": {**record, "memory_peak_bytes": peak}}
    if trace:
        for m in metric_entries(bench, work["name"], "per_layer"):
            reader = harness.load_module(os.path.join(files, "metrics", f"{m['name']}.py"),
                                         "portbench_metric_" + "".join(ch if ch.isalnum() else "_" for ch in m["name"]))
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        prof = ctx["profile"]
        if prof is not None:
            from portbench import profiler

            result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = profiler.breakdown(prof)
    else:
        e2e["setup_s"] = setup_s
        for m in metric_entries(bench, work["name"], "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    result["correct"] = all(passes(c["value"], c["limit"]) for c in checks.values())
    if control:
        result["control"] = {k: v for k, v in numbers.items() if k.startswith("control")}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    work, bench = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(work, bench, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
