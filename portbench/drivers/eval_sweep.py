"""Offline evaluation sweep: ``engine.eval_model`` over a RefCOCO-shaped split.

Closed loop. Set-up builds the split, the weights, the program's dataset and
``DataLoader`` as ``main.py`` builds its CIDEr loader (unique annotations),
then runs ``eval_model`` twice on a one-batch slice of the split (the graph
session's eager call and capture, the native core's build). The window calls
``eval_model(decoder=...)`` over the whole split again and again, every NLG
metric omitted, and ends with the pass that is running when ``--seconds``
have gone: captions/s is every caption of those passes over their time.

Traffic keys: ``split`` (images, objects, expressions, partition), ``batch``,
``decoder``, ``judge_captions`` (how many served captions the reference
reads after the window).
"""

from __future__ import annotations

import gc
import os
import sys
import time

from portbench import profiler, synth
from portbench.drivers import common
from portbench.harness import Spans


class _GcClock:
    """Seconds the interpreter's cyclic collector ran, while installed."""

    def __init__(self):
        self.seconds, self._t = 0.0, None

    def __call__(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self._t = None


class Driver:
    def __init__(self, cell: common.Cell):
        self.cell = cell
        # every row decodes max_position_embeddings - 1 steps (EOS unreachable)
        self.steps = cell.cfg.max_position_embeddings - 1
        self.spans = Spans()
        self.profile = None

    def setup(self) -> None:
        from retr_tpu_torch.data.dataset import DataLoader, build_dataset
        from retr_tpu_torch.models import weights

        c, t = self.cell, self.cell.traffic
        self.split = synth.write_split(c.scratch, c.seed, t["split"], c.model_cfg["vocab_size"])
        c.cfg = c.cfg.replace(ref_base=self.split["ref_base"], ref_dir=self.split["ref_base"] + "/refcoco")
        self.state = c.state_dict(decode=True)
        self.params = weights.to_params(self.state, c.cfg, device=c.device)
        self.tokenizer = c.tokenizer()
        self.bos = self.tokenizer.convert_tokens_to_ids(self.tokenizer.cls_token)
        workers = c.cfg.num_workers
        self.loader = DataLoader(build_dataset(c.cfg, "validation", self.tokenizer, return_unique=True),
                                 t["batch"], num_workers=workers)
        warm = DataLoader(build_dataset(c.cfg.replace(limit=t["batch"]), "validation", self.tokenizer,
                                        return_unique=True), t["batch"], num_workers=workers)
        for _ in range(2):
            self._pass(warm)
        self.expected = [a[0] for a in self.loader.dataset.annot_select]

    def _pass(self, loader, timer=None):
        from retr_tpu_torch.engine import eval_model

        _, hyps = eval_model(self.params, self.cell.cfg, loader, self.tokenizer, metrics_to_omit=common.NLG_METRICS,
                             decoder=self.cell.traffic["decoder"], timer=timer)
        return hyps

    def window(self, seconds: float, trace: bool) -> dict:
        from retr_tpu_torch.utils.profiling import PhaseTimer

        self.passes = []       # (hypotheses, seconds, profiled)
        gc_clock = _GcClock()
        gc.callbacks.append(gc_clock)
        t0 = time.perf_counter()
        while True:
            profiled = trace and len(self.passes) == 1
            timer = PhaseTimer()
            gc_before, cpu_before = gc_clock.seconds, os.times()
            t = time.perf_counter()
            if profiled:
                box = {}
                self.profile = profiler.trace(lambda: box.setdefault("h", self._pass(self.loader, timer)))
                hyps = box["h"]
            else:
                hyps = self._pass(self.loader, timer)
            self.passes.append((hyps, time.perf_counter() - t, profiled))
            cpu = os.times()
            waits = timer.samples.get("host_wait", [])
            for s in waits:
                self.spans.add("host_wait", s)
            # where the pass's time went on the host: eval_model's phases, the
            # rest of its loop (detokenizing, references), the process's CPU
            # seconds over all threads and the collector's seconds
            phases = {k: sum(v) for k, v in timer.samples.items()}
            rest = self.passes[-1][1] - sum(phases.values())
            print(f"pass {len(self.passes)}: {len(hyps)} captions in {self.passes[-1][1]:.3f} s, "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
                  + f", rest {rest:.3f} s, cpu {cpu.user - cpu_before.user:.2f}+{cpu.system - cpu_before.system:.2f} s"
                  f", gc {gc_clock.seconds - gc_before:.3f} s{' (profiled)' if profiled else ''}", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds and len(self.passes) >= (3 if trace else 1):
                break
        gc.callbacks.remove(gc_clock)
        plain = [p for p in self.passes if not p[2]]
        return {"captions_per_s": sum(len(h) for h, _, _ in plain) / sum(s for _, s, _ in plain),
                "window_s": sum(s for _, s, _ in self.passes)}

    def counts(self) -> tuple:
        """(attempted, failed): every annotation of every pass is attempted; one
        whose caption is missing from its pass fails."""
        attempted = len(self.expected) * len(self.passes)
        got = sum(len({h["ann_id"] for h in hyps} & set(self.expected)) for hyps, _, _ in self.passes)
        return attempted, attempted - got

    def release(self) -> None:
        del self.params
        common.release()

    def judge(self, control: bool = False) -> dict:
        c = self.cell
        served = [(p, h) for p, (hyps, _, _) in enumerate(self.passes) for h in hyps]
        pick = common.draw_sample(len(served), c.traffic["judge_captions"], c.seed)
        records = {r[0]: r for r in self.split["records"]}
        requests, texts = [], []
        for k in pick:
            rec = records[served[k][1]["ann_id"]]
            requests.append((synth.load_pool_image(c.coco, rec[1]), rec[2]))
            texts.append(served[k][1]["expression"])
        out = common.judge_captions(c.model_cfg, self.state, requests, texts, bos=self.bos, steps=self.steps,
                                    device=c.device, image_side=c.cfg.image_size, control=control)
        out["unreadable"] = sum(common.served_ids([h["expression"] for h in hyps], self.steps)[1]
                                for hyps, _, _ in self.passes)
        out["missing"] = self.counts()[1]
        return out

    def context(self) -> dict:
        """What the per-layer readers see."""
        return {"profile": self.profile, "spans": self.spans.samples, "cfg": self.cell.model_cfg,
                "traffic": self.cell.traffic, "steps": self.steps}
