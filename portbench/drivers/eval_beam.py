"""Offline evaluation sweep in beam search: ``eval_sweep``'s closed loop with
``eval_model(decoder="beam")`` at ``Config.beam_size`` beams.

Set-up and the window's passes are ``eval_sweep``'s. A traced run profiles
one more pass after the window, through ``portbench/launches.py``, so that
each device operation keeps the host time of its launch (which tells the
decode loop's device time from the encoder's); its captions are left out of
captions/s, as ``eval_sweep`` leaves out its profiled pass. The judge holds
each token of the served best hypothesis against the reference's top beams
at its prefix (``beam_judge.beam_gaps``: ``beam_gap``; its control
``control_beam_gap``).

Traffic keys: ``eval_sweep``'s, with ``decoder`` "beam".
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import launches, synth
from portbench.drivers import common, eval_sweep
from portbench.reference import beam_judge, judge
from portbench.reference import model as ref_model
from portbench.reference import preprocess as ref_pre


def judge_beam_captions(model_cfg: dict, state_dict: dict, requests, texts, *, bos: int, steps: int, beams: int,
                        device, image_side: int, control: bool = False) -> dict:
    """``common.judge_captions`` for beam search's best hypotheses: {"beam_gap":
    the widest gap of a served token below the reference's ``beams``-th best
    at its prefix, "unreadable"}, and with ``control`` also "control_beam_gap"."""
    ids, bad = common.served_ids(texts, steps)
    keep = [i for i in range(len(texts)) if ids[i, 0] >= 0]
    out = {"unreadable": bad, "beam_gap": 0.0}
    if not keep:
        return out
    ref = ref_model.build(model_cfg, state_dict, device)
    g, loc = model_cfg["use_global_features"], model_cfg["use_location_features"]
    samples = [ref_pre.sample(requests[i][0], requests[i][1], image_side, g, loc) for i in keep]
    served = ids[keep].to(device)
    with common._full_f32():
        out["beam_gap"] = float(beam_judge.beam_gaps(ref, samples, served, bos, beams).max())
        if control:
            ctl = ref_model.build(model_cfg, judge.float8_weights(state_dict), device, dtype=torch.bfloat16)
            out["control_beam_gap"] = float(beam_judge.beam_gaps(ref, samples, served, bos, beams,
                                                                 control=ctl).max())
    return out


class Driver(eval_sweep.Driver):
    def window(self, seconds: float, trace: bool) -> dict:
        from retr_tpu_torch.utils.profiling import PhaseTimer

        e2e = super().window(seconds, False)
        if trace:
            timer, box = PhaseTimer(), {}
            t = time.perf_counter()
            self.profile = launches.trace(lambda: box.setdefault("h", self._pass(self.loader, timer)))
            self.passes.append((box["h"], time.perf_counter() - t, True))
            for s in timer.samples.get("host_wait", []):
                self.spans.add("host_wait", s)
            e2e["window_s"] += self.passes[-1][1]
            print(f"pass {len(self.passes)}: {len(box['h'])} captions in {self.passes[-1][1]:.3f} s (profiled)",
                  file=sys.stderr)
        return e2e

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
        out = judge_beam_captions(c.model_cfg, self.state, requests, texts, bos=self.bos, steps=self.steps,
                                  beams=c.cfg.beam_size, device=c.device, image_side=c.cfg.image_size,
                                  control=control)
        out["unreadable"] = sum(common.served_ids([h["expression"] for h in hyps], self.steps)[1]
                                for hyps, _, _ in self.passes)
        out["missing"] = self.counts()[1]
        return out

    def context(self) -> dict:
        return {**super().context(), "beams": self.cell.cfg.beam_size}
