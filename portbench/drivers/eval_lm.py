"""Offline evaluation sweep with the LM decoder (``Config.decoder_kind ==
"lm"``): ``eval_sweep``'s closed loop over a RefCOCO-shaped split, greedy,
with ``lm_weights``' state dict and the LM's judge.

Set-up and the window's passes are ``eval_sweep``'s; the weights are
``portbench/lm_weights.py``'s (the program's parameters are views of the
judge's state dict, so 16 B parameters are held once). A traced run profiles
one more pass after the window through ``portbench/launches.py``, as
``eval_beam`` does, so that the prefill's and the decode loop's device time
are told apart by the host spans that launched them; its captions are left
out of captions/s. The experts' tallies of that pass (``moe.pairs``, and
``moe.max_expert_tokens`` as its mean over the pass's batches) go to the
readers' context and to stderr.

The judge reads ``judge_captions`` served captions with the plain reference
(``portbench/reference/lm.py``, a layer at a time in float32): each served
token's gap below the reference's best logit at its prefix (``token_gap``),
and the program's routed experts on the judged tokens (``expert_gap``): at
each MoE layer the program's own ``models/lm.moe`` without its shared
experts takes the reference's input to that layer, rounded to the compute
type, and its output's distance from the reference's routed experts on the
same input, over the norm of theirs, is read; ``expert_gap`` is the widest
layer's. So a fault in the routing or the grouped products shows there
however little the routed experts move the logits. The control runs the
same reference with float8 e4m3 weights in bfloat16 (``control_gap``), and
its MoE layers with float8 weights in bfloat16 on the same inputs
(``control_expert_gap``), and reports the share of the judged tokens' MoE
choices that bfloat16 moves (``control_bf16_expert_flips``: the reference in
bfloat16 against float32, per token and MoE layer).

A program whose ``Config`` has no ``decoder_kind`` would drop the LM's keys
and build a RE:TR model: importing this module then fails at once.

Traffic keys: ``eval_sweep``'s, with ``decoder`` "greedy".
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import torch

from retr_tpu_torch.config import Config

if "decoder_kind" not in {f.name for f in dataclasses.fields(Config)}:
    raise RuntimeError("eval_lm: this program's Config has no decoder_kind, so it cannot build the LM decoder "
                       "(Config.from_dict would drop the lm_* keys and build a RE:TR model under this cell's name)")

from retr_tpu_torch.models import lm as prog_lm  # noqa: E402
from retr_tpu_torch.precision import dtype_of, matmul_precision  # noqa: E402

from portbench import lm_weights, synth  # noqa: E402
from portbench.drivers import common, eval_beam  # noqa: E402
from portbench.reference import judge as ref_judge  # noqa: E402
from portbench.reference import lm as ref_lm  # noqa: E402
from portbench.reference import preprocess as ref_pre  # noqa: E402

MOE_COUNTERS = ("moe.pairs", "moe.max_expert_tokens")


def _gap(logits: torch.Tensor, chosen: torch.Tensor) -> float:
    return float((logits.max(-1).values - logits.gather(-1, chosen[..., None].long())[..., 0]).max())


def _distance(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


class _ExpertProbe:
    """The reference's ``probe``: at each MoE layer, the program's routed
    experts (``models/lm.moe`` with the layer's leaves of the state dict, no
    shared experts) and, with ``control``, the float8 control's, against the
    reference's on the layer's input rounded to the compute type."""

    def __init__(self, cfg: Config, model_cfg: dict, state_dict: dict, control: bool):
        self.cfg, self.model_cfg, self.state_dict, self.control = cfg, model_cfg, state_dict, control
        self.layers = prog_lm.params_from_state(state_dict, cfg)["layers"]
        self.gaps, self.control_gaps = [], []

    def __call__(self, i: int, moe) -> None:
        dt = dtype_of(self.cfg.compute_dtype)
        x = moe.inp.to(dt)
        want, _ = moe.routed(x.float())
        routed = {k: v for k, v in self.layers[i]["moe"].items() if k != "shared"}
        with matmul_precision(dt):
            self.gaps.append(_distance(prog_lm.moe(routed, x, self.cfg), want))
        if self.control:
            half = torch.bfloat16
            ctl = ref_lm.moe_module(self.model_cfg, self.state_dict, i, x.device, half, ref_lm.float8_leaf)
            self.control_gaps.append(_distance(ctl.routed(x.to(half))[0], want))


def judge_lm_captions(model_cfg: dict, state_dict: dict, requests, texts, *, cfg: Config, bos: int, steps: int,
                      device, image_side: int, control: bool = False) -> dict:
    """``common.judge_captions`` for the LM decoder: {"token_gap",
    "expert_gap", "unreadable"}, and with ``control`` also "control_gap",
    "control_expert_gap" and "control_bf16_expert_flips"."""
    ids, bad = common.served_ids(texts, steps)
    keep = [i for i in range(len(texts)) if ids[i, 0] >= 0]
    out = {"unreadable": bad, "token_gap": 0.0, "expert_gap": 0.0}
    if not keep:
        return out
    g, loc = model_cfg["use_global_features"], model_cfg["use_location_features"]
    inp = ref_pre.batch([ref_pre.sample(requests[i][0], requests[i][1], image_side, g, loc) for i in keep], device)
    served = ids[keep].to(device)
    caps = torch.cat([torch.full((len(keep), 1), bos, dtype=served.dtype, device=device), served[:, :-1]], 1)
    enc_sd = {k: v for k, v in state_dict.items() if k.startswith(ref_lm.ENCODER_PREFIXES)}
    with common._full_f32():
        mem, mask = ref_lm.memory(ref_lm.encoder(model_cfg, enc_sd, device), inp)
        routes, probe = [], _ExpertProbe(cfg, model_cfg, state_dict, control)
        logits = ref_lm.lm_logits(model_cfg, state_dict, mem, mask, caps, routes=routes, probe=probe)
        out["token_gap"] = _gap(logits, served)
        out["expert_gap"] = max(probe.gaps, default=0.0)
        if control:
            out["control_expert_gap"] = max(probe.control_gaps, default=0.0)
            half = torch.bfloat16
            cmem, _ = ref_lm.memory(ref_lm.encoder(model_cfg, ref_judge.float8_weights(enc_sd), device, half), inp)
            chosen = ref_lm.lm_logits(model_cfg, state_dict, cmem, mask, caps, dtype=half,
                                      transform=ref_lm.float8_leaf).argmax(-1)
            out["control_gap"] = _gap(logits, chosen)
            bmem, _ = ref_lm.memory(ref_lm.encoder(model_cfg, enc_sd, device, half), inp)
            broutes = []
            ref_lm.lm_logits(model_cfg, state_dict, bmem, mask, caps, dtype=half, routes=broutes)
            s = mem.shape[1]
            moved = [(a[:, s:].sort(-1).values != b[:, s:].sort(-1).values).any(-1) for a, b in zip(routes, broutes)]
            out["control_bf16_expert_flips"] = float(torch.stack(moved).float().mean())
    return out


class Driver(eval_beam.Driver):
    def __init__(self, cell: common.Cell):
        super().__init__(cell)
        cell.state_dict = functools.partial(lm_weights.state_dict, cell.model_cfg, cell.seed, cell.device)
        self.moe = {}

    def window(self, seconds: float, trace: bool) -> dict:
        from retr_tpu_torch.utils import profiling

        c = self.cell
        before = profiling.counters()
        e2e = super().window(seconds, trace)
        after = profiling.counters()
        self.moe = {k: after.get(k, 0) - before.get(k, 0) for k in MOE_COUNTERS if k in after}
        if self.moe:
            # the busiest [layer, expert] over the mean is a ratio a batch: its mean over the pass's batches
            self.moe["moe.max_expert_tokens"] /= -(-len(self.expected) // c.traffic["batch"])
            print("moe counters of the traced pass: " + ", ".join(f"{k} {v}" for k, v in self.moe.items()),
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
        out = judge_lm_captions(c.model_cfg, self.state, requests, texts, cfg=c.cfg, bos=self.bos, steps=self.steps,
                                device=c.device, image_side=c.cfg.image_size, control=control)
        out["unreadable"] = sum(common.served_ids([h["expression"] for h in hyps], self.steps)[1]
                                for hyps, _, _ in self.passes)
        out["missing"] = self.counts()[1]
        return out

    def context(self) -> dict:
        ctx = {**super().context(), "moe": self.moe}
        del ctx["beams"]            # eval_beam's, and this cell is greedy
        return ctx
