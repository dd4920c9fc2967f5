"""Training: ``engine.train_one_epoch`` over the shuffled training loader.

Set-up builds the split, the weights, the program's dataset and
``DataLoader(batch_size, shuffle, drop_last, num_workers)`` as ``main.py``
builds its training loader, ``create_train_state`` and ``make_train_step``,
and drives that same state through epoch 0's first three batches by
``train_one_epoch`` itself (the step's eager call, its capture, a replay).
Those three steps are what the reference follows: their losses, the first
gradient as AdamW got it (its first moment after one step over 1 - beta1) and
the parameters' change after three. The window runs ``train_one_epoch``
for epochs 1, 2, ... and stops the loader once ``--seconds`` have gone; a
sample counts once its step has completed.

A float32 configuration turns both TF32 switches off for the process before
set-up, as the configuration states.

Traffic keys: ``split`` (images, objects, expressions, partition).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import profiler, synth
from portbench.drivers import common
from portbench.harness import Spans
from portbench.reference import judge, model as ref_model
from portbench.reference import train as ref_train

FIRST_STEPS = 3
PROFILED_STEPS = 10


def _cut(loader, stop, spans=None):
    """The same DataLoader (dataset, shuffle, seed, workers) whose iteration
    ends when ``stop(i)`` says so before batch i; with ``spans``, the host
    time blocked on each batch goes to ``spans`` as "loader_wait"."""
    from retr_tpu_torch.data.dataset import DataLoader

    class Cut(DataLoader):
        def __iter__(self):
            it = super().__iter__()
            try:
                i = 0
                while not stop(i):
                    t = time.perf_counter()
                    b = next(it, None)
                    if b is None:
                        return
                    if spans is not None:
                        spans.add("loader_wait", time.perf_counter() - t)
                    yield b
                    i += 1
            finally:
                it.close()

    cut = Cut.__new__(Cut)
    cut.__dict__.update(loader.__dict__)
    return cut


def ref_name(path) -> str:
    """The reference state-dict name of a leaf of the program's parameter tree
    (the tree ``retr_tpu_torch/models/weights.py`` documents); q/k/v map to
    ``in_proj``, whose norm is theirs together."""
    p = [str(x) for x in path]
    leaf = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias", "table": "weight"}[p[-1]]
    if p[0] == "backbone":
        if p[-2] == "conv" and "downsample" in p:
            return f"backbone.body.{p[1]}.{p[2]}.downsample.0.weight"
        return "backbone.body." + ".".join(p[1:-1]) + ".weight"
    if p[0] in ("input_proj", "loc_proj"):
        return f"{p[0]}.{leaf}"
    if p[0] == "mlp":
        return f"mlp.layers.{p[2]}.{leaf}"
    if p[1] == "embeddings":
        part = {"word": "word_embeddings", "pos": "position_embeddings", "norm": "LayerNorm"}[p[2]]
        return f"transformer.embeddings.{part}.{leaf}"
    stack = p[1]
    if p[2] == "norm":
        return f"transformer.{stack}.norm.{leaf}"
    block = {"self_attn": "self_attn" if stack == "encoder" else "tgt_self_attn",
             "cross_attn": "tgt_src_cross_attn", "ff": "ff"}[p[4]]
    base = f"transformer.{stack}.layers.{p[3]}.{block}"
    if p[5] == "norm":
        return f"{base}.norm.{leaf}"
    if p[5] == "mha":
        return f"{base}.sublayer.out_proj.{leaf}" if p[6] == "out" else f"{base}.sublayer.in_proj_{leaf}"
    return f"{base}.sublayer.{0 if p[5] == 'lin1' else 2}.{leaf}"


def leaf_norms(named) -> dict:
    """{reference name: norm} from (reference name, tensor) pairs, leaves that
    share a name summed in squares."""
    sq = {}
    for name, t in named:
        sq[name] = sq.get(name, 0.0) + float(torch.linalg.vector_norm(t.double())) ** 2
    return {k: v ** 0.5 for k, v in sq.items()}


def worst_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


class Driver:
    def __init__(self, cell: common.Cell):
        self.cell = cell
        self.spans = Spans()
        self.profile = None
        self.steps = 0
        self.losses = []
        self.trace_at, self.tracer, self.trace_s = -1, None, 0.0

    def _step(self, state, batch, seed):
        t = time.perf_counter()
        if self.steps == self.trace_at:
            self.tracer = profiler.Trace()
            self.tracer.start()
            self.trace_t = t
        state, loss = self.train_step(state, batch, seed)
        self.steps += 1
        if self.tracer is not None and self.steps == self.trace_at + PROFILED_STEPS:
            self.profile = self.tracer.stop()
            self.tracer = None
            self.trace_s = time.perf_counter() - self.trace_t
        self.losses.append(loss)
        if self.steps == 1:
            opt = state.opt_state.state
            self.first_moment = [(ref_name(path), opt[leaf]["exp_avg"].detach().clone() if leaf in opt
                                  else torch.zeros_like(leaf)) for path, leaf in self._trained(state)]
        return state, loss

    @staticmethod
    def _trained(state):
        from retr_tpu_torch.train.state import tree_leaves_with_path

        return [(path, leaf) for path, leaf in tree_leaves_with_path(state.params) if leaf.requires_grad]

    def setup(self) -> None:
        from retr_tpu_torch.data.dataset import DataLoader, build_dataset
        from retr_tpu_torch.engine import train_one_epoch
        from retr_tpu_torch.models import weights
        from retr_tpu_torch.train.state import create_train_state, make_train_step

        c, cfg = self.cell, self.cell.cfg
        if cfg.compute_dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        self.split = synth.write_split(c.scratch, c.seed, c.traffic["split"], c.model_cfg["vocab_size"])
        c.cfg = cfg = cfg.replace(ref_base=self.split["ref_base"], ref_dir=self.split["ref_base"] + "/refcoco")
        self.state_dict = c.state_dict(decode=False)
        tokenizer = c.tokenizer()
        self.loader = DataLoader(build_dataset(cfg, "training", tokenizer), cfg.batch_size, shuffle=True,
                                 drop_last=True, seed=cfg.seed, num_workers=cfg.num_workers)
        self.state = create_train_state(cfg, weights.to_params(self.state_dict, cfg, device=c.device),
                                        device=c.device, steps_per_epoch=len(self.loader))
        self.start = [(ref_name(p), leaf.detach().clone()) for p, leaf in self._trained(self.state)]
        self.train_step = make_train_step(cfg)
        self.state, _ = train_one_epoch(self.state, self._step, _cut(self.loader, lambda i: i >= FIRST_STEPS),
                                        cfg.seed, epoch=0)
        self.first_losses = [float(x) for x in self.losses]
        self.change = [(name, leaf.detach() - start) for (name, start), (_, leaf)
                       in zip(self.start, self._trained(self.state))]
        del self.start
        self.batch = cfg.batch_size

    def window(self, seconds: float, trace: bool) -> dict:
        """Epochs 1, 2, ... until ``seconds`` have gone; with ``trace`` the
        profiler covers steps 5-14 of the window, whose time the rate leaves out."""
        from retr_tpu_torch.engine import train_one_epoch

        self.spans.samples.clear()
        base, t0 = self.steps, time.perf_counter()
        if trace:
            self.trace_at = base + 5
        deadline = t0 + seconds
        epoch = 1
        while time.perf_counter() < deadline or self.tracer is not None:
            stop = (lambda i: time.perf_counter() >= deadline and self.tracer is None)
            self.state, _ = train_one_epoch(self.state, self._step, _cut(self.loader, stop, self.spans),
                                            self.cell.cfg.seed, epoch=epoch)
            epoch += 1
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.window_steps = self.steps - base
        waits = self.spans.samples.get("loader_wait", [])
        print(f"train: {self.window_steps} steps in {elapsed:.3f} s over {epoch - 1} epoch(s), loader_wait "
              f"{sum(waits):.3f} s, profiled {self.trace_s:.3f} s", file=sys.stderr)
        counted = self.window_steps - (PROFILED_STEPS if self.profile is not None else 0)
        return {"train_samples_per_s": counted * self.batch / (elapsed - self.trace_s)}

    def counts(self) -> tuple:
        return self.window_steps * self.batch, 0

    def release(self) -> None:
        del self.state, self.train_step
        common.release()

    def reference_rows(self):
        """The raw rows of epoch 0's first batches, in the loader's order
        (worked out again: its permutation is ``default_rng(seed + epoch)``)."""
        c = self.cell
        flat = [(rec[1], rec[2], s) for rec in self.split["records"] for s in rec[3]]
        idx = np.arange(len(flat))
        np.random.default_rng(c.cfg.seed + 0).shuffle(idx)
        b = self.batch
        return [[(synth.load_pool_image(c.coco, flat[k][0]), flat[k][1], flat[k][2]) for k in idx[i * b:(i + 1) * b]]
                for i in range(FIRST_STEPS)]

    def reference(self, control: bool = False) -> tuple:
        """The reference's three steps from the same weights and rows: (losses,
        {leaf: norm of the first clipped gradient}, {leaf: norm of the change}).
        ``control``: one precision below the configuration's, in the program's
        place: TF32 for float32; for bfloat16, the weights rounded to float8
        (e4m3, a scale per output channel) and the step computed in bfloat16."""
        c = self.cell
        vocab = {synth.token_name(i): i for i in range(c.model_cfg["vocab_size"])}
        epoch_seed = ref_train.fold_in(c.cfg.seed, 0)
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        f32 = c.model_cfg["compute_dtype"] == "float32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = control and f32
        try:
            if control and not f32:
                model = ref_model.build(c.model_cfg, judge.float8_weights(self.state_dict), c.device,
                                        dtype=torch.bfloat16).train()
            else:
                model = ref_model.build(c.model_cfg, self.state_dict, c.device).train()
            opt = ref_train.make_optimizer(model, c.model_cfg)
            start = {n: p.detach().clone() for n, p in ref_train.trained(model).items()}
            losses, first = [], None
            for k, rows in enumerate(self.reference_rows()):
                seed_k = ref_train.fold_in(epoch_seed, k)
                b = ref_train.batch(rows, c.model_cfg, seed_k, vocab, c.device)
                loss, grads = ref_train.step(model, opt, b, seed_k, c.model_cfg)
                losses.append(loss)
                first = grads if first is None else first
            change = {n: p.detach() - start[n] for n, p in ref_train.trained(model).items()}
            return losses, leaf_norms(first.items()), leaf_norms(change.items())
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    @staticmethod
    def compare(side: tuple, ref: tuple) -> dict:
        """The numbers compared: the worst step's loss gap, and the worst leaf's
        gap of the first gradient's and the change's norms. Leaves whose
        reference gradient is under a thousandth of the median leaf's move by
        round-off alone and are left out."""
        med = float(np.median(list(ref[1].values())))
        keep = [k for k, v in ref[1].items() if v >= 1e-3 * med]
        return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(side[0], ref[0])),
                "grad_gap": worst_gap(side[1], ref[1], keep), "change_gap": worst_gap(side[2], ref[2], keep),
                "leaves_left_out": len(ref[1]) - len(keep)}

    def judge(self, control: bool = False) -> dict:
        prog = (self.first_losses, leaf_norms((k, m / 0.1) for k, m in self.first_moment),
                leaf_norms(self.change))
        ref = self.reference()
        out = self.compare(prog, ref)
        if control:
            out.update({f"control_{k}": v for k, v in self.compare(self.reference(control=True), ref).items()})
        return out

    def context(self) -> dict:
        return {"profile": self.profile, "spans": self.spans.samples, "cfg": self.cell.model_cfg,
                "traffic": self.cell.traffic}
