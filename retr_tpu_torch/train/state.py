"""Train state, the training step and the validation loss (retr_tpu/train/state.py).

The optimization recipe is the reference's:

- AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay ``cfg.weight_decay``
  on every trained leaf) in two groups: the backbone at ``lr_backbone``,
  everything else at ``lr``. ``torch.optim.AdamW`` computes optax's ``adamw``.
- Frozen leaves, as the reference freezes them: the backbone's conv1, bn1 and
  layer1, and every folded BatchNorm affine. They do not require grad, so they
  get no update, no decay, and stay out of the clip norm (optax zeroes their
  gradients before the clip; the reference's are None or buffers).
- The PAD row of the word embedding gets a zero gradient before the norm is
  taken (``nn.Embedding(padding_idx=...)``).
- Global-norm clip at ``cfg.clip_max_norm``, optax's form: ``g / norm * max``
  when the norm is not below ``max``.
- The learning rate per update count: StepLR, or cosine decay, either with an
  optional linear warm-up (``build_schedule``), as in optax.
- Loss: softmax cross-entropy of the shifted tokens, averaged over ALL
  positions, PAD included (the reference's criterion has no ignore_index).

Forward and ``backward()`` both run inside ``precision.matmul_precision`` of the
compute type, so the f32 (parity) step has TF32 off in the backward's products
and convolutions as well. Parameters stay f32 (master weights) in either
compute type. The step updates the parameters in place (JAX returns new
arrays) and returns the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from retr_tpu_torch import device as device_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.pipeline import Batch
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, layers
from retr_tpu_torch.precision import dtype_of, matmul_precision

Params = Dict[str, Any]

__all__ = ["Batch", "TrainState", "build_schedule", "create_train_state", "loss_fn",
           "make_eval_step", "make_optimizer", "make_train_step", "param_labels", "step_lr"]


# ---------------------------------------------------------------------------------
# Parameter tree and its partition (frozen / backbone / rest)
# ---------------------------------------------------------------------------------


def tree_leaves_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) pairs in the order the JAX package flattens the same tree
    (dict keys sorted, lists in order); a path is a tuple of keys and indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _label_path(path: Tuple) -> str:
    if path and path[0] == "backbone":
        if path[1] in ("conv1", "bn1", "layer1"):
            return "frozen"
        if any(k in ("bn1", "bn2", "bn3", "bn") for k in path):
            return "frozen"
        return "backbone"
    return "rest"


def param_labels(params: Params) -> Params:
    """The tree of labels: "frozen", "backbone" or "rest" per leaf."""
    return tree_map_with_path(lambda path, _: _label_path(path), params)


# ---------------------------------------------------------------------------------
# Learning-rate schedules (functions of the update count, as in optax)
# ---------------------------------------------------------------------------------


def step_lr(base_lr: float, lr_drop_epochs: int, steps_per_epoch: int, gamma: float = 0.1):
    """torch StepLR(step_size=lr_drop, gamma=0.1) as a per-update schedule."""

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // lr_drop_epochs)

    return schedule


def build_schedule(cfg: Config, base_lr: float, steps_per_epoch: int):
    """``lr_schedule="step"``: StepLR; ``"cosine"``: optax's
    warmup_cosine_decay_schedule (0 -> base_lr over ``warmup_steps``, then
    cosine to 0 at ``epochs * steps_per_epoch``). For the step schedule
    ``warmup_steps > 0`` ramps ``base_lr * (count + 1) / warmup_steps`` first."""
    warmup = cfg.warmup_steps
    if cfg.lr_schedule == "cosine":
        total = max(cfg.epochs * max(steps_per_epoch, 1), warmup + 1)
        decay = total - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return base_lr * count / warmup
            t = min(count - warmup, decay)
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    sched = step_lr(base_lr, cfg.lr_drop, steps_per_epoch)
    if warmup > 0:
        def warmed(count: int) -> float:
            return base_lr * (count + 1) / warmup if count < warmup else sched(count)

        return warmed
    return sched


def make_optimizer(cfg: Config, params: Params, steps_per_epoch: int) -> torch.optim.AdamW:
    """AdamW over the trained leaves in two groups ("rest" at ``lr``, "backbone"
    at ``lr_backbone``), each group carrying its schedule under "schedule"."""
    groups: Dict[str, List[torch.Tensor]] = {"rest": [], "backbone": []}
    for path, leaf in tree_leaves_with_path(params):
        label = _label_path(path)
        if label != "frozen":
            groups[label].append(leaf)
    return torch.optim.AdamW(
        [{"params": groups[name], "lr": base, "name": name,
          "schedule": build_schedule(cfg, base, steps_per_epoch)}
         for name, base in (("rest", cfg.lr), ("backbone", cfg.lr_backbone))],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class TrainState:
    """Parameters (f32 leaf tensors; frozen ones do not require grad), the
    AdamW that updates them, the number of updates made, and the pre-clip
    global gradient norm of the last update."""

    params: Params
    opt_state: torch.optim.AdamW
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None


def create_train_state(cfg: Config, params: Params, device=None,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Copy ``params`` (the port's tree, e.g. ``weights.to_params``) to ``device``
    (``cuda`` unless told otherwise) as f32 leaves, and build the optimizer."""
    dev = device_mod.resolve(device)

    def leaf(path, t):
        t = t.detach().to(device=dev, dtype=torch.float32).clone()
        return t.requires_grad_(_label_path(path) != "frozen")

    params = tree_map_with_path(leaf, params)
    return TrainState(params, make_optimizer(cfg, params, steps_per_epoch))


# ---------------------------------------------------------------------------------
# Loss and the steps
# ---------------------------------------------------------------------------------


# "fused": mean(logsumexp - target logit); "logsoftmax": the reference's
# -mean(log_softmax[target]). The same function; the JAX package picked the first
# for the TPU (no [B, T, V] log-softmax and no gather), both are kept.
CE_IMPL = "fused"


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logits32 = logits.float()
    tgt = targets.long()[..., None]
    if CE_IMPL == "logsoftmax":
        return -torch.log_softmax(logits32, dim=-1).gather(-1, tgt)[..., 0].mean()
    return (torch.logsumexp(logits32, dim=-1) - logits32.gather(-1, tgt)[..., 0]).mean()


def loss_fn(params: Params, cfg: Config, batch: Batch, seed: Optional[int], *, train: bool,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Cross-entropy of the logits of caps[:, :-1] against caps[:, 1:]."""
    logits = caption.forward(
        params, cfg, Masked(batch.images, batch.image_masks),
        batch.caps[:, :-1], batch.cap_masks[:, :-1],
        global_samples=(Masked(batch.global_images, batch.global_masks)
                        if batch.global_images is not None else None),
        loc_feats=batch.loc_feats, train=train, seed=seed, compute_dtype=compute_dtype,
    )
    return _cross_entropy(logits, batch.caps[:, 1:])


def _trained(state: TrainState) -> List[torch.Tensor]:
    return [p for g in state.opt_state.param_groups for p in g["params"]]


def _update(cfg: Config, state: TrainState) -> None:
    """PAD-row zero, global-norm clip, AdamW at the scheduled learning rates."""
    trained = _trained(state)
    for p in trained:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.params["transformer"]["embeddings"]["word"]["table"].grad[cfg.pad_token_id] = 0.0
    grads = [p.grad for p in trained]
    state.grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    norm = float(state.grad_norm)
    if cfg.clip_max_norm > 0 and norm >= cfg.clip_max_norm:
        torch._foreach_div_(grads, norm)                 # optax's form: (g / norm) * max_norm
        torch._foreach_mul_(grads, cfg.clip_max_norm)
    for group in state.opt_state.param_groups:
        group["lr"] = group["schedule"](state.step)
    state.opt_state.step()
    state.step += 1


def _split(batch: Batch, n: int) -> List[Batch]:
    b = batch.images.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by accum_steps {n}")
    m = b // n
    return [Batch(*(None if x is None else x[i * m:(i + 1) * m] for x in batch)) for i in range(n)]


def make_train_step(cfg: Config, *, compute_dtype=None, accum_steps: Optional[int] = None) -> Callable:
    """The training step ``step(state, batch, seed) -> (state, loss)``: gradients,
    PAD-row zero, clip, AdamW, in place on ``state``.

    ``compute_dtype`` defaults to ``cfg.compute_dtype`` (f32 parity, bf16
    throughput; the backbone computes in it, parameters stay f32). ``seed`` is
    an integer; the step's dropout seed is ``fold_in(seed, state.step)``.
    ``accum_steps`` (default ``cfg.grad_accum_steps``) > 1 splits the batch into
    that many micro-batches (micro-batch i draws dropout from
    ``fold_in(step seed, i)``), sums their gradients and scales the sum by
    1/accum_steps before the one update: the mean of equal-size micro-batch
    gradients is the full batch's gradient."""
    dt = dtype_of(cfg.compute_dtype if compute_dtype is None else compute_dtype)
    accum = cfg.grad_accum_steps if accum_steps is None else accum_steps

    def step(state: TrainState, batch: Batch, seed: int) -> Tuple[TrainState, torch.Tensor]:
        micro = _split(batch, accum)
        step_seed = layers.fold_in(seed, state.step)
        state.opt_state.zero_grad(set_to_none=True)
        total = None
        with matmul_precision(dt):
            for i, mb in enumerate(micro):
                loss = loss_fn(state.params, cfg, mb, step_seed if accum == 1 else layers.fold_in(step_seed, i),
                               train=True, compute_dtype=dt)
                loss.backward()
                total = loss.detach() if total is None else total + loss.detach()
        if accum > 1:
            for p in _trained(state):
                if p.grad is not None:
                    p.grad.mul_(1.0 / accum)
            total = total * (1.0 / accum)
        _update(cfg, state)
        return state, total

    return step


def make_eval_step(cfg: Config, *, compute_dtype=None) -> Callable:
    """Validation loss ``step(params, batch) -> loss``: no gradient, no dropout."""
    dt = dtype_of(cfg.compute_dtype if compute_dtype is None else compute_dtype)

    def step(params: Params, batch: Batch) -> torch.Tensor:
        with torch.no_grad(), matmul_precision(dt):
            return loss_fn(params, cfg, batch, None, train=False, compute_dtype=dt)

    return step
