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
- Global-norm clip at ``cfg.clip_max_norm``, optax's form on the device:
  ``g / where(norm >= max, norm, 1) * where(norm >= max, max, 1)``, so the
  step reads nothing back to the host.
- The learning rate per update count: StepLR, or cosine decay, either with an
  optional linear warm-up (``build_schedule``), as in optax.
- Loss: softmax cross-entropy of the shifted tokens, averaged over ALL
  positions, PAD included (the reference's criterion has no ignore_index).

Forward and ``backward()`` both run inside ``precision.matmul_precision`` of the
compute type, so the f32 (parity) step has TF32 off in the backward's products
and convolutions as well. Parameters stay f32 (master weights) in either
compute type. The step updates the parameters in place (JAX returns new
arrays) and returns the state.

JAX compiles each step into one program (``jax.jit``); here, on a CUDA device
with no mesh and ``CUDA_GRAPHS`` on, each step is one CUDA graph
(ops/graphs.py): a key's first call runs eagerly, the second captures and
replays, later calls replay. The AdamW on a CUDA device is capturable: its
step counters live on the device, and each group's ``lr`` is a device tensor
the host fills from the schedule before each step, so the eager step and the
graph do the same arithmetic. On the CPU the optimizer is torch's default.
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
from retr_tpu_torch.ops import graphs
from retr_tpu_torch.parallel import mesh as pmesh
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
    at ``lr_backbone``), each group carrying its schedule under "schedule".
    On a CUDA device it is capturable (step counters on the device, each
    group's ``lr`` a 0-d f32 device tensor), so a CUDA graph can hold its step."""
    groups: Dict[str, List[torch.Tensor]] = {"rest": [], "backbone": []}
    for path, leaf in tree_leaves_with_path(params):
        label = _label_path(path)
        if label != "frozen":
            groups[label].append(leaf)
    dev = groups["rest"][0].device
    capturable = dev.type == "cuda"

    def lr(base):
        return torch.tensor(base, dtype=torch.float32, device=dev) if capturable else base

    opt = torch.optim.AdamW(
        [{"params": groups[name], "lr": lr(base), "name": name,
          "schedule": build_schedule(cfg, base, steps_per_epoch)}
         for name, base in (("rest", cfg.lr), ("backbone", cfg.lr_backbone))],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay, capturable=capturable)
    opt._warned_capturable_if_run_uncaptured = True   # its eager steps are meant (warm-up, a mesh)
    return opt


def set_learning_rates(state: "TrainState") -> None:
    """Each group's learning rate for update ``state.step``, from its
    schedule: written into the group's device tensor (no host read), or set
    as a float on the CPU."""
    for group in state.opt_state.param_groups:
        lr = group["schedule"](state.step)
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


@dataclasses.dataclass
class TrainState:
    """Parameters (f32 leaf tensors; frozen ones do not require grad), the
    AdamW that updates them, the number of updates made, and the pre-clip
    global gradient norm of the last update. Under a mesh, ``params`` are
    this rank's slices and ``specs`` the spec tree they were cut by
    (``parallel.mesh.param_shardings``)."""

    params: Params
    opt_state: torch.optim.AdamW
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None
    mesh: Optional[pmesh.Mesh] = None
    specs: Optional[Params] = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` (no index) names the current card."""
    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index
    return a.type == b.type and (a.type != "cuda" or index(a) == index(b))


def create_train_state(cfg: Config, params: Params, device=None,
                       steps_per_epoch: int = 1000, mesh: Optional[pmesh.Mesh] = None) -> TrainState:
    """Copy ``params`` (the port's tree, e.g. ``weights.to_params``) to ``device``
    (``cuda`` unless told otherwise; the mesh's device under ``mesh``, and a
    ``device`` that is not the mesh's raises) as f32 leaves, and build the
    optimizer. Under ``mesh`` the full tree is cut to this rank's slices
    first."""
    if cfg.decoder_kind == "lm":
        raise NotImplementedError("training with the LM decoder (ROADMAP L2: LM training)")
    if mesh is None:
        dev = device_mod.resolve(device)
    elif device is not None and not _same_device(torch.device(device), mesh.device):
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    else:
        dev = mesh.device
    specs = None
    if mesh is not None:
        specs = pmesh.param_shardings(params, mesh, cfg.nheads)
        params = pmesh.shard_params(params, mesh, specs)

    def leaf(path, t):
        t = t.detach().to(device=dev, dtype=torch.float32).clone()
        return t.requires_grad_(_label_path(path) != "frozen")

    params = tree_map_with_path(leaf, params)
    return TrainState(params, make_optimizer(cfg, params, steps_per_epoch), mesh=mesh, specs=specs)


def trained_specs(state: TrainState) -> List[pmesh.Spec]:
    """The spec of each trained leaf, in the optimizer's order (all
    replicated without a mesh)."""
    trained = _trained(state)
    if state.specs is None:
        return [pmesh.REPLICATED] * len(trained)
    spec_of = {id(x): s for x, s in zip(pmesh.leaves(state.params), pmesh.leaves(state.specs))}
    return [spec_of[id(p)] for p in trained]


# ---------------------------------------------------------------------------------
# Loss and the steps
# ---------------------------------------------------------------------------------


# "fused": mean(logsumexp - target logit); "logsoftmax": the reference's
# -mean(log_softmax[target]). The same function; the JAX package picked the first
# for the TPU (no [B, T, V] log-softmax and no gather), both are kept.
CE_IMPL = "fused"


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy over every position. Logits narrower than
    ``vocab_size`` are this rank's slice of an mp-sharded head: the
    vocab-parallel form (:func:`_vocab_parallel_cross_entropy`)."""
    logits32 = logits.float()
    if vocab_size is not None and logits.shape[-1] != vocab_size:
        return _vocab_parallel_cross_entropy(logits32, targets.long())
    tgt = targets.long()[..., None]
    if CE_IMPL == "logsoftmax":
        return -torch.log_softmax(logits32, dim=-1).gather(-1, tgt)[..., 0].mean()
    return (torch.logsumexp(logits32, dim=-1) - logits32.gather(-1, tgt)[..., 0]).mean()


def _vocab_parallel_cross_entropy(logits32: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logsumexp - target logit over a vocabulary split across the mp group,
    with three all_reduces over [B, T]: the max (a shift, no gradient), the
    sum of exponentials and the target logit (each rank holds it or 0). The
    gradient reaching this rank's logits is its slice of softmax - onehot."""
    v = logits32.shape[-1]
    start = pmesh.current().mp_rank * v
    gmax = pmesh.all_reduce(logits32.detach().amax(dim=-1), pmesh.mp_group(), "max")
    shifted = logits32 - gmax[..., None]
    sum_exp = pmesh.reduce_from_mp(shifted.exp().sum(dim=-1))
    local = targets - start
    inside = (local >= 0) & (local < v)
    picked = shifted.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    target = pmesh.reduce_from_mp(torch.where(inside, picked, 0.0))
    return (torch.log(sum_exp) - target).mean()


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
    return cross_entropy(logits, batch.caps[:, 1:], cfg.vocab_size)


def _trained(state: TrainState) -> List[torch.Tensor]:
    return [p for g in state.opt_state.param_groups for p in g["params"]]


def _flat_all_reduce(tensors: List[torch.Tensor], group, scale: float) -> None:
    """Sum ``tensors`` over ``group`` in one all_reduce of a flat bucket, then
    scale, in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pmesh.all_reduce(flat, group).mul_(scale)
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view_as(t))


def _average_gradients(state: TrainState, specs: List[pmesh.Spec]) -> None:
    """DDP's arithmetic on the parameter tree: each sharded gradient is
    averaged over its dp group; each replicated one over the whole world
    (its mp copies are equal up to the rounding of the card's atomics, so
    the mean keeps the replicated parameters bit-equal across the mp group)."""
    mesh = state.mesh
    grads = [p.grad for p in _trained(state)]
    _flat_all_reduce([g for g, s in zip(grads, specs) if "mp" not in s], mesh.world_group, 1.0 / mesh.world)
    _flat_all_reduce([g for g, s in zip(grads, specs) if "mp" in s], mesh.dp_group, 1.0 / mesh.dp)


def _leaf_norms(grads: List[torch.Tensor]) -> torch.Tensor:
    """Each leaf's norm, stacked, in f32. The CPU's f32 norm sums into one
    running f32 value (3e-5 relative off at millions of elements, where
    optax's is within 1e-7), so on the CPU the sums are taken in f64."""
    wide = torch.float64 if grads[0].device.type == "cpu" else None
    return torch.stack(torch._foreach_norm(grads, 2, dtype=wide)).float()


def _global_norm(grads: List[torch.Tensor], specs: List[pmesh.Spec], mesh) -> torch.Tensor:
    """The norm of the whole gradient: the squares of the sharded leaves
    summed over the mp group, the replicated leaves counted once."""
    split = [g for g, s in zip(grads, specs) if "mp" in s]
    if not split:
        return torch.linalg.vector_norm(_leaf_norms(grads))
    rest = [g for g, s in zip(grads, specs) if "mp" not in s]
    sq_split = pmesh.all_reduce(_leaf_norms(split).square().sum(), mesh.mp_group)
    sq_rest = _leaf_norms(rest).square().sum() if rest else torch.zeros_like(sq_split)
    return torch.sqrt(sq_rest + sq_split)


def _update(cfg: Config, state: TrainState) -> torch.Tensor:
    """dp gradient mean (under a mesh), PAD-row zero, global-norm clip, AdamW
    at the learning rates the groups hold (:func:`set_learning_rates`).
    Returns the pre-clip global norm; reads nothing back to the host."""
    trained = _trained(state)
    for p in trained:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    specs = trained_specs(state)
    if state.mesh is not None:
        _average_gradients(state, specs)
    state.params["transformer"]["embeddings"]["word"]["table"].grad[cfg.pad_token_id].zero_()
    grads = [p.grad for p in trained]
    norm = _global_norm(grads, specs, state.mesh)
    if cfg.clip_max_norm > 0:
        # optax's form, (g / norm) * max_norm, where norm >= max_norm; g / 1 * 1 = g below
        over = norm >= cfg.clip_max_norm
        torch._foreach_div_(grads, torch.where(over, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(over, cfg.clip_max_norm, 1.0))
    state.opt_state.step()
    return norm


def _split(batch: Batch, n: int) -> List[Batch]:
    b = batch.images.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by accum_steps {n}")
    m = b // n
    return [Batch(*(None if x is None else x[i * m:(i + 1) * m] for x in batch)) for i in range(n)]


# On a CUDA device with no mesh, make_train_step's and make_eval_step's steps
# replay a CUDA graph per key (ops/graphs.py); off, they run eagerly (the
# card's tests and chip_smoke.py compare the two).
CUDA_GRAPHS = True


def _graphed(device: torch.device, mesh) -> bool:
    """Whether a step on ``device`` runs as a CUDA graph: ``CUDA_GRAPHS`` on,
    a CUDA device and no mesh (its collectives run over gloo or NCCL from the
    host, which a graph cannot hold)."""
    return CUDA_GRAPHS and device.type == "cuda" and mesh is None


def step_seed(seed: int, state: TrainState) -> int:
    """The root of a step's dropout seeds: ``fold_in(seed, state.step)``, with
    the dp rank folded in under a mesh with dp > 1."""
    root = layers.fold_in(seed, state.step)
    if state.mesh is not None and state.mesh.dp > 1:
        root = layers.fold_in(root, state.mesh.dp_rank)
    return root


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a captured train step reads or writes in place: the
    parameters, each optimizer-state tensor and each group's ``lr`` tensor."""
    opt = state.opt_state
    out = [t for _, t in tree_leaves_with_path(state.params)]
    out += [t for p in _trained(state) for t in opt.state.get(p, {}).values() if torch.is_tensor(t)]
    return out + [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]


def train_session_key(cfg: Config, state: TrainState, batch: Batch, compute_dtype, accum_steps: int) -> tuple:
    """The graph session key of a train step on ``state`` and ``batch``."""
    return graphs.step_session_key("train", batch.images.device, compute_dtype, batch, accum_steps=accum_steps,
                                   cfg=cfg, tensors=state_tensors(state), extra=(CE_IMPL,))


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
    gradients is the full batch's gradient.

    On a CUDA device with no mesh the step is a CUDA graph (``CUDA_GRAPHS``;
    ops/graphs.py ``run_step``), keyed by :func:`train_session_key`: every
    micro-batch's forward and backward, the PAD-row zero, the clip, AdamW and
    the in-place update. Only the learning rates (written before) and
    ``state.step`` (counted after) are the host's. The returned loss and
    ``state.grad_norm`` are copies, which later steps do not overwrite.

    Under ``state.mesh`` the batch is this dp rank's rows and the step runs
    eagerly: with the mesh active (the mp-sharded blocks' collectives), the
    dp rank folded into the step seed where dp > 1, the gradients (and the
    returned loss) averaged over dp after the backward and any accumulation,
    and the clip by the global norm of the sharded gradient."""
    if cfg.decoder_kind == "lm":
        raise NotImplementedError("training with the LM decoder (ROADMAP L2: LM training)")
    dt = dtype_of(cfg.compute_dtype if compute_dtype is None else compute_dtype)
    accum = cfg.grad_accum_steps if accum_steps is None else accum_steps

    def grads_and_update(state: TrainState, batch: Batch, root: int) -> Tuple[torch.Tensor, torch.Tensor]:
        micro = _split(batch, accum)
        mesh = state.mesh
        state.opt_state.zero_grad(set_to_none=True)
        total = None
        with pmesh.active(mesh), matmul_precision(dt):
            for i, mb in enumerate(micro):
                loss = loss_fn(state.params, cfg, mb, root if accum == 1 else layers.fold_in(root, i),
                               train=True, compute_dtype=dt)
                loss.backward()
                total = loss.detach() if total is None else total + loss.detach()
        if accum > 1:
            for p in _trained(state):
                if p.grad is not None:
                    p.grad.mul_(1.0 / accum)
            total = total * (1.0 / accum)
        if mesh is not None:
            total = pmesh.all_reduce(total.clone(), mesh.dp_group) / mesh.dp
        return total, _update(cfg, state)

    def step(state: TrainState, batch: Batch, seed: int) -> Tuple[TrainState, torch.Tensor]:
        _split(batch, accum)     # a batch that does not split raises before any session is made
        root = step_seed(seed, state)
        set_learning_rates(state)
        dev = batch.images.device
        if _graphed(dev, state.mesh):
            loss, norm = graphs.run_step(
                lambda: (train_session_key(cfg, state, batch, dt, accum), state_tensors(state)), batch,
                lambda b, r: grads_and_update(state, b, r), device=dev, root=root, owner=state.opt_state)
        else:
            loss, norm = grads_and_update(state, batch, root)
        state.grad_norm = norm
        state.step += 1
        return state, loss

    return step


def make_eval_step(cfg: Config, *, compute_dtype=None) -> Callable:
    """Validation loss ``step(params, batch) -> loss``: no gradient, no dropout.
    On a CUDA device with no active mesh, a CUDA graph per key (the
    parameters' identities, the batch's shapes: a ragged last batch has its
    own), as :func:`make_train_step`'s."""
    if cfg.decoder_kind == "lm":
        raise NotImplementedError("training with the LM decoder (ROADMAP L2: LM training)")
    dt = dtype_of(cfg.compute_dtype if compute_dtype is None else compute_dtype)

    def forward(params: Params, batch: Batch) -> torch.Tensor:
        with torch.no_grad(), matmul_precision(dt):
            return loss_fn(params, cfg, batch, None, train=False, compute_dtype=dt)

    def step(params: Params, batch: Batch) -> torch.Tensor:
        dev = batch.images.device
        if not _graphed(dev, pmesh.current()):
            return forward(params, batch)
        leaves = [t for _, t in tree_leaves_with_path(params)]
        key = graphs.step_session_key("eval", dev, dt, batch, accum_steps=1, cfg=cfg, tensors=leaves,
                                      extra=(CE_IMPL,))
        (loss,) = graphs.run_step(lambda: (key, leaves), batch, lambda b, _: (forward(params, b),), device=dev)
        return loss

    return step
