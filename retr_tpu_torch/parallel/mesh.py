"""The (dp, mp) process mesh over torch.distributed, its collectives and the
tensor-parallel sharding rules (retr_tpu/parallel/mesh.py).

Every rank is one process on one device. Rank ``r`` sits at ``(r // mp,
r % mp)``, the layout of JAX's ``np.asarray(devices).reshape(dp, mp)``: each
mp group is a run of consecutive ranks. Unlike JAX's mesh, which may leave
devices out, the world must be exactly ``dp * mp``: a rank outside the mesh
would be an idle process.

- dp: data parallel. Each dp rank runs its own rows; gradients are averaged
  over the dp group (``train/state.make_train_step``).
- mp: tensor parallel, Megatron's pair on the blocks of :func:`param_specs`:
  q/k/v, FF1 and the vocab head column-sharded, the attention out-projection
  and FF2 row-sharded, the backbone and everything else replicated. The
  layer functions (``models/layers``, ``transformer``, ``caption``,
  ``train/state.cross_entropy``) see a block's local width and insert
  :func:`copy_to_mp` / :func:`reduce_from_mp` themselves, reading the mesh
  made current by :func:`active`.

The only tensor collective used is ``all_reduce`` (a gather of shards is an
all_reduce of zero-filled full buffers, exact since ``x + 0 == x``), plus
``all_gather_object`` for host lists: so gloo can carry CUDA tensors, and
several ranks can share one card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from retr_tpu_torch import device as device_mod

Spec = Tuple[Optional[str], ...]   # one entry per dimension: "mp" (sharded) or None
REPLICATED: Spec = ()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, mp) mesh, its groups and its device. A
    subgroup of one rank is None (no collective runs on it); a group that
    spans the world is the default group, even a world of one, so a world of
    one still runs its collectives."""

    dp: int
    mp: int
    rank: int
    dp_rank: int
    mp_rank: int
    dp_group: Any
    mp_group: Any
    world_group: Any
    device: torch.device

    @property
    def world(self) -> int:
        return self.dp * self.mp


def init_distributed(backend: Optional[str] = None, device=None, *, file_store: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Initialise the default process group; returns this rank's device.

    Rank and world size come from the arguments, else torchrun's ``RANK`` and
    ``WORLD_SIZE``. Without ``file_store`` (a ``FileStore`` path shared by the
    ranks) the rendezvous is torchrun's ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``). The device defaults to ``cuda:LOCAL_RANK`` and must
    exist; several ranks share a card only when the caller names it. The
    backend defaults to NCCL on CUDA and gloo on the CPU."""
    env = os.environ
    if rank is None or world_size is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError("init_distributed needs RANK and WORLD_SIZE (set by torchrun) "
                               "or rank=, world_size= and a file_store")
        rank = int(env["RANK"]) if rank is None else rank
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if (device.index or 0) >= n_cards:
            raise RuntimeError(f"{device} does not exist here ({n_cards} CUDA devices); "
                               "pass device='cpu' for the gloo CPU path")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if file_store is not None:
        store = dist.FileStore(file_store, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world_size)
    return device


def make_mesh(dp: Optional[int] = None, mp: int = 1, device=None) -> Mesh:
    """The mesh of the initialised process group, whose world must be exactly
    ``dp * mp`` (dp defaults to world // mp). ``device`` defaults to the
    current CUDA device, whatever the backend, and raises where there is no
    card: the CPU only when asked for. Every rank must call it: it creates
    the dp and mp groups."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"a (dp={dp}, mp={mp}) mesh needs an initialised process group "
                         "(parallel.mesh.init_distributed, or torchrun with --distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp = world // mp if dp is None else dp
    if mp < 1 or dp < 1 or dp * mp != world:
        raise ValueError(f"dp({dp}) * mp({mp}) must equal the world size ({world}): every process "
                         "is one device of the mesh")
    device = device_mod.resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def groups(members: List[List[int]]):
        # new_group is collective: every rank creates every group, in one order
        mine = None
        for ranks in members:
            if len(ranks) == world:
                return dist.group.WORLD
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = g
        return mine

    dp_group = groups([[i * mp + j for i in range(dp)] for j in range(mp)])
    mp_group = groups([[i * mp + j for j in range(mp)] for i in range(dp)])
    return Mesh(dp, mp, rank, rank // mp, rank % mp, dp_group, mp_group, dist.group.WORLD, device)


# -- the current mesh -----------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("retr_mesh", default=None)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the layer functions read (None: no mesh)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current() -> Optional[Mesh]:
    return _CURRENT.get()


def mp_group():
    mesh = current()
    if mesh is None:
        raise RuntimeError("a block's weights are mp-sharded but no mesh is active: "
                           "run under parallel.mesh.active(mesh)")
    return mesh.mp_group


# -- collectives ----------------------------------------------------------------


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In place over ``group`` (None: this rank alone, nothing to do); returns t."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


def all_gather_object(obj: Any, group) -> List[Any]:
    """Each rank's ``obj`` in rank order over ``group`` (host objects, pickled)."""
    if group is None:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def any_over_dp(flag: torch.Tensor) -> torch.Tensor:
    """A device bool OR-ed over the active mesh's dp group (the flag itself
    without a mesh or where the group is this rank alone)."""
    mesh = current()
    if mesh is None or mesh.dp_group is None:
        return flag
    return all_reduce(flag.to(torch.int32), mesh.dp_group, "max").bool()


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.world_group)


class _CopyToMp(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the mp group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromMp(torch.autograd.Function):
    """All-reduce over the mp group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-sharded product: replicated forward, its
    gradient summed over the mp group."""
    return _CopyToMp.apply(x, mp_group())


def reduce_from_mp(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-sharded product: the partial sums added over the
    mp group; the gradient passes through."""
    return _ReduceFromMp.apply(x, mp_group())


def mp_slice(n_local: int) -> slice:
    """This rank's rows of a dimension split over the current mesh's mp."""
    r = current().mp_rank
    return slice(r * n_local, (r + 1) * n_local)


# -- the tensor-parallel rules (JAX's spec trees, a tuple per leaf) --------------


def _mha_spec() -> Dict[str, Any]:
    # q/k/v project E -> E (heads): the output dim sharded; the out-projection
    # contracts the sharded dim (all-reduce), its output replicated
    return {"q": {"w": (None, "mp"), "b": ("mp",)}, "k": {"w": (None, "mp"), "b": ("mp",)},
            "v": {"w": (None, "mp"), "b": ("mp",)}, "out": {"w": ("mp", None), "b": ()}}


def _norm_spec() -> Dict[str, Spec]:
    return {"scale": (), "bias": ()}


def _att_block_spec():
    return {"norm": _norm_spec(), "mha": _mha_spec()}


def _ff_spec():
    # lin1 expands d -> dff (dff sharded); lin2 contracts dff -> d (all-reduce)
    return {"norm": _norm_spec(), "lin1": {"w": (None, "mp"), "b": ("mp",)}, "lin2": {"w": ("mp", None), "b": ()}}


def transformer_specs(params: dict) -> dict:
    spec: dict = {
        "encoder": {"layers": [{"self_attn": _att_block_spec(), "ff": _ff_spec()}
                               for _ in params["encoder"]["layers"]]},
        "decoder": {"layers": [{"self_attn": _att_block_spec(), "cross_attn": _att_block_spec(), "ff": _ff_spec()}
                               for _ in params["decoder"]["layers"]],
                    "norm": _norm_spec()},
        "embeddings": {"word": {"table": ()}, "pos": {"table": ()}, "norm": _norm_spec()},
    }
    if "norm" in params["encoder"]:
        spec["encoder"]["norm"] = _norm_spec()
    if "src_pos" in params:
        spec["src_pos"] = {"table": (), "norm": _norm_spec()}
    return spec


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_specs(params: dict) -> dict:
    """The spec tree of the caption model: backbone replicated, the
    transformer's blocks mp-sharded, the vocab head column-sharded."""
    spec: dict = {
        "backbone": _map(lambda _: REPLICATED, params["backbone"]),
        "input_proj": {"w": (), "b": ()},
        "transformer": transformer_specs(params["transformer"]),
        "mlp": {"layers": [{"w": (), "b": ()}, {"w": (), "b": ()}, {"w": (None, "mp"), "b": ("mp",)}]},
    }
    if "loc_proj" in params:
        spec["loc_proj"] = {"w": (), "b": ()}
    return spec


def _fits(leaf: torch.Tensor, spec: Spec, mp: int) -> bool:
    return all(axis is None or leaf.shape[d] % mp == 0 for d, axis in enumerate(spec))


def param_shardings(params: dict, mesh, nheads: Optional[int] = None) -> dict:
    """The spec of each leaf of the full tree ``params`` on ``mesh`` (a Mesh
    or its mp): JAX's
    ``fit`` rule, applied per block (an attention block, an FF block or the
    head is sharded whole or replicated whole): a block with a dimension that
    does not divide mp falls back to replicated (the vocab head at an odd
    vocab, say). With ``nheads`` an attention block is sharded only where
    ``nheads % mp == 0`` too, since each rank computes whole heads."""
    specs = param_specs(params)
    mp = mesh.mp if isinstance(mesh, Mesh) else int(mesh)

    def block(p, s, heads_ok=True):
        ok = mp > 1 and heads_ok and all(_fits(x, sp, mp) for x, sp in zip(leaves(p), leaves(s)))
        return s if ok else _map(lambda _: REPLICATED, s)

    heads_ok = nheads is None or nheads % mp == 0
    tp, ts = params["transformer"], specs["transformer"]
    for stack in ("encoder", "decoder"):
        for lp, ls in zip(tp[stack]["layers"], ts[stack]["layers"]):
            for name in ls:
                if name == "ff":
                    ls[name] = block(lp[name], ls[name])
                else:
                    ls[name]["mha"] = block(lp[name]["mha"], ls[name]["mha"], heads_ok)
    specs["mlp"]["layers"][-1] = block(params["mlp"]["layers"][-1], specs["mlp"]["layers"][-1])
    return specs


def leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts (keys sorted) and lists; a spec tuple is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full leaf (a view; the leaf itself where replicated)."""
    for d, axis in enumerate(spec):
        if axis == "mp":
            n = x.shape[d] // mesh.mp
            x = x.narrow(d, mesh.mp_rank * n, n)
    return x


def shard_params(params: dict, mesh: Mesh, specs: Optional[dict] = None) -> dict:
    """This rank's slices of the full tree ``params`` (contiguous copies of
    the sharded leaves, the replicated ones as they are). ``specs`` defaults
    to :func:`param_shardings`."""
    specs = param_shardings(params, mesh) if specs is None else specs
    return _map(lambda x, s: shard_leaf(x, s, mesh).contiguous() if "mp" in s else x, params, specs)


def gather_leaves(local: List[torch.Tensor], specs: List[Spec], mesh: Mesh) -> List[torch.Tensor]:
    """The full tensors of sharded leaves: each rank writes its slice into a
    zero-filled full buffer, and one all_reduce over the mp group of the
    buffers, flattened into one, adds them (exact: every element is its
    shard's value plus zeros). Replicated leaves come back as they are; the
    gathered ones carry no gradient and are copied out of the flat buffer,
    each allocated alone as a fresh leaf is: a view at an arbitrary offset
    is aligned otherwise, and the matmul libraries may pick other kernels,
    with other roundings, for it."""
    full, views = [], []
    for x, s in zip(local, specs):
        if "mp" not in s:
            continue
        shape = [n * mesh.mp if axis == "mp" else n for n, axis in zip(x.shape, s)]
        full.append((x, s, shape))
    if not full:
        return list(local)
    sizes = [int(torch.Size(shape).numel()) for _, _, shape in full]
    with torch.no_grad():
        flat = torch.zeros(sum(sizes), dtype=full[0][0].dtype, device=full[0][0].device)
        for (x, s, shape), chunk in zip(full, flat.split(sizes)):
            buf = chunk.view(shape)
            shard_leaf(buf, s, mesh).copy_(x)
            views.append(buf)
        all_reduce(flat, mesh.mp_group)
        views = [v.clone() for v in views]
    it = iter(views)
    return [next(it) if "mp" in s else x for x, s in zip(local, specs)]


def gather_params(local: dict, mesh: Mesh, specs: dict) -> dict:
    """The full tree from this rank's slices (``specs``: the tree
    :func:`param_shardings` gave on the full tree). Every rank of an mp group
    must call it."""
    xs, ss = leaves(local), leaves(specs)
    full: List[Optional[torch.Tensor]] = [None] * len(xs)
    for dt in {x.dtype for x in xs}:   # one flat buffer per dtype
        idx = [i for i, x in enumerate(xs) if x.dtype == dt]
        for i, y in zip(idx, gather_leaves([xs[i] for i in idx], [ss[i] for i in idx], mesh)):
            full[i] = y
    return _unflatten(local, iter(full))


def _unflatten(tree, it):
    """A tree shaped like ``tree`` whose leaves come from ``it``, in the order
    :func:`leaves` walks (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflatten(v, it) for v in tree]
    return next(it)


# -- batches ----------------------------------------------------------------------


def shard_batch(mesh: Optional[Mesh], batch):
    """This dp rank's rows of a batch every rank holds alike (a NamedTuple of
    tensors or None). A ragged batch (rows % dp != 0) is kept whole on every
    rank, as JAX replicates it."""
    if mesh is None or mesh.dp == 1:
        return batch
    b = batch[0].shape[0]
    if b % mesh.dp:
        return batch
    n = b // mesh.dp
    return type(batch)(*(None if x is None else x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n] for x in batch))

