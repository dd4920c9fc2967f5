"""Checkpoints: the port's own directories, and reference ``.pth`` interop
(retr_tpu/train/checkpoints.py).

A checkpoint is a directory named by :func:`checkpoint_name` (the reference's
file-name template) holding two files:

- ``state.pth`` (``torch.save``): the reference-named model state dict
  (``models/weights.to_state_dict``), the AdamW state dict without its groups'
  schedules (local functions, which cannot be pickled; :func:`load_checkpoint`
  puts the template optimizer's back), the update count ``step`` and the last
  pre-clip ``grad_norm``, all on the CPU;
- ``retr_metadata.json``: epoch, step, losses, CIDEr and the whole config,
  the JSON keys the JAX package writes, so ``config_from_checkpoint`` replaces
  the reference's file-name sniffing.

Each file is written to a temporary name and moved into place with
``os.replace``, the state first and the metadata last: ``latest_checkpoint``
takes only directories whose metadata exists, so a save cut half-way never
becomes "latest". The JAX package's Orbax directories are not read (their
weights reach the port as a ``.pth`` through ``python -m retr_tpu.export_pth``);
their ``retr_metadata.json`` is, by :func:`read_metadata` and
:func:`config_from_checkpoint`.

Under a mesh (``TrainState.mesh``) a checkpoint holds the whole tensors:
:func:`save_checkpoint` gathers the parameters and AdamW's two moments over
the mp group on the calling thread (a collective, which every rank must
call in the same order, so never on :class:`AsyncSaver`'s worker), rank 0
alone writes, and every rank waits at a barrier; :func:`load_checkpoint`
reads the whole file on every rank and keeps this rank's slices. So a
checkpoint does not depend on the mesh's shape.

The reference saves ``{"model_state_dict": ..., "epoch": ..., ...}`` and
encodes the model variant in the file name, which
:func:`override_config_with_reference_filename` reads.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.models import weights
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.train.state import TrainState, trained_specs, tree_leaves_with_path, tree_map_with_path

METADATA_FILE = "retr_metadata.json"
STATE_FILE = "state.pth"
METADATA_KEYS = ("epoch", "train_loss", "val_loss", "cider_score")
PORT_DEVICES = ("cuda", "cpu")


def checkpoint_name(cfg: Config, epoch: int) -> str:
    """The reference's file-name template (main.py:69-71), as a directory name."""
    loc = "_loc" if cfg.use_location_features else ""
    glob = "_glob" if cfg.use_global_features else ""
    return f"{cfg.transformer_type}_{cfg.prefix}{loc}{glob}_checkpoint_{epoch}"


def _atomic_write(final: str, write) -> None:
    """``write(tmp_path)``, then ``os.replace`` onto ``final``: a reader sees
    the old file or the whole new one, never a torn one."""
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        write(tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _state_tensors(state: TrainState, copy: bool) -> Dict[str, Any]:
    """What a checkpoint holds of ``state``, on the state's device: the
    parameter tree, the optimizer state dict without the groups' schedules,
    step and grad_norm. ``copy`` clones every tensor, so the snapshot stays as
    it is while training goes on updating the state in place. Under a mesh
    the sharded parameters and moments are gathered to whole tensors."""
    def own(t):
        return t.detach().clone() if copy else t.detach()

    opt = state.opt_state.state_dict()
    params = tree_map_with_path(lambda _, t: own(t), state.params)
    moments = {i: {k: own(v) for k, v in s.items()} for i, s in opt["state"].items()}
    if state.mesh is not None:
        params = pmesh.gather_params(params, state.mesh, state.specs)
        specs = trained_specs(state)
        keys = [(i, k) for i, s in moments.items() for k, v in s.items() if v.dim() > 0]   # not AdamW's step
        full = pmesh.gather_leaves([moments[i][k] for i, k in keys], [specs[i] for i, _ in keys], state.mesh)
        for (i, k), t in zip(keys, full):
            moments[i][k] = t
    return {
        "params": params,
        "optimizer": {"state": moments,
                      "param_groups": [{k: v for k, v in g.items() if k != "schedule"}
                                       for g in opt["param_groups"]]},
        "step": int(state.step),
        "grad_norm": None if state.grad_norm is None else own(state.grad_norm),
    }


def _path(directory: str, cfg: Config, epoch: int) -> str:
    return os.path.abspath(os.path.join(directory, checkpoint_name(cfg, epoch)))


def _write(directory: str, snap: Dict[str, Any], cfg: Config, *, epoch: int,
           train_loss: float = float("nan"), val_loss: float = float("nan"),
           cider_score: float = float("nan")) -> str:
    path = _path(directory, cfg, epoch)
    os.makedirs(path, exist_ok=True)
    opt = snap["optimizer"]
    payload = {
        "model_state_dict": weights.to_state_dict(snap["params"], cfg),
        "optimizer_state_dict": {"state": {i: {k: v.cpu() for k, v in s.items()} for i, s in opt["state"].items()},
                                 "param_groups": opt["param_groups"]},
        "step": snap["step"],
        "grad_norm": None if snap["grad_norm"] is None else snap["grad_norm"].cpu(),
    }
    _atomic_write(os.path.join(path, STATE_FILE), lambda tmp: torch.save(payload, tmp))
    meta = {"epoch": epoch, "step": snap["step"], "train_loss": float(train_loss), "val_loss": float(val_loss),
            "cider_score": float(cider_score), "config": cfg.to_dict()}

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
            f.flush()
            os.fsync(f.fileno())

    _atomic_write(os.path.join(path, METADATA_FILE), write_meta)
    return path


def save_checkpoint(directory: str, state: TrainState, cfg: Config, *, epoch: int,
                    train_loss: float = float("nan"), val_loss: float = float("nan"),
                    cider_score: float = float("nan")) -> str:
    """Write ``state`` as ``<directory>/<checkpoint_name(cfg, epoch)>``; returns
    that path. Under a mesh every rank calls it: rank 0 writes, all wait."""
    snap = _state_tensors(state, copy=False)
    mesh = state.mesh
    if mesh is None or mesh.rank == 0:
        _write(directory, snap, cfg, epoch=epoch, train_loss=train_loss, val_loss=val_loss,
               cider_score=cider_score)
    pmesh.barrier(mesh)
    return _path(directory, cfg, epoch)


class AsyncSaver:
    """Saves on a worker thread. :meth:`submit` copies the state's tensors on
    their device (the train step updates the live ones in place) and returns;
    the worker moves the copy to the host and writes it. At most one save is in
    flight: ``submit`` first joins the previous one, so copies never pile up
    on the device. A failed save re-raises at the next ``submit`` and at
    :meth:`wait`, which joins the save in flight; call it before reading
    checkpoints back and when training ends. Under a mesh every rank calls
    both: ``submit`` gathers the state on the calling thread, rank 0's worker
    writes it, and ``wait`` ends at a barrier of every rank."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._errors: List[Exception] = []
        self._mesh: Optional[pmesh.Mesh] = None

    def submit(self, directory: str, state: TrainState, cfg: Config, **meta: Any) -> None:
        self.wait()
        snap = _state_tensors(state, copy=True)
        self._mesh = state.mesh
        if state.mesh is not None and state.mesh.rank != 0:
            return

        def run():
            try:
                _write(directory, snap, cfg, **meta)
            except Exception as exc:  # noqa: BLE001 — re-raised by submit and wait
                self._errors.append(exc)

        self._thread = threading.Thread(target=run, name="retr-ckpt-save", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            pmesh.barrier(mesh)
        if self._errors:
            raise self._errors[0]


def read_metadata(path: str) -> Dict[str, Any]:
    """A checkpoint directory's ``retr_metadata.json`` (the port's or the JAX
    package's)."""
    with open(os.path.join(path, METADATA_FILE)) as f:
        return json.load(f)


def config_from_checkpoint(path: str) -> Config:
    """The config a checkpoint directory was trained with. A device the port
    does not run on (the JAX package writes "tpu") becomes the port's default."""
    d = dict(read_metadata(path)["config"])
    if str(d.get("device", "")).split(":")[0] not in PORT_DEVICES:
        d.pop("device", None)
    return Config.from_dict(d)


def _read_state(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def load_model_state(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(reference-named model state dict on the CPU, metadata) of a port
    checkpoint directory or of a reference ``.pth`` file."""
    if path.endswith(".pth"):
        return load_reference_state(path)
    return _read_state(path)["model_state_dict"], read_metadata(path)


def load_checkpoint(path: str, template: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore a checkpoint directory into ``template`` (a ``create_train_state``
    of the same model; its device is the one loaded to): parameters copied in
    place, the optimizer's state loaded and its groups' schedules kept, step
    and grad_norm set. Under the template's mesh each rank keeps its slices
    of the whole tensors. Returns (template, metadata)."""
    blob = _read_state(path)
    meta = read_metadata(path)
    mesh = template.mesh
    params = weights.to_params(blob["model_state_dict"], config_from_checkpoint(path))
    opt_sd = blob["optimizer_state_dict"]
    if mesh is not None:
        params = pmesh.shard_params(params, mesh, template.specs)
        specs = trained_specs(template)
        opt_sd = {"state": {i: {k: pmesh.shard_leaf(v, specs[i], mesh).contiguous() if v.dim() > 0 else v
                                for k, v in s.items()} for i, s in opt_sd["state"].items()},
                  "param_groups": opt_sd["param_groups"]}
    loaded = dict(tree_leaves_with_path(params))
    live = list(tree_leaves_with_path(template.params))
    if [p for p, _ in live] != list(loaded):
        raise ValueError(f"{path} holds another model than the template's")
    with torch.no_grad():
        for p, leaf in live:
            leaf.copy_(loaded[p])
    opt = template.opt_state
    schedules = [g["schedule"] for g in opt.param_groups]
    # the moments go to their parameter's device; AdamW's step counters stay
    # on the host, where a fresh AdamW keeps them
    opt.load_state_dict(opt_sd)
    for g, schedule in zip(opt.param_groups, schedules):
        g["schedule"] = schedule
    template.step = int(blob["step"])
    gn = blob["grad_norm"]
    template.grad_norm = None if gn is None else gn.to(live[0][1].device)
    return template, meta


def latest_checkpoint(directory: str, cfg: Optional[Config] = None) -> Optional[str]:
    """The highest-epoch checkpoint directory under ``directory`` whose
    metadata exists (only names of ``cfg``'s variant when given), or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(r"_checkpoint_(\d+)$")
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        m = pat.search(name)
        if not m:
            continue
        if cfg is not None and not name.startswith(checkpoint_name(cfg, 0).rsplit("_", 1)[0]):
            continue
        full = os.path.join(directory, name)
        if os.path.exists(os.path.join(full, METADATA_FILE)) and int(m.group(1)) > best_epoch:
            best, best_epoch = full, int(m.group(1))
    return best


# ---------------------------------------------------------------------------------
# Reference-checkpoint interop
# ---------------------------------------------------------------------------------


def override_config_with_reference_filename(cfg: Config, checkpoint_path: str) -> Config:
    """The reference's file-name sniffing for ``.pth`` files: 'loc_glob_checkpoint'
    selects location and global features, 'loc_checkpoint' location only."""
    name = os.path.basename(checkpoint_path)
    if "loc_glob_checkpoint" in name:
        return cfg.replace(use_location_features=True, use_global_features=True)
    if "loc_checkpoint" in name:
        return cfg.replace(use_location_features=True, use_global_features=False)
    return cfg.replace(use_location_features=False, use_global_features=False)


def load_reference_state(pth_path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(model_state_dict, its metadata) of a reference ``.pth`` file, on the
    CPU. A file without ``model_state_dict`` is taken as the state dict itself.
    The file is unpickled as the reference wrote it: load only checkpoints you
    trust."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=False)
    state = blob.get("model_state_dict", blob)
    return state, {k: blob[k] for k in METADATA_KEYS if k in blob}


def import_reference_checkpoint(pth_path: str, cfg: Config, device=None):
    """(the port's parameter tree on ``device``, metadata) of a reference ``.pth``."""
    state, meta = load_reference_state(pth_path)
    return weights.to_params(state, cfg, device=device), meta


def export_reference_state(state_dict, pth_path: str, *, epoch: int = 0, train_loss: float = float("nan"),
                           val_loss: float = float("nan"), cider_score: float = float("nan")) -> str:
    """Write a reference-named state dict as a reference-format ``.pth``:
    ``model_state_dict`` plus epoch, losses and CIDEr, with the optimizer and
    scheduler state saved empty (the reference's evaluation reads only
    ``model_state_dict``)."""
    blob = {"epoch": epoch, "model_state_dict": dict(state_dict), "optimizer_state_dict": {},
            "lr_scheduler_state_dict": {}, "train_loss": float(train_loss), "val_loss": float(val_loss),
            "cider_score": float(cider_score)}
    _atomic_write(pth_path, lambda tmp: torch.save(blob, tmp))
    return pth_path


def export_reference_checkpoint(params, cfg: Config, pth_path: str, *, epoch: int = 0,
                                train_loss: float = float("nan"), val_loss: float = float("nan"),
                                cider_score: float = float("nan")) -> str:
    """Write a parameter tree as a reference-format ``.pth``
    (:func:`export_reference_state`)."""
    return export_reference_state(weights.to_state_dict(params, cfg), pth_path, epoch=epoch,
                                  train_loss=train_loss, val_loss=val_loss, cider_score=cider_score)
