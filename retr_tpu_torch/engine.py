"""Train/eval engine: the epoch loops and the NLG-metric evaluation
(retr_tpu/engine.py).

- :func:`train_one_epoch`: teacher forcing through the port's train step
  (``train/state.make_train_step``), colour-jittered batches, a non-finite
  loss stops training (:class:`NonFiniteLossError`), the epoch-mean loss.
- :func:`evaluate`: the validation loss, no gradient and no dropout.
- :func:`eval_model`: decode the loader's dataset (greedy, beam or sampled)
  and score it with BLEU 1-4, METEOR, ROUGE-L and CIDEr against the
  tokenizer-normalized references, transposed with the reference's
  ``zip(*references)``, which keeps only as many references per segment as
  the annotation with the fewest has (engine.py:181).

Seeds are integers and ``models.layers.fold_in`` derives them, as
``jax.random.fold_in`` derives keys: the epoch's seed is ``fold_in(seed,
epoch)`` and batch i's augmentation seed ``fold_in(epoch seed, i)``, so a
batch built on the staging thread equals one built inline. Batches go to the
device the parameters live on. Loss reads are deferred ``pipeline_depth - 1``
steps: the read of a loss on the device is the only barrier. On a CUDA
device with no mesh the steps of ``train/state.py`` replay CUDA graphs
(``ops/graphs.py``), so only the batch's upload and colour jitter
(``data/pipeline.device_batch``, which the JAX package compiles apart) are
dispatched op by op between two steps.

Spans (``utils/profiling.py``): ``train.loader_wait`` and
``train.device_batch`` per training step; ``eval.<phase>`` for each of
``eval_model``'s PhaseTimer phases and ``eval.collect`` per batch (the
fetch, pruning, detokenizing and the references).

Under a ``parallel.mesh.Mesh`` every rank is a process, as in JAX's
multi-host runs: a training batch is this rank's own loader rows (``main``
shards the loader by dp rank), jittered from a seed that folds in the dp
rank (JAX folds in the process index; the ranks of one mp group feed one
model, so they must jitter alike); an evaluation batch, alike on every rank,
is cut to this dp rank's rows (``parallel.mesh.shard_batch``) and the loss is
the dp mean of the equal slices, or computed whole on every rank where the
batch does not split; ``eval_model`` decodes each dp rank's rows of the
batch padded to a multiple of dp, tensor-parallel on this rank's mp slices,
and gathers the ids on every rank.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import torch

from retr_tpu_torch import decode as decode_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.dataset import DataLoader, pad_host_batch
from retr_tpu_torch.data.pipeline import Batch, device_batch
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.metrics import NLGEval
from retr_tpu_torch.models import layers
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.precision import dtype_of
from retr_tpu_torch.train.state import TrainState, make_eval_step, tree_leaves_with_path
from retr_tpu_torch.utils import profiling
from retr_tpu_torch.utils.logging import MetricLogger
from retr_tpu_torch.utils.profiling import PhaseTimer

class NonFiniteLossError(RuntimeError):
    """Raised when a training batch produces a non-finite loss (engine.py:75-77).

    With ``pipeline_depth > 1`` the loss check is deferred, so by the time
    this raises the optimizer has applied updates from the non-finite
    gradients for up to ``depth-1`` further steps: the ``TrainState`` is
    poisoned and must be abandoned, never checkpointed. ``last_good_step`` is
    the last global step whose loss was verified finite."""

    def __init__(self, message: str, *, last_good_step: Optional[int] = None):
        super().__init__(message)
        self.last_good_step = last_good_step


def pack_encoder_inputs(encoder_input, global_features: bool, location_features: bool):
    """Reference-compatible batch packing (engine.py:20-48): a flat tuple of
    arrays becomes the model's (samples, global_samples, loc_feats) triple of
    Masked pairs. The engine itself uses data.pipeline.device_batch."""
    def masked(img, mask):
        return Masked(torch.as_tensor(img), torch.as_tensor(mask))

    if not global_features and not location_features:
        t_img, t_mask = encoder_input
        return masked(t_img, t_mask), None, None
    if global_features and not location_features:
        t_img, t_mask, g_img, g_mask = encoder_input
        return masked(t_img, t_mask), masked(g_img, g_mask), None
    if not global_features and location_features:
        t_img, t_mask, l_feats = encoder_input
        return masked(t_img, t_mask), None, torch.as_tensor(l_feats)
    t_img, t_mask, g_img, g_mask, l_feats = encoder_input
    return masked(t_img, t_mask), masked(g_img, g_mask), torch.as_tensor(l_feats)


def _check_mesh(mesh) -> Optional[pmesh.Mesh]:
    if mesh is not None and not isinstance(mesh, pmesh.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (or None), not {type(mesh).__name__}")
    return mesh


def _device_of(params) -> torch.device:
    return next(leaf for _, leaf in tree_leaves_with_path(params)).device


def _loader_batches(loader):
    """The loader's host batches, the wait for each a ``train.loader_wait``
    span (the wait that finds the loader exhausted is not kept)."""
    it = iter(loader)
    while True:
        with profiling.span("train.loader_wait") as s:
            host_batch = next(it, None)
            if host_batch is None:
                s.cancel()
        if host_batch is None:
            return
        yield host_batch


def _staged_batches(loader, make_batch, device: torch.device, depth: int = 2):
    """Yield ``make_batch(i, host_batch)`` for each loader batch, the calls
    running up to ``depth`` ahead on a background thread.

    On a card the thread builds each batch on a stream of its own and records
    an event after it; the consumer's current stream waits on that event
    before the batch is used, and each tensor is marked as used on the
    consumer's stream, so the allocator does not hand its memory back while
    the step still reads it. Exceptions from the loader or the upload re-raise
    at the consumer; an early exit unblocks and joins the thread."""
    import queue as _queue
    import threading as _threading

    q: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
    stop = _threading.Event()
    done = object()
    cuda = device.type == "cuda"

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                pass
        return False

    def work():
        try:
            stream = torch.cuda.Stream(device) if cuda else None
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                for i, host_batch in enumerate(loader):
                    batch = make_batch(i, host_batch)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if stop.is_set() or not _put((batch, ready)):
                        return
            _put(done)
        except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
            _put(exc)

    worker = _threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch:
                    if t is not None:
                        t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        while True:  # drain so a blocked put exits
            try:
                q.get_nowait()
            except _queue.Empty:
                break
        worker.join()


def train_one_epoch(
    state: TrainState,
    step_fn,
    loader: DataLoader,
    seed: int,
    *,
    epoch: int = 0,
    logger: Optional[MetricLogger] = None,
    pipeline_depth: int = 2,
    mesh=None,
    stage_uploads: bool = False,
) -> Tuple[TrainState, float]:
    """One training epoch (reference engine.py:52-87): ``step_fn(state,
    batch, epoch seed) -> (state, loss)`` for each loader batch, on the
    device of ``state.params``; returns (state, the epoch's mean loss).

    ``stage_uploads`` builds and uploads batch n+1 on a staging thread while
    step n runs (:func:`_staged_batches`); off, each batch is built inline
    between steps. Either way batch i is jittered from ``fold_in(fold_in(seed,
    epoch), i)``. The loss of step n is read ``pipeline_depth - 1`` steps
    later; a non-finite loss raises :class:`NonFiniteLossError` at most that
    many steps after it was made (``pipeline_depth=1``: at once). A
    ``DataLoader``'s shuffle epoch is pinned to ``epoch``; a list of host
    batches is taken as it is.

    ``mesh``: a ``parallel.mesh.Mesh``; each batch is this rank's own rows
    (the global batch is the dp ranks' together), batch i jittered from
    ``fold_in(fold_in(epoch seed, dp rank), i)`` where dp > 1. The step sees
    the mesh through ``state.mesh``."""
    mesh = _check_mesh(mesh)
    # the permutation is a function of (seed, epoch): a resumed run sees the
    # same order in epoch e as an uninterrupted one
    if isinstance(loader, DataLoader):
        loader.epoch = epoch

    device = _device_of(state.params)
    epoch_loss, n = 0.0, 0
    epoch_seed = layers.fold_in(seed, epoch)
    aug_seed = epoch_seed if mesh is None or mesh.dp == 1 else layers.fold_in(epoch_seed, mesh.dp_rank)
    step0 = state.step
    pending: deque = deque()  # (global_step, loss on the device)

    def drain_one():
        nonlocal epoch_loss
        i, loss = pending.popleft()
        loss_value = float(loss)
        if not math.isfinite(loss_value):
            raise NonFiniteLossError(f"Loss is {loss_value} at step {i}, stopping training",
                                     last_good_step=i - 1)
        epoch_loss += loss_value
        if logger is not None:
            logger.log("train_step", step=i, loss=loss_value, epoch=epoch)

    def make_batch(i, host_batch):
        with profiling.span("train.device_batch", step=step0 + i + 1):
            gen = layers.make_generator(layers.fold_in(aug_seed, i), device)
            return device_batch(host_batch, device, train=True, generator=gen)

    if stage_uploads:
        batches = _staged_batches(_loader_batches(loader), make_batch, device, depth=2)
    else:
        batches = (make_batch(i, hb) for i, hb in enumerate(_loader_batches(loader)))

    for batch in batches:
        state, loss = step_fn(state, batch, epoch_seed)
        n += 1
        pending.append((step0 + n, loss))
        if len(pending) >= max(1, pipeline_depth):
            drain_one()
    while pending:
        drain_one()
    return state, epoch_loss / max(n, 1)


def evaluate(params, cfg: Config, loader: DataLoader, *, eval_step=None, mesh=None,
             pipeline_depth: int = 2) -> float:
    """Validation loss (reference engine.py:89-114) on the device of
    ``params``; per-batch losses are read ``pipeline_depth - 1`` batches
    behind the dispatch. Under ``mesh`` (``params`` this rank's slices), each
    batch is cut to this dp rank's rows and its loss is the dp mean; a batch
    that does not split over dp is computed whole on every rank."""
    mesh = _check_mesh(mesh)
    if eval_step is None:
        eval_step = make_eval_step(cfg)
    device = _device_of(params)
    total, n = 0.0, 0
    pending: deque = deque()

    def drain_one():
        nonlocal total, n
        total += float(pending.popleft())
        n += 1

    with pmesh.active(mesh):
        for host_batch in loader:
            full = device_batch(host_batch, device)
            batch = pmesh.shard_batch(mesh, full)
            loss = eval_step(params, batch)
            if batch is not full:
                loss = pmesh.all_reduce(loss.clone(), mesh.dp_group) / mesh.dp
            pending.append(loss)
            if len(pending) >= max(1, pipeline_depth):
                drain_one()
    while pending:
        drain_one()
    return total / max(n, 1)


def normalize_with_tokenizer(sent: str, tokenizer) -> str:
    """Tokenizer encode->decode round trip (engine.py:117-122)."""
    return tokenizer.decode(tokenizer.encode(sent), skip_special_tokens=True)


def _decode(params, cfg: Config, batch: Batch, decoder: str, special: dict, batch_index: int,
            noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    samples = Masked(batch.images, batch.image_masks)
    g = Masked(batch.global_images, batch.global_masks) if batch.global_images is not None else None
    common = dict(global_samples=g, loc_feats=batch.loc_feats, max_len=cfg.max_position_embeddings,
                  bos_token=special["bos"], eos_token=special["eos"], compute_dtype=dtype_of(cfg.compute_dtype))
    if decoder == "greedy":
        return decode_mod.greedy(params, cfg, samples, **common)
    if decoder == "beam":
        tokens, _ = decode_mod.beam_search(params, cfg, samples, beam_size=cfg.beam_size,
                                           length_penalty=cfg.length_penalty, **common)
        return tokens[:, 0]
    if decoder == "sample":
        # deterministic per (cfg.seed, batch index): reruns reproduce
        gen = layers.make_generator(layers.fold_in(cfg.seed, batch_index), batch.images.device)
        return decode_mod.sample(params, cfg, samples, gen, temperature=cfg.sample_temperature,
                                 top_k=cfg.sample_top_k, top_p=cfg.sample_top_p, noise_rows=noise_rows, **common)
    raise ValueError(f"unknown decoder {decoder!r}")


def eval_model(
    params,
    cfg: Config,
    loader: DataLoader,
    tokenizer,
    *,
    metrics_to_omit: Optional[List[str]] = None,
    print_samples: bool = False,
    decoder: str = "greedy",
    timer: Optional[PhaseTimer] = None,
    pipeline_depth: int = 2,
    mesh: Optional[pmesh.Mesh] = None,
    specs: Optional[dict] = None,
) -> Tuple[Dict[str, float], List[dict]]:
    """Decode the loader's dataset on the device of ``params`` and score it
    with the NLG suite; returns (metrics, [{"ann_id", "expression"}, ...]).

    ``decoder``: "greedy" (the reference's), "beam" (``cfg.beam_size``,
    ``cfg.length_penalty``) or "sample" (``cfg.sample_temperature``,
    ``sample_top_k``, ``sample_top_p``; batch i draws from ``fold_in(cfg.seed,
    i)``). On a card each decoder launches the decode kernels. A ragged last
    batch is padded to the loader's batch size by repeating its last row and
    the padded rows are dropped after. ``timer`` (a PhaseTimer) records the
    phases host_wait (blocked on the loader), input (device batch), decode,
    fetch (the ids' copy to the host) and score. Batch n+1 is dispatched
    before batch n's ids are fetched (``pipeline_depth=1``: serial).

    Under ``mesh`` (retr_tpu/parallel/sweep.py) each batch is padded to a
    multiple of dp, each dp rank uploads and decodes its rows, and the ids
    come back to every rank (``all_gather_object`` over dp), so every rank
    scores the whole split alike. ``params`` are the whole tree, or this
    rank's slices with the ``specs`` they were cut by (``TrainState.specs``;
    slices need a mesh with mp > 1). Slices are decoded as they are, never
    gathered: the encoder, the decode step (``transformer.decode_step``: the
    local heads, FF columns and caches of H/mp heads, an all-reduce of the
    partial sums per block) and the vocabulary head (the choices combined
    over mp, ``decode``) run on this rank's share, as JAX's XLA path
    partitions the sharded tree; a block ``param_shardings`` kept whole runs
    whole. "sample" draws batch i's noise over the loader's batch and keeps
    each rank's rows, so a row draws alike whatever dp is."""
    mesh = _check_mesh(mesh)
    if specs is not None and (mesh is None or mesh.mp == 1) and any("mp" in s for s in pmesh.leaves(specs)):
        raise ValueError("eval_model: mp-sliced parameters (specs) need the mesh they were cut on")
    dp, dp_rank = (1, 0) if mesh is None else (mesh.dp, mesh.dp_rank)
    frame = getattr(loader, "batch_size", 0)
    full = -(-frame // dp) * dp
    timer = timer if timer is not None else PhaseTimer()
    nlgeval = NLGEval(no_skipthoughts=True, no_glove=True, metrics_to_omit=metrics_to_omit or [])

    annotations: Dict[int, List[str]] = defaultdict(list)
    for a in loader.dataset.annot:  # (ann_id, filename, caption, bbox)
        annotations[a[0]].append(a[2])

    special = {name: tokenizer.convert_tokens_to_ids(tok) for name, tok in
           (("pad", tokenizer.pad_token), ("bos", tokenizer.cls_token), ("eos", tokenizer.sep_token))}
    device = _device_of(params)
    hypotheses: List[str] = []
    ids_hypotheses: List[dict] = []
    references: List[List[str]] = []
    n_dispatched = 0

    def dispatch(host_batch):
        nonlocal n_dispatched
        # under a mesh: this dp rank's rows of the batch padded to a multiple of dp, uploaded alone
        padded = pmesh.shard_batch(mesh, pad_host_batch(host_batch, full))
        with timer.phase("input"):
            batch = device_batch(padded, device)
        with timer.phase("decode"), torch.no_grad():
            out = _decode(params, cfg, batch, decoder, special, n_dispatched,
                          noise_rows=None if mesh is None else (dp_rank * (full // dp), frame))
        n_dispatched += 1
        return out, host_batch

    def collect(entry):
        ids_dev, host_batch = entry
        with profiling.span("eval.collect", rows=len(host_batch.ann_ids)):
            with timer.phase("fetch"):
                token_ids = ids_dev.cpu().tolist()
                if mesh is not None:
                    token_ids = [row for part in pmesh.all_gather_object(token_ids, mesh.dp_group) for row in part]
            token_ids = token_ids[: len(host_batch.ann_ids)]  # drop the padded rows

            pruned = decode_mod.prune_token_ids(token_ids, clean=True, pad_token=special["pad"],
                                                bos_token=special["bos"], eos_token=special["eos"])
            hyps = tokenizer.batch_decode(pruned)
            hypotheses.extend(hyps)
            ids_hyps = [{"ann_id": int(i), "expression": h} for i, h in zip(host_batch.ann_ids.tolist(), hyps)]
            ids_hypotheses.extend(ids_hyps)
            if print_samples and (mesh is None or mesh.rank == 0):
                print(*ids_hyps, sep="\n")
            refs = [annotations[int(i)] for i in host_batch.ann_ids]
            references.extend([normalize_with_tokenizer(r, tokenizer) for r in rs] for rs in refs)

    pending: deque = deque()
    it = iter(loader)
    with pmesh.active(mesh):
        while True:
            with timer.phase("host_wait"):
                host_batch = next(it, None)
            if host_batch is None:
                break
            pending.append(dispatch(host_batch))
            if len(pending) >= max(1, pipeline_depth):
                collect(pending.popleft())
        while pending:
            collect(pending.popleft())

    # the reference's zip(*) transposition truncates to the min ref count (engine.py:181)
    transposed_references = list(map(list, zip(*references)))
    with timer.phase("score"):
        metrics = nlgeval.compute_metrics(ref_list=transposed_references, hyp_list=hypotheses)
    return metrics, ids_hypotheses
