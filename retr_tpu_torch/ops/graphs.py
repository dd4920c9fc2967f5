"""CUDA graphs of the decode loop: the port's counterpart of the JAX package's
``jax.jit`` + ``lax.while_loop`` (retr_tpu/decode.py), where every decode path
is one compiled program whose steps run on the device and the host dispatches
once per batch.

The port's loop (decode.py) runs its steps in chunks of ``decode.CHECK_EVERY``
between two host checks of the stop condition. On a CUDA device a
:class:`Session` captures each chunk once as a CUDA graph and replays it after:
one host call launches the chunk's kernels and torch ops, so no decode step is
dispatched from the host. A graph bakes in the addresses it reads and writes,
so the session owns the loop's carries (token buffer, self caches, cross K/V,
stop flags, the step index the kernels read) and keeps alive the decode tree
the kernels read (decode.py keeps that tree across calls). Each call writes its
inputs into the carries eagerly (the prologue), replays, and copies its result
out.

A session serves one :func:`session_key`: the shapes, the storage type, the
decoder kind and every flag a capture reads. :func:`session` keeps at most
``MAX_SESSIONS`` of them, least recently used first out (beam 512 x 5 alone
holds 3.08 GB of tiled cross K/V and 0.5 GB of caches in bf16).

The first call of a key runs the loop eagerly on the session's own buffers and
stream (:meth:`Session.warm_up`): that creates what a capture cannot, the
kernels' libraries and their ``cudaFuncSetAttribute`` calls and cuBLAS's
handle and workspace for the stream. Then :meth:`Session.capture` records one
graph per chunk start (0, 16, ..., 112 at ``max_len`` 128), all in one memory
pool, with ``capture_error_mode="thread_local"``: while the ServingQueue's
collector captures, its dispatcher enqueues the next batch's encoder. A session's
lock keeps two threads from replaying one set of buffers at once. A capture or
replay that fails raises.

``decoder_kernels.LAUNCHES`` counts launches that ran: while a chunk is
captured its wrappers count into a tally of their own (``dk._capture``), and
each replay adds that tally.

:class:`StepSession` and :func:`run_step` do the same for the training path's
two programs, the counterparts of the JAX package's jitted train and eval
steps (retr_tpu/train/state.py): one graph per :func:`step_session_key`, over
the step's forward, backward, clip and AdamW (train/state.py builds the
body). A key's first call runs the step eagerly on the session's stream (its
warm-up, and a real step), recording the step's seed plan
(``models/layers.SeedRecorder``); the next call copies its batch into the
session's static inputs, captures the graph with the dropout generators of
that plan registered, and replays it; later calls copy and replay. Outputs
are copied out of the graph's after each replay. Train and eval sessions
share the registry, and ``MAX_SESSIONS``, with the decode's.

Counters (``utils/profiling.py``, read by ``ServingQueue.stats()``, so
``/healthz``): ``graphs.captures`` (one per :meth:`Session.capture`) and
``graphs.evictions`` (a session dropped past ``MAX_SESSIONS``). A replay
adds its kernels to ``decoder_kernels.LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from retr_tpu_torch.models import layers
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.utils import profiling

# sessions kept at once, decode and step ones together; the least recently used
# goes first. Six hold an epoch of main's: the train step, the validation
# loss at two batch sizes, the greedy sweep at two.
MAX_SESSIONS = 6

_sessions: "OrderedDict[tuple, Session]" = OrderedDict()
_registry = threading.Lock()


def session_key(kind: str, memory: torch.Tensor, *, rows: int, beams: int, max_len: int,
                trees: Sequence, extra: tuple = ()) -> tuple:
    """The key of a decode's session: the decoder ``kind``, the memory's device,
    storage type and length S, the batch ``rows``, ``beams``, ``max_len``,
    the kernel flags and tiles a capture reads (``LAYER_GRID``,
    ``MERGED_LAYER``, ``HEAD_KERNEL``, ``BEAM_TOPK_KERNEL``,
    ``_stack_max_blocks``, ``_block_rows``, ``_beam_rows``, ``_stack_trace``),
    the identity of each object in ``trees`` (the decode tree and the head,
    which the session keeps alive, so no other object takes their identity)
    and the caller's ``extra`` (the config, the constants the steps bake in)."""
    trace = dk._stack_trace
    return (kind, str(memory.device), memory.dtype, memory.shape[1], rows, beams, max_len,
            dk.LAYER_GRID, dk.MERGED_LAYER, dk.HEAD_KERNEL, dk.BEAM_TOPK_KERNEL,
            dk._stack_max_blocks, dk._block_rows, dk._beam_rows, None if trace is None else trace.data_ptr(),
            tuple(id(t) for t in trees), extra)


class Session:
    """The buffers, graphs and lock of one key. ``loop`` holds the carries
    (decode.py's loop objects: ``chunk(i0, n)`` runs steps i0 .. i0+n-1 in
    place); ``trees`` are kept alive while the graphs read them; each of
    ``generators`` (sampling's, a train step's dropout) is registered with
    every graph, so a replay draws from its state at that time and advances
    it, as eager draws would."""

    def __init__(self, loop, trees: Sequence, device: torch.device, generators: Sequence = ()):
        self.loop = loop
        self.trees = list(trees)
        self.device = device
        self.generators = list(generators)
        self.lock = threading.Lock()
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]] = {}
        self.stream = torch.cuda.Stream(device)
        self.capture_s = None     # seconds to capture every chunk
        self.pool_bytes = None    # device memory the graphs' pool reserved while they were captured

    def warm_up(self, run: Callable):
        """``run()`` eagerly on the session's stream, ordered after the work
        queued so far and before the work queued after; returns its result."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = run()
        cur.wait_stream(self.stream)
        return out

    def capture(self, chunks: List[Tuple[int, Callable[[], None]]]) -> None:
        """One graph per ``(start, body)`` of ``chunks``, in order, in one pool."""
        profiling.count("graphs.captures")
        t0 = time.perf_counter()
        before = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for i0, body in chunks:
                g = torch.cuda.CUDAGraph()
                for gen in self.generators:
                    g.register_generator_state(gen)
                dk._capture.tally = {}
                try:
                    g.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        body()
                    except BaseException:
                        # end the capture so the stream leaves capture mode;
                        # the body's error is the one raised
                        with contextlib.suppress(RuntimeError):
                            g.capture_end()
                        raise
                    g.capture_end()
                    self.graphs[i0] = (g, dk._capture.tally)
                finally:
                    dk._capture.tally = None
        cur.wait_stream(self.stream)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - before
        self.capture_s = time.perf_counter() - t0

    def replay(self, i0: int) -> None:
        """Replay the chunk that starts at step ``i0`` on the current stream."""
        g, launches = self.graphs[i0]
        g.replay()
        dk.add_launches(launches)

    def buffer_bytes(self) -> int:
        """Bytes of the carries the session owns."""
        return sum(t.numel() * t.element_size() for t in self.loop.buffers())


def session(key: tuple, make: Callable[[], Session]) -> Session:
    """The session of ``key``, made by ``make()`` where there is none; the
    least recently used beyond ``MAX_SESSIONS`` is dropped."""
    with _registry:
        s = _sessions.pop(key, None)
        if s is None:
            s = make()
        _sessions[key] = s
        while len(_sessions) > MAX_SESSIONS:
            _drop(_sessions.popitem(last=False)[1])
            profiling.count("graphs.evictions")
        return s


# ---------------------------------------------------------------------------------
# Sessions of a step (train/state.py's make_train_step and make_eval_step)
# ---------------------------------------------------------------------------------


def step_session_key(kind: str, device: torch.device, dtype: torch.dtype, batch, *, accum_steps: int, cfg,
                     tensors: Sequence[torch.Tensor], extra: tuple = ()) -> tuple:
    """The key of a step's session: the ``kind`` ("train" or "eval"), the
    device, the compute ``dtype`` (it also sets the TF32 switches a capture
    reads), the shape and type of each field of ``batch`` (its rows among
    them: a ragged last batch has a key of its own), ``accum_steps``,
    ``cfg.remat``, ``cfg.dropout``, ``cfg.use_pallas_attention``, the
    config, cuDNN's and torch's determinism switches, the caller's ``extra``
    (flags the body reads) and the identity and address of every tensor in
    ``tensors`` (the parameters, and for a train step every optimizer-state
    tensor and learning rate: a loaded checkpoint replaces the moments, and a
    graph keyed on shapes alone would write into freed memory). The session
    keeps those tensors alive, so no other tensor takes their identity."""
    fields = tuple(None if x is None else (tuple(x.shape), x.dtype) for x in batch)
    return (kind, str(device), dtype, fields, accum_steps, cfg.remat, cfg.dropout, cfg.use_pallas_attention,
            cfg, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(), extra, _identities(tensors))


def _identities(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((id(t), t.data_ptr()) for t in tensors)


class StepSession(Session):
    """One captured step of ``kind`` ("train" or "eval"): a single graph
    (start 0), the static ``inputs`` it reads (a copy of the batch), its
    ``outputs``, the seed ``plan`` of its dropout generators (empty for a
    step without dropout seeds), the ``tensors`` of its key (kept alive)
    and its ``owner`` (a train step's optimizer, whose sessions with other
    state tensors are stale)."""

    def __init__(self, kind: str, device: torch.device, tensors: Sequence[torch.Tensor], owner=None):
        super().__init__(None, tensors, device)
        self.kind, self.owner = kind, owner
        self.identities = _identities(tensors)
        self.warm = False
        self.plan: List[Tuple[int, ...]] = []
        self.inputs = None
        self.outputs: Tuple[torch.Tensor, ...] = ()

    def buffer_bytes(self) -> int:
        """Bytes of the static inputs the session owns."""
        return sum(x.numel() * x.element_size() for x in (self.inputs or ()) if x is not None)


def _drop_stale(owner, identities: tuple, keep: Session) -> None:
    """Drop the sessions of ``owner`` captured on other tensors than
    ``identities`` (they can never match a key again)."""
    with _registry:
        stale = [k for k, s in _sessions.items() if s is not keep and isinstance(s, StepSession)
                 and s.owner is owner and s.identities != identities]
        dropped = [_sessions.pop(k) for k in stale]
    for s in dropped:
        _drop(s)


def _rekey(old: tuple, new: tuple, s: Session) -> None:
    """File ``s`` under ``new`` instead of ``old`` (a warm-up made state that the key names)."""
    if new == old:
        return
    with _registry:
        if _sessions.get(old) is s:
            del _sessions[old]
        other = _sessions.pop(new, None)
        _sessions[new] = s
    if other is not None and other is not s:
        _drop(other)


def run_step(key_of: Callable[[], Tuple[tuple, List[torch.Tensor]]], batch, body: Callable, *,
             device: torch.device, root: Optional[int] = None, owner=None) -> Tuple[torch.Tensor, ...]:
    """One call of a captured step. ``key_of()`` gives the session key and
    the tensors it names; ``body(batch, root)`` returns the step's output
    tensors (it runs on ``batch``, on the session's inputs while captured).
    The key's first call runs the body eagerly on the session's stream under
    a ``SeedRecorder`` of ``root`` (the step's dropout root; None: no
    dropout), then files the session under ``key_of()`` again (the warm-up
    made AdamW's state, which the key names) and drops ``owner``'s stale
    sessions; the second call captures the body and replays it; later calls
    replay. Each replay first seeds the plan's generators from ``root``.
    Returns copies of the outputs. A capture or replay that fails raises."""
    key, tensors = key_of()
    s = session(key, lambda: StepSession(key[0], device, tensors, owner))
    with s.lock:
        if not s.warm:
            recorder = layers.SeedRecorder(root)
            with layers.seed_hook(recorder) if root is not None else contextlib.nullcontext():
                out = s.warm_up(lambda: body(batch, root))
            s.plan, s.warm = recorder.chains, True
            new_key, tensors = key_of()
            s.trees, s.identities = list(tensors), _identities(tensors)
            _rekey(key, new_key, s)
            if owner is not None:
                _drop_stale(owner, s.identities, s)
            return tuple(t.clone() for t in out)
        seeds = layers.plan_seeds(s.plan, root) if s.plan else []
        if not s.graphs:
            s.inputs = tuple(None if x is None else torch.empty_like(x) for x in batch)
            _copy_in(s.inputs, batch)
            s.generators = [torch.Generator(device=device).manual_seed(x) for x in seeds]
            hook = layers.StepGenerators(seeds, s.generators)

            def capture_body():
                s.outputs = tuple(body(type(batch)(*s.inputs), root))

            with layers.seed_hook(hook):
                s.capture([(0, capture_body)])
            hook.check()
        else:
            _copy_in(s.inputs, batch)
        for gen, x in zip(s.generators, seeds):
            gen.manual_seed(x)
        s.replay(0)
        return tuple(t.clone() for t in s.outputs)


def _copy_in(inputs, batch) -> None:
    for dst, src in zip(inputs, batch):
        if dst is not None:
            dst.copy_(src, non_blocking=True)


def _drop(s: Session) -> None:
    """Forget a session once no thread replays it and its device is done
    with it (its pool may be reused from any stream after)."""
    with s.lock:
        torch.cuda.synchronize(s.device)
        s.graphs.clear()


def sessions() -> List[Session]:
    with _registry:
        return list(_sessions.values())


def clear() -> None:
    """Drop every session (their buffers and pools go back to the allocator)."""
    with _registry:
        while _sessions:
            _drop(_sessions.popitem(last=False)[1])
