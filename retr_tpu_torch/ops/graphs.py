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
pool, with ``capture_error_mode="thread_local"``: the ServingQueue's collector
thread synchronises events while its dispatcher may be capturing. A session's
lock keeps two threads from replaying one set of buffers at once. A capture or
replay that fails raises.

``decoder_kernels.LAUNCHES`` counts launches that ran: while a chunk is
captured its wrappers count into a tally of their own (``dk._capture``), and
each replay adds that tally.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from retr_tpu_torch.ops import decoder_kernels as dk

MAX_SESSIONS = 4  # sessions kept at once; the least recently used goes first

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
    place); ``trees`` are kept alive while the graphs read them; ``generator``
    (sampling) is registered with every graph, so a replay draws from its
    state at that time and advances it, as eager draws would."""

    def __init__(self, loop, trees: Sequence, device: torch.device, generator=None):
        self.loop = loop
        self.trees = list(trees)
        self.device = device
        self.generator = generator
        self.lock = threading.Lock()
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]] = {}
        self.stream = torch.cuda.Stream(device)
        self.capture_s = None     # seconds to capture every chunk
        self.pool_bytes = None    # device memory the graphs' pool reserved while they were captured

    def warm_up(self, run: Callable[[], None]) -> None:
        """``run()`` eagerly on the session's stream, ordered after the work
        queued so far and before the work queued after."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            run()
        cur.wait_stream(self.stream)

    def capture(self, chunks: List[Tuple[int, Callable[[], None]]]) -> None:
        """One graph per ``(start, body)`` of ``chunks``, in order, in one pool."""
        t0 = time.perf_counter()
        before = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for i0, body in chunks:
                g = torch.cuda.CUDAGraph()
                if self.generator is not None:
                    g.register_generator_state(self.generator)
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
        return s


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
