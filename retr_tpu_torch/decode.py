"""Greedy, prefix-forced, sampled and beam decoding, sequence scores and
attention maps: encode once, then the KV-cached loop (retr_tpu/decode.py).

Greedy token semantics are the reference's, exactly: BOS in slot 0; the logits
of position i are argmaxed into slot i+1; rows that produced EOS keep receiving
(ignored) tokens; when every row has finished the pending write is skipped and
the loop stops; at most ``max_len - 1`` steps. The buffer, post-EOS junk
included, equals retr_tpu.decode.greedy's. ``greedy_with_prefix`` and ``sample``
run the same loop (:class:`_TokenLoop`) and differ only in how a step's token is
chosen.

Beam search is retr_tpu.decode.beam_search's: memory tiled across the beams,
caches never reordered (ancestry addressing), the two-stage top-k on raw
logits, frozen finished beams, ``early_stop`` and the length-normalised final
ranking. Every top-k and sort breaks ties to the lowest index, as
``jax.lax.top_k`` and the stable ``jnp.argsort`` do (``ops.decoder_kernels.topk_first``).

On the GPU neither loop waits for the host each step: the stop condition stays
on the device, the step index the kernels read is a device int32, and the host
looks at it only every ``CHECK_EVERY`` steps, between two chunks of the loop.
Greedy steps run after every row finished are no-ops (the write is skipped). A
beam step is not a no-op, so each beam step's carry update is gated by the
device bool ``running`` (the JAX loop's condition, which stays false once
false). Unlike the JAX package, no rows are padded: the CUDA kernels take any
batch. Under the head flags the head is packed as the head kernels read it
(``ops.decoder_kernels.pack_head``).

The decode tree (the bf16 cast of the transformer and head, the stacked
decoder layers, the packed head) is kept across calls (:class:`_Memo`,
rebuilt when a source leaf's ``data_ptr()`` or ``_version`` changes). The
loops are objects whose carries are buffers that each step updates in place
(:class:`_TokenLoop` for greedy, ``greedy_with_prefix`` and ``sample``,
:class:`_BeamLoop`); ``chunk(i0, n)`` runs steps i0 .. i0+n-1 with ``i`` a
Python int, as the eager loop always did.

On a CUDA device the chunks are the counterpart of JAX's ``jax.jit`` +
``lax.while_loop``: each key's session (ops/graphs.py) owns the carries,
runs its first call eagerly, captures one CUDA graph per chunk start and
replays them after, so the host dispatches one replay per CHECK_EVERY steps.
Each call writes its inputs into the carries first (the cross K/V, BOS, the
flags, step 0); the self caches are not cleared, since a step reads only
slots that earlier steps of the same call wrote. The result is a copy, never
the session's buffer. The kernels, the arithmetic and the tokens are the
eager loop's. The loop stays eager:

- on CPU tensors;
- under an active mesh whose world is larger than one (its gloo or NCCL
  collectives, ``_argmax_over_mp``, ``_topk_log_softmax_over_mp``,
  ``_gather_vocab``, ``pmesh.any_over_dp``, are not captured), and for beam
  under any active mesh (its dp check runs a collective in a world of one
  too);
- for beam's ``margins`` diagnostic, which reads every step on the host;
- in ``greedy_with_attention``, a diagnostic at batch 1;
- with the module flag ``CUDA_GRAPHS`` off, so that the two paths can be
  compared on one card.

Under ``Config.decoder_kind`` "lm" the token loop decodes with the language
model of ``models/lm.py``: its prologue prefills the projected encoder memory
into the latent cache (the span ``decode.prefill``), each step is one
MLA + MoE step of every row, and the head is the LM's (final norm, vocabulary
product, argmax). Greedy, ``greedy_with_prefix`` and sampling run it, eager or
as graphs alike: :func:`_decoder` picks the loop's decoder object
(:class:`_RetrDecoder` or :class:`_LMDecoder`) once a run. Beam search,
sequence scores, attention maps and meshes raise ``NotImplementedError``.
Where the tracer records, the experts' tokens of a batch are read once after
its loop (``moe.pairs``, ``moe.max_expert_tokens``).

Under an active mesh whose mp slices the tree (``parallel/mesh.shard_params``)
the decoder runs tensor-parallel (``models/transformer.decode_step``) and
the MLP head's last layer gives this rank's vocabulary columns; the choices
combine them over the mp group with all-reduces alone, so every rank of the
group picks the tokens the whole vocabulary gives: greedy the first index
of the global max (:func:`_argmax_over_mp`), beam the global top-k and
log-softmax (:func:`_topk_log_softmax_over_mp`), sampling draws on the
gathered logits (:func:`_gather_vocab`). Under the head flags the head's
last layer is gathered once per call and the head kernels run on the whole
vocabulary, as JAX's Pallas head reads its operands whole under GSPMD.
"""

from __future__ import annotations

import functools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from retr_tpu_torch.config import Config
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import caption, lm, transformer
from retr_tpu_torch.ops import decoder_kernels as dk
from retr_tpu_torch.ops import graphs
from retr_tpu_torch.parallel import mesh as pmesh
from retr_tpu_torch.precision import dtype_of, matmul_precision
from retr_tpu_torch.utils import profiling

Params = Dict[str, Any]

CHECK_EVERY = 16  # steps between host checks of the loop's stop condition
# On a CUDA device the loop's chunks run as captured CUDA graphs (the module's
# docstring); False runs them eagerly, so the two can be compared on one card.
CUDA_GRAPHS = True


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


class _Memo:
    """A function of a parameter tree kept across decode calls: the entry of a
    tree is found by its leaves' identities, and is valid while every leaf
    is alive (weak references) with the ``data_ptr()`` and ``_version`` it
    had when the entry was built. An in-place update (the trainer's AdamW
    step, a checkpoint load) bumps ``_version``, so the entry is rebuilt and
    a stale copy is never read. At most ``size`` entries, least recently used
    first out. Built without autograd: the decode reads them only."""

    size = 4

    def __init__(self, build: Callable):
        self.build = build
        self.entries: OrderedDict = OrderedDict()
        self.lock = threading.Lock()

    def __call__(self, tree, *args):
        leaves = _leaves(tree)
        ident = (tuple(map(id, leaves)), args)
        stamp = tuple((t.data_ptr(), t._version) for t in leaves)
        with self.lock:
            hit = self.entries.pop(ident, None)
            if hit is None or hit[1] != stamp or any(r() is not t for r, t in zip(hit[0], leaves)):
                with torch.no_grad():
                    hit = (tuple(map(weakref.ref, leaves)), stamp, self.build(tree, *args))
            self.entries[ident] = hit
            while len(self.entries) > self.size:
                self.entries.popitem(last=False)
        return hit[2]


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# The decode tree: the storage-type cast of the transformer and the head, the
# decoder layers stacked as the kernels read them, the packed head. Kept
# across calls, so the graphs of ops/graphs.py find their weights where they
# were captured, and no call pays for the copies again.
_cast = _Memo(_cast_tree)
_decoder_tree = _Memo(transformer.prepare_decoder)
_packed = _Memo(dk.pack_head)


def _cast_for_decode(params: Params, memory, pos, compute_dtype):
    """Storage type of the decode loop: in bf16 mode the decoder's and head's
    weights (kept across calls, ``_cast``), the encoder memory and (allocated
    from it) the decode state are bf16; f32 parity mode returns everything
    unchanged. LayerNorm and softmax still compute in f32 inside the
    kernels."""
    dt = dtype_of(compute_dtype)
    if dt == torch.float32:
        return params, memory, pos

    def cast(tree):
        # kept across calls only where it is a copy: an entry whose leaves are
        # the caller's would hold them after the caller dropped its tree
        return _cast(tree, dt) if any(t.is_floating_point() and t.dtype != dt for t in _leaves(tree)) else tree

    params = {**params, **{k: cast(params[k]) for k in ("transformer", "mlp", "lm") if k in params}}
    return params, memory.to(dt), pos.to(dt)


def _chunks(max_len: int) -> List[Tuple[int, int]]:
    """(first step, steps) of each chunk between two host checks: the loop's
    ``max_len - 1`` steps cut every CHECK_EVERY."""
    return [(i0, min(CHECK_EVERY, max_len - 1 - i0)) for i0 in range(0, max_len - 1, CHECK_EVERY)]


def _graphed(device: torch.device, collectives: bool = False) -> bool:
    """Whether the loop runs as CUDA graphs: on a CUDA device with
    ``CUDA_GRAPHS`` on, and no active mesh whose collectives the loop would
    run (a world larger than one; ``collectives``: in a world of one too)."""
    if not CUDA_GRAPHS or device.type != "cuda":
        return False
    mesh = pmesh.current()
    return mesh is None or (mesh.world == 1 and not collectives)


def _session_trees(tparams: Params, mlp: Params, head_p: Optional[Params]) -> list:
    """What a session's graphs read of the decode tree, named in its key and
    kept alive by it: the prepared decoder and the packed head (kept
    across calls), and the head's leaves (a dict around them may be new on
    every call)."""
    return [t for t in (tparams, head_p) if t is not None] + _leaves(mlp)


def _drive(loop, max_len: int, replay: Optional[Callable[[int], None]] = None) -> None:
    """Run the loop's chunks, the host checking the stop condition before
    each (the span ``decode.stop_check``: the host blocked on the card):
    eagerly, or by ``replay(first step)`` of the captured chunk."""
    for i0, n in _chunks(max_len):
        with profiling.span("decode.stop_check"):
            stopped = loop.stopped(i0)
        if stopped:
            break
        if replay is None:
            loop.chunk(i0, n)
        else:
            replay(i0)


def _run(new_loop: Callable, start: Callable, *, max_len: int, key: Optional[tuple] = None,
         trees: Sequence = (), generator: Optional[torch.Generator] = None):
    """Run a decode loop to its end and return its result. Without ``key``:
    ``new_loop(generator)``, started by ``start(loop)`` and run eagerly.
    With ``key``: the loop of the key's graph session (made on its first
    call, its first run eager and then captured; replayed after). A sampling
    session draws from a generator of its own, set to ``generator``'s state
    before the run; ``generator`` takes its state after, as after an eager
    run."""
    if key is None:
        loop = new_loop(generator)
        start(loop)
        _drive(loop, max_len)
        return loop.result(owned=True)

    def make():
        own = None if generator is None else torch.Generator(device=generator.device)
        loop = new_loop(own)
        return graphs.Session(loop, trees, loop.step.device, () if own is None else (own,))

    session = graphs.session(key, make)
    with session.lock:
        loop = session.loop
        if generator is not None:
            loop.generator.set_state(generator.get_state())
        start(loop)
        if session.graphs:
            _drive(loop, max_len, session.replay)
        else:
            session.warm_up(functools.partial(_drive, loop, max_len))
            session.capture([(i0, functools.partial(loop.chunk, i0, n)) for i0, n in _chunks(max_len)])
        if generator is not None:
            generator.set_state(loop.generator.get_state())
        return loop.result(owned=False)


class _RetrDecoder:
    """RE:TR's decoder on the token loop: the prepared decoder layers, whose
    state is the self caches and the cross K/V of the memory, and the MLP
    head (packed for the head kernel with ``packed_head``)."""

    def __init__(self, params: Params, cfg: Config, packed_head: bool = False):
        if cfg.decoder_kind != "retr":     # the token loop's runs take _LMDecoder; beam search has no other
            raise NotImplementedError("beam search with the LM decoder (ROADMAP L1: LM beam search)")
        self.cfg, self.tree, self.mlp = cfg, _decoder_tree(params["transformer"]), params["mlp"]
        self.head_p = _packed_head(self.mlp, cfg) if packed_head else None
        self.trees = _session_trees(self.tree, self.mlp, self.head_p)

    def alloc(self, rows: int, mem_len: int, max_len: int, dtype, device) -> tuple:
        return transformer.alloc_decode_state(self.tree, self.cfg, rows, mem_len, max_len, dtype, device)

    def prefill(self, cache, cross, memory, mem_mask, pos, max_len: int) -> None:
        transformer.init_decode_state(self.tree, memory, mem_mask, pos, self.cfg, max_len, out=(cache, cross))

    def step(self, cache, cross, tokens, step, mem_len: int) -> torch.Tensor:
        return transformer.decode_step(self.tree, cache, cross, tokens, step, self.cfg)[0]

    def argmax(self, hs) -> torch.Tensor:
        if self.head_p is not None:
            return dk.mlp_head_argmax(self.head_p, hs)
        return _argmax_head(self.mlp, self.cfg, hs)

    def logits(self, hs) -> torch.Tensor:
        return _head_logits(self.mlp, self.cfg, hs)

    def finish(self, cache) -> None:
        pass


class _LMDecoder:
    """The language model of ``models/lm.py`` on the token loop: its state is
    the latent cache (``lm.LatentState``; no cross state), its prologue the
    prefix's prefill (the span ``decode.prefill``), its head the final norm's
    vocabulary product. One card only: meshes raise."""

    def __init__(self, params: Params, cfg: Config, packed_head: bool = False):
        if pmesh.current() is not None:
            raise NotImplementedError("the LM decoder under a dp/mp mesh (ROADMAP L3: LM under dp/mp)")
        self.cfg, self.p = cfg, params["lm"]
        self.trees = [self.p]

    def alloc(self, rows: int, mem_len: int, max_len: int, dtype, device) -> tuple:
        return lm.alloc_state(self.cfg, rows, mem_len, max_len, dtype, device), ()

    def prefill(self, cache, cross, memory, mem_mask, pos, max_len: int) -> None:
        with profiling.span("decode.prefill", rows=memory.shape[0], tokens=memory.shape[0] * memory.shape[1]):
            lm.prefill(self.p, memory, mem_mask, self.cfg, cache)

    def step(self, cache, cross, tokens, step, mem_len: int) -> torch.Tensor:
        return lm.decode_step(self.p, cache, tokens, step, mem_len, self.cfg)

    def argmax(self, hs) -> torch.Tensor:
        return lm.logits(self.p, hs).argmax(dim=-1).to(torch.int32)

    def logits(self, hs) -> torch.Tensor:
        return lm.logits(self.p, hs).float()

    def finish(self, cache) -> None:
        """The batch's expert tallies, read once after its loop where the
        tracer records: ``moe.pairs``, the pairs routed, and
        ``moe.max_expert_tokens``, the busiest [layer, expert]'s pairs over
        the mean of all (a ratio a batch; the counter sums it over batches)."""
        if profiling.recording():
            tally = cache.tally
            profiling.count("moe.pairs", int(tally.sum()))
            profiling.count("moe.max_expert_tokens", float(tally.max() / tally.float().mean().clamp_min(1e-9)))


def _decoder(params: Params, cfg: Config, packed_head: bool = False):
    """The token loop's decoder of ``cfg.decoder_kind``."""
    return (_LMDecoder if cfg.decoder_kind == "lm" else _RetrDecoder)(params, cfg, packed_head)


class _TokenLoop:
    """The carries of greedy, prefix completion and sampling, which
    :meth:`chunk` updates in place: the [B, max_len] token buffer, the
    decoder's state (``cache`` and ``cross``: RE:TR's self caches and cross
    K/V, the LM's latent cache), the finished flags, the prefix lengths and
    the step index the kernels read. ``choose(loop, i, hs)`` gives the [B]
    int32 tokens of slot i+1 from the hidden states of position i (and
    ``loop.decoder``, ``loop.captions``, ``loop.prefix_lens``,
    ``loop.generator``)."""

    def __init__(self, decoder, choose: Callable, *, rows: int, mem_len: int, max_len: int, eos_token: int, dtype,
                 device, generator=None):
        self.decoder, self.choose, self.eos = decoder, choose, eos_token
        self.mem_len, self.max_len, self.dtype, self.generator = mem_len, max_len, dtype, generator
        self.cache, self.cross = decoder.alloc(rows, mem_len, max_len, dtype, device)
        self.captions = torch.zeros((rows, max_len), dtype=torch.int32, device=device)
        self.prefix_lens = torch.zeros(rows, dtype=torch.int32, device=device)
        self.finished = torch.zeros(rows, dtype=torch.bool, device=device)
        self.step = torch.zeros((), dtype=torch.int32, device=device)

    def buffers(self) -> List[torch.Tensor]:
        return [*self.cache, *self.cross, self.captions, self.prefix_lens, self.finished, self.step]

    def start(self, memory, mem_mask, pos, bos_token: int, captions=None, prefix_lens=None) -> None:
        """The prologue: the decoder's state of this memory, BOS in slot 0 of
        the token buffer (or of ``captions``, a preset buffer of forced
        tokens), no row finished, step 0."""
        self.decoder.prefill(self.cache, self.cross, memory, mem_mask, pos, self.max_len)
        if captions is None:
            self.captions.zero_()
        else:
            self.captions.copy_(captions)
        self.captions[:, 0] = bos_token
        if prefix_lens is not None:
            self.prefix_lens.copy_(prefix_lens)
        self.finished.zero_()
        self.step.zero_()

    def stopped(self, i0: int) -> bool:
        """The host check before step ``i0``: every row finished."""
        return i0 > 0 and bool(self.finished.all())

    def chunk(self, i0: int, n: int) -> None:
        """Steps i0 .. i0+n-1: each decodes position i, and the reference's
        write and stop rules apply to the chosen tokens."""
        with matmul_precision(self.dtype):
            for i in range(i0, i0 + n):
                hs = self.decoder.step(self.cache, self.cross, self.captions[:, i], self.step, self.mem_len)
                tok = self.choose(self, i, hs)
                self.finished |= tok == self.eos
                write = ~self.finished.all()  # all just finished: the reference skips this write
                self.captions[:, i + 1] = torch.where(write, tok, self.captions[:, i + 1])
                self.step += 1

    def result(self, owned: bool) -> torch.Tensor:
        """The token buffer; a copy where the buffer is a session's. The
        decoder reads what it tallied here, once a batch."""
        self.decoder.finish(self.cache)
        return self.captions if owned else self.captions.clone()


def _token_run(kind: str, params: Params, cfg: Config, memory, mem_mask, pos, choose: Callable, *, max_len: int,
               bos_token: int, eos_token: int, captions=None, prefix_lens=None, generator=None,
               packed_head: bool = False, extra: tuple = (), cuda_graphs: bool = True) -> torch.Tensor:
    """Greedy, prefix completion or sampling (``kind``) on the token loop:
    eager, or the graphs of the session of its key (the module's docstring)."""
    b, s = memory.shape[:2]
    decoder = _decoder(params, cfg, packed_head)

    def new_loop(gen):
        return _TokenLoop(decoder, choose, rows=b, mem_len=s, max_len=max_len, eos_token=eos_token,
                          dtype=memory.dtype, device=memory.device, generator=gen)

    def start(loop):
        loop.start(memory, mem_mask, pos, bos_token, captions, prefix_lens)

    key, trees = None, decoder.trees
    if cuda_graphs and _graphed(memory.device):
        key = graphs.session_key(kind, memory, rows=b, beams=1, max_len=max_len, trees=trees,
                                 extra=(cfg, eos_token, CHECK_EVERY, *extra))
    return _run(new_loop, start, max_len=max_len, key=key, trees=trees, generator=generator)


def _vocab_split(mlp: Params, cfg: Config) -> bool:
    """Whether the head's last layer is an mp slice of the vocabulary."""
    return pmesh.is_mp_sharded(mlp["layers"][-1]["w"], 1, cfg.vocab_size)


def _gather_vocab(x: torch.Tensor) -> torch.Tensor:
    """[N, V/mp] vocabulary slices of the mp group -> the whole [N, V], rank order."""
    parts = pmesh.all_gather(x.contiguous(), pmesh.mp_group())
    return parts.permute(1, 0, 2).reshape(x.shape[0], -1)


def _argmax_over_mp(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary split across the mp group: the global max
    (all-reduce MAX of the local maxima) and, among the ranks that hold it,
    the lowest global index (all-reduce MIN), argmax's first max."""
    group = pmesh.mp_group()
    idx = logits.argmax(dim=-1)
    best = logits.gather(-1, idx[:, None])[:, 0].float()
    top = pmesh.all_reduce(best.clone(), group, "max")
    own = idx + pmesh.current().mp_rank * logits.shape[-1]
    cand = torch.where(best == top, own, torch.iinfo(torch.int64).max)
    return pmesh.all_reduce(cand, group, "min").to(torch.int32)


def _topk_log_softmax_over_mp(logits: torch.Tensor, k: int):
    """``dk.topk_log_softmax`` of f32 logits whose vocabulary is split across
    the mp group (k at most a slice's width): each rank's top-k of its raw
    logits and its (max, sum of exp(x - max)); the global logsumexp from
    those; the candidates of all ranks, gathered in rank order, ranked by
    ``topk_first``, whose ties then go to the lowest global index as
    ``lax.top_k``'s do. Values within f32 rounding of the whole row's (the
    sum of exponentials runs per slice)."""
    group = pmesh.mp_group()
    n, v = logits.shape
    vals, idx = dk.topk_first(logits, k)
    m = logits.max(dim=-1, keepdim=True).values
    se = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    top_m = pmesh.all_reduce(m.clone(), group, "max")
    log_z = torch.log(pmesh.all_reduce(se * torch.exp(m - top_m), group))
    cand_v = _gather_vocab(vals)
    cand_i = _gather_vocab(idx + pmesh.current().mp_rank * v)
    best, pos = dk.topk_first(cand_v, k)
    return (best - top_m) - log_z, cand_i.gather(1, pos).to(torch.int32)


def _head_logits(mlp: Params, cfg: Config, hs) -> torch.Tensor:
    """The MLP head's f32 logits over the whole vocabulary (gathered over mp
    where the last layer is a slice)."""
    logits = caption.mlp_head(mlp, hs).float()
    return _gather_vocab(logits) if _vocab_split(mlp, cfg) else logits


def _argmax_head(mlp: Params, cfg: Config, hs) -> torch.Tensor:
    logits = caption.mlp_head(mlp, hs)
    if _vocab_split(mlp, cfg):
        return _argmax_over_mp(logits)
    return logits.argmax(dim=-1).to(torch.int32)


def _packed_head(mlp: Params, cfg: Config) -> Params:
    """The head as the head kernels read it (``pack_head``, kept across calls),
    its last layer first gathered over mp where it is a vocabulary slice
    (then packed anew on every call: the gather is a collective)."""
    if _vocab_split(mlp, cfg):
        l3 = mlp["layers"][-1]
        w, b = pmesh.gather_leaves([l3["w"], l3["b"]], [(None, "mp"), ("mp",)], pmesh.current())
        return dk.pack_head({**mlp, "layers": [*mlp["layers"][:-1], {"w": w, "b": b}]})
    return _packed(mlp)


def greedy_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, *,
                       max_len: int, bos_token: int, eos_token: int, cuda_graphs: bool = True) -> torch.Tensor:
    """Greedy decode given the encoder output; returns the [B, max_len] int32
    token buffer (on memory's device). ``cuda_graphs=False`` keeps the loop
    eager (``greedy_with_attention``)."""

    def choose(loop, i, hs):
        return loop.decoder.argmax(hs)

    return _token_run("greedy", params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                      eos_token=eos_token, packed_head=dk.HEAD_KERNEL, cuda_graphs=cuda_graphs)


class Encoded(NamedTuple):
    """The encoder's output as the decode loop takes it (:func:`_encode_for_decode`):
    the params cast for the loop, the memory, its mask and positions.
    :func:`greedy`, :func:`greedy_with_prefix`, :func:`sample` and
    :func:`beam_search` take one in place of their samples: they then skip
    the encode and decode with its params, not their own. So a caller can
    enqueue a batch's encode and run its decode later, on another thread."""
    params: Params
    memory: torch.Tensor
    mem_mask: torch.Tensor
    pos: torch.Tensor


def _encode_for_decode(params, cfg, samples, global_samples, loc_feats, compute_dtype, filler_idx) -> Encoded:
    if isinstance(samples, Encoded):
        return samples
    with profiling.span("decode.encode", rows=samples.tensors.shape[0]):
        memory, mem_mask, pos = caption.encode(
            params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
            compute_dtype=compute_dtype, filler_idx=filler_idx,
        )
        params, memory, pos = _cast_for_decode(params, memory, pos, compute_dtype)
    return Encoded(params, memory, mem_mask, pos)


def greedy(params: Params, cfg: Config, samples: Masked, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           max_len: int = 128, bos_token: int = 101, eos_token: int = 102,
           compute_dtype=torch.float32, filler_idx=None) -> torch.Tensor:
    """Batched greedy decoding: encode once, then the KV-cached loop. Runs on the
    device the samples are on; ``samples`` may be their :class:`Encoded`."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    return greedy_from_memory(params, cfg, memory, mem_mask, pos, max_len=max_len,
                              bos_token=bos_token, eos_token=eos_token)


def greedy_with_prefix(params: Params, cfg: Config, samples: Masked, prefix: torch.Tensor,
                       prefix_lens: torch.Tensor, *, global_samples: Optional[Masked] = None,
                       loc_feats: Optional[torch.Tensor] = None, max_len: int = 128, bos_token: int = 101,
                       eos_token: int = 102, compute_dtype=torch.float32, filler_idx=None) -> torch.Tensor:
    """Greedy completion of per-row forced prefixes (retr_tpu.decode.greedy_with_prefix).

    prefix [B, P] int32 (0-padded) and prefix_lens [B] int32, on the samples'
    device: positions 1..prefix_lens[b] hold the forced tokens, the rest decodes
    greedily. The forced tokens still go through the decode step (they fill the
    caches); only the argmax is overridden. A forced EOS finishes its row;
    ``prefix_lens`` of zero is exactly ``greedy``. The head is ``mlp_head`` and
    argmax, as in the JAX package (no head kernel)."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    b, p = prefix.shape
    captions = torch.zeros((b, max_len), dtype=torch.int32, device=memory.device)
    cols = torch.arange(p, device=memory.device)[None, :]
    captions[:, 1:p + 1] = torch.where(cols < prefix_lens[:, None], prefix.to(torch.int32), 0)

    def choose(loop, i, hs):
        forced = i + 1 <= loop.prefix_lens            # position i+1 is in the prefix
        return torch.where(forced, loop.captions[:, i + 1], loop.decoder.argmax(hs))

    return _token_run("prefix", params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                      eos_token=eos_token, captions=captions, prefix_lens=prefix_lens)


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator,
                  noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [B, N] (f32) by the Gumbel-max
    trick, as ``jax.random.categorical`` draws: argmax(logits - log(-log(u))),
    u uniform on (tiny, 1) from ``generator`` (on the logits' device).

    ``noise_rows=(start, frame)``: these rows are rows start.. of a batch of
    ``frame`` rows; the noise of the whole frame is drawn and these rows'
    kept (rows past the frame, padding, take its last), so a row draws the
    same wherever the batch is split."""
    if noise_rows is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    else:
        start, frame = noise_rows
        u = torch.rand((frame, logits.shape[1]), generator=generator, device=logits.device, dtype=torch.float32)
        rows = (torch.arange(logits.shape[0], device=logits.device) + start).clamp_(max=frame - 1)
        u = u.index_select(0, rows)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _nucleus_keep(sorted_vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """On values sorted largest first: the smallest prefix whose softmax mass
    reaches ``top_p``, and always at least one entry."""
    cum = torch.cumsum(torch.softmax(sorted_vals, dim=-1), dim=-1)
    first = torch.ones_like(cum[:, :1], dtype=torch.bool)
    return torch.cat([first, cum[:, :-1] < top_p], dim=-1)


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One token per row of f32 logits [B, V] under temperature, top-k and
    top-p, composed as retr_tpu.decode.sample composes them: argmax exactly when
    ``temperature <= 0`` or ``top_k == 1``; with ``0 < top_k < V`` the draw runs
    on the top-k shortlist (``topk_first``, ``lax.top_k``'s order), cut to its
    nucleus when ``top_p < 1``; otherwise on the full vocabulary, where a
    ``top_p < 1`` cut removes every logit below the nucleus's smallest.
    ``noise_rows``: as :func:`gumbel_argmax`'s."""
    if temperature <= 0.0 or top_k == 1:
        return logits.argmax(dim=-1).to(torch.int32)
    neg_inf = -1e30
    z = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        vals, idx = dk.topk_first(z, top_k)
        if top_p < 1.0:
            vals = torch.where(_nucleus_keep(vals, top_p), vals, neg_inf)
        choice = gumbel_argmax(vals, generator, noise_rows)
        return idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    if top_p < 1.0:
        sorted_z = z.sort(dim=-1, descending=True).values
        cutoff = torch.where(_nucleus_keep(sorted_z, top_p), sorted_z, float("inf")).amin(dim=-1, keepdim=True)
        z = torch.where(z < cutoff, neg_inf, z)
    return gumbel_argmax(z, generator, noise_rows).to(torch.int32)


def sample(params: Params, cfg: Config, samples: Masked, generator: torch.Generator, *,
           global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
           max_len: int = 128, bos_token: int = 101, eos_token: int = 102, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0, compute_dtype=torch.float32, filler_idx=None,
           noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Ancestral sampling with temperature, top-k and nucleus (top-p) filtering
    (retr_tpu.decode.sample; :func:`sample_tokens` composes the filters).

    The greedy loop's write and stop rules; ``generator`` is a ``torch.Generator``
    on the samples' device (the counterpart of the JAX key), and the draws
    stay on the device, so a step does not wait for the host. torch cannot
    reproduce ``jax.random``: the draws match the JAX package's in
    distribution, and exactly where sampling reduces to argmax.
    ``noise_rows=(start, frame)``: the samples are rows start.. of a batch
    of ``frame`` rows, which each step's noise is drawn for (the sharded
    sweep's dp ranks; :func:`gumbel_argmax`). As CUDA graphs the session
    draws from a generator of its own, registered with its graphs
    (``CUDAGraph.register_generator_state``), given ``generator``'s state
    before the decode and handing it back after: each replay draws fresh
    noise, at the Philox offsets of the eager loop, so a seed gives the
    eager loop's tokens."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    return sample_from_memory(params, cfg, memory, mem_mask, pos, generator, max_len=max_len, bos_token=bos_token,
                              eos_token=eos_token, temperature=temperature, top_k=top_k, top_p=top_p,
                              noise_rows=noise_rows)


def sample_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, generator: torch.Generator, *,
                       max_len: int, bos_token: int, eos_token: int, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0, noise_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """:func:`sample` given the encoder output."""

    def choose(loop, i, hs):
        return sample_tokens(loop.decoder.logits(hs), loop.generator, temperature=temperature, top_k=top_k,
                             top_p=top_p, noise_rows=noise_rows)

    return _token_run("sample", params, cfg, memory, mem_mask, pos, choose, max_len=max_len, bos_token=bos_token,
                      eos_token=eos_token, generator=generator, extra=(temperature, top_k, top_p, noise_rows))


def sequence_scores(params: Params, cfg: Config, samples: Masked, caps: torch.Tensor, cap_masks: torch.Tensor,
                    *, global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                    compute_dtype=torch.float32, filler_idx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token log-probabilities of given captions (retr_tpu.decode.sequence_scores).

    caps [B, T] int32 (BOS first, 0-padded), cap_masks [B, T] bool (True = pad).
    One teacher-forced forward (input caps[:, :-1], targets caps[:, 1:]),
    log_softmax in f32, gathered at the targets. Returns (logprobs [B, T-1],
    valid [B, T-1]), valid marking real target positions. Under
    ``cfg.use_pallas_attention`` the forward's attention cores run in the
    fused attention kernel."""
    logits = caption.forward(params, cfg, samples, caps[:, :-1], cap_masks[:, :-1],
                             global_samples=global_samples, loc_feats=loc_feats, train=False,
                             compute_dtype=compute_dtype, filler_idx=filler_idx)
    logits = torch.log_softmax(logits.float(), dim=-1)   # [B, T-1, V]; the logits are dropped
    tok_lp = logits.gather(-1, caps[:, 1:, None].long())[..., 0]
    return tok_lp, ~cap_masks[:, 1:]


def greedy_with_attention(params: Params, cfg: Config, samples: Masked, *,
                          global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                          max_len: int = 128, bos_token: int = 101, eos_token: int = 102,
                          compute_dtype=torch.float32, filler_idx=None):
    """Greedy decode and its attention maps (retr_tpu.decode.greedy_with_attention):
    one teacher-forced forward over the decoded buffer gives every step's
    maps. Returns (ids [B, max_len], atts) with atts keyed ``enc_tc_self_att``,
    ``dec_exp_self_att`` and ``dec_exp_tc_cross_att``, [layers, B, T, S] each.
    The whole call runs with ``use_pallas_attention`` off: the maps come from
    the plain attention core, and the encoder of the greedy half uses it too,
    so the ids and the maps come from one computation and the fused attention
    kernel is never launched."""
    cfg = cfg.replace(use_pallas_attention=False)
    dparams, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                        compute_dtype, filler_idx)
    ids = greedy_from_memory(dparams, cfg, memory, mem_mask, pos, max_len=max_len, bos_token=bos_token,
                             eos_token=eos_token, cuda_graphs=False)
    _, atts = caption.forward(params, cfg, samples, ids, ids == 0, global_samples=global_samples,
                              loc_feats=loc_feats, return_attention=True, compute_dtype=compute_dtype,
                              filler_idx=filler_idx)
    return ids, atts


def _beam_active(scores, finished, fin_len, step: int, *, length_penalty: float,
                 early_stop: bool) -> torch.Tensor:
    """The JAX beam loop's condition on the state after ``step`` steps, as a
    device bool (retr_tpu/decode.py beam_search_from_memory ``cond``; the
    bound ``step < max_len - 1`` is the caller's loop range)."""
    if not early_stop:
        return ~finished.all()
    inf = float("inf")
    all_fin, any_fin = finished.all(dim=-1), finished.any(dim=-1)
    # finished beams' final normalised scores, and the raw score they hold
    fin_norm = scores / fin_len.clamp_min(1.0) ** length_penalty
    worst_fin = torch.where(finished, fin_norm, inf).min(dim=-1, keepdim=True).values
    fin_raw_min = torch.where(finished, scores, inf).min(dim=-1, keepdim=True).values
    # a live beam's best case: finish now (raw log-prob only decreases), in f32
    live = ~finished
    len_lo = torch.tensor(float(step) + 1.0, dtype=torch.float32) ** length_penalty
    can_win = torch.where(live, scores / len_lo, -inf).ge(worst_fin).any(dim=-1)
    can_evict = torch.where(live, scores, -inf).ge(fin_raw_min).any(dim=-1)
    return (~all_fin & (~any_fin | can_win | can_evict)).any()


_NEG_INF = -1e9   # the score of a beam slot that is not live


class _BeamLoop:
    """The carries of beam search, which :meth:`chunk` updates in place: the
    [B, K, max_len] token buffer, scores, finished flags and lengths, the
    ancestry matrix (and its per-step scratch), the self caches and tiled
    cross K/V, the device bool ``running`` (the JAX loop's condition) and
    the step index the kernels read."""

    def __init__(self, tparams: Params, mlp: Params, head_p: Optional[Params], cfg: Config, *, rows: int,
                 beams: int, mem_len: int, max_len: int, eos_token: int, length_penalty: float, early_stop: bool,
                 dtype, device, margins: Optional[list] = None):
        self.tparams, self.mlp, self.head_p, self.cfg = tparams, mlp, head_p, cfg
        self.k, self.max_len, self.eos, self.dtype = beams, max_len, eos_token, dtype
        self.length_penalty, self.early_stop, self.margins = length_penalty, early_stop, margins
        self.split = _vocab_split(mlp, cfg)
        # beams share their element's memory, so the cross K/V are tiled and never
        # reordered; the self caches use ancestry addressing instead of reordering
        self.cache, self.cross = transformer.alloc_decode_state(tparams, cfg, rows * beams, mem_len, max_len,
                                                                dtype, device)
        shape = (rows, beams)
        self.tokens = torch.zeros((*shape, max_len), dtype=torch.int32, device=device)
        self.scores = torch.zeros(shape, dtype=torch.float32, device=device)
        self.finished = torch.zeros(shape, dtype=torch.bool, device=device)
        self.fin_len = torch.zeros(shape, dtype=torch.float32, device=device)
        self.anc = torch.zeros((*shape, max_len), dtype=torch.int32, device=device)
        self.anc_i = torch.zeros_like(self.anc)
        self.running = torch.zeros((), dtype=torch.bool, device=device)
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.beams = torch.arange(beams, dtype=torch.int32, device=device)
        self.first_slot = self.beams == 0

    def buffers(self) -> List[torch.Tensor]:
        return [*self.cache, *self.cross, self.tokens, self.scores, self.finished, self.fin_len, self.anc,
                self.anc_i, self.running, self.step, self.beams, self.first_slot]

    def _active(self, step: int) -> torch.Tensor:
        return pmesh.any_over_dp(_beam_active(self.scores, self.finished, self.fin_len, step,
                                               length_penalty=self.length_penalty, early_stop=self.early_stop))

    def start(self, memory, mem_mask, pos, bos_token: int) -> None:
        """The prologue: the tiled cross K/V of this memory, BOS in slot 0 of
        every beam, beam 0 of each element the only live score."""
        k = self.k
        transformer.init_decode_state(self.tparams, memory.repeat_interleave(k, dim=0),
                                      mem_mask.repeat_interleave(k, dim=0), pos, self.cfg, self.max_len,
                                      out=(self.cache, self.cross))
        self.tokens.zero_()
        self.tokens[:, :, 0] = bos_token
        self.scores.copy_(torch.where(self.first_slot, 0.0, _NEG_INF).float().expand_as(self.scores))
        self.finished.zero_()
        self.fin_len.zero_()
        self.anc.zero_()
        self.step.zero_()
        self.running.copy_(self._active(0))

    def stopped(self, i0: int) -> bool:
        """The host check before step ``i0``: the JAX loop's condition is false."""
        return not bool(self.running)

    def chunk(self, i0: int, n: int) -> None:
        """Steps i0 .. i0+n-1 of the beam loop. Steps past the JAX loop's stop
        still run until the next host check: their carry updates are gated off
        by ``running``, and the cache slots they write (at positions no kept
        token reaches) are never read by a step whose result is kept."""
        b, k, t = self.tokens.shape
        eos = self.eos
        with matmul_precision(self.dtype):
            for i in range(i0, i0 + n):
                self.anc_i.copy_(self.anc)
                self.anc_i[:, :, i] = self.beams      # position i is written by each beam's own row
                hs, _ = transformer.decode_step_beam(self.tparams, self.cache, self.cross,
                                                     self.tokens[:, :, i].reshape(b * k), self.step, self.cfg,
                                                     self.anc_i, k)
                if self.head_p is not None:
                    row_scores, row_tokens = dk.mlp_head_topk(self.head_p, hs, k)
                else:
                    logits = caption.mlp_head(self.mlp, hs).float()
                    row_scores, row_tokens = (_topk_log_softmax_over_mp if self.split else dk.topk_log_softmax)(
                        logits, k)
                row_scores, row_tokens = row_scores.view(b, k, k), row_tokens.view(b, k, k)

                # finished beams: one EOS continuation at no cost
                fin = self.finished[:, :, None]
                row_scores = torch.where(fin, torch.where(self.first_slot, 0.0, _NEG_INF), row_scores)
                row_tokens = torch.where(fin, eos, row_tokens)

                cand = (self.scores[:, :, None] + row_scores).view(b, k * k)
                if self.margins is not None:
                    top = dk.topk_first(cand, min(k + 1, k * k))[0]
                    self.margins.append(top[:, k - 1] - top[:, -1])
                top_scores, top_idx = dk.topk_first(cand, k)
                beam_idx = top_idx // k
                tok = row_tokens.view(b, k * k).gather(1, top_idx)
                rows = beam_idx[:, :, None].expand(b, k, t)
                new_tokens = self.tokens.gather(1, rows)
                new_tokens[:, :, i + 1] = tok
                prev_fin = self.finished.gather(1, beam_idx)
                ends = tok == eos
                new_fin_len = torch.where(~prev_fin & ends, float(i + 1), self.fin_len.gather(1, beam_idx))

                running = self.running
                self.tokens.copy_(torch.where(running, new_tokens, self.tokens))
                self.scores.copy_(torch.where(running, top_scores, self.scores))
                self.finished.copy_(torch.where(running, prev_fin | ends, self.finished))
                self.fin_len.copy_(torch.where(running, new_fin_len, self.fin_len))
                self.anc.copy_(torch.where(running, self.anc_i.gather(1, rows), self.anc))
                self.running &= self._active(i + 1)
                self.step += 1

    def result(self, owned: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The length-normalised ranking: tokens after BOS up to and including
        the first EOS. New tensors, whoever owns the buffers."""
        b, k, t = self.tokens.shape
        is_eos = self.tokens == self.eos
        length = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1), t - 1).float()
        norm = self.scores / length.clamp_min(1.0) ** self.length_penalty
        norm, order = dk.topk_first(norm, k)
        return self.tokens.gather(1, order[:, :, None].expand(b, k, t)), norm


def beam_search_from_memory(params: Params, cfg: Config, memory, mem_mask, pos, *, max_len: int,
                            bos_token: int, eos_token: int, beam_size: int,
                            length_penalty: float = 1.0, early_stop: bool = True,
                            margins: Optional[list] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with length normalisation score / length**length_penalty.

    Returns (tokens [B, K, max_len] int32 best first, normalised scores [B, K]).
    Finished beams are frozen (they re-emit EOS at no cost). The self caches are
    never reordered: each beam row writes its own slot, and the [B, K, T]
    ancestry matrix says which row of the group wrote each position
    (transformer.decode_step_beam). ``early_stop`` ends the loop, per batch
    element, once no live beam can outrank the worst finished one (finishing
    now) or evict a finished one under the raw score, as in the JAX package.
    The loop's condition is the whole batch's: under an active mesh it is
    OR-ed over the dp group each step, as the JAX loop's condition is
    all-reduced over a dp-sharded batch, so a dp rank's rows decode as in
    the whole batch.

    ``margins``: if a list, each step appends the [B] gap between the k-th and
    (k+1)-th candidate of the k*k shortlist (a diagnostic for parity checks;
    the loop then runs eagerly).
    """
    b, s = memory.shape[:2]
    dec = _RetrDecoder(params, cfg, dk.BEAM_TOPK_KERNEL)

    def new_loop(gen):
        return _BeamLoop(dec.tree, dec.mlp, dec.head_p, cfg, rows=b, beams=beam_size, mem_len=s, max_len=max_len,
                         eos_token=eos_token, length_penalty=length_penalty, early_stop=early_stop,
                         dtype=memory.dtype, device=memory.device, margins=margins)

    def start(loop):
        loop.start(memory, mem_mask, pos, bos_token)

    key, trees = None, dec.trees
    if margins is None and _graphed(memory.device, collectives=True):
        key = graphs.session_key("beam", memory, rows=b, beams=beam_size, max_len=max_len, trees=trees,
                                 extra=(cfg, eos_token, length_penalty, early_stop, CHECK_EVERY))
    return _run(new_loop, start, max_len=max_len, key=key, trees=trees)


def beam_search(params: Params, cfg: Config, samples: Masked, *,
                global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                max_len: int = 128, bos_token: int = 101, eos_token: int = 102, beam_size: int = 5,
                length_penalty: float = 1.0, compute_dtype=torch.float32, early_stop: bool = True,
                filler_idx=None):
    """Batched beam search: encode once, then the KV-cached beam loop. Runs on
    the device the samples are on; ``samples`` may be their :class:`Encoded`."""
    params, memory, mem_mask, pos = _encode_for_decode(params, cfg, samples, global_samples, loc_feats,
                                                       compute_dtype, filler_idx)
    return beam_search_from_memory(params, cfg, memory, mem_mask, pos, max_len=max_len,
                                   bos_token=bos_token, eos_token=eos_token, beam_size=beam_size,
                                   length_penalty=length_penalty, early_stop=early_stop)


def prune_token_ids(idx_seqs: Sequence[Sequence[int]], clean: bool = True, pad_token: int = 0,
                    bos_token: int = 101, eos_token: int = 102) -> List[List[int]]:
    """Cut each sequence at its first EOS; optionally strip PAD/BOS/EOS."""
    results = []
    for seq in idx_seqs:
        pruned = []
        for idx in seq:
            pruned.append(int(idx))
            if idx == eos_token:
                break
        if clean:
            pruned = [i for i in pruned if i not in (pad_token, bos_token, eos_token)]
        results.append(pruned)
    return results


def greedy_decoding(samples: Masked, params: Params, cfg: Config, tokenizer, *,
                    global_samples: Optional[Masked] = None, loc_feats: Optional[torch.Tensor] = None,
                    max_len: int = 128, clean: bool = True, pad_token: int = 0, bos_token: int = 101,
                    eos_token: int = 102, compute_dtype=torch.float32) -> List[str]:
    """Decode, prune and detokenize (retr_tpu.decode.greedy_decoding)."""
    ids = greedy(params, cfg, samples, global_samples=global_samples, loc_feats=loc_feats,
                 max_len=max_len, bos_token=bos_token, eos_token=eos_token, compute_dtype=compute_dtype)
    pruned = prune_token_ids(ids.cpu().tolist(), clean=clean, pad_token=pad_token,
                             bos_token=bos_token, eos_token=eos_token)
    return [tokenizer.decode(seq, skip_special_tokens=True) for seq in pruned]


def greedy_single(params: Params, cfg: Config, samples: Masked, tokenizer, **kwargs) -> str:
    """One image's greedy expression (retr_tpu.decode.greedy_single): the
    batched path at batch 1."""
    return greedy_decoding(samples, params, cfg, tokenizer, **kwargs)[0]
