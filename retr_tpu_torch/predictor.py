"""High-level inference API: image + bbox -> referring expression (retr_tpu/predictor.py).

Host preprocessing (crop / pad / PIL-exact resize / tokenize, in the C++ core of
``retr_tpu_torch.native`` where it loads), normalization on the device, encode
once, the KV-cached greedy, sampling or beam loop through the CUDA decode
kernels, then pruning and detokenization.

    pred = Predictor(state_dict, cfg, tokenizer, max_batch=32)   # runs on cuda
    pred = Predictor.from_checkpoint("Concat_refcoco_checkpoint_7")   # or a reference .pth
    pred.predict(image, bbox)                          # -> "the woman in the red coat"
    pred.predict_batch(images, bboxes)                 # -> list[str], greedy
    pred.predict_batch(images, bboxes, beam=True)      # beam search, cfg.beam_size beams
    pred.predict_batch(images, bboxes, decoder="sample", seed=7)   # cfg.sample_* knobs
    pred.complete(image, bbox, "the woman")            # completes a forced prefix
    pred.score(images, bboxes, texts)                  # log-likelihood of given texts
    pred.predict_with_attention(image, bbox)           # (text, attention maps)

Each chunk of up to ``max_batch`` requests is padded to ``max_batch`` rows by
repeating its last request, as the JAX package does, so on a CUDA device each
decoder has one graph session (decode.py, ops/graphs.py): its first batch
runs the loop eagerly and captures it, later batches replay it. Sampling draws from a
``torch.Generator`` seeded with ``layers.fold_in(seed, chunk)``, the counterpart
of ``fold_in(key(seed), chunk)``.

:class:`ServingQueue` batches concurrent requests on two threads: a dispatcher
that preprocesses and enqueues each batch's encode, and a collector that runs
its decode loop, waits for its tokens and detokenizes. Admission is bounded;
over the bound ``submit`` raises :class:`ServingOverloaded` with a
Retry-After estimate.
"""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from retr_tpu_torch import decode as decode_mod
from retr_tpu_torch import device as device_mod
from retr_tpu_torch.config import Config
from retr_tpu_torch.data.dataset import collate
from retr_tpu_torch.data.pipeline import device_batch
from retr_tpu_torch.data.preprocess import load_image, preprocess_sample
from retr_tpu_torch.data.tokenizer import prepare_tokenizer
from retr_tpu_torch.masking import Masked
from retr_tpu_torch.models import layers, weights
from retr_tpu_torch.precision import dtype_of
from retr_tpu_torch.train import checkpoints
from retr_tpu_torch.utils import profiling


def _to_host(ids: torch.Tensor):
    """Start the copy of a token buffer to the host: (host tensor, CUDA event
    recorded after the copy, or None on the CPU). Waiting on the event waits for
    this batch only, not for work queued after it on the stream."""
    if ids.device.type != "cuda":
        return ids, None
    host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
    host.copy_(ids, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class Predictor:
    def __init__(self, params_state: Mapping[str, torch.Tensor], cfg: Config, tokenizer=None, *,
                 max_batch: int = 8, device=None):
        """params_state: a reference-named state dict (models/weights.py).
        ``device`` defaults to ``cuda``; without CUDA that raises (pass "cpu")."""
        self.device = device_mod.resolve(device)
        self.cfg = cfg
        self.params = weights.to_params(params_state, cfg, device=self.device)
        self.max_batch = max_batch
        if tokenizer is None:
            tokenizer, _, _ = prepare_tokenizer(cfg.vocab_file)
        self.tokenizer = tokenizer
        self.bos = tokenizer.convert_tokens_to_ids(tokenizer.cls_token)
        self.eos = tokenizer.convert_tokens_to_ids(tokenizer.sep_token)
        self.pad = tokenizer.convert_tokens_to_ids(tokenizer.pad_token)

    # -- construction ---------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "Predictor":
        """A checkpoint directory of ``retr_tpu_torch.main``, with the config it
        was trained with, or a reference ``.pth`` file, with the variant read
        from the file name over ``Config()``'s defaults. ``kw`` go to the
        constructor (``tokenizer``, ``max_batch``, ``device``)."""
        if path.endswith(".pth"):
            cfg = checkpoints.override_config_with_reference_filename(Config(), path)
        else:
            cfg = checkpoints.config_from_checkpoint(path)
        state, _ = checkpoints.load_model_state(path)
        return cls(state, cfg, **kw)

    # -- inference ------------------------------------------------------------------
    def predict(self, image, bbox, *, beam: bool = False, decoder: str = "greedy", seed: int = 0) -> str:
        return self.predict_batch([image], [bbox], beam=beam, decoder=decoder, seed=seed)[0]

    def predict_batch(self, images: Sequence, bboxes: Sequence, *, beam: bool = False,
                      decoder: str = "greedy", seed: int = 0) -> List[str]:
        """images: file paths or HWC uint8 arrays; bboxes: [x, y, w, h] each.

        ``decoder``: 'greedy' | 'beam' | 'sample' (``beam=True`` is shorthand for
        'beam'). 'sample' draws with the cfg sample_* knobs, deterministic per
        ``seed`` and chunk index."""
        if len(images) != len(bboxes):
            raise ValueError(f"{len(images)} images but {len(bboxes)} boxes")
        if beam:
            decoder = "beam"
        if decoder not in ("greedy", "beam", "sample"):
            raise ValueError(f"unknown decoder {decoder!r}")
        out: List[str] = []
        for chunk, i in enumerate(range(0, len(images), self.max_batch)):
            out += self._run_chunk(images[i:i + self.max_batch], bboxes[i:i + self.max_batch], decoder,
                                   seed=seed, chunk=chunk)
        return out

    def complete(self, image, bbox, prefix_text: str) -> str:
        """Greedy completion of a partial expression (decode.greedy_with_prefix):
        ``complete(img, bb, "the woman")`` returns a full expression that starts
        with the given words. Runs at batch 1."""
        batch = self._device_batch([self._preprocess_one(image, bbox)], pad=False)
        ids = [t for t in self.tokenizer.encode(prefix_text) if t not in (self.bos, self.eos, self.pad)]
        max_p = self.cfg.max_position_embeddings - 2
        ids = ids[:max_p]
        prefix = torch.zeros((1, max_p), dtype=torch.int32)
        prefix[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        out = decode_mod.greedy_with_prefix(
            self.params, self.cfg, Masked(batch.images, batch.image_masks), prefix.to(self.device),
            torch.tensor([len(ids)], dtype=torch.int32, device=self.device), **self._common(batch))
        return self._collect(_to_host(out), 1)[0]

    def score(self, images: Sequence, bboxes: Sequence, texts: Sequence[str]) -> List[dict]:
        """Log-likelihoods of candidate expressions for given regions
        (decode.sequence_scores): one dict per request with ``logprob`` (sum over
        real tokens, EOS included), ``n_tokens`` and ``ppl``."""
        if not len(images) == len(bboxes) == len(texts):
            raise ValueError(f"{len(images)} images, {len(bboxes)} boxes and {len(texts)} texts")
        out: List[dict] = []
        for i in range(0, len(images), self.max_batch):
            out += self._score_chunk(images[i:i + self.max_batch], bboxes[i:i + self.max_batch],
                                     texts[i:i + self.max_batch])
        return out

    def _score_chunk(self, images, bboxes, texts) -> List[dict]:
        samples = [self._preprocess_one(im, bb, txt) for im, bb, txt in zip(images, bboxes, texts)]
        true_n = len(samples)
        batch = self._device_batch(samples)
        common = self._common(batch)
        tok_lp, valid = decode_mod.sequence_scores(
            self.params, self.cfg, Masked(batch.images, batch.image_masks), batch.caps, batch.cap_masks,
            global_samples=common["global_samples"], loc_feats=batch.loc_feats,
            compute_dtype=common["compute_dtype"])
        lp = tok_lp[:true_n].cpu().numpy()
        v = valid[:true_n].cpu().numpy()
        out = []
        for row_lp, row_v in zip(lp, v):
            total = float(row_lp[row_v].sum())
            n = int(row_v.sum())
            out.append({"logprob": total, "n_tokens": n, "ppl": float(np.exp(-total / max(n, 1)))})
        return out

    def predict_with_attention(self, image, bbox):
        """One request's expression and attention maps: ``(text, atts)`` with atts
        mapping ``enc_tc_self_att`` / ``dec_exp_self_att`` / ``dec_exp_tc_cross_att``
        to ``[layers, T, S]`` numpy stacks (batch dim removed). Runs at batch 1;
        the maps come from the plain attention core."""
        batch = self._device_batch([self._preprocess_one(image, bbox)], pad=False)
        ids, atts = decode_mod.greedy_with_attention(
            self.params, self.cfg, Masked(batch.images, batch.image_masks), **self._common(batch))
        text = self._collect(_to_host(ids), 1)[0]
        return text, {k: v[:, 0].cpu().numpy() for k, v in atts.items()}

    # -- the batch run, split for ServingQueue --------------------------------------
    def _run_chunk(self, images, bboxes, decoder: str, *, seed: int = 0, chunk: int = 0) -> List[str]:
        return self._collect(*self._dispatch(images, bboxes, decoder, seed=seed, chunk=chunk))

    def _preprocess_one(self, image, bbox, caption: str = ""):
        """Host preprocessing of one request (crop / pad / resize / tokenize).
        Raises on malformed input, per request, so a batcher can fail only the
        request at fault."""
        arr = load_image(image) if isinstance(image, str) else np.asarray(image)
        return preprocess_sample(
            arr, bbox, caption, self.tokenizer,
            image_size=self.cfg.image_size,
            max_length=self.cfg.max_position_embeddings,
            use_global=self.cfg.use_global_features,
            use_location=self.cfg.use_location_features,
        )

    def _dispatch(self, images, bboxes, decoder: str, *, seed: int = 0, chunk: int = 0):
        """Preprocess and decode; returns (pending ids, true_n) for :meth:`_collect`."""
        samples = [self._preprocess_one(im, bb) for im, bb in zip(images, bboxes)]
        return self._dispatch_samples(samples, decoder, seed=seed, chunk=chunk)

    def _device_batch(self, samples, pad: bool = True):
        """Collate on the host (padded to ``max_batch`` rows by repeating the
        last sample, unless ``pad`` is off) and move to the device."""
        samples = list(samples)
        if pad:
            samples += [samples[-1]] * (self.max_batch - len(samples))
        return device_batch(collate(samples), self.device)

    def _common(self, batch) -> dict:
        g = (Masked(batch.global_images, batch.global_masks)
             if batch.global_images is not None else None)
        return dict(global_samples=g, loc_feats=batch.loc_feats,
                    max_len=self.cfg.max_position_embeddings, bos_token=self.bos, eos_token=self.eos,
                    compute_dtype=dtype_of(self.cfg.compute_dtype))

    def _dispatch_samples(self, samples, decoder: str, *, seed: int = 0, chunk: int = 0):
        """Decode already preprocessed samples (see :meth:`_preprocess_one`):
        :meth:`_encode_samples`, then :meth:`_decode_encoded`. Returns
        (pending ids, true_n) for :meth:`_collect`."""
        return self._decode_encoded(self._encode_samples(samples), decoder, seed=seed, chunk=chunk)

    def _encode_samples(self, samples) -> tuple:
        """A batch's encode half: collate, upload and enqueue the encoder.
        Returns (``decode.Encoded``, the decoders' keyword arguments, true_n)
        for :meth:`_decode_encoded`."""
        batch = self._device_batch(samples)
        common = self._common(batch)
        encoded = decode_mod._encode_for_decode(
            self.params, self.cfg, Masked(batch.images, batch.image_masks), common["global_samples"],
            common["loc_feats"], common["compute_dtype"], None)
        return encoded, common, len(samples)

    def _decode_encoded(self, encoded_batch: tuple, decoder: str, *, seed: int = 0, chunk: int = 0):
        """A batch's decode half: the decoder from the output of
        :meth:`_encode_samples`. Returns (pending ids, true_n): on the card
        the ids' copy to pinned host memory is queued with an event behind it,
        so :meth:`_collect` waits for this batch only. The loop itself checks
        the device every ``decode.CHECK_EVERY`` steps, so this returns near
        the decode's end."""
        encoded, common, true_n = encoded_batch
        if decoder == "beam":
            tokens, _ = decode_mod.beam_search(self.params, self.cfg, encoded, beam_size=self.cfg.beam_size,
                                               length_penalty=self.cfg.length_penalty, **common)
            ids = tokens[:, 0]
        elif decoder == "sample":
            gen = layers.make_generator(layers.fold_in(seed, chunk), self.device)
            ids = decode_mod.sample(self.params, self.cfg, encoded, gen, temperature=self.cfg.sample_temperature,
                                    top_k=self.cfg.sample_top_k, top_p=self.cfg.sample_top_p, **common)
        else:
            ids = decode_mod.greedy(self.params, self.cfg, encoded, **common)
        return _to_host(ids[:true_n]), true_n

    def _collect(self, pending, true_n: int) -> List[str]:
        host, done = pending
        if done is not None:
            done.synchronize()
        pruned = decode_mod.prune_token_ids(
            host[:true_n].tolist(), clean=True, pad_token=self.pad, bos_token=self.bos, eos_token=self.eos)
        return self.tokenizer.batch_decode(pruned)


class ServingOverloaded(RuntimeError):
    """Raised by ServingQueue.submit when the bounded request queue is full.

    Shedding at once keeps the tail latency bounded under overload, where an
    unbounded queue would answer every request after minutes.
    ``retry_after_s`` estimates when capacity frees up (the drain time of the
    queue and the batches in flight), for an HTTP Retry-After header.
    """

    def __init__(self, retry_after_s: float):
        super().__init__(f"serving queue full; retry after ~{retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class ServingQueue:
    """Dynamic batcher over a Predictor, with a dispatch and a collect stage.

    Requests submitted from any thread are coalesced into batches of up to
    ``predictor.max_batch``; a batch is dispatched as soon as it is full or its
    oldest request has waited ``max_wait_s``. Each ``submit`` returns a
    ``concurrent.futures.Future[str]``.

    Admission control: at most ``max_queued`` requests stand in the queue
    (default ``4 * predictor.max_batch``); a submit beyond that raises
    :class:`ServingOverloaded` at once. ``stats()`` reports the accepted and
    rejected counts and the smoothed per-batch service time behind the
    Retry-After estimate.

    The DISPATCHER preprocesses each request (a malformed one fails only its own
    future), collates, uploads and enqueues the encoder
    (``Predictor._encode_samples``); the COLLECTOR runs the decode loop from
    that encoder output (``Predictor._decode_encoded``), waits for the
    batch's tokens, detokenizes and resolves the futures. So the card decodes
    batch n while the dispatcher coalesces, preprocesses and encodes batch
    n+1; both enqueue on the one stream, which runs the work in that order.
    Up to ``pipeline_depth`` encoded batches wait between them; a full
    pipeline blocks the dispatcher, whose next batch then keeps filling. On a
    CUDA device the loop replays captured graphs, one host call per
    ``decode.CHECK_EVERY`` steps (the first batch of a decoder captures them,
    under the session's lock and thread-local, while the dispatcher may
    encode), eagerly elsewhere. Both threads run on the predictor's device.
    Batch ``n`` of the queue's life (counted as the dispatcher hands it on)
    samples with seed ``(0, n)``; a batch whose encode or decode fails fails
    its own futures.

    Spans (``utils/profiling.py``, attributes ``batch``, ``request``,
    ``rows``): ``serve.queue_wait`` per request (submit to its batch
    closed); per batch ``serve.coalesce`` (its first request taken to its
    close), ``serve.preprocess`` and ``serve.dispatch`` (collate, upload, the
    encoder's enqueue) on the dispatcher, ``serve.decode`` (the loop, its
    ``decode.stop_check`` spans inside) on the collector.

        q = ServingQueue(pred)
        futs = [q.submit(img, bbox) for img, bbox in requests]
        texts = [f.result() for f in futs]
        q.close()
    """

    def __init__(self, predictor: Predictor, *, max_wait_s: float = 0.05, beam: bool = False,
                 decoder: str = "greedy", pipeline_depth: int = 2, max_queued: Optional[int] = None):
        self.predictor = predictor
        self.max_wait_s = max_wait_s
        self.decoder = "beam" if beam else decoder
        if self.decoder not in ("greedy", "beam", "sample"):
            raise ValueError(f"unknown decoder {self.decoder!r}")
        # bounded admission, unbounded container: submit() sheds under the lock,
        # so close()'s sentinel can always be posted
        self.max_queued = max_queued if max_queued is not None else 4 * predictor.max_batch
        self._q: "queue.Queue" = queue.Queue()
        self._flight: "queue.Queue" = queue.Queue(maxsize=max(pipeline_depth, 1))
        self._closed = False
        self._close_lock = threading.Lock()  # makes the closed check and the enqueue atomic
        self._accepted = 0
        self._rejected = 0
        self._batches = 0   # batches encoded and handed to the collector
        self._rows = 0      # their real rows (requests preprocessed without error)
        self._decoded = 0   # batches whose decode half has returned or raised
        self._decoded_behind = 0   # batches begun while an earlier one was still to decode
        # EMA of the per-batch service time (collect to collect), seeded with the window
        self._batch_s = max_wait_s
        self._last_collect_t: Optional[float] = None
        dev = predictor.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._dispatcher.start()
        self._collector.start()

    def _on_device(self):
        return torch.cuda.device(self._device) if self._device.type == "cuda" else contextlib.nullcontext()

    def _retry_after_estimate(self) -> float:
        """Drain time of the standing queue and the batches in flight at the
        smoothed per-batch service time."""
        batches_ahead = (self._q.qsize() / max(self.predictor.max_batch, 1) + self._flight.qsize() + 1)
        return max(self.max_wait_s, batches_ahead * self._batch_s)

    def submit(self, image, bbox) -> "Future[str]":
        # The lock pairs the closed check with the enqueue: a submit racing
        # close() must not land behind the shutdown sentinel, where its future
        # would never resolve.
        with self._close_lock:
            if self._closed:
                raise RuntimeError("ServingQueue is closed")
            # submits serialize on this lock and the workers only remove items,
            # so qsize() can only over-count here: shedding errs early
            if self._q.qsize() >= self.max_queued:
                self._rejected += 1
                raise ServingOverloaded(self._retry_after_estimate())
            fut: "Future[str]" = Future()
            self._q.put((image, bbox, fut, self._accepted, profiling.now()))
            self._accepted += 1
        return fut

    def stats(self) -> dict:
        """Admission and serving counters; ``decoded_behind`` counts the
        batches whose first request was taken while an earlier batch was
        still to decode (how often the dispatcher works beside a decode);
        ``graph_captures`` and ``graph_evictions`` are the process's
        (``graphs.captures``, ``graphs.evictions``)."""
        graph = profiling.counters()
        return {
            "accepted": self._accepted,
            "rejected": self._rejected,
            "queued": self._q.qsize(),
            "in_flight_batches": self._flight.qsize(),
            "batch_service_s": self._batch_s,
            "max_queued": self.max_queued,
            "batches": self._batches,
            "rows": self._rows,
            "decoded_behind": self._decoded_behind,
            "graph_captures": graph.get("graphs.captures", 0),
            "graph_evictions": graph.get("graphs.evictions", 0),
        }

    def close(self, *, wait: bool = True) -> None:
        """Stop accepting requests; drain what is queued, then stop the workers."""
        with self._close_lock:
            already = self._closed
            self._closed = True
            if not already:
                self._q.put(None)
        if wait:
            self._dispatcher.join()
            self._collector.join()

    def _next_batch(self, b: int) -> tuple:
        """Block for the first request, then coalesce batch ``b`` until full
        or max_wait_s; its ``serve.coalesce`` span and its requests'
        ``serve.queue_wait`` spans end when it closes. Returns the batch (None
        once closed) and whether an earlier batch was still to decode when
        its first request was taken."""
        first = self._q.get()
        if first is None:
            return None, False
        behind = self._decoded < self._batches
        started = profiling.now()
        batch = [first]
        t_end = time.monotonic() + self.max_wait_s
        while len(batch) < self.predictor.max_batch:
            try:
                item = self._q.get(timeout=max(t_end - time.monotonic(), 0.0))
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-post the sentinel: the worker exits next round
                break
            batch.append(item)
        if profiling.recording():
            closed = profiling.now()
            profiling.record("serve.coalesce", started, closed, batch=b)
            for item in batch:
                profiling.record("serve.queue_wait", item[4], closed, request=item[3], batch=b)
        return batch, behind

    def _dispatch_loop(self) -> None:
        with self._on_device():
            self._dispatch_batches()

    def _dispatch_batches(self) -> None:
        for b in itertools.count():
            batch, behind = self._next_batch(b)
            if batch is None:
                # nothing can land behind the sentinel (the submit lock), but
                # fail anything left rather than leave a future unresolved
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        item[2].set_exception(RuntimeError("ServingQueue is closed"))
                self._flight.put(None)  # collector shutdown
                return
            samples, ok_futs = [], []
            with profiling.span("serve.preprocess", batch=b, rows=len(batch)):
                for image, bbox, fut, _, _ in batch:
                    try:
                        samples.append(self.predictor._preprocess_one(image, bbox))
                        ok_futs.append(fut)
                    except Exception as exc:  # this request's input is at fault: fail it alone
                        fut.set_exception(exc)
            if not samples:
                continue
            try:
                with profiling.span("serve.dispatch", batch=b, rows=len(samples)):
                    encoded = self.predictor._encode_samples(samples)
            except Exception as exc:  # a device failure fails the whole batch
                for f in ok_futs:
                    f.set_exception(exc)
                continue
            chunk = self._batches
            self._batches += 1
            self._rows += len(samples)
            self._decoded_behind += behind
            self._flight.put((b, chunk, encoded, ok_futs))  # blocks at depth: back-pressure

    def _decode(self, b: int, chunk: int, encoded: tuple, futs: list):
        """The collector's decode half of batch ``b``; returns (pending ids, true_n)."""
        try:
            with profiling.span("serve.decode", batch=b, rows=len(futs)):
                return self.predictor._decode_encoded(encoded, self.decoder, chunk=chunk)
        finally:
            self._decoded += 1

    def _collect_loop(self) -> None:
        with self._on_device():
            while True:
                item = self._flight.get()
                if item is None:
                    return
                b, chunk, encoded, futs = item
                try:
                    texts = self.predictor._collect(*self._decode(b, chunk, encoded, futs))
                except Exception as exc:  # a device failure fails the whole batch
                    for f in futs:
                        f.set_exception(exc)
                    continue
                # in a saturated pipeline the collect-to-collect interval is the batch rate
                now = time.monotonic()
                if self._last_collect_t is not None:
                    self._batch_s = 0.8 * self._batch_s + 0.2 * (now - self._last_collect_t)
                self._last_collect_t = now
                for f, t in zip(futs, texts):
                    f.set_result(t)
