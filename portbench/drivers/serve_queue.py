"""Serving: open-loop Poisson arrivals into ``predictor.ServingQueue``.

Set-up loads ``images`` pool images into memory (HWC uint8 arrays, what
``serve.py`` hands the queue after decoding a request), builds the
``Predictor`` and the queue, and warms them with full batches (the graph
session's eager call and capture, the native core's build). The window offers
one request at each due time of the arrival schedule (a fixed set of
exponential gaps at ``rate`` per second in an order drawn from the seed; each
request a pool image and a RefCOCO-like box drawn from the seed). With
``--trace 1`` the window is the queue at work at the cell's own rate for
``min(--seconds, TRACED_SECONDS)``, inside the profiler: the warmed queue is
closed, the profiler starts, a fresh queue on the same ``Predictor`` takes
the window's requests, and the profiler stops once that queue's threads have
ended (see profiler.Trace). A
request's latency runs from its due time to the moment its future resolves,
so a stall of the offering thread counts against the requests it delays; a
shed or failed request is a miss. After the last due time the driver waits
up to ``grace_s`` for every future.

Traffic keys: ``rate``, ``images``, ``max_batch``, ``max_wait_s``,
``pipeline_depth``, ``decoder``, ``grace_s``, ``judge_captions``.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

from portbench import profiler, synth
from portbench.drivers import common

# the traced window's length: about 150 batches of the queue at the cell's rate
TRACED_SECONDS = 10.0


class Driver:
    def __init__(self, cell: common.Cell):
        self.cell = cell
        # every row decodes max_position_embeddings - 1 steps (EOS unreachable)
        self.steps = cell.cfg.max_position_embeddings - 1
        self.profile = None

    def setup(self) -> None:
        from retr_tpu_torch.predictor import Predictor

        c, t = self.cell, self.cell.traffic
        rng = np.random.default_rng([c.seed % (1 << 63), 13])
        picked = rng.choice(synth.POOL_IMAGES, t["images"], replace=False)
        self.images = [synth.load_pool_image(c.coco, int(i)) for i in picked]
        self.state = c.state_dict(decode=True)
        tokenizer = c.tokenizer()
        self.pred = Predictor(self.state, c.cfg, tokenizer, max_batch=t["max_batch"], device=c.device)
        self.bos = self.pred.bos
        self.rng = rng
        warm = [self._request() for _ in range(t["max_batch"])]
        for _ in range(2):
            self.pred.predict_batch([im for im, _ in warm], [b for _, b in warm], decoder=t["decoder"])
        self.open_queue()
        for f in [self.queue.submit(im, b) for im, b in warm]:
            f.result()

    def open_queue(self) -> None:
        """A fresh ServingQueue on the warmed Predictor (each window closes its queue)."""
        from retr_tpu_torch.predictor import ServingQueue

        t = self.cell.traffic
        self.queue = ServingQueue(self.pred, max_wait_s=t["max_wait_s"], pipeline_depth=t["pipeline_depth"],
                                  decoder=t["decoder"])

    def _request(self):
        i = int(self.rng.integers(len(self.images)))
        h, w = self.images[i].shape[:2]
        return self.images[i], synth.draw_box(self.rng, h, w)

    def window(self, seconds: float, trace: bool) -> dict:
        if not trace:
            return self._offer(seconds)
        # the profiler starts and stops while no thread of a queue runs CUDA work
        self.queue.close(wait=True)
        tr = profiler.Trace()
        tr.start()
        try:
            self.open_queue()
            return self._offer(min(seconds, TRACED_SECONDS))
        finally:
            self.profile = tr.stop()

    def _offer(self, seconds: float) -> dict:
        from retr_tpu_torch.predictor import ServingOverloaded

        t = self.cell.traffic
        offsets = synth.arrival_offsets(t["rate"], seconds, self.cell.seed)
        n = len(offsets)
        self.requests = [self._request() for _ in range(n)]
        self.futures = [None] * n
        self.done_at = [None] * n
        self.shed = 0
        lock = threading.Lock()
        late = []

        def resolved(i):
            def cb(_fut):
                with lock:
                    self.done_at[i] = time.perf_counter()
            return cb

        start = time.perf_counter() + 0.05
        self.due = start + offsets

        def offer(lo, hi):
            for i in range(lo, hi):
                wait = self.due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late.append(time.perf_counter() - self.due[i])
                try:
                    fut = self.queue.submit(*self.requests[i])
                except ServingOverloaded:
                    self.shed += 1
                    continue
                self.futures[i] = fut
                fut.add_done_callback(resolved(i))

        offer(0, n)
        close = self.due[-1] if n else start
        deadline = close + t["grace_s"]
        for f in self.futures:
            if f is not None:
                try:
                    f.exception(timeout=max(deadline - time.perf_counter(), 0.0))
                except TimeoutError:
                    pass
        self.queue.close(wait=True)
        miss = deadline
        with lock:
            lat = np.array([(d if d is not None else miss) - due for d, due in zip(self.done_at, self.due)])
        self.errors = sum(1 for f in self.futures if f is not None and f.done() and f.exception() is not None)
        self.unanswered = sum(1 for f in self.futures if f is not None and not f.done())
        print(f"serve: {n} requests at {t['rate']} /s, shed {self.shed}, errors {self.errors}, "
              f"unanswered {self.unanswered}, p50 {np.percentile(lat, 50) * 1e3:.2f} ms, "
              f"generator lateness max {max(late, default=0) * 1e3:.3f} ms "
              f"p99 {np.percentile(late, 99) * 1e3 if late else 0:.3f} ms, queue {self.queue.stats()}",
              file=sys.stderr)
        return {"latency_p95_ms": float(np.percentile(lat, 95, method="inverted_cdf")) * 1e3,
                "latency_p50_ms": float(np.percentile(lat, 50, method="inverted_cdf")) * 1e3,
                "lateness_max_ms": max(late, default=0.0) * 1e3, "offered_per_s": n / seconds}

    def counts(self) -> tuple:
        return len(self.futures), self.shed + self.errors + self.unanswered

    def release(self) -> None:
        del self.pred, self.queue
        common.release()

    def judge(self, control: bool = False) -> dict:
        c = self.cell
        served = [i for i, f in enumerate(self.futures) if f is not None and f.done() and f.exception() is None]
        pick = [served[k] for k in common.draw_sample(len(served), c.traffic["judge_captions"], c.seed)]
        out = common.judge_captions(c.model_cfg, self.state, [self.requests[i] for i in pick],
                                    [self.futures[i].result() for i in pick], bos=self.bos, steps=self.steps,
                                    device=c.device, image_side=c.cfg.image_size, control=control)
        out["unreadable"] = common.served_ids([self.futures[i].result() for i in served], self.steps)[1]
        out["unanswered"] = self.unanswered
        out["errors"] = self.errors
        return out

    def context(self) -> dict:
        return {"profile": self.profile, "spans": {}, "cfg": self.cell.model_cfg, "traffic": self.cell.traffic}
