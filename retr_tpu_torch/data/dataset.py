"""RefCOCO caption dataset and batched loader with background prefetch
(retr_tpu/data/dataset.py).

- :class:`RefCocoCaptions` reads the reference's annotation files
  (``data/annotations.py``) and does the host half of preprocessing per
  sample: decode, crop, pad, the PIL-exact resize and the tokenizer
  (``data/preprocess.py``). ``return_unique`` keeps the first sentence per
  ann_id (refcoco.py:82-91). Images are read by ``read_image(path)``, by
  default ``preprocess.load_image`` (PIL, as the JAX package decodes, or
  ``np.load`` for a file saved by ``np.save``); decoded images are kept in a thread-safe LRU cache.
- :func:`build_dataset` selects the partition (train/val/testA/testB/test,
  refcoco.py:207-220).
- :class:`DataLoader` shuffles with ``np.random.default_rng(seed + epoch)``,
  shards (``shard=(index, count)``), drops the ragged last batch on request,
  and prefetches batches from a thread pool (the JPEG decode and the native
  resize release the GIL). Its batches equal the JAX package's bit for bit.
- :func:`collate` stacks samples into a :class:`HostBatch`; uint8 images and
  bool masks go to the device in one upload (``data/pipeline.py``).
"""

from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from retr_tpu_torch.data import annotations as ann_mod
from retr_tpu_torch.data.preprocess import Sample, load_image, preprocess_sample


class HostBatch(NamedTuple):
    """Stacked numpy arrays, pre-device. None fields per the feature-flag matrix."""

    ann_ids: np.ndarray
    target_images: np.ndarray   # [B, S, S, 3] uint8
    target_masks: np.ndarray    # [B, S, S] bool
    caps: np.ndarray            # [B, T+1] int32
    cap_masks: np.ndarray       # [B, T+1] bool
    context_images: Optional[np.ndarray] = None
    context_masks: Optional[np.ndarray] = None
    loc_feats: Optional[np.ndarray] = None


def pad_host_batch(host: HostBatch, to_size: int) -> HostBatch:
    """Repeat the final row until the batch has ``to_size`` rows (ann_ids
    too); callers slice the padded rows back off. ``eval_model`` pads its
    ragged last batch so that every decode sees the loader's batch size."""
    b = host.target_images.shape[0]
    if b >= to_size:
        return host
    reps = to_size - b

    def pad(x):
        if x is None:
            return None
        return np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)

    return HostBatch(*(pad(f) for f in host))


class RefCocoCaptions:
    """Annotation-backed dataset; __getitem__ does the host half of preprocessing."""

    def __init__(
        self,
        records: List[dict],
        root: str,
        tokenizer,
        *,
        max_length: int = 128,
        image_size: int = 224,
        return_unique: bool = False,
        return_global_context: bool = False,
        return_location_features: bool = False,
        image_cache_size: int = 256,
        read_image: Optional[Callable[[str], np.ndarray]] = None,
    ):
        self.root = root
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.return_global_context = return_global_context
        self.return_location_features = return_location_features
        self.read_image = read_image or load_image
        # decoded-image LRU, shared by the prefetch threads: RefCOCO has ~3
        # annotations per COCO image
        self._img_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._img_cache_lock = threading.Lock()
        self.image_cache_size = image_cache_size

        # (ann_id, filename, caption, bbox) tuples, reference layout (refcoco.py:74-75)
        self.annot = [
            (r["ann_id"], ann_mod.image_filename(r["image_id"]), r["caption"], r["bbox"])
            for r in records
        ]
        if return_unique:  # first sentence per ann_id (refcoco.py:82-91)
            seen = set()
            self.annot_select = []
            for a in self.annot:
                if a[0] not in seen:
                    seen.add(a[0])
                    self.annot_select.append(a)
        else:
            self.annot_select = self.annot

    def __len__(self) -> int:
        return len(self.annot_select)

    def _load_image(self, filename: str) -> np.ndarray:
        if self.image_cache_size > 0:
            with self._img_cache_lock:
                img = self._img_cache.get(filename)
                if img is not None:
                    self._img_cache.move_to_end(filename)
                    return img
        img = self.read_image(os.path.join(self.root, "train2014", filename))
        if self.image_cache_size > 0:
            with self._img_cache_lock:
                self._img_cache[filename] = img
                while len(self._img_cache) > self.image_cache_size:
                    self._img_cache.popitem(last=False)
        return img

    def __getitem__(self, idx: int) -> Sample:
        ann_id, filename, caption, bbox = self.annot_select[idx]
        image = self._load_image(filename)
        return preprocess_sample(
            image, bbox, caption, self.tokenizer,
            ann_id=ann_id, image_size=self.image_size, max_length=self.max_length,
            use_global=self.return_global_context,
            use_location=self.return_location_features,
        )


def build_dataset(config, mode: str = "training", tokenizer=None, return_unique: bool = False,
                  read_image: Optional[Callable[[str], np.ndarray]] = None) -> RefCocoCaptions:
    """Reference build_dataset (refcoco.py:191-255): partition select + dataset."""
    mode_l = mode.lower()
    valid = ["training", "train", "validation", "val", "testa", "testb", "test"]
    if mode_l not in valid:
        raise ValueError(f"mode {mode} not in {valid}")

    rows, ids = ann_mod.get_refcoco_data(config.ref_dir)
    partition = {
        "training": "train", "train": "train",
        "validation": "val", "val": "val",
        "testa": "testA", "testb": "testB", "test": "test",
    }[mode_l]
    wanted = set(ids["caption_ids"][partition])
    records = [r for r in rows if r["sent_id"] in wanted]
    if config.limit > 0:
        records = records[: config.limit]

    if tokenizer is None:
        from retr_tpu_torch.data.tokenizer import prepare_tokenizer

        tokenizer, _, _ = prepare_tokenizer(config.vocab_file)

    return RefCocoCaptions(
        records, config.dir, tokenizer,
        max_length=config.max_position_embeddings, image_size=config.image_size,
        return_unique=return_unique,
        return_global_context=config.use_global_features,
        return_location_features=config.use_location_features,
        read_image=read_image,
    )


def collate(samples: List[Sample]) -> HostBatch:
    first = samples[0]
    return HostBatch(
        ann_ids=np.asarray([s.ann_id for s in samples], np.int64),
        target_images=np.stack([s.target_image for s in samples]),
        target_masks=np.stack([s.target_mask for s in samples]),
        caps=np.stack([s.caption_ids for s in samples]),
        cap_masks=np.stack([s.caption_mask for s in samples]),
        context_images=(
            np.stack([s.context_image for s in samples]) if first.context_image is not None else None
        ),
        context_masks=(
            np.stack([s.context_mask for s in samples]) if first.context_mask is not None else None
        ),
        loc_feats=np.stack([s.loc_feats for s in samples]) if first.loc_feats is not None else None,
    )


class DataLoader:
    """Batched iterator with shuffling and background thread prefetch.

    ``num_workers`` threads preprocess samples concurrently; ``prefetch_depth``
    batches are staged ahead. A worker's exception is raised to the consumer.

    ``shard=(index, count)`` keeps every count-th sample starting at ``index``,
    trimmed to ``len(dataset) // count`` samples: disjoint, equal-sized
    shards, consistent across processes because the shuffle permutation is
    seeded identically (seed + epoch) everywhere before slicing. Each
    iteration advances ``epoch``; the engine pins it to the epoch it runs.
    """

    def __init__(
        self,
        dataset: RefCocoCaptions,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch_depth: int = 2,
        shard: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.epoch = 0
        if shard is not None:
            index, count = shard
            if not (0 <= index < count):
                raise ValueError(f"shard index {index} outside [0, {count})")
        self.shard = shard

    def _shard_size(self) -> int:
        n = len(self.dataset)
        return n if self.shard is None else n // self.shard[1]

    def __len__(self) -> int:
        n = self._shard_size()
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.shard is not None:
            index, count = self.shard
            idx = idx[index::count][: len(idx) // count]  # equal size on every process
        batches = [idx[i : i + self.batch_size].tolist() for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[HostBatch]:
        from concurrent.futures import ThreadPoolExecutor

        batches = self._index_batches()
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not put(collate(samples)):
                            return
                put(None)
            except BaseException as exc:  # noqa: BLE001 — relayed to the consumer
                put(exc)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
