"""Synthetic RefCOCO: the image pool, the splits, the vocabulary and the arrivals.

- The pool: ``POOL_IMAGES`` COCO-sized images (longer side 640, COCO's mix of
  landscape and portrait; smooth colour fields, a few flat-shaded objects and
  sensor noise, so the resize and the crops see image-like content), saved by
  ``np.save`` under COCO's ``.jpg`` names, which the program's
  ``preprocess.load_image`` reads by their magic bytes (the card's machine has
  no Pillow, so nothing there decodes a JPEG). The pool does not depend on the
  seed: it is built once per checkout under ``.portbench_cache/`` (about 1.8
  GB, in parallel threads) and read by every later run, as COCO's files are.
- A split, from the seed: which pool images, the boxes (area 2-60 % of the
  image, aspect 1:3 to 3:1, as RefCOCO's boxes are spread), the expressions
  (words of the vocabulary, RefCOCO's lengths) and their order. Its sizes are
  fixed by the traffic file, so every seed carries the same amount of work.
  Annotation files go under ``TMPDIR``.
- The vocabulary: 30,522 ids whose names are distinct plain words, with
  BERT's special ids, written to a ``vocab.txt`` both sides read. A served
  string therefore names every served id, and the reference reads them back.
- Arrivals: an open-loop schedule whose gaps are one fixed set of exponential
  draws, in an order drawn from the seed (every seed offers the same load).
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

POOL_IMAGES = 2048
POOL_VERSION = "pool-v1"
SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102}
_NAMES = {v: k for k, v in SPECIALS.items()}
# RefCOCO's expression lengths in words (mean ~3.6), as weights over 1..12
FIRST_WORD = 104        # the first id after BERT's specials
LENGTH_WEIGHTS = np.array([8, 18, 22, 18, 12, 8, 5, 3, 2, 2, 1, 1], np.float64)


def cache_root(checkout: str) -> str:
    return os.path.join(checkout, ".portbench_cache")


def token_name(i: int) -> str:
    return _NAMES.get(i, f"w{i}")


def write_vocab(path: str, vocab_size: int) -> str:
    """``vocab.txt`` with ``token_name(i)`` on line i."""
    if not os.path.exists(path):
        tmp = f"{path}.part"
        with open(tmp, "w") as f:
            f.write("\n".join(token_name(i) for i in range(vocab_size)) + "\n")
        os.replace(tmp, path)
    return path


def parse(text: str) -> list:
    """A served string back to its ids (the inverse of the vocabulary's names);
    an unknown word gives -1."""
    out = []
    for word in text.split():
        if word in SPECIALS:
            out.append(SPECIALS[word])
        elif word[:1] == "w" and word[1:].isdigit():
            out.append(int(word[1:]))
        else:
            out.append(-1)
    return out


# ---------------------------------------------------------------------------------
# The image pool
# ---------------------------------------------------------------------------------


def image_id(i: int) -> int:
    return 1000 + i


def image_path(coco_dir: str, i: int) -> str:
    return os.path.join(coco_dir, "train2014", f"COCO_train2014_{image_id(i):012d}.jpg")


def image_size(i: int) -> tuple:
    """(h, w) of pool image i: longer side 640, COCO's common shorter sides."""
    rng = np.random.default_rng([7, i])
    short = int(rng.choice([480, 427, 426, 424, 428, 360, 512, 640, 457, 500]))
    return (short, 640) if rng.random() < 0.7 else (640, short)


def make_image(i: int) -> np.ndarray:
    rng = np.random.default_rng([11, i])
    h, w = image_size(i)
    gh, gw = 6, 8
    field = rng.uniform(30, 225, (gh, gw, 3)).astype(np.float32)
    ys = np.linspace(0, gh - 1, h, dtype=np.float32)
    xs = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, gh - 1), np.minimum(x0 + 1, gw - 1)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = field[y0][:, x0] * (1 - fx) + field[y0][:, x1] * fx
    bot = field[y1][:, x0] * (1 - fx) + field[y1][:, x1] * fx
    img = top * (1 - fy) + bot * fy
    for _ in range(int(rng.integers(3, 9))):
        bh, bw = int(rng.integers(h // 10, h // 2)), int(rng.integers(w // 10, w // 2))
        y, x = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
        shade = np.linspace(0.8, 1.2, bw, dtype=np.float32)[None, :, None]
        img[y:y + bh, x:x + bw] = rng.uniform(0, 255, 3).astype(np.float32) * shade
    img += 8 * rng.standard_normal(img.shape, dtype=np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


_POOL_LOCK = threading.Lock()


def ensure_pool(checkout: str, workers: int = 8) -> str:
    """Build the pool once per checkout; returns the COCO directory."""
    coco = os.path.join(cache_root(checkout), POOL_VERSION, "coco")
    done = os.path.join(coco, "complete")
    with _POOL_LOCK:
        if os.path.exists(done):
            return coco
        os.makedirs(os.path.join(coco, "train2014"), exist_ok=True)

        def write(i):
            path = image_path(coco, i)
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.part"
                with open(tmp, "wb") as f:
                    np.save(f, make_image(i))
                os.replace(tmp, path)

        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(write, range(POOL_IMAGES)))
        open(done, "w").close()
    return coco


def load_pool_image(coco: str, i: int) -> np.ndarray:
    return np.load(image_path(coco, i), allow_pickle=False)


# ---------------------------------------------------------------------------------
# Boxes, expressions and splits
# ---------------------------------------------------------------------------------


def draw_box(rng, h: int, w: int) -> list:
    """A RefCOCO-like box [x, y, w, h]: area 2-60 % of the image (log-uniform),
    aspect w/h 1:3-3:1 (log-uniform), inside the image, sides >= 16 px."""
    area = np.exp(rng.uniform(np.log(0.02), np.log(0.6))) * h * w
    aspect = np.exp(rng.uniform(np.log(1 / 3), np.log(3)))
    bw = float(np.clip(np.sqrt(area * aspect), 16, w - 1))
    bh = float(np.clip(np.sqrt(area / aspect), 16, h - 1))
    x = float(rng.uniform(0, w - bw))
    y = float(rng.uniform(0, h - bh))
    return [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)]


def draw_expression(rng, vocab_size: int) -> str:
    n = int(rng.choice(len(LENGTH_WEIGHTS), p=LENGTH_WEIGHTS / LENGTH_WEIGHTS.sum())) + 1
    return " ".join(token_name(int(t)) for t in rng.integers(FIRST_WORD, vocab_size, n))


def counts(total: int, n: int, rng) -> np.ndarray:
    """``n`` whole counts that sum to ``total`` and differ by at most one, in
    an order drawn from ``rng`` (the same multiset for every seed)."""
    base = np.full(n, total // n)
    base[: total - base.sum()] += 1
    return rng.permutation(base)


def write_split(root: str, seed: int, spec: dict, vocab_size: int) -> dict:
    """A synthetic RefCOCO split under ``root`` in RE:TR's on-disk formats
    (``instances.json``, ``refs(unc).p``). ``spec``: ``images`` (how many of the
    pool), ``objects``, ``expressions`` (totals), ``partition`` ("val" or
    "train"). Returns {"ref_base", "records": [(ann_id, pool index, box,
    [expressions])]} in annotation order."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 3])
    picked = np.sort(rng.choice(POOL_IMAGES, spec["images"], replace=False))
    per_image = counts(spec["objects"], spec["images"], rng)
    per_object = counts(spec["expressions"], spec["objects"], rng)
    annotations, refs, records = [], [], []
    sent_id = 0
    for i, n_obj in zip(picked.tolist(), per_image.tolist()):
        h, w = image_size(i)
        for _ in range(n_obj):
            a = len(annotations)
            box = draw_box(rng, h, w)
            sents = [draw_expression(rng, vocab_size) for _ in range(int(per_object[a]))]
            annotations.append({"id": a, "image_id": image_id(i), "bbox": box, "category_id": 1})
            refs.append({"ann_id": a, "ref_id": a, "image_id": image_id(i), "split": spec["partition"],
                         "file_name": f"COCO_train2014_{image_id(i):012d}_{a}.jpg",
                         "sentences": [{"sent_id": sent_id + k, "sent": s} for k, s in enumerate(sents)]})
            sent_id += len(sents)
            records.append((a, i, box, sents))
    ref_dir = os.path.join(root, "refs", "refcoco")
    os.makedirs(ref_dir, exist_ok=True)
    with open(os.path.join(ref_dir, "instances.json"), "w") as f:
        json.dump({"annotations": annotations}, f)
    with open(os.path.join(ref_dir, "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)
    return {"ref_base": os.path.join(root, "refs"), "records": records}


# ---------------------------------------------------------------------------------
# Open-loop arrivals
# ---------------------------------------------------------------------------------


def arrival_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson process at ``rate``
    over ``seconds``: a fixed set of exponential gaps (mean 1/rate, drawn from
    a constant seed, rescaled so they end at ``seconds``), put in an order
    drawn from ``seed``."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(20240501).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([int(seed) % (1 << 63), 5]).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]
