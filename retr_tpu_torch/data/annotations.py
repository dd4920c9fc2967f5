"""RefCOCO/RefCOCO+/RefCOCOg annotation pipeline.

A copy of retr_tpu/data/annotations.py: the port imports nothing of retr_tpu.

Reads the same on-disk formats as the reference (data_utils/utils.py:67-147):
``instances.json`` (COCO instances) and ``refs(unc).p`` / ``refs(umd).p`` (pickled
list of referring-expression records), producing one row per *sentence* keyed by
sent_id with columns ann_id / caption / ref_id / refcoco_split / coco_split /
image_id / bbox / category_id, plus per-partition id lists.

Implementation is plain dict/list wrangling (no pandas dependency in the hot path —
the reference's pandas merge is an offline-startup convenience, not a capability);
a DataFrame view is available for interop.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Tuple


def _coco_split_of(file_name: str) -> str | None:
    for split in ("train", "val", "test"):
        if split in file_name:
            return split
    return None


def load_annotations(path: str) -> List[dict]:
    """One record per sentence, merged with its instance's image_id/bbox/category_id.

    Equivalent to get_refcoco_df (utils.py:67-91): refs pickle x instances.json join
    on ann_id, exploded over each record's sentences.
    """
    with open(os.path.join(path, "instances.json")) as f:
        instances = json.load(f)
    by_ann: Dict[int, dict] = {a["id"]: a for a in instances["annotations"]}

    refs_name = "refs(umd).p" if path.rstrip("/").endswith("refcocog") else "refs(unc).p"
    with open(os.path.join(path, refs_name), "rb") as f:
        refs = pickle.load(f)

    rows: List[dict] = []
    for ref in refs:
        ann = by_ann[ref["ann_id"]]
        for sent in ref["sentences"]:
            rows.append(
                {
                    "sent_id": sent["sent_id"],
                    "ann_id": ref["ann_id"],
                    "caption": sent["sent"],
                    "ref_id": ref["ref_id"],
                    "refcoco_split": ref["split"],
                    "coco_split": _coco_split_of(ref["file_name"]),
                    "image_id": ann["image_id"],
                    "bbox": ann["bbox"],
                    "category_id": ann["category_id"],
                }
            )
    return rows


def get_refcoco_data(path: str) -> Tuple[List[dict], dict]:
    """Reference get_refcoco_data (utils.py:94-118): (records, split-id dict)."""
    rows = load_annotations(path)
    partitions = sorted({r["refcoco_split"] for r in rows})
    image_ids: Dict[str, list] = {}
    caption_ids: Dict[str, list] = {}
    for part in partitions:
        part_rows = [r for r in rows if r["refcoco_split"] == part]
        seen = dict.fromkeys(r["image_id"] for r in part_rows)
        image_ids[part] = list(seen)
        caption_ids[part] = [r["sent_id"] for r in part_rows]
    return rows, {"image_ids": image_ids, "caption_ids": caption_ids}


def to_dataframe(rows: List[dict]):
    """Optional pandas view matching the reference's DF (indexed by sent_id).
    pandas is imported here only: nothing on the training or evaluation path
    calls this."""
    import pandas as pd

    return pd.DataFrame(rows).set_index("sent_id")


def image_filename(image_id: int, prefix: str = "COCO_train2014_", ending: str = ".jpg") -> str:
    """Zero-padded COCO filename (refcoco.py:98-100)."""
    return f"{prefix}{str(image_id).zfill(12)}{ending}"
