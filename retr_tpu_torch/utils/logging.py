"""Structured JSONL metric logging.

A copy of retr_tpu/utils/logging.py: the port imports nothing of retr_tpu.

The reference's observability is stdout prints + tqdm (SURVEY.md §5); per-epoch
scalars exist only in checkpoint files. Here every scalar lands in an append-only
JSONL stream with wall-clock timestamps, greppable and machine-readable.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional, TextIO


class MetricLogger:
    def __init__(self, path: Optional[str] = None, also_stdout: bool = True):
        self._fh: Optional[TextIO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.also_stdout = also_stdout

    def log(self, event: str, **fields: Any) -> None:
        rec = {"t": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self.also_stdout and event != "train_step":  # step spam stays in the file
            print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
