"""Structured metric logging.

The reference logs nothing but a prep-time print and a tqdm bar
(HC-SpMM_main.py:54,165); loss/accuracy are never recorded (SURVEY.md §5).
This logger emits JSONL records (stdout and/or file) so every bench config
in BASELINE.json produces machine-readable output.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricLogger:
    def __init__(
        self,
        path: Optional[str] = None,
        stream: Optional[IO] = None,
        context: Optional[dict] = None,
    ):
        self._file = open(path, "a") if path else None
        self._stream = stream
        self._context = context or {}
        self._t0 = time.perf_counter()

    def log(self, **fields) -> dict:
        rec = dict(self._context)
        rec["t"] = round(time.perf_counter() - self._t0, 6)
        rec.update(fields)
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream:
            self._stream.write(line + "\n")
            self._stream.flush()
        return rec

    def close(self):
        if self._file:
            self._file.close()


def stdout_logger(**context) -> MetricLogger:
    return MetricLogger(stream=sys.stdout, context=context)
