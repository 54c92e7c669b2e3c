"""Timestamped console lines and a JSONL metrics file (counterpart of
``motion324_tpu/utils/logging.py``, which imports JAX)."""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Any, Mapping

__all__ = ["log", "MetricsLogger"]


def log(*args) -> None:
    now = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
    print(now, *args, flush=True)


class MetricsLogger:
    """Appends one JSON object per logged step to ``<dir>/metrics.jsonl``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._file = open(self.path, "a")

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
