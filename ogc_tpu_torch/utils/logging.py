"""Scalar logging to JSONL (the JsonlWriter of ogc_tpu/utils/logging.py).

One line per scalar, ``{"t", "tag", "value", "step"}``, appended to
``<log_dir>/scalars.jsonl``; the trainer calls ``add_scalar`` like a
TensorBoard SummaryWriter.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class JsonlWriter:
    """Minimal SummaryWriter-compatible scalar logger."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None):
        self._f.write(
            json.dumps(
                {"t": time.time(), "tag": tag, "value": float(value),
                 "step": global_step}
            )
            + "\n"
        )

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
