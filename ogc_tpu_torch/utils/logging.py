"""Scalar logging to JSONL (the JsonlWriter of ogc_tpu/utils/logging.py).

One line per scalar, ``{"t", "tag", "value", "step"}``, appended to
``<log_dir>/scalars.jsonl``; the trainer calls ``add_scalar`` like a
TensorBoard SummaryWriter.  Under data parallelism only rank 0 writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ogc_tpu_torch.parallel import mesh


class JsonlWriter:
    """Minimal SummaryWriter-compatible scalar logger; on a rank other than
    0 it writes nothing."""

    def __init__(self, log_dir: str):
        self._f = None
        if mesh.is_main():
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, global_step: Optional[int] = None):
        if self._f is None:
            return
        self._f.write(
            json.dumps(
                {"t": time.time(), "tag": tag, "value": float(value),
                 "step": global_step}
            )
            + "\n"
        )

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
