"""YAML config loading with the reference's flat merge into args
(counterpart of ogc_tpu/utils/config.py; reference train_seg.py:250-258).

The compute dtype comes from ``OGC_COMPUTE_DTYPE`` or the config's
``compute_dtype`` (bf16 or f32; absent is f32), as in the JAX package.
"""

from __future__ import annotations

import argparse
import os

import torch
import yaml

from ogc_tpu_torch.nn.layers import set_compute_dtype


def apply_compute_dtype(configs: dict) -> None:
    """Set nn/layers.py's compute dtype from the env or the config; reset
    to float32 when neither names one.  Raises on any other name."""
    dt = os.environ.get("OGC_COMPUTE_DTYPE") or configs.get("compute_dtype")
    dt = str(dt or "f32").lower()
    if dt in ("bf16", "bfloat16"):
        set_compute_dtype(torch.bfloat16)
    elif dt in ("f32", "float32", "none"):
        set_compute_dtype(None)
    else:
        raise ValueError(f"compute_dtype must be bf16 or f32, got {dt!r}")


def load_config_into_args(args: argparse.Namespace) -> argparse.Namespace:
    """Merge the YAML at ``args.config`` into the namespace (flat)."""
    with open(args.config) as f:
        configs = yaml.safe_load(f)
    for k, v in configs.items():
        setattr(args, k, v)
    apply_compute_dtype(configs)
    return args
