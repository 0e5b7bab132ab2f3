"""YAML config loading with the reference's flat merge into args
(counterpart of ogc_tpu/utils/config.py; reference train_seg.py:250-258).

The port runs float32 only, so a config that asks for another compute dtype
is refused rather than run in float32.
"""

from __future__ import annotations

import argparse

import yaml


def load_config_into_args(args: argparse.Namespace) -> argparse.Namespace:
    """Merge the YAML at ``args.config`` into the namespace (flat)."""
    with open(args.config) as f:
        configs = yaml.safe_load(f)
    dt = str(configs.get("compute_dtype") or "f32").lower()
    if dt not in ("f32", "float32", "none"):
        raise NotImplementedError(
            f"compute_dtype {dt!r}: the port runs float32 only")
    for k, v in configs.items():
        setattr(args, k, v)
    return args
