"""Model checkpoints in the reference format: ``{"model_state": state_dict}``
written with ``torch.save`` to ``<name>.pth.tar`` (reference
utils/pytorch_util.py:84-99)."""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import torch

SUFFIX = ".pth.tar"


def weight_path(save_path: str, round_: int = 0) -> str:
    """``<save_path>[_R<round>]/best`` (test_seg.py:132-136)."""
    if round_ > 0:
        save_path = save_path + "_R%d" % round_
    return osp.join(save_path, "best")


def save_model_state(state_dict: Dict[str, torch.Tensor], path: str) -> str:
    """Write ``{"model_state": state_dict}`` to ``path + ".pth.tar"``."""
    out = path + SUFFIX
    os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    torch.save({"model_state": state_dict}, out)
    return out


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """Read the state_dict saved at ``path`` or ``path + ".pth.tar"``."""
    if not osp.exists(path) and osp.exists(path + SUFFIX):
        path = path + SUFFIX
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return raw["model_state"] if "model_state" in raw else raw
