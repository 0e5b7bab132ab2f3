"""Checkpoints written with ``torch.save`` to ``<name>.pth.tar``.

Evaluation reads ``{"model_state": state_dict}``, the reference format
(utils/pytorch_util.py:84-99).  Training writes the full train state --
``model_state``, ``optimizer_state`` and ``epoch`` -- to
``<save_path>_R<round>/current`` and copies it to ``best`` when the
validation loss improves, so a run can resume and the evaluation reads the
same file.  Under data parallelism rank 0 alone writes (ogc_tpu/utils/
checkpoint.py:91), and every rank waits for the write; every rank resumes
from the same file.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Dict

import torch

from ogc_tpu_torch.parallel import mesh

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
    raw = load_train_state(path)
    return raw["model_state"] if "model_state" in raw else raw


def save_train_state(state: dict, is_best: bool, filename: str,
                     bestname: str) -> str:
    """Write ``state`` to ``filename + ".pth.tar"``; copy it to
    ``bestname + ".pth.tar"`` when ``is_best``."""
    out = filename + SUFFIX
    os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    torch.save(state, out + ".tmp")
    os.replace(out + ".tmp", out)
    if is_best:
        shutil.copyfile(out, bestname + SUFFIX)
    return out


def save_trainer(model: torch.nn.Module, optimizer, epoch: int,
                 is_best: bool, filename: str, bestname: str) -> str:
    """The full train state of a trainer -- ``model_state`` (the
    state_dict on the CPU), ``optimizer_state`` and ``epoch`` -- through
    ``save_train_state``, written by rank 0; every rank returns once it is
    on disk."""
    if mesh.is_main():
        state = {"model_state": {k: v.detach().cpu()
                                 for k, v in model.state_dict().items()},
                 "optimizer_state": optimizer.state_dict(), "epoch": epoch}
        save_train_state(state, is_best, filename, bestname)
    mesh.barrier()
    return filename + SUFFIX


def resume_trainer(model: torch.nn.Module, optimizer, path: str) -> int:
    """Restore what ``save_trainer`` wrote into ``model`` and
    ``optimizer``; returns the epoch."""
    state = load_train_state(path)
    model.load_state_dict(state["model_state"])
    optimizer.load_state_dict(state["optimizer_state"])
    return int(state["epoch"])


def load_train_state(path: str) -> dict:
    """Read what ``torch.save`` wrote at ``path`` or ``path + ".pth.tar"``
    (a full train state saved by ``save_train_state``)."""
    if not osp.exists(path) and osp.exists(path + SUFFIX):
        path = path + SUFFIX
    return torch.load(path, map_location="cpu", weights_only=True)
