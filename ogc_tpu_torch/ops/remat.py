"""Rematerialisation of a forward under grad (counterpart of
ogc_tpu/train/seg.py::_resolve_remat / _remat_wrap and the refinement
scan's ``nn.remat``, ogc_tpu/models/flownet.py:537-550).

``checkpoint(fn, mode)`` runs ``fn`` under ``torch.utils.checkpoint`` with
``use_reentrant=False``: ``full`` keeps no activation and recomputes every
one in the backward; ``dots`` keeps the outputs of the matrix products and
convolutions (a selective-checkpoint policy, as ``dots_saveable``) and
recomputes the rest.  For a model, each call of its outermost blocks (the
modules whose class sets ``remat_block``: the SA and FP stages and the
MaskFormer head, FlowStep3D's conv stacks) is a checkpoint of its own, and
the glue between them runs as it is.  One checkpoint around the whole
forward would recompute every activation at once at the start of the
backward, and eager PyTorch then holds them all again: on the card such a
wrap left the peak memory of a step where it was.  Block by block, the
backward holds one block's activations at a time.

Two things the recompute must not do, so that gradients and running
statistics are bit-equal to no remat:

* search again.  Neighbour and sampling selections (``pinned``: FPS, KNN,
  ball query) are kept from the forward and handed back in the recompute in
  call order, as the JAX package pins its tagged indices as saved
  residuals.  The CUDA selections are ctypes launches that a selective
  policy cannot see, so the pinning is a tape of its own: the forward
  records each selection's result with the dispatch modes off (a selective
  policy neither counts nor caches the selection's inner ops), and the
  recompute replays them.
* update state twice.  ``recomputing()`` is true inside the recompute;
  SchedulableBatchNorm then leaves its running statistics alone.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

MODES = ("full", "dots")

_tape: Optional[List] = None  # the active tape
_replay = False               # the active tape is being replayed
_pos = 0                      # the next entry to replay


def resolve(mode: Optional[str], allowed=MODES) -> Optional[str]:
    """The remat mode from a CLI value, or ``OGC_REMAT`` when None: None
    for off (``""``, ``off``, ``0``, ``none``); ValueError for a value
    outside ``allowed``."""
    if mode is None:
        mode = os.environ.get("OGC_REMAT", "")
    mode = (mode or "").lower()
    if mode in ("", "off", "0", "none"):
        return None
    if mode not in allowed:
        raise ValueError(f"remat must be one of off/{'/'.join(allowed)}, "
                         f"got {mode!r}")
    return mode


def recomputing() -> bool:
    """True inside a checkpoint's recompute."""
    return _replay


def pinned(fn: Callable) -> Callable:
    """Record ``fn``'s result in a checkpoint's forward, hand it back in the
    recompute; a plain call elsewhere."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _pos
        if _tape is None:
            return fn(*args, **kwargs)
        if _replay:
            out = _tape[_pos]
            _pos += 1
            return out
        with _disable_current_modes():
            out = fn(*args, **kwargs)
        _tape.append(out)
        return out

    return wrapper


@contextlib.contextmanager
def _tape_ctx(tape: List, replay: bool):
    global _tape, _replay, _pos
    saved = _tape, _replay, _pos
    _tape, _replay, _pos = tape, replay, 0
    try:
        yield
    finally:
        _tape, _replay, _pos = saved


_SAVED_OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
              torch.ops.aten.convolution.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _contexts(mode: str):
    """checkpoint's ``context_fn``: a fresh tape recorded in the forward and
    replayed in the recompute (and, for ``dots``, the selective policy)."""
    tape: List = []
    fwd, rec = _tape_ctx(tape, False), _tape_ctx(tape, True)
    if mode == "full":
        return fwd, rec
    sac_fwd, sac_rec = create_selective_checkpoint_contexts(_save_dots)
    return _both(fwd, sac_fwd), _both(rec, sac_rec)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _checkpointed(fn: Callable, mode: str) -> Callable:
    def run(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(_contexts, mode), **kwargs)

    return run


@contextlib.contextmanager
def _blocks_checkpointed(model: torch.nn.Module, mode: str):
    """Within the block, every outermost ``remat_block`` module of
    ``model`` runs its forward under a checkpoint of its own."""
    patched = []

    def visit(m):
        for child in m.children():
            if not getattr(child, "remat_block", False):
                visit(child)
            elif all(child is not p for p in patched):
                child.forward = _checkpointed(child.forward, mode)
                patched.append(child)

    visit(model)
    try:
        yield
    finally:
        for m in patched:
            del m.forward


def checkpoint(fn: Callable, mode: Optional[str]) -> Callable:
    """``fn`` under the resolved remat ``mode`` (None: ``fn`` itself); a
    model block by block."""
    if mode is None:
        return fn
    if not isinstance(fn, torch.nn.Module):
        return _checkpointed(fn, mode)

    def run(*args, **kwargs):
        with _blocks_checkpointed(fn, mode):
            return fn(*args, **kwargs)

    return run
