"""Mask matching by IoU for the invariance loss: the CUDA kernel
(csrc/iou_match.cu) and its plain version on the host.

``iou_match(seg1, seg2, k)`` takes two (B, N) int64 argmax label maps of
``k`` slots and returns ``col_ind`` (B, k) int64 on their device: seg2's
slot matched to each of seg1's by the maximum-IoU linear assignment
(losses/seg_unsup.py::match_mask_by_iou).  It routes by the tensors'
device: a CPU tensor takes ``iou_match_plain`` (the numpy IoU and
utils/lap.py's solver); a CUDA tensor launches the kernel, which computes
the same float32 IoU and repeats the solver's steps, so it returns the same
columns on tied matrices too, or raises.  ``iou_match.launches`` counts
kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.utils.lap import linear_sum_assignment

# The most slots the kernel takes: one warp owns the columns, a lane each.
MAX_K = 32


def iou_match_plain(seg1: torch.Tensor, seg2: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The host path: CPU (B, N) labels -> (B, k) int64 on the CPU.  The
    IoU of the one-hot masks in float32, iou[b, g, p] of seg1's slot g and
    seg2's slot p, then utils/lap.py's maximum-IoU assignment."""
    eye = np.eye(k, dtype=np.float32)
    oh1, oh2 = eye[seg1.numpy()], eye[seg2.numpy()]
    inter = np.einsum("bng,bnp->bgp", oh1, oh2)
    union = oh1.sum(1)[..., None] + oh2.sum(1)[:, None, :] - inter
    iou = inter / np.maximum(union, np.float32(1e-10))
    return torch.from_numpy(linear_sum_assignment(iou, True).astype(np.int64))


def iou_match(seg1: torch.Tensor, seg2: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N) int64 labels in [0, k) -> (B, k) int64 ``col_ind`` on their
    device."""
    if seg1.device.type == "cpu":
        return iou_match_plain(seg1, seg2, k)
    if seg1.device.type != "cuda" or seg2.device != seg1.device:
        raise ValueError(f"iou_match: unsupported devices {seg1.device}, "
                         f"{seg2.device}")
    if (seg1.dim() != 2 or seg1.shape != seg2.shape
            or seg1.dtype != torch.int64 or seg2.dtype != torch.int64):
        raise ValueError(f"iou_match: want two (B, N) int64 label maps, got "
                         f"{tuple(seg1.shape)} {seg1.dtype} and "
                         f"{tuple(seg2.shape)} {seg2.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"iou_match: {k} slots outside the kernel's "
                         f"1..{MAX_K}")
    B, N = seg1.shape
    seg1, seg2 = seg1.contiguous(), seg2.contiguous()
    out = _build.empty((B, k), torch.int64, seg1.device)
    err = _build.lib().ogc_iou_match(
        seg1.data_ptr(), seg2.data_ptr(), B, N, k, out.data_ptr(),
        _build.raw_stream(seg1.device.index))
    _build.check(err, "ogc_iou_match")
    iou_match.launches += 1
    return out


iou_match.launches = 0
