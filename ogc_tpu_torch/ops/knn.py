"""Exact k-nearest neighbours: the CUDA kernel (csrc/knn_exact.cu) and its
plain PyTorch version.

Replaces ogc_tpu/ops/pallas_knn.py::_knn_exact_kernel and
::_knn_exact_kernel_removal.  ``knn_exact`` routes by the tensor's device: a
CPU tensor takes ``knn_exact_plain``; a CUDA tensor launches the kernel or
raises.  ``knn_exact.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ogc_tpu_torch.ops import _build

MAX_K = 64


def knn_exact_plain(query: torch.Tensor, points: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form d2, stable sort (ties to the lower index), first k.

    :param query: (B, N, 3); :param points: (B, M, 3); requires k <= M.
    :return: (dist (B, N, k) float32 = sqrt(max(d2, 0)), idx (B, N, k) int32).
    """
    q = query.float()
    p = points.float()
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    d2 = (dx * dx + dy * dy) + dz * dz  # (B, N, M)
    del dx, dy, dz
    d2s, idx = torch.sort(d2, dim=-1, stable=True)
    return (torch.sqrt(torch.clamp(d2s[..., :k], min=0.0)),
            idx[..., :k].to(torch.int32))


def knn_exact(query: torch.Tensor, points: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN, ascending d2, ties to the lower index; requires k <= M."""
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_exact_plain(query, points, k)
    for name, t in (("query", query), ("points", points)):
        if t.device.type != "cuda":
            raise ValueError(f"knn_exact: {name} on {t.device}")
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"knn_exact: want (B, *, 3) float32 {name}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    B, N, _ = query.shape
    M = points.shape[1]
    if points.shape[0] != B or query.device != points.device:
        raise ValueError("knn_exact: query and points disagree on batch/device")
    if not 1 <= k <= min(M, MAX_K):
        raise ValueError(f"knn_exact: k={k} must be in 1..min(M={M}, {MAX_K})")
    query = query.contiguous()
    points = points.contiguous()
    dist = torch.empty((B, N, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=query.device)
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = _build.lib().ogc_knn_exact(
        query.data_ptr(), points.data_ptr(), B, N, M, k, dist.data_ptr(),
        idx.data_ptr(), stream)
    _build.check(err, "ogc_knn_exact")
    knn_exact.launches += 1
    return dist, idx


knn_exact.launches = 0
