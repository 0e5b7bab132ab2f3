"""Exact k-nearest neighbours: the CUDA kernel (csrc/knn_exact.cu) and its
plain PyTorch version.

Replaces ogc_tpu/ops/pallas_knn.py::_knn_exact_kernel and
::_knn_exact_kernel_removal.  ``knn_exact`` routes by the tensor's device: a
CPU tensor takes ``knn_exact_plain``; a CUDA tensor launches the kernel or
raises.  ``knn_exact.launches`` counts kernel launches.  ``knn_plan`` picks
the kernel: one thread per query with its list in registers for k up to
``THREAD_MAX_K`` when there are queries enough to fill the card
(``THREAD_MIN_QUERIES``), else one warp per query (a ballot, a survivor
buffer and a merge into a shared-memory list of (d2 bits, index) keys).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ogc_tpu_torch.ops import _build

MAX_K = 64


def plain_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' dtype: float32, as the kernels compute, or
    float64 for float64 tensors (the CPU tests' float64 runs)."""
    return torch.promote_types(x.dtype, torch.float32)


def pair_d2(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Direct-form d2 of every (query, point) pair in float32 (float64 for
    float64 clouds), as the kernels compute it: points minus query per
    coordinate, then ((dx*dx + dy*dy) + dz*dz).
    (B, N, 3) x (B, M, 3) -> (B, N, M)."""
    dt = torch.promote_types(plain_dtype(query), plain_dtype(points))
    q, p = query.to(dt), points.to(dt)
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return (dx * dx + dy * dy) + dz * dz


def check_clouds(fn: str, a: torch.Tensor, b: torch.Tensor, an: str,
                 bn: str) -> None:
    """Raise unless ``a`` and ``b`` are (B, *, 3) float32 CUDA tensors of
    one batch size on one device (the kernels' inputs)."""
    for name, t in ((an, a), (bn, b)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} on {t.device}")
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"{fn}: want (B, *, 3) float32 {name}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if a.shape[0] != b.shape[0] or a.device != b.device:
        raise ValueError(f"{fn}: {an} and {bn} disagree on batch/device")


def knn_exact_plain(query: torch.Tensor, points: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form d2, stable sort (ties to the lower index), first k.

    :param query: (B, N, 3); :param points: (B, M, 3); requires k <= M.
    :return: (dist (B, N, k) float32 (float64 for float64 clouds)
        = sqrt(max(d2, 0)), idx (B, N, k) int32).
    """
    d2s, idx = torch.sort(pair_d2(query, points), dim=-1, stable=True)
    return (torch.sqrt(torch.clamp(d2s[..., :k], min=0.0)),
            idx[..., :k].to(torch.int32))


#: The thread-per-query kernel takes k <= THREAD_MAX_K over at least
#: THREAD_MIN_QUERIES queries (B x N: 512 blocks of 128 threads, ~4 per SM);
#: the warp kernel takes the rest (csrc/knn_exact.cu).  The crossover
#: measured on the H100 (chip_smoke.py's knn_crossover) is in PERF.md.
THREAD_MAX_K = 8
THREAD_MIN_QUERIES = 65536
#: List capacities the kernels are compiled for: the thread kernel's
#: register list, and the warp kernel's k <= 32 or k <= 64.
THREAD_KCAP = (4, 8)
WARP_KCAP = (32, 64)


def knn_plan(k: int, queries: int,
             variant: Optional[str] = None) -> Tuple[str, int]:
    """(kernel, list capacity) for k over ``queries`` (B x N) queries:
    ``"thread"`` for k <= THREAD_MAX_K over >= THREAD_MIN_QUERIES queries,
    else ``"warp"``, unless ``variant`` names one."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_plan: k={k} outside 1..{MAX_K}")
    variant = variant or (
        "thread" if k <= THREAD_MAX_K and queries >= THREAD_MIN_QUERIES
        else "warp")
    caps = {"thread": THREAD_KCAP, "warp": WARP_KCAP}[variant]
    if k > caps[-1]:
        raise ValueError(f"knn_plan: the {variant} kernel takes k <= "
                         f"{caps[-1]}, not {k}")
    return variant, next(c for c in caps if k <= c)


def knn_exact(query: torch.Tensor, points: torch.Tensor, k: int,
              variant: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN, ascending d2, ties to the lower index; requires k <= M.
    ``variant`` (``"thread"`` or ``"warp"``) overrides ``knn_plan``'s
    choice of kernel on the card."""
    if query.is_cpu and points.is_cpu:
        return knn_exact_plain(query, points, k)
    check_clouds("knn_exact", query, points, "query", "points")
    B, N, _ = query.shape
    M = points.shape[1]
    if not 1 <= k <= min(M, MAX_K):
        raise ValueError(f"knn_exact: k={k} must be in 1..min(M={M}, {MAX_K})")
    kernel, _ = knn_plan(k, B * N, variant)
    if not query.is_contiguous():
        query = query.contiguous()
    if not points.is_contiguous():
        points = points.contiguous()
    dev = query.get_device()
    dist = _build.empty((B, N, k), torch.float32, dev)
    idx = _build.empty((B, N, k), torch.int32, dev)
    if B * N == 0:
        return dist, idx
    err = _build.lib().ogc_knn_exact(
        query.data_ptr(), points.data_ptr(), B, N, M, k,
        int(kernel == "warp"), dist.data_ptr(), idx.data_ptr(),
        _build.raw_stream(dev))
    if err:
        _build.check(err, "ogc_knn_exact")
    knn_exact.launches += 1
    return dist, idx


knn_exact.launches = 0
