"""Furthest point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Replaces ogc_tpu/ops/pallas_kernels.py::_fps_kernel.  ``fps`` routes by the
tensor's device: a CPU tensor takes ``fps_plain``; a CUDA tensor launches the
kernel or raises.  ``fps.launches`` counts kernel launches and
``fps.cluster_launches`` those of the cluster instance.  ``fps_plan``
picks the compiled instance for a cloud of N points: points a thread,
threads of a CTA, whether x, y, z sit in registers, and the CTAs a cloud
(one up to ``MAX_N`` points; above it, up to ``MAX_N_CLUSTER``, a cluster
of 4-16 CTAs that each hold a slice of the cloud).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.knn import plain_dtype

# The clouds the kernel takes: the largest N of the parent kernel, which
# held 16 bytes a point in one CTA's shared memory.
MAX_N = (227 * 1024 - 1024) // 16
# fps_plan's table, from chip_smoke.py's fps_crossover (each compiled
# instance timed at every path shape): up to N points, that many points a
# thread with x, y, z in registers; above the last, SHARED_PPT a thread
# with x, y, z read from shared memory.
PLAN = ((512, 1), (2048, 4), (4095, 8), (8192, 32))
SHARED_PPT = 16
# Above MAX_N a cloud takes a thread-block cluster: CTA r holds the slice
# [r S, r S + S) of S = ceil(N / CTAs) consecutive points, 32 a thread in
# registers (at most 256 threads, CLUSTER_POINTS points), and the CTAs
# exchange their winners through distributed shared memory.  The CTAs a
# cloud, from chip_smoke.py's check_fps_large (every cluster size timed at
# 16384 to 131072 points): as few as hold the cloud, but at least
# MIN_CLUSTER (four 4096-point slices beat two 8192-point ones), at most
# MAX_CLUSTER (above 8, the portable size, the kernel opts in to larger
# clusters).  So the kernel takes clouds of up to MAX_N_CLUSTER points.
CLUSTER_POINTS = 8192
MIN_CLUSTER, MAX_CLUSTER = 4, 16
MAX_N_CLUSTER = MAX_CLUSTER * CLUSTER_POINTS


class FpsPlan(NamedTuple):
    ppt: int  # points a thread
    threads: int  # threads of the cloud's CTA
    reg_xyz: bool  # x, y, z in registers (else read from shared memory)
    cluster: int = 1  # CTAs a cloud


@functools.lru_cache(maxsize=None)
def fps_plan(n: int) -> FpsPlan:
    """The instance for a cloud of ``n`` points: up to MAX_N one CTA with
    the points a thread of the first row of PLAN that takes ``n`` and as
    many threads as the cloud needs; above it a cluster of CTAs with 32
    points a thread."""
    if not 1 <= n <= MAX_N_CLUSTER:
        raise ValueError(f"fps_plan: N={n} outside 1..{MAX_N_CLUSTER}")
    if n > MAX_N:
        return cluster_plan(n, max(MIN_CLUSTER, -(-n // CLUSTER_POINTS)))
    ppt, reg = next(((p, True) for top, p in PLAN if n <= top),
                    (SHARED_PPT, False))
    return FpsPlan(ppt, max(32, -(-n // (32 * ppt)) * 32), reg)


def cluster_plan(n: int, cluster: int) -> FpsPlan:
    """The cluster instance over ``cluster`` CTAs for a cloud of ``n``
    points (chip_smoke.py times the other cluster sizes with it)."""
    s = -(-n // cluster)
    return FpsPlan(32, max(32, -(-s // 1024) * 32), True, cluster)


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy FPS from index 0; the lowest index among the maxima wins.

    :param xyz: (B, N, 3) float32 (float64 runs in float64).
    :return: (B, npoint) int32.
    """
    B, N, _ = xyz.shape
    x = xyz.to(plain_dtype(xyz))
    col = torch.arange(N, device=x.device)
    rows = torch.arange(B, device=x.device)
    min_d2 = torch.full((B, N), 1e10, dtype=x.dtype, device=x.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=x.device)
    last = torch.zeros(B, dtype=torch.long, device=x.device)
    for i in range(1, npoint):
        d = x - x[rows, last][:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        top = min_d2.max(dim=1, keepdim=True).values
        last = torch.where(min_d2 == top, col, N).min(dim=1).values
        out[:, i] = last.to(torch.int32)
    return out


def _launch(xyz: torch.Tensor, npoint: int, plan: FpsPlan) -> torch.Tensor:
    """Launches the kernel's instance ``plan`` on a CUDA ``xyz`` that
    ``fps`` has checked; ``chip_smoke.py``'s crossover calls it with other
    compiled instances.  A plan the kernel was not compiled for raises."""
    B, N, _ = xyz.shape
    xyz = xyz.contiguous()
    out = _build.empty((B, npoint), torch.int32, xyz.device)
    err = _build.lib().ogc_fps(
        xyz.data_ptr(), B, N, npoint, plan.ppt, plan.threads,
        int(plan.reg_xyz), plan.cluster, out.data_ptr(),
        _build.raw_stream(xyz.device.index))
    _build.check(err, f"ogc_fps {tuple(plan)}")
    fps.launches += 1
    if plan.cluster > 1:
        fps.cluster_launches += 1
    return out


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 FPS indices; npoint may
    exceed N (the indices past the N-th are 0)."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps: want (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    N = xyz.shape[1]
    if not 1 <= N <= MAX_N_CLUSTER:
        raise ValueError(f"fps: N={N} outside the kernel's "
                         f"1..{MAX_N_CLUSTER}")
    if npoint < 1:
        raise ValueError(f"fps: npoint={npoint} must be positive")
    if npoint <= N:
        return _launch(xyz, npoint, fps_plan(N))
    # More samples than points (a sparse outdoor cloud): after N steps
    # every min_d2 is 0, so every later step picks index 0, as the plain
    # version does.
    out = _launch(xyz, N, fps_plan(N))
    return torch.cat([out, out.new_zeros((out.shape[0], npoint - N))], 1)


fps.launches = 0
fps.cluster_launches = 0
