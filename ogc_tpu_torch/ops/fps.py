"""Furthest point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Replaces ogc_tpu/ops/pallas_kernels.py::_fps_kernel.  ``fps`` routes by the
tensor's device: a CPU tensor takes ``fps_plain``; a CUDA tensor launches the
kernel or raises.  ``fps.launches`` counts kernel launches.  ``fps_plan``
picks the compiled instance for a cloud of N points: points a thread,
threads of the cloud's CTA, and whether x, y, z sit in registers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ogc_tpu_torch.ops import _build

# The clouds the kernel takes: the largest N of the parent kernel, which
# held 16 bytes a point in one CTA's shared memory.
MAX_N = (227 * 1024 - 1024) // 16
# fps_plan's table, from chip_smoke.py's fps_crossover (each compiled
# instance timed at every path shape): up to N points, that many points a
# thread with x, y, z in registers; above the last, SHARED_PPT a thread
# with x, y, z read from shared memory.
PLAN = ((512, 1), (2048, 4), (4095, 8), (8192, 32))
SHARED_PPT = 16


class FpsPlan(NamedTuple):
    ppt: int  # points a thread
    threads: int  # threads of the cloud's CTA
    reg_xyz: bool  # x, y, z in registers (else read from shared memory)


@functools.lru_cache(maxsize=None)
def fps_plan(n: int) -> FpsPlan:
    """The instance for a cloud of ``n`` points: the points a thread of the
    first row of PLAN that takes ``n``, with as many threads as the cloud
    needs."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fps_plan: N={n} outside 1..{MAX_N}")
    ppt, reg = next(((p, True) for top, p in PLAN if n <= top),
                    (SHARED_PPT, False))
    return FpsPlan(ppt, max(32, -(-n // (32 * ppt)) * 32), reg)


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy FPS from index 0; the lowest index among the maxima wins.

    :param xyz: (B, N, 3) float32.  :return: (B, npoint) int32.
    """
    B, N, _ = xyz.shape
    x = xyz.float()
    col = torch.arange(N, device=x.device)
    rows = torch.arange(B, device=x.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=x.device)
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
        int(plan.reg_xyz), out.data_ptr(),
        _build.raw_stream(xyz.device.index))
    _build.check(err, f"ogc_fps {tuple(plan)}")
    fps.launches += 1
    return out


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 FPS indices."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps: want (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    N = xyz.shape[1]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"fps: N={N} outside the kernel's 1..{MAX_N}")
    if not 1 <= npoint <= N:
        raise ValueError(f"fps: npoint={npoint} must be in 1..N={N}")
    return _launch(xyz, npoint, fps_plan(N))


fps.launches = 0
