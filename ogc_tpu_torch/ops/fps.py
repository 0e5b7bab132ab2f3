"""Furthest point sampling: the CUDA kernel (csrc/fps.cu) and its plain
PyTorch version.

Replaces ogc_tpu/ops/pallas_kernels.py::_fps_kernel.  ``fps`` routes by the
tensor's device: a CPU tensor takes ``fps_plain``; a CUDA tensor launches the
kernel or raises.  ``fps.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ogc_tpu_torch.ops import _build

# 16 bytes of dynamic shared memory per point (x, y, z, min_d2) must fit in
# the 227 KB a block may use, next to the kernel's static reduction buffers.
MAX_N = (227 * 1024 - 1024) // 16


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


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 FPS indices."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps: want (B, N, 3) float32, got "
                         f"{tuple(xyz.shape)} {xyz.dtype}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"fps: N={N} outside the kernel's 1..{MAX_N}")
    if not 1 <= npoint <= N:
        raise ValueError(f"fps: npoint={npoint} must be in 1..N={N}")
    xyz = xyz.contiguous()
    out = _build.empty((B, npoint), torch.int32, xyz.device)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = _build.lib().ogc_fps(xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                               stream)
    _build.check(err, "ogc_fps")
    fps.launches += 1
    return out


fps.launches = 0
