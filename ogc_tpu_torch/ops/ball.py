"""Exact ball query: the CUDA kernel (csrc/ball_query.cu) and its plain
PyTorch version.

Replaces ogc_tpu/ops/pallas_knn.py::_ball_exact_pruned_kernel (and the
exact-ball mode of ::_knn_kernel), plus the ``_fill_balls`` padding that
ogc_tpu/ops/core.py applies to their output: both versions return the filled
ball.  ``ball_query_exact`` routes by the tensors' device: CPU tensors take
``ball_query_plain``; CUDA tensors launch the kernel or raise.
``ball_query_exact.launches`` counts kernel launches.  The kernel also
serves the block-min ball query (ops/knn_blockmin.py) with runs of ``blk``
candidates; ``launch_ball`` launches it for both.
"""

from __future__ import annotations

import numpy as np
import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.knn import check_clouds, pair_d2, plain_dtype


def radius_sq(radius: float) -> float:
    """r^2 as the JAX package compares it: the double product rounded to
    float32 (a Python float threshold against float32 distances)."""
    return float(np.float32(float(radius) * float(radius)))


def fill_balls(cand: torch.Tensor, nsample: int,
               n_valid_below: int) -> torch.Tensor:
    """Reference ball padding (ogc_tpu/ops/core.py::_fill_balls): slots
    beyond the in-radius count repeat the first in-radius index; an empty
    ball is all zeros.  ``cand`` is ascending, invalid keys >= n_valid_below."""
    count = (cand < n_valid_below).sum(-1, keepdim=True)
    slot = torch.arange(nsample, device=cand.device)
    idx = torch.where(slot < count, cand, cand[..., :1])
    return torch.where(count > 0, idx, 0).to(torch.int32)


def ball_query_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int, chunk: int = 1024) -> torch.Tensor:
    """Direct-form d2, key ``where(d2 < r^2, i, N + i)``, the nsample
    smallest keys, then ``fill_balls``.  Centres go in chunks so the
    (B, chunk, N) tiles stay bounded.

    :param xyz: (B, N, 3) points; :param new_xyz: (B, M, 3) centres.
    :return: (B, M, nsample) int32.
    """
    p = xyz.to(plain_dtype(xyz))
    N = p.shape[1]
    r2 = radius_sq(radius)
    ids = torch.arange(N, device=p.device)
    k_eff = min(nsample, N)
    cands = []
    for c in new_xyz.to(plain_dtype(new_xyz)).split(chunk, dim=1):
        key = torch.where(pair_d2(c, p) < r2, ids, N + ids)
        cands.append(torch.topk(key, k_eff, dim=-1, largest=False,
                                sorted=True).values)
    cand = torch.cat(cands, 1)
    if k_eff < nsample:  # fewer points than slots: pad with an invalid key
        cand = torch.cat([cand, cand.new_full(
            (*cand.shape[:2], nsample - k_eff), 2 * N)], -1)
    return fill_balls(cand, nsample, N)


def launch_ball(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                nsample: int, blk: int, n_pad: int) -> torch.Tensor:
    """Launch csrc/ball_query.cu on CUDA tensors: runs of ``blk`` candidates
    (1: the exact ball), the points padded to ``n_pad`` (= N when exact)
    with points at 1e6.  Returns the filled balls (B, M, nsample) int32."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    xyz = xyz.contiguous()
    new_xyz = new_xyz.contiguous()
    idx = _build.empty((B, M, nsample), torch.int32, xyz.device)
    if B * M == 0:
        return idx
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = _build.lib().ogc_ball_query(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, n_pad, nsample, blk,
        radius_sq(radius), idx.data_ptr(), stream)
    _build.check(err, "ogc_ball_query")
    return idx


def ball_query_exact(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int) -> torch.Tensor:
    """The nsample lowest in-radius indices (strict d2 < r^2) of each
    centre, filled as the reference fills them: (B, M, nsample) int32."""
    if xyz.device.type == "cpu" and new_xyz.device.type == "cpu":
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    check_clouds("ball_query_exact", xyz, new_xyz, "xyz", "new_xyz")
    if nsample < 1:
        raise ValueError(f"ball_query_exact: nsample={nsample} must be >= 1")
    idx = launch_ball(xyz, new_xyz, radius, nsample, 1, xyz.shape[1])
    if idx.numel():
        ball_query_exact.launches += 1
    return idx


ball_query_exact.launches = 0
