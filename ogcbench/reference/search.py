"""Neighbour search and sampling for the plain reference: frozen copies of
the port's plain versions (greedy FPS, exact KNN, exact ball query, the
block-min approximate KNN and ball query, the ball fill) and of the gates
that pick the approximate search, in plain PyTorch.

Exact KNN selects by the packed key (d2 bits, index) with ``topk``, which
is the stable sort's first k: ascending direct-form d2, ties to the lower
index.  Distances are sqrt(d2) rounded once from float64 (the correctly
rounded float32 sqrt).  Every search runs in chunks of queries so that its
(B, chunk, M) tiles stay bounded at the benchmark's sizes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

TILE = 1024            # block-min candidate padding
PAD = 1e6              # block-min pad coordinate
BALL_INVALID = 2 ** 30
RECALL_LARGE_K, RECALL_SMALL_K = 0.95, 0.99
CHUNK = 512


def pair_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """((dx*dx + dy*dy) + dz*dz) of every (query, point) pair in float32,
    points minus query per coordinate: (B, n, 3) x (B, M, 3) -> (B, n, M)."""
    q, p = q.float(), p.float()
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return (dx * dx + dy * dy) + dz * dz


def _sqrt(d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(d2, min=0.0).double()).float()


def radius_sq(radius: float) -> float:
    return float(np.float32(float(radius) * float(radius)))


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy FPS from index 0, the lowest index among the maxima:
    (B, N, 3) -> (B, npoint) int64."""
    B, N, _ = xyz.shape
    x = xyz.float()
    col = torch.arange(N, device=x.device)
    rows = torch.arange(B, device=x.device)
    min_d2 = torch.full((B, N), 1e10, dtype=x.dtype, device=x.device)
    out = torch.zeros((B, npoint), dtype=torch.long, device=x.device)
    last = torch.zeros(B, dtype=torch.long, device=x.device)
    for i in range(1, npoint):
        d = x - x[rows, last][:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        top = min_d2.max(dim=1, keepdim=True).values
        last = torch.where(min_d2 == top, col, N).min(dim=1).values
        out[:, i] = last
    return out


def knn_exact(query: torch.Tensor, points: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, idx int64), each (B, N, k): ascending d2, ties to the lower
    index; k > M pads with the farthest neighbour."""
    M = points.shape[1]
    k_eff = min(k, M)
    ids = torch.arange(M, device=points.device, dtype=torch.int64)
    dists, idxs = [], []
    for q in query.split(CHUNK, dim=1):
        d2 = pair_d2(q, points)
        key = (d2.view(torch.int32).to(torch.int64) << 32) | ids
        top = torch.topk(key, k_eff, dim=-1, largest=False, sorted=True).values
        idxs.append(top & 0xFFFFFFFF)
        dists.append(_sqrt((top >> 32).to(torch.int32).view(torch.float32)))
    dist, idx = torch.cat(dists, 1), torch.cat(idxs, 1)
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(*dist.shape[:-1], pad)],
                         -1)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], -1)
    return dist, idx


def fill_balls(cand: torch.Tensor, nsample: int,
               n_valid_below: int) -> torch.Tensor:
    """Slots past the in-radius count repeat the first in-radius index; an
    empty ball is all zeros."""
    count = (cand < n_valid_below).sum(-1, keepdim=True)
    slot = torch.arange(nsample, device=cand.device)
    idx = torch.where(slot < count, cand, cand[..., :1])
    return torch.where(count > 0, idx, 0).long()


def ball_exact(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """The nsample lowest indices with d2 < r^2 of each centre, filled."""
    N = xyz.shape[1]
    r2 = radius_sq(radius)
    ids = torch.arange(N, device=xyz.device)
    k_eff = min(nsample, N)
    cands = []
    for c in new_xyz.split(CHUNK, dim=1):
        key = torch.where(pair_d2(c, xyz) < r2, ids, N + ids)
        cands.append(torch.topk(key, k_eff, dim=-1, largest=False,
                                sorted=True).values)
    cand = torch.cat(cands, 1)
    if k_eff < nsample:
        cand = torch.cat([cand, cand.new_full(
            (*cand.shape[:2], nsample - k_eff), 2 * N)], -1)
    return fill_balls(cand, nsample, N)


def _pick_block(m: int, k: int, recall: float) -> int:
    if k <= 1:
        return 32
    cap = int(2 * m * (1.0 - recall) / (k - 1))
    for blk in (32, 16, 8, 4):
        if blk <= cap:
            return blk
    return 4


def block_size(m: int, k: int, recall: float) -> int:
    """The run length: the largest keeping the expected recall, halved
    while fewer than k runs would hold real points."""
    blk = _pick_block(m, k, recall)
    while blk > 4 and -(-m // blk) < k:
        blk //= 2
    if -(-m // blk) < k:
        raise ValueError(f"block-min: {m} points in runs of {blk} give fewer "
                         f"than k={k} winners")
    return blk


def _padded(points: torch.Tensor) -> torch.Tensor:
    B, M, _ = points.shape
    mp = -(-M // TILE) * TILE
    if mp == M:
        return points.float()
    pad = points.new_full((B, mp - M, 3), PAD, dtype=torch.float32)
    return torch.cat([points.float(), pad], 1)


def knn_blockmin(query: torch.Tensor, points: torch.Tensor, k: int,
                 recall: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-min KNN: each run of ``blk`` padded candidates keeps its
    minimum (ties to the lowest index), the run keys pack the minimum d2's
    high bits with the index, and the k smallest keys win; the distances
    are the truncated d2's square roots."""
    M = points.shape[1]
    blk = block_size(M, k, recall)
    p = _padded(points)
    mp = p.shape[1]
    mask_low = (1 << max(1, (mp - 1).bit_length())) - 1
    ids = torch.arange(mp, device=p.device, dtype=torch.int32).reshape(-1, blk)
    dists, idxs = [], []
    for q in query.float().split(CHUNK, dim=1):
        d3 = pair_d2(q, p).unflatten(-1, (-1, blk))
        vmin = d3.amin(-1)
        amin = torch.where(d3 == vmin[..., None], ids, BALL_INVALID).amin(-1)
        keys = (vmin.view(torch.int32) & ~mask_low) | amin
        top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        idxs.append((top & mask_low).long())
        dists.append(_sqrt((top & ~mask_low).view(torch.float32)))
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def ball_blockmin(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                  nsample: int) -> torch.Tensor:
    """Block-min ball query: each run's lowest in-radius index, the nsample
    smallest run keys, filled."""
    N = xyz.shape[1]
    blk = block_size(N, nsample, RECALL_LARGE_K)
    p = _padded(xyz)
    ids = torch.arange(p.shape[1], device=p.device,
                       dtype=torch.int32).reshape(-1, blk)
    r2 = radius_sq(radius)
    cands = []
    for c in new_xyz.float().split(CHUNK, dim=1):
        d3 = pair_d2(c, p).unflatten(-1, (-1, blk))
        keys = torch.where(d3 < r2, ids, BALL_INVALID).amin(-1)
        cands.append(torch.topk(keys, nsample, dim=-1, largest=False,
                                sorted=True).values)
    return fill_balls(torch.cat(cands, 1), nsample, BALL_INVALID)


class Search:
    """The neighbour mode: ``exact`` searches exactly everywhere; otherwise
    KNN takes block-min where the searched cloud has M >= 1024 points and
    ceil(M / 4) >= k, the ball query where N >= 1024 and ceil(N / 4) >=
    nsample, and the exact routes elsewhere."""

    def __init__(self, exact: bool):
        self.exact = exact

    def knn(self, k: int, query: torch.Tensor, points: torch.Tensor):
        M = points.shape[1]
        if not self.exact and M >= 1024 and -(-M // 4) >= k:
            recall = RECALL_LARGE_K if k >= 8 else RECALL_SMALL_K
            return knn_blockmin(query, points, k, recall)
        return knn_exact(query, points, k)

    def ball(self, radius: float, nsample: int, xyz: torch.Tensor,
             new_xyz: torch.Tensor) -> torch.Tensor:
        N = xyz.shape[1]
        if not self.exact and N >= 1024 and -(-N // 4) >= nsample:
            return ball_blockmin(xyz, new_xyz, radius, nsample)
        return ball_exact(xyz, new_xyz, radius, nsample)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) -> (B, M, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx]


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather(points, idx.reshape(B, M * S)).reshape(B, M, S, -1)
