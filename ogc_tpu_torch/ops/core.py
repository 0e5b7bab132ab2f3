"""Point-cloud primitives in PyTorch, channels-last.

Counterpart of ogc_tpu/ops/core.py in its exact-neighbour (parity) mode:
features are (B, N, C) and groups (B, M, S, C), as in the JAX package.

* ``furthest_point_sample`` -- greedy FPS from index 0, ties to the lowest
  index (ops/fps.py; reference pointnet2/src/sampling_gpu.cu:93-253).
* ``knn`` -- exact neighbours, ascending distance, ties to the lower index,
  sqrt distances (ops/knn.py; reference src/interpolate_gpu.cu:9-57).
* ``query_and_group`` -- KNN with the radius clamp: neighbours farther than
  the radius are replaced by the nearest one (pointnet2/pointnet2.py:281-301).

``gather`` and ``group`` are plain indexing, as the JAX package leaves them
to XLA on this path.  Approximate neighbour search is not ported yet
(ROADMAP queue B): ``set_exact_neighbors(False)`` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ogc_tpu_torch.ops.fps import fps
from ogc_tpu_torch.ops.knn import knn_exact


def set_exact_neighbors(exact: bool) -> None:
    """Only exact search exists in the port; asking for approximate raises."""
    if not exact:
        raise NotImplementedError(
            "approximate neighbour search (--approx_knn, nested FPS) is not "
            "ported yet: see ROADMAP.md queue B")


def exact_neighbors() -> bool:
    return True


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """:param xyz: (B, N, 3).  :return: (B, npoint) int32 indices."""
    return fps(xyz.float(), npoint)


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) -> (B, M, C)."""
    B = points.shape[0]
    rows = torch.arange(B, device=points.device)[:, None]
    return points[rows, idx.long()]


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    return gather(points, idx.reshape(B, M * S)).reshape(B, M, S, -1)


def knn(k: int, query: torch.Tensor,
        points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query`` (B, N, 3) in ``points`` (B, M, 3).

    :return: (dist, idx), each (B, N, k): sqrt distances and int32 indices,
        ascending, ties to the lower index.  For k > M the row is padded with
        its farthest neighbour (ogc_tpu/ops/core.py::_pad_k).
    """
    M = points.shape[1]
    k_eff = min(k, M)
    dist, idx = knn_exact(query.float(), points.float(), k_eff)
    if k_eff < k:
        pad = k - k_eff
        dist = torch.cat([dist, dist[..., -1:].expand(*dist.shape[:-1], pad)], -1)
        idx = torch.cat([idx, idx[..., -1:].expand(*idx.shape[:-1], pad)], -1)
    return dist, idx


def three_nn(unknown: torch.Tensor,
             known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN with k = 3 (pointnet2/pointnet2.py:112-140)."""
    return knn(3, unknown, known)


def interpolate_weights(unknown: torch.Tensor, known: torch.Tensor,
                        eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-distance weights over the 3 nearest neighbours
    (utils/pointnet2_util.py:98-101).  :return: (idx, weight), (B, N, 3)."""
    dist, idx = three_nn(unknown, known)
    recip = 1.0 / (dist + eps)
    return idx, recip / recip.sum(-1, keepdim=True)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, M, C) features, (B, N, 3) idx and weights -> (B, N, C)."""
    return (group(features, idx) * weight[..., None]).sum(2)


def upsample_feat(pc: torch.Tensor, pc_sub: torch.Tensor,
                  feat_sub: torch.Tensor) -> torch.Tensor:
    """Features of ``pc_sub`` interpolated onto ``pc`` (utils/data_util.py:21-38)."""
    idx, weight = interpolate_weights(pc, pc_sub)
    return three_interpolate(feat_sub, idx, weight)


def query_and_group(radius: Optional[float], nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None,
                    use_xyz: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN grouping with the radius clamp and relative coordinates.

    :return: (new_features (B, M, nsample, 3+C or C),
        grouped_xyz (B, M, nsample, 3)).
    """
    dist, idx = knn(nsample, new_xyz, xyz)
    if radius is not None:
        idx = torch.where(dist > radius, idx[..., :1], idx)
    return group_with_idx(xyz, new_xyz, idx, features, use_xyz)


def group_with_idx(xyz: torch.Tensor, new_xyz: torch.Tensor, idx: torch.Tensor,
                   features: Optional[torch.Tensor] = None,
                   use_xyz: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query_and_group with precomputed neighbour indices."""
    if features is None:
        grouped_xyz = group(xyz, idx) - new_xyz[:, :, None, :]
        return grouped_xyz, grouped_xyz
    g = group(torch.cat([xyz, features], -1), idx)
    grouped_xyz = g[..., :3] - new_xyz[:, :, None, :]
    if use_xyz:
        return torch.cat([grouped_xyz, g[..., 3:]], -1), grouped_xyz
    return g[..., 3:], grouped_xyz
