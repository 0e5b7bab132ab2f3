"""Point-cloud primitives in PyTorch, channels-last.

Counterpart of ogc_tpu/ops/core.py: features are (B, N, C) and groups
(B, M, S, C), as in the JAX package.

* ``furthest_point_sample`` -- greedy FPS from index 0, ties to the lowest
  index (ops/fps.py; reference pointnet2/src/sampling_gpu.cu:93-253).
* ``knn`` -- neighbours ascending by distance, ties to the lower index,
  sqrt distances (reference src/interpolate_gpu.cu:9-57).
* ``ball_query`` -- the nsample lowest in-radius indices (strict d2 < r^2),
  ascending, an under-full ball filled with its first index, an empty ball
  all zeros (reference src/ball_query_gpu.cu:9-45).
* ``query_and_group`` -- KNN with the radius clamp: neighbours farther than
  the radius are replaced by the nearest one (pointnet2/pointnet2.py:281-301).

Neighbour mode, as in the JAX package: ``OGC_EXACT_NEIGHBORS`` in ("1",
"on") at import pins exact search; otherwise search is approximate, and
``set_exact_neighbors`` switches it; ``knn`` and ``ball_query`` take a
per-call ``exact`` that overrides it.  Exact search is ops/knn.py (#2) and
ops/ball.py (#5).  Approximate search takes the block-min kernel
(ops/knn_blockmin.py, #3) behind the JAX package's gates: KNN where the
searched cloud has M >= 1024 points and ceil(M / 4) >= k, ball query where
N >= 1024 and ceil(N / 4) >= nsample.  Off the gates approximate mode takes
the exact routes: there the JAX package calls ``jax.lax.approx_max_k``,
which computes an exact top-k away from the TPU (XLA lowers it exactly on
the CPU and the GPU), so exact is what it computes.  Exact KNN takes the
bound-pruned kernel (ops/knn_pruned.py, #4) instead of #2 behind the JAX
package's opt-in gate: ``OGC_PALLAS_EXACT_PRUNE=knn`` (read at import, or
``set_exact_prune``), 4096 <= M <= 16384, M >= k and N >= 1024 queries.

Distances, a documented deviation: the port computes the direct-form d2
((dx*dx + dy*dy) + dz*dz, as the Pallas kernels and the reference CUDA do)
at every size, where the JAX package, below its Pallas gates (M, N < 1024),
takes XLA on the expanded form |a|^2 - 2ab + |b|^2.  On continuous SAPIEN
scenes (tests/test_torch_search_form.py: 32 clouds of 512 points) the exact
lists differ only at near-ties, within the expanded form's rounding bound:
SA0's k 64 lists 6 of 8192 before the radius clamp (0 after the 0.1 clamp,
3 after the 0.2 one), and none at SA1, the two FP three_nn, the smooth KNN
and ball, and OA-ICP's k = 1 interpolation.

FPS, KNN and ball query are ``ops.remat.pinned``: under a remat checkpoint
the recompute takes the forward's selections instead of searching again.

``pool_neighbors`` (ops/pool.py, #12) reduces grouped features over the
neighbour axis behind the JAX package's ``OGC_PALLAS_POOL`` gate.

``gather`` and ``group`` are a row gather whose backward is a deterministic
scatter-add (ascending source order, no atomics); ``three_interpolate`` and
``group_with_idx`` go through them.  ``group`` routes as the JAX package
does: where ``ops/onehot.py::onehot_path_applicable`` holds (a source of at
most 1024 points and 16 channels, at least 1024 rows per cloud) through the
small-source gather/scatter kernels #7/#8, else through advanced indexing
with the scatter-add of ops/scatter.py (#11) as its backward.  Both
backwards give the same bits.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ogc_tpu_torch.ops.ball import ball_query_exact
from ogc_tpu_torch.ops.fps import fps
from ogc_tpu_torch.ops.knn import knn_exact
from ogc_tpu_torch.ops.knn_blockmin import ball_query_blockmin, knn_blockmin
from ogc_tpu_torch.ops.knn_pruned import knn_exact_pruned
from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                      onehot_path_applicable,
                                      scatter_add_rows_onehot)
from ogc_tpu_torch.ops.remat import pinned
from ogc_tpu_torch.ops.scatter import scatter_add_rows


_EXACT = os.environ.get("OGC_EXACT_NEIGHBORS", "") in ("1", "on")
# The JAX package's default is "on", which prunes only its ball query (the
# port's #5 is that ball query); "knn" also routes exact KNN to #4.
_EXACT_PRUNE = os.environ.get("OGC_PALLAS_EXACT_PRUNE", "on")
_PRUNE_MIN_M, _PRUNE_MIN_N, _PRUNE_MAX_M = 4096, 1024, 16384
# Recall targets of the block-min run length: large-k grouping tolerates
# more misses than the k = 3 interpolation stencil.
_RECALL_LARGE_K = 0.95
_RECALL_SMALL_K = 0.99


def set_exact_neighbors(exact: bool) -> None:
    """Switch neighbour search between exact and approximate."""
    global _EXACT
    _EXACT = bool(exact)


def exact_neighbors() -> bool:
    return _EXACT


def set_exact_prune(mode: str) -> None:
    """Set the #4 gate as ``OGC_PALLAS_EXACT_PRUNE`` would: "knn" routes
    exact KNN on its shapes to the bound-pruned kernel."""
    global _EXACT_PRUNE
    _EXACT_PRUNE = mode


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 (the kernels' dtype), or float64 when it is float64:
    the CPU tests' float64 runs, where the plain versions then compute in
    float64 too."""
    return x if x.dtype == torch.float64 else x.float()


@pinned
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """:param xyz: (B, N, 3).  :return: (B, npoint) int32 indices."""
    return fps(widen(xyz), npoint)


class _Gather(torch.autograd.Function):
    """Row gather (B, N, C) x (B, R) -> (B, R, C); its backward is a
    deterministic scatter-add kernel, never ``index_add_`` or the atomic
    backward of advanced indexing.  With ``onehot`` the pair is the
    small-source kernels #7/#8, else advanced indexing and #11.  The
    backward runs only when the source needs a gradient (SA0 groups the
    input cloud and launches no scatter)."""

    @staticmethod
    def forward(ctx, points, idx, onehot=False):
        ctx.save_for_backward(idx)
        ctx.n_dest = points.shape[1]
        ctx.onehot = onehot
        if onehot:
            if points.element_size() == 2:
                # bf16 rows: a gather copies bits, so the kernel (float32
                # only) moves them as float32 words, two channels a word.
                if points.shape[-1] % 2:
                    return gather_rows_onehot(points.float(),
                                              idx).to(points.dtype)
                words = points.contiguous().view(torch.float32)
                return gather_rows_onehot(words, idx).view(points.dtype)
            return gather_rows_onehot(points, idx)
        rows = torch.arange(points.shape[0], device=points.device)[:, None]
        return points[rows, idx.long()]

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        scatter = scatter_add_rows_onehot if ctx.onehot else scatter_add_rows
        d = scatter(idx, widen(grad).contiguous(), ctx.n_dest)
        return d.to(grad.dtype), None, None


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) -> (B, M, C)."""
    return _Gather.apply(points, idx)


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    N, C = points.shape[1], points.shape[2]
    out = _Gather.apply(points, idx.reshape(B, M * S),
                        onehot_path_applicable(N, M * S, C))
    return out.reshape(B, M, S, C)


@pinned
def knn(k: int, query: torch.Tensor, points: torch.Tensor,
        exact: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query`` (B, N, 3) in ``points`` (B, M, 3).

    :param exact: this call's neighbour mode; None takes the global one.
    :return: (dist, idx), each (B, N, k): sqrt distances and int32 indices,
        ascending, ties to the lower index (in approximate mode on the gate,
        #3's winners and truncated distances).  For k > M the row is padded
        with its farthest neighbour (ogc_tpu/ops/core.py::_pad_k).
    """
    M = points.shape[1]
    exact = _EXACT if exact is None else bool(exact)
    if not exact and M >= 1024 and -(-M // 4) >= k:
        recall = _RECALL_LARGE_K if k >= 8 else _RECALL_SMALL_K
        return knn_blockmin(widen(query), widen(points), k, recall)
    if (exact and _EXACT_PRUNE == "knn"
            and _PRUNE_MIN_M <= M <= _PRUNE_MAX_M and M >= k
            and query.shape[1] >= _PRUNE_MIN_N):
        return knn_exact_pruned(widen(query), widen(points), k)
    k_eff = min(k, M)
    dist, idx = knn_exact(widen(query), widen(points), k_eff)
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


@pinned
def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor,
               exact: Optional[bool] = None) -> torch.Tensor:
    """Fixed-size in-radius neighbour lists of the centres ``new_xyz``
    (B, M, 3) among ``xyz`` (B, N, 3): (B, M, nsample) int32
    (ogc_tpu/ops/core.py::ball_query, with _fill_balls).  ``exact`` is this
    call's neighbour mode; None takes the global one."""
    N = xyz.shape[1]
    exact = _EXACT if exact is None else bool(exact)
    if not exact and N >= 1024 and -(-N // 4) >= nsample:
        return ball_query_blockmin(widen(xyz), widen(new_xyz), radius,
                                   nsample)
    return ball_query_exact(widen(xyz), widen(new_xyz), radius, nsample)


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
