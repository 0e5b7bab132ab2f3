"""Point-to-point ICP for ego-motion estimation on KITTI-SF and Waymo.

Two implementations with the same semantics (reference
utils/icp_util.py:10-123), as in ogc_tpu/utils/icp.py:

- ``icp`` -- the numpy oracle (scipy ``cKDTree`` 1-NN), host-side per scene;
  the outdoor CLIs take it with ``--host_preproc``.
- ``icp_batched`` -- the torch counterpart of the JAX package's ``icp_xla``:
  a fixed number of iterations over a batch of scenes with a per-scene
  convergence mask (the reference's early break), 1-NN through ``ops.knn``
  (the exact KNN kernel #2, or the block-min kernel #3 in approximate mode)
  and ``ops.gather``, and a batched 3x3 Kabsch SVD (``torch.linalg.svd``).
  The Kabsch sums and products are written out elementwise in float32, so
  no TF32 matmul touches the coordinates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from ogc_tpu_torch import ops


def best_fit_transform(A: np.ndarray, B: np.ndarray):
    """Least-squares rigid transform mapping corresponding A onto B.

    :return: (T (m+1,m+1), R (m,m), t (m,)).
    Reference: icp_util.py:10-51 (SVD Kabsch with reflection fix).
    """
    assert A.shape == B.shape
    m = A.shape[1]
    cA, cB = A.mean(0), B.mean(0)
    H = (A - cA).T @ (B - cB)
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[m - 1, :] *= -1
        R = Vt.T @ U.T
    t = cB - R @ cA
    T = np.identity(m + 1)
    T[:m, :m] = R
    T[:m, m] = t
    return T, R, t


def nearest_neighbor(src: np.ndarray, dst: np.ndarray):
    """1-NN of each src point in dst: (distances, indices)."""
    tree = cKDTree(dst)
    distances, indices = tree.query(src, k=1)
    return distances.ravel(), indices.ravel()


def icp(
    A: np.ndarray,
    B: np.ndarray,
    init_pose: Optional[np.ndarray] = None,
    max_iterations: int = 20,
    tolerance: float = 0.001,
):
    """Iterative closest point: best-fit transform mapping A onto B.

    :return: (T, distances, n_iterations).
    Reference: icp_util.py:73-123.
    """
    assert A.shape == B.shape
    m = A.shape[1]
    src = np.ones((m + 1, A.shape[0]))
    dst = np.ones((m + 1, B.shape[0]))
    src[:m, :] = A.T.copy()
    dst[:m, :] = B.T.copy()
    if init_pose is not None:
        src = init_pose @ src

    prev_error = 0.0
    distances = np.zeros(A.shape[0])
    i = 0
    for i in range(max_iterations):
        distances, indices = nearest_neighbor(src[:m, :].T, dst[:m, :].T)
        T, _, _ = best_fit_transform(src[:m, :].T, dst[:m, indices].T)
        src = T @ src
        mean_error = distances.mean()
        if abs(prev_error - mean_error) < tolerance:
            break
        prev_error = mean_error

    T, _, _ = best_fit_transform(A, src[:m, :].T)
    return T, distances, i


# ---------------------------------------------------------------------------
# Batched ICP on the device
# ---------------------------------------------------------------------------


def _transform(R: torch.Tensor, t: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """R x + t for (Bb, 3, 3), (Bb, 3) and points (Bb, P, 3)."""
    return (x[:, :, None, :] * R[:, None]).sum(-1) + t[:, None, :]


def _best_fit(A: torch.Tensor,
              B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched least-squares rigid transform A -> B (corresponding points),
    as ogc_tpu/utils/icp.py::_best_fit_xla: SVD Kabsch, the last right
    singular vector flipped where det(R) < 0.

    :param A, B: (Bb, P, 3).  :return: (R (Bb, 3, 3), t (Bb, 3)).
    """
    cA = A.mean(1, keepdim=True)
    cB = B.mean(1, keepdim=True)
    H = ((A - cA)[..., :, None] * (B - cB)[..., None, :]).sum(1)
    U, _, Vt = torch.linalg.svd(H)
    # R = Vt^T U^T; det(R) by the triple product of its rows.
    R = (Vt.transpose(1, 2)[:, :, :, None] * U.transpose(1, 2)[:, None]).sum(2)
    det = (R[:, 0] * torch.linalg.cross(R[:, 1], R[:, 2])).sum(-1)
    flip = torch.where(det < 0, -1.0, 1.0).to(A.dtype)
    Vt = torch.cat([Vt[:, :2], Vt[:, 2:] * flip[:, None, None]], 1)
    R = (Vt.transpose(1, 2)[:, :, :, None] * U.transpose(1, 2)[:, None]).sum(2)
    t = cB[:, 0] - (R * cA).sum(-1)
    return R, t


@torch.no_grad()
def icp_batched(A: torch.Tensor, B: torch.Tensor, max_iterations: int = 20,
                tolerance: float = 0.001) -> torch.Tensor:
    """Batched ICP: best-fit rigid transforms mapping A onto B.

    :param A, B: (Bb, P, 3) float32 tensors on one device (the callers run
        it on FPS-1024 subclouds, test_flow_waymo.py:158-160).
    :return: T (Bb, 4, 4) homogeneous transforms.

    Semantics of ogc_tpu/utils/icp.py::icp_xla: per iteration, 1-NN
    correspondences -> Kabsch -> apply; a scene stops when its mean 1-NN
    distance changes by < tolerance (it then passes through the remaining
    iterations unchanged), and the final transform is re-fit from the
    original cloud.  No host synchronisation inside the loop.
    """
    Bb = A.shape[0]
    src = A
    prev = torch.zeros(Bb, dtype=A.dtype, device=A.device)
    done = torch.zeros(Bb, dtype=torch.bool, device=A.device)
    for _ in range(max_iterations):
        dist, idx = ops.knn(1, src, B)
        corr = ops.gather(B, idx[..., 0])
        R, t = _best_fit(src, corr)
        mean_err = dist[..., 0].mean(1)
        src = torch.where(done[:, None, None], src, _transform(R, t, src))
        conv = (prev - mean_err).abs() < tolerance
        prev = torch.where(done, prev, mean_err)
        done = done | conv
    R, t = _best_fit(A, src)
    T = torch.zeros((Bb, 4, 4), dtype=A.dtype, device=A.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T
