"""Ground-plane fitting (GPF): FPS pre-downsample, lowest-point seeding,
iterative least-squares plane fits, a retry loop raising the seed threshold.

Copy of ogc_tpu/utils/gpf.py (reference utils/gpf_util.py:20-70; the
skspatial plane fit replaced by an SVD plane fit, the same least-squares
solution): the numpy oracle ``ground_plane_fitting`` (host-side per scene,
the outdoor CLIs' ``--host_preproc``) with FPS from the port's kernel #1,
and ``ground_plane_fitting_batched``, the torch counterpart of the JAX
package's ``ground_plane_fitting_xla``: a batch of padded clouds on the
device, with ``valid`` / ``fit_valid`` masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ogc_tpu_torch import ops


def fps_downsample(pc: np.ndarray, n_sample_point: int = 1024,
                   device: str = "cuda") -> np.ndarray:
    """FPS indices of a single cloud (reference utils/data_util.py:8-18 /
    gpf_util.py:7-17), by the port's FPS on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(pc[None], np.float32))
    return ops.furthest_point_sample(x.to(device), n_sample_point)[0].cpu() \
        .numpy()


def plane_best_fit(points: np.ndarray):
    """Least-squares plane through points: (center, unit normal).

    Equivalent to skspatial Plane.best_fit (normal = singular vector of the
    smallest singular value of the centered cloud)."""
    center = points.mean(0)
    _, _, Vt = np.linalg.svd(points - center, full_matrices=False)
    normal = Vt[-1]
    return center, normal / np.linalg.norm(normal)


def extract_initial_gpf_seed(
    pc: np.ndarray, n_lpr: int = 20, thresh_seed: float = 0.4,
    vertical_axis: int = 1,
) -> np.ndarray:
    """Seed points below (mean of n_lpr lowest heights + thresh)
    (gpf_util.py:20-29)."""
    height = pc[:, vertical_axis]
    lpr = np.partition(height, n_lpr)[:n_lpr].mean()
    return pc[height < (lpr + thresh_seed)]


def ground_plane_fitting(
    points: np.ndarray,
    n_sample_point: int = 8192,
    n_iter: int = 5,
    n_lpr: int = 200,
    thresh_seed: float = 0.4,
    thresh_dist: float = 0.4,
    vertical_axis: int = 1,
    device: str = "cuda",
) -> np.ndarray:
    """:return: is_ground (N,) int32.  Reference: gpf_util.py:32-70 including
    the retry loop raising thresh_seed by 0.05 up to 0.8.  FPS runs on
    ``device``."""
    if n_sample_point > 0 and points.shape[0] > n_sample_point:
        fps_idx = fps_downsample(points, n_sample_point=n_sample_point,
                                 device=device)
        pc = points[fps_idx]
    else:
        pc = points

    center = normal = None
    while True:
        try:
            seed = extract_initial_gpf_seed(pc, n_lpr, thresh_seed, vertical_axis)
            for _ in range(n_iter):
                if seed.shape[0] < 3:
                    raise ValueError("too few seed points")
                center, normal = plane_best_fit(seed)
                dist = np.abs((pc - center) @ normal)
                seed = pc[dist < thresh_dist]
            break
        except Exception:
            thresh_seed += 0.05
            if thresh_seed > 0.8:
                return np.zeros(points.shape[0], dtype=np.int32)

    dist = np.abs((points - center) @ normal)
    return (dist < thresh_dist).astype(np.int32)


# ---------------------------------------------------------------------------
# Batched GPF on the device
# ---------------------------------------------------------------------------


def _masked_plane_fit(pc: torch.Tensor, w: torch.Tensor):
    """Weighted least-squares plane: (center (Bb, 3), unit normal (Bb, 3)).
    Normal = the eigenvector of the smallest eigenvalue of the weighted 3x3
    covariance, the SVD fit on the selected points for 0/1 weights.  The
    covariance is summed elementwise in float32 (no TF32 matmul)."""
    denom = w.sum(1).clamp(min=1.0)[:, None]
    center = (pc * w[..., None]).sum(1) / denom
    d = (pc - center[:, None, :]) * w[..., None]
    cov = (d[..., :, None] * d[..., None, :]).sum(1)
    # eigh: ascending eigenvalues; the sign of the normal is irrelevant
    # (distances are absolute).
    normal = torch.linalg.eigh(cov)[1][..., 0]
    return center, normal / normal.norm(dim=-1, keepdim=True).clamp(min=1e-12)


@torch.no_grad()
def ground_plane_fitting_batched(
    points: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    fit_valid: Optional[torch.Tensor] = None,
    n_iter: int = 5,
    n_lpr: int = 200,
    thresh_seed: float = 0.4,
    thresh_dist: float = 0.4,
    vertical_axis: int = 1,
    max_thresh_seed: float = 0.8,
) -> torch.Tensor:
    """Batched ground-plane fitting (ogc_tpu/utils/gpf.py::
    ground_plane_fitting_xla).

    :param points: (Bb, N, 3) float32 (variable-size clouds padded; pass
        ``valid``).
    :param valid: optional (Bb, N) bool mask of real (non-padding) points.
    :param fit_valid: optional (Bb, N) bool mask of the points the plane is
        FITTED on (the reference fits on an FPS subcloud and classifies the
        full cloud, gpf_util.py:37-41,68-69: pass the FPS selection here).
    :return: is_ground (Bb, N) int32 over ``valid`` (0 on padding).

    Seed points below (mean of the n_lpr lowest fit heights + thresh_seed);
    n_iter rounds of plane fit and reselection within thresh_dist; an
    attempt with fewer than 3 seed points in any round fails and the next
    raises thresh_seed by 0.05, up to max_thresh_seed (all zeros if every
    attempt fails).  Every attempt runs, and each scene takes its first
    that succeeded, so the host never waits on the device.
    """
    Bb, N, _ = points.shape
    dev = points.device
    if valid is None:
        valid = torch.ones((Bb, N), dtype=torch.bool, device=dev)
    fit_valid = valid if fit_valid is None else fit_valid & valid
    height = points[..., vertical_axis]
    h_fit = torch.where(fit_valid, height, torch.full_like(height, 1e10))
    # Masked entries sit at +1e10 and are never among the lowest while
    # n_lpr real points exist; tiny clouds fail the count check below.
    lpr = torch.topk(h_fit, min(n_lpr, N), dim=1, largest=False).values \
        .mean(1)

    def attempt(seed_thresh):
        seed = fit_valid & (h_fit < (lpr + seed_thresh)[:, None])
        ok = torch.ones(Bb, dtype=torch.bool, device=dev)
        for _ in range(n_iter):
            ok = ok & (seed.sum(1) >= 3)
            center, normal = _masked_plane_fit(points, seed.to(points.dtype))
            dist = ((points - center[:, None, :]) * normal[:, None, :]) \
                .sum(-1).abs()
            seed = fit_valid & (dist < thresh_dist)
        return (valid & (dist < thresh_dist)).to(torch.int32), ok

    n_retry = int(round((max_thresh_seed - thresh_seed) / 0.05)) + 1
    result = torch.zeros((Bb, N), dtype=torch.int32, device=dev)
    chosen = torch.zeros(Bb, dtype=torch.bool, device=dev)
    for r in range(max(n_retry, 1)):
        ig, ok = attempt(np.float32(thresh_seed + 0.05 * r).item())
        result = torch.where((ok & ~chosen)[:, None], ig, result)
        chosen = chosen | ok
    return result
