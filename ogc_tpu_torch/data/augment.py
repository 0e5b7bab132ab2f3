"""Host-side data utilities: label compression, one-hot masks, spatial
augmentation.  Parity with the reference utils/data_util.py (numpy-only; the
GPU FPS/interp helpers of the reference live in the ops package instead).
Copy of ogc_tpu/data/augment.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation


def compress_label_id(segm: np.ndarray) -> np.ndarray:
    """Relabel ids to consecutive 0..K-1 (utils/data_util.py:41-49)."""
    _, inv = np.unique(segm, return_inverse=True)
    return inv


def segm_to_mask(segm: np.ndarray, max_n_object: Optional[int] = None) -> np.ndarray:
    """One-hot (N,) -> (N, K) (utils/data_util.py:52-61)."""
    ids, inv = np.unique(segm, return_inverse=True)
    if max_n_object is None:
        max_n_object = ids.shape[0]
    return np.eye(max_n_object, dtype=np.float32)[inv]


def batch_segm_to_mask(
    segms: np.ndarray, max_n_object: int, ignore_npoint_thresh: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched one-hot with small-object suppression
    (utils/data_util.py:64-96).

    :return: masks (B, N, K), valids (B, N)."""
    masks, valids = [], []
    for b in range(segms.shape[0]):
        segm = segms[b].copy()
        if ignore_npoint_thresh > 0:
            ids, sizes = np.unique(segm, return_counts=True)
            ok_ids = ids[sizes >= ignore_npoint_thresh]
            valid = np.in1d(segm, ok_ids)
            segm[~valid] = 0
        else:
            valid = np.ones_like(segm, dtype=bool)
        valid = valid.astype(np.float32)
        _, inv = np.unique(segm, return_inverse=True)
        mask = np.eye(max_n_object, dtype=np.float32)[inv] * valid[:, None]
        masks.append(mask)
        valids.append(valid)
    return np.stack(masks, 0), np.stack(valids, 0)


def batch_segm_to_mask_withconf(
    segms: np.ndarray,
    confs: List[np.ndarray],
    max_n_object: int,
    ignore_npoint_thresh: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-hot masks carrying per-object confidence scores
    (utils/data_util.py:99-137)."""
    masks, valids = [], []
    for b in range(segms.shape[0]):
        segm = segms[b].copy()
        conf = np.asarray(confs[b])
        if ignore_npoint_thresh > 0:
            ids, sizes = np.unique(segm, return_counts=True)
            ok_ids = ids[sizes >= ignore_npoint_thresh]
            valid = np.in1d(segm, ok_ids)
            segm[~valid] = 0
            conf = conf[ok_ids]
        else:
            valid = np.ones_like(segm, dtype=bool)
        valid = valid.astype(np.float32)
        _, inv = np.unique(segm, return_inverse=True)
        mask = np.eye(max_n_object, dtype=np.float32)[inv] * valid[:, None]
        n_object = conf.shape[0]
        mask[:, :n_object] = mask[:, :n_object] * conf[None, :]
        masks.append(mask)
        valids.append(valid)
    return np.stack(masks, 0), np.stack(valids, 0)


def augment_transform(
    pcs: np.ndarray,
    flows: np.ndarray,
    aug_args: Dict,
    n_view: int = 2,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random scale/rot/shift augmentation of a frame pair, optionally with
    an independent second-frame transform for flow training.

    Reference: utils/data_util.py:140-195.  P' = sRP + t; F' = sRF.
    :return: (aug_pcs (2*n_view, N, 3), aug_flows (2*n_view, N, 3)).
    """
    if rng is None:
        rng = np.random
    assert pcs.shape[0] == flows.shape[0] == 2
    pc1, pc2 = pcs[0], pcs[1]
    flow1, flow2 = flows[0], flows[1]

    aug_pcs, aug_flows = [], []
    for _ in range(n_view):
        degree_range = np.array(aug_args["degree_range"])
        degree = rng.uniform(-degree_range, degree_range)
        rot = Rotation.from_euler("zyx", degree, degrees=True).as_matrix()
        scale = rng.uniform(aug_args["scale_low"], aug_args["scale_high"], 3)
        shift_range = np.array(aug_args["shift_range"])
        shift = rng.uniform(-shift_range, shift_range)

        a_pc1 = scale * (pc1 @ rot.T) + shift
        a_pc2 = scale * (pc2 @ rot.T) + shift
        a_flow1 = scale * (flow1 @ rot.T)
        a_flow2 = scale * (flow2 @ rot.T)

        if "aug_pc2" in aug_args:
            p2 = aug_args["aug_pc2"]
            degree2 = rng.uniform(-np.array(p2["degree_range"]), np.array(p2["degree_range"]))
            rot2 = Rotation.from_euler("zyx", degree2, degrees=True).as_matrix()
            shift2 = rng.uniform(-np.array(p2["shift_range"]), np.array(p2["shift_range"]))

            warped2 = a_pc2 + a_flow2
            a_pc2 = a_pc2 @ rot2.T + shift2
            a_flow2 = warped2 - a_pc2
            warped1 = a_pc1 + a_flow1
            a_flow1 = warped1 @ rot2.T + shift2 - a_pc1

        aug_pcs.extend([a_pc1, a_pc2])
        aug_flows.extend([a_flow1, a_flow2])
    return np.stack(aug_pcs, 0), np.stack(aug_flows, 0)
