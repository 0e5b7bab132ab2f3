"""The one traffic generator: batches of KITTI-SF-style frame pairs from a
workload's parameters and the run's seed.

Parameters (``ogcbench/workloads/<traffic>.json``): ``batches`` distinct
batches of ``batch`` items, ``n_points`` points a cloud; with
``augment`` each item is the two frames seen in two augmented views (four
clouds, as the segmentation trainer's dataset yields them from epoch 1 on:
the pair decentralised when the configuration says so, then a random
scale, rotation and shift per view, the configuration's
``aug_transform_args``), else the pair itself.  Every seed gives the same
sizes; the scenes and views are drawn from the seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ogcbench.traffic.street import kittisf_pair, rng_for


def augment_transform(pcs, flows, aug, rng, n_view=2):
    """A copy of the port's augmentation: per view P' = s R P + t and
    F' = s R F, rotation by zyx Euler degrees in +-degree_range, scale in
    [scale_low, scale_high] per axis, shift in +-shift_range.
    (2, N, 3) pairs -> (2 n_view, N, 3)."""
    out_p, out_f = [], []
    for _ in range(n_view):
        degree = rng.uniform(-np.array(aug["degree_range"]),
                             np.array(aug["degree_range"]))
        rot = Rotation.from_euler("zyx", degree, degrees=True).as_matrix()
        scale = rng.uniform(aug["scale_low"], aug["scale_high"], 3)
        shift = rng.uniform(-np.array(aug["shift_range"]),
                            np.array(aug["shift_range"]))
        for f in range(2):
            out_p.append(scale * (pcs[f] @ rot.T) + shift)
            out_f.append(scale * (flows[f] @ rot.T))
    return np.stack(out_p), np.stack(out_f)


def item(rng, params: Dict, cfg: Dict) -> Tuple[np.ndarray, ...]:
    pcs, segms, flows = kittisf_pair(rng, params["n_points"])
    if params["augment"]:
        if cfg.get("decentralize"):
            pcs = pcs - pcs.mean(1).mean(0)
        pcs, flows = augment_transform(pcs, flows, cfg["aug_transform_args"],
                                       rng)
        segms = np.concatenate([segms, segms])
    return (pcs.astype(np.float32), segms.astype(np.int32),
            flows.astype(np.float32))


def batches(params: Dict, cfg: Dict, seed: int) -> List[Tuple[np.ndarray, ...]]:
    """``params["batches"]`` batches (pcs (B, T, N, 3), segms (B, T, N),
    flows (B, T, N, 3)), T = 4 with augmentation else 2."""
    rng = rng_for(seed)
    out = []
    for _ in range(params["batches"]):
        items = [item(rng, params, cfg) for _ in range(params["batch"])]
        out.append(tuple(np.stack(f) for f in zip(*items)))
    return out
