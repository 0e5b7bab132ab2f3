"""Synthetic scenes (the port's copy of tests/synth.py::
make_sapien_root_coherent, ::rand_se3 and ::scene_like_cloud; numpy and
scipy only): SAPIEN scenes with spatially coherent parts, and outdoor-like
clouds.  The same seed gives byte-identical data.
"""

import json
import os
import os.path as osp

import numpy as np
from scipy.spatial.transform import Rotation


def rand_se3(rng, max_deg=30.0, max_shift=0.3):
    R = Rotation.from_euler(
        "zyx", rng.uniform(-max_deg, max_deg, 3), degrees=True
    ).as_matrix()
    t = rng.uniform(-max_shift, max_shift, 3)
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = t
    return M


def make_sapien_root_coherent(root, n_scenes=60, n_views=4, n_points=512,
                              max_parts=5, seed=0, test_frac=0.2):
    """MBS-SAPIEN-format dataset (data/%06d.npz + meta.json) whose parts are
    compact: each part an anisotropic Gaussian blob around its own centre
    (2..max_parts parts per scene), moved by per-part SE(3)s with moderate
    articulation, as real SAPIEN articulated objects are."""
    rng = np.random.RandomState(seed)
    os.makedirs(osp.join(root, "data"), exist_ok=True)
    ids = list(range(n_scenes))
    for i in ids:
        n_parts = rng.randint(2, max_parts + 1)
        centers = rng.uniform(-0.6, 0.6, (n_parts, 3))
        scales = rng.uniform(0.08, 0.3, (n_parts, 3))
        # Points per part: roughly balanced with jitter.
        w = rng.dirichlet(np.full(n_parts, 5.0))
        counts = np.maximum(1, (w * n_points).astype(int))
        counts[0] += n_points - counts.sum()
        base, segm = [], []
        for p in range(n_parts):
            base.append(centers[p]
                        + scales[p] * rng.randn(counts[p], 3))
            segm.append(np.full(counts[p], p + 1))
        base = np.concatenate(base).astype(np.float32)
        segm = np.concatenate(segm)
        perm = rng.permutation(n_points)  # no part-sorted point order
        base, segm = base[perm], segm[perm]
        cams = [rand_se3(rng, max_deg=10.0, max_shift=0.1)
                for _ in range(n_views)]
        motions = {
            str(p): [rand_se3(rng, max_deg=25.0, max_shift=0.25)
                     for _ in range(n_views)]
            for p in range(1, n_parts + 1)
        }
        pcs = np.zeros((n_views, n_points, 3), dtype=np.float32)
        for v in range(n_views):
            for p in range(1, n_parts + 1):
                sel = segm == p
                M = np.linalg.inv(cams[v]) @ motions[str(p)][v]
                pcs[v, sel] = base[sel] @ M[:3, :3].T + M[:3, 3]
        trans = {"cam": [cams[v] for v in range(n_views)]}
        for p in range(1, n_parts + 1):
            trans[p] = motions[str(p)]
        np.savez(
            osp.join(root, "data", "%06d.npz" % i),
            pc=pcs,
            segm=np.tile(segm, (n_views, 1)),
            trans=np.array(trans, dtype=object),
        )
    n_test = max(1, int(n_scenes * test_frac))
    meta = {"train": ids[:-n_test], "val": ids[-n_test:], "test": ids[-n_test:]}
    with open(osp.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    return root


def scene_like_cloud(rng, n, extent=30.0):
    """Surface-like outdoor cloud: a ground plane and 8 clusters, the
    regime where Morton blocking is informative (n, 3) float32."""
    ground = np.c_[extent * rng.rand(n // 2, 2), 0.2 * rng.rand(n // 2, 1)]
    ks = [
        extent * rng.rand(3) * np.array([1, 1, 0.1])
        + rng.randn(n // 14, 3) * np.array([1.5, 1.5, 0.8])
        for _ in range(8)
    ]
    return np.vstack([ground] + ks)[:n].astype(np.float32)
