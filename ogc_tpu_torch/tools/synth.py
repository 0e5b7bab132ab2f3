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


# ---------------------------------------------------------------------------
# Outdoor scenes at full resolution (KITTI-SF, Waymo, KITTI-Det,
# SemanticKITTI layouts)
# ---------------------------------------------------------------------------


def _yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


class _Street:
    """A street in world coordinates (y up): a ground plane that rises by
    ``tilt`` per metre of x, two rows of static boxes (buildings), and
    moving boxes (class 1 cars, 2 pedestrians, 3 cyclists) with a velocity
    a frame.  ``sample`` draws ``n`` surface points in a sensor frame
    (x right, y up, z forward) of the front field of view."""

    def __init__(self, rng, ground_y, tilt, n_objects=8):
        self.rng, self.ground_y, self.tilt = rng, ground_y, tilt
        boxes = []
        for side in (-1, 1):
            for z0 in np.arange(4.0, 60.0, 9.0):
                boxes.append((np.r_[side * rng.uniform(13, 17), 0.0, z0],
                              np.r_[2.0, rng.uniform(3, 6), 4.0], 0, 0,
                              np.zeros(3)))
        for k in range(n_objects):
            cls = 1 + k % 3
            size = {1: [1.8, 1.6, 4.2], 2: [0.6, 1.8, 0.6],
                    3: [0.7, 1.7, 1.8]}[cls]
            vel = np.r_[rng.uniform(-0.3, 0.3), 0.0,
                        rng.uniform(-1.5, 1.5) if cls == 1 else 0.3]
            boxes.append((np.r_[rng.uniform(-9, 9), 0.0,
                                rng.uniform(6, 45)], np.array(size), k + 1,
                          cls, vel))
        self.boxes = boxes

    def ground(self, x):
        return self.ground_y + self.tilt * x

    def world(self, n, t, pose):
        """(world points (n, 3), instance ids, classes, velocities) of n
        surface samples at frame t seen from ``pose`` (4x4, sensor to
        world)."""
        rng = self.rng
        m = 4 * n
        # Ground in the sensor's front wedge (a third of the samples), then
        # boxes.
        mg = m // 3
        z = rng.uniform(2.0, 34.0, mg)
        x = rng.uniform(-1.0, 1.0, mg) * z
        g = (np.c_[x, np.zeros(mg), z] @ pose[:3, :3].T) + pose[:3, 3]
        g[:, 1] = self.ground(g[:, 0]) + 0.02 * rng.randn(mg)
        pts, ids, cls, vel = [g], [np.zeros(mg, int)], [np.zeros(mg, int)], \
            [np.zeros((mg, 3))]
        per = m // len(self.boxes)
        for c, size, oid, ocls, v in self.boxes:
            c = c + t * v
            u = rng.uniform(-0.5, 0.5, (per, 3)) * size
            face = rng.randint(0, 3, per)
            u[np.arange(per), face] = np.sign(u[np.arange(per), face]) \
                * size[face] / 2
            p = c + u
            p[:, 1] += self.ground(c[0]) + size[1] / 2
            pts.append(p)
            ids.append(np.full(per, oid))
            cls.append(np.full(per, ocls))
            vel.append(np.tile(v, (per, 1)))
        return tuple(np.concatenate(a) for a in (pts, ids, cls, vel))


def _frame(street, n, t, pose, fov=True):
    """n points of frame t in sensor coordinates, the front field of view
    within 60 m and depth < 35 m (process_waymo.py:90-93): (pc, world,
    ids, cls, vel)."""
    w, ids, cls, vel = street.world(n, t, pose)
    p = (w - pose[:3, 3]) @ pose[:3, :3]
    keep = ((p[:, 2] > np.abs(p[:, 0])) & (p[:, 2] < 35.0)
            & ((p ** 2).sum(1) < 3600.0)) if fov else np.ones(len(p), bool)
    sel = street.rng.permutation(np.flatnonzero(keep))[:n]
    assert len(sel) == n, "too few samples in the field of view"
    return p[sel], w[sel], ids[sel], cls[sel], vel[sel]


def make_kittisf_full_root(root, ids, n_points, seed=0):
    """KITTI-SF at full resolution (processed/<id>/{pc1,pc2,segm}.npy; the
    dataset takes flow = pc2 - pc1): ground at y = -1.65 (removed by the
    CLIs' y < -1.4 in both frames), static buildings, moving objects and
    an ego-motion of ~1 m and a degree between the frames.  ``n_points``
    is an int or a list (one count a scene)."""
    rng = np.random.RandomState(seed)
    counts = ([n_points] * len(ids) if np.isscalar(n_points)
              else list(n_points))
    for i, n in zip(ids, counts):
        street = _Street(rng, -1.65, 0.0)
        pose1 = np.eye(4)
        pc1, w, seg, _, vel = _frame(street, n, 0, pose1)
        pose2 = np.eye(4)
        pose2[:3, :3] = _yaw(np.deg2rad(rng.uniform(-1.5, 1.5)))
        pose2[:3, 3] = [rng.uniform(-0.2, 0.2), 0.0, rng.uniform(0.5, 1.5)]
        pc2 = (w + vel - pose2[:3, 3]) @ pose2[:3, :3]
        d = osp.join(root, "processed", i)
        os.makedirs(d, exist_ok=True)
        np.save(osp.join(d, "pc1.npy"), pc1.astype(np.float32))
        np.save(osp.join(d, "pc2.npy"), pc2.astype(np.float32))
        np.save(osp.join(d, "segm.npy"), seg.astype(np.int32))
    return root


def waymo_pose(t):
    """Sensor-to-world pose of frame t: driving forward 1.2 m a frame while
    turning 0.6 degrees."""
    pose = np.eye(4)
    pose[:3, :3] = _yaw(np.deg2rad(0.6 * t))
    pose[:3, 3] = [0.05 * t, 0.0, 1.2 * t]
    return pose


def make_waymo_root(root, seqs, n_frames, n_points, seed=0, downsampled=False):
    """Waymo Open (data/<seq>/{pc,segm,semantic_segm,pose}_%04d.npy and the
    backward flows flow_%04d_%04d.npy of frame t to t - 1): a tilted ground
    (y = 0.025 x - 0.1, so its far side rises above the CLIs' y < 0.3 and
    only GPF finds it), buildings, cars / pedestrians / cyclists (classes
    1 / 2 / 3) moving between frames, poses for ``--use_odometry``.
    ``n_points`` is an int or a (low, high) range drawn per frame; with
    ``downsampled`` the frames keep points outside the field of view too
    (the training sets' 8192-point frames)."""
    rng = np.random.RandomState(seed)
    for seq in seqs:
        street = _Street(rng, -0.1, 0.025)
        d = osp.join(root, "data", seq)
        os.makedirs(d, exist_ok=True)
        for t in range(n_frames):
            n = (n_points if np.isscalar(n_points)
                 else rng.randint(n_points[0], n_points[1] + 1))
            pose = waymo_pose(t)
            pc, w, ids, cls, vel = _frame(street, n, t, pose,
                                          fov=not downsampled)
            np.save(osp.join(d, "pc_%04d.npy" % t), pc.astype(np.float32))
            np.save(osp.join(d, "segm_%04d.npy" % t), ids.astype(np.int32))
            np.save(osp.join(d, "semantic_segm_%04d.npy" % t),
                    cls.astype(np.int32))
            np.save(osp.join(d, "pose_%04d.npy" % t), pose)
            if t > 0:
                prev = waymo_pose(t - 1)
                back = (w - vel - prev[:3, 3]) @ prev[:3, :3]
                np.save(osp.join(d, "flow_%04d_%04d.npy" % (t, t - 1)),
                        (back - pc).astype(np.float32))
    return root


def make_single_frame_root(root, ids, n_points, seed=0):
    """KITTI-Det / SemanticKITTI downsampled layout (downsampled/<id>/
    {pc,segm}.npy): one street frame of ``n_points`` points each."""
    rng = np.random.RandomState(seed)
    for i in ids:
        pc, _, seg, _, _ = _frame(_Street(rng, -1.65, 0.0), n_points, 0,
                                  np.eye(4), fov=False)
        d = osp.join(root, "downsampled", i)
        os.makedirs(d, exist_ok=True)
        np.save(osp.join(d, "pc.npy"), pc.astype(np.float32))
        np.save(osp.join(d, "segm.npy"), seg.astype(np.int32))
    return root
