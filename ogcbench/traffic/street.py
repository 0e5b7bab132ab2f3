"""Seeded outdoor street scenes (numpy): a copy of the port's synthetic
street (ogc_tpu_torch/tools/synth.py) kept with the benchmark, so that a
change to the program cannot change the traffic.

A street is two rows of static buildings and moving boxes
(cars, pedestrians, cyclists) with a velocity a frame.  ``kittisf_pair``
draws a KITTI-SF-style frame pair as the downsampled set holds it: the
front field of view within 35 m, no ground (the set removes y < -1.4), ``n``
points a frame sampled independently in each frame, an ego-motion of about
a metre and a degree between the frames, and each frame's flow to the
other frame's sensor coordinates.
"""

from __future__ import annotations

import numpy as np

GROUND_Y = -1.65
GROUND_CUT = -1.4


def rng_for(seed: int) -> np.random.RandomState:
    """A RandomState from any whole-number seed (beyond 32 bits too)."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence(
        int(seed))))


def _yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


class Street:
    """World coordinates, y up; boxes are (centre, size, instance id, class,
    velocity)."""

    def __init__(self, rng, ground_y=GROUND_Y, n_objects=8):
        self.rng, self.ground_y = rng, ground_y
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

    def world(self, m, t):
        """(points (m', 3), instance ids, velocities): m / n_boxes samples
        on each box's surface at frame t (the ground, which the KITTI-SF
        set removes, is not drawn)."""
        rng = self.rng
        pts, ids, vel = [], [], []
        per = m // len(self.boxes)
        for c, size, oid, _, v in self.boxes:
            c = c + t * v
            u = rng.uniform(-0.5, 0.5, (per, 3)) * size
            face = rng.randint(0, 3, per)
            u[np.arange(per), face] = np.sign(u[np.arange(per), face]) \
                * size[face] / 2
            p = c + u
            p[:, 1] += self.ground_y + size[1] / 2
            pts.append(p)
            ids.append(np.full(per, oid))
            vel.append(np.tile(v, (per, 1)))
        return tuple(np.concatenate(a) for a in (pts, ids, vel))


def _frame(street, n, t, pose, oversample):
    """n non-ground points of frame t in the sensor's coordinates, within
    the front field of view and 35 m: (pc, world, ids, vel)."""
    w, ids, vel = street.world(oversample * n, t)
    p = (w - pose[:3, 3]) @ pose[:3, :3]
    keep = ((p[:, 2] > np.abs(p[:, 0])) & (p[:, 2] < 35.0)
            & (p[:, 1] >= GROUND_CUT))
    sel = street.rng.permutation(np.flatnonzero(keep))
    if len(sel) < n:
        raise ValueError(f"{len(sel)} points in view, want {n}")
    sel = sel[:n]
    return p[sel], w[sel], ids[sel], vel[sel]


def kittisf_pair(rng, n, oversample=8):
    """One frame pair: (pcs (2, n, 3), segms (2, n), flows (2, n, 3)),
    float32 / int32; flow 1 carries frame 1's points into frame 2's sensor
    coordinates, flow 2 frame 2's into frame 1's."""
    street = Street(rng)
    pose1 = np.eye(4)
    pose2 = np.eye(4)
    pose2[:3, :3] = _yaw(np.deg2rad(rng.uniform(-1.5, 1.5)))
    pose2[:3, 3] = [rng.uniform(-0.2, 0.2), 0.0, rng.uniform(0.5, 1.5)]
    pc1, w1, id1, v1 = _frame(street, n, 0, pose1, oversample)
    pc2, w2, id2, v2 = _frame(street, n, 1, pose2, oversample)
    flow1 = (w1 + v1 - pose2[:3, 3]) @ pose2[:3, :3] - pc1
    flow2 = (w2 - v2 - pose1[:3, 3]) @ pose1[:3, :3] - pc2
    return (np.stack([pc1, pc2]).astype(np.float32),
            np.stack([id1, id2]).astype(np.int32),
            np.stack([flow1, flow2]).astype(np.float32))
