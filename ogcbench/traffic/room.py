"""Seeded OGC-DR-style dynamic rooms (numpy), kept with the benchmark so
that a change to the program cannot change the traffic.

A room follows OGC's generator (``data_prepare/ogcdr/build_ogcdr.py``,
whose constants are copied here): a floor of 1 x [0.6, 1] (the short side
on a random axis) at y = -0.49 inside walls 0.01 thick, and a room type of
8, 7, 6, 5 or 4 objects with their largest extents drawn from the type's
interval; each object gets a random yaw, stands on the floor and is placed
without overlap (bounding-box rejection, the first of up to 1000 draws; a
room whose objects find no place is drawn anew).  Each of the next three
frames moves every object as the generator does: a turn by up to 10
degrees (about y with probability 0.6, else about x or z) composed with
its pose and re-grounded, then a shift of 0.02-0.04 along each floor axis,
either sign, inside the room and clear of the objects moved before it (21
tries a frame, else the room is drawn anew).  As the published set holds
them (``--keep_background`` off), the clouds hold the objects only, ids
from 1.

The ShapeNet meshes are stood in for by unions of boxes: a cabinet (one
box), a long shallow box (display, bench, sofa, lamp), a table (a top and
four legs) and a chair (a seat, a back and four legs), scaled to the drawn
extent.  Each frame samples its ``n`` points once, on its own, over the
objects' faces: the number a face gets is proportional to its area
(systematic sampling), the points uniform on it.  The generator's FPS of
100000 surface samples down to 2048 spreads them more evenly; the density,
and so the mean neighbour count within a radius, is the same.

Each room gives ``train_flow``'s six view pairs (``VIEW_SELS``) as items:
the flows come from the poses by the dataset's rule (``compute_flow``,
copied from ``ogc_tpu_torch/data/ogcdr.py``), and each item is augmented
as ``train_flow``'s training set does it (``augment_transform``, copied
from ``ogc_tpu_torch/data/augment.py``, with ``aug_pc2``): two views of the
pair.  The items of as many rooms as the traffic needs are shuffled into
batches, as the training loader shuffles the set.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ogcbench.traffic.street import rng_for

N_OBJECTS = [8, 7, 6, 5, 4]
SCALE_INTERVALS = [[0.2, 0.3], [0.2, 0.35], [0.25, 0.35], [0.25, 0.40],
                   [0.25, 0.45]]
XZ_GROUND_RANGE = [0.6, 1.0]
GROUND_LEVEL = -0.5 + 0.01
WALL_THICKNESS = 0.01
PROB_ROTATION_Y = 0.6
MOT_ANGLE = 10.0
MOT_TRANSL_RANGE = [0.02, 0.04]
MAX_ITER = 1000
N_FRAME = 4
FRAME_TRIES = 20
#: ``train_flow``'s view pairs (``VIEW_SELS``): each room gives six items
VIEW_SELS = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]


def _boxes(kind: int, rng) -> np.ndarray:
    """A stand-in object as (k, 2, 3) boxes [low; high], its bounding box
    centred at the origin and its largest extent 1."""
    if kind == 0:  # cabinet
        size = rng.uniform([0.5, 0.5, 0.4], 1.0)
        boxes = [[-size / 2, size / 2]]
    elif kind == 3:  # display, bench, sofa, lamp: long and shallow
        size = np.array([1.0, rng.uniform(0.3, 1.0), rng.uniform(0.15, 0.5)])
        boxes = [[-size / 2, size / 2]]
    else:
        w, d = rng.uniform(0.6, 1.0), rng.uniform(0.5, 1.0)
        top = rng.uniform(0.4, 0.8) if kind == 1 else rng.uniform(0.4, 0.5)
        slab, leg = 0.06, 0.06
        boxes = [[[-w / 2, top - slab, -d / 2], [w / 2, top, d / 2]]]
        for sx in (-1, 1):
            for sz in (-1, 1):
                x, z = sx * (w / 2 - leg / 2), sz * (d / 2 - leg / 2)
                boxes.append([[x - leg / 2, 0.0, z - leg / 2],
                              [x + leg / 2, top - slab, z + leg / 2]])
        if kind == 2:  # the chair's back
            boxes.append([[-w / 2, top, d / 2 - slab],
                          [w / 2, top + rng.uniform(0.4, 0.6), d / 2]])
    boxes = np.asarray(boxes, dtype=np.float64)
    lo, hi = boxes[:, 0].min(0), boxes[:, 1].max(0)
    return (boxes - (lo + hi) / 2) / (hi - lo).max()


def _faces(boxes: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The boxes' faces as rectangles: (origin, edge u, edge v), each
    (6 k, 3), and their areas."""
    origins, us, vs = [], [], []
    for lo, hi in boxes:
        size = hi - lo
        for a in range(3):
            b, c = (a + 1) % 3, (a + 2) % 3
            u, v = np.zeros(3), np.zeros(3)
            u[b], v[c] = size[b], size[c]
            for side in (lo[a], hi[a]):
                o = lo.copy()
                o[a] = side
                origins.append(o)
                us.append(u)
                vs.append(v)
    origins, us, vs = (np.asarray(x) for x in (origins, us, vs))
    return origins, us, vs, np.linalg.norm(np.cross(us, vs), axis=1)


def _corners(boxes: np.ndarray) -> np.ndarray:
    sel = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                    for k in (0, 1)])
    return boxes[:, sel, [0, 1, 2]].reshape(-1, 3)


def _rot(axis: int, degrees: float) -> np.ndarray:
    """The rotation by ``degrees`` about axis 0 (x), 1 (y) or 2 (z)."""
    c, s = np.cos(np.deg2rad(degrees)), np.sin(np.deg2rad(degrees))
    i, j = (axis + 1) % 3, (axis + 2) % 3
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def _first_clear(draw, placed: List[np.ndarray]):
    """The first of up to MAX_ITER candidates that overlaps none of the
    ``placed`` xz boxes [low; high] (the generator's interval test), or
    None.  ``draw(k)`` gives the next k candidates (k, 2, 2) with their
    poses' xz shifts (k, 2), which are drawn in growing chunks."""
    boxes = np.stack(placed) if placed else np.zeros((0, 2, 2))
    k, left = 8, MAX_ITER
    while left:
        cands, shifts = draw(min(k, left))
        left -= len(cands)
        gap = np.abs(cands.sum(1)[:, None] - boxes.sum(1)[None]) / 2
        reach = ((cands[:, 1] - cands[:, 0])[:, None]
                 + (boxes[:, 1] - boxes[:, 0])[None]) / 2
        free = np.flatnonzero(~(gap < reach).all(-1).any(-1))
        if len(free):
            return cands[free[0]], shifts[free[0]]
        k *= 4
    return None


class Room:
    """One room's objects (canonical boxes) and their poses (N_FRAME, n, 4,
    4), canonical -> world, y up."""

    def __init__(self, rng):
        self.rng = rng
        while True:
            try:
                self._build()
                return
            except ValueError:  # no place, or no frames, for its objects
                continue

    def _build(self):
        rng = self.rng
        t = rng.randint(len(N_OBJECTS))
        n = N_OBJECTS[t]
        side = rng.uniform(*XZ_GROUND_RANGE)
        self.xz = np.array([1.0, side] if rng.rand() < 0.5 else [side, 1.0])
        self.objects = [_boxes(rng.randint(4), rng)
                        * rng.uniform(*SCALE_INTERVALS[t]) for _ in range(n)]
        poses = []
        for obj in self.objects:
            p = np.eye(4)
            p[:3, :3] = _rot(1, rng.uniform(0.0, 360.0))
            poses.append(self._ground(obj, p))
        frames = [self._place(poses)]
        tries = 0
        while len(frames) < N_FRAME and tries <= FRAME_TRIES:
            try:
                frames.append(self._move(self._turn(frames[-1])))
            except ValueError:
                tries += 1
        if len(frames) < N_FRAME:
            raise ValueError("the objects found no next frame")
        self.poses = np.stack(frames)

    def _turn(self, poses):
        """Each object turned by up to MOT_ANGLE degrees (about y with
        probability PROB_ROTATION_Y, else about x or z) and re-grounded
        (``dynamic_poses``)."""
        rng, out = self.rng, []
        for obj, p in zip(self.objects, poses):
            if rng.rand() < PROB_ROTATION_Y:
                r = _rot(1, rng.uniform(-MOT_ANGLE, MOT_ANGLE))
            else:
                angle = rng.uniform(-MOT_ANGLE, MOT_ANGLE)
                r = _rot(0 if rng.rand() < 0.5 else 2, angle)
            q = p.copy()
            q[:3, :3] = r @ p[:3, :3]
            out.append(self._ground(obj, q))
        return out

    @staticmethod
    def _ground(obj, pose):
        """pose with its height set so that the object stands on the
        floor."""
        pose = pose.copy()
        pose[1, 3] = 0.0
        low = (_corners(obj) @ pose[:3, :3].T)[:, 1].min()
        pose[1, 3] = GROUND_LEVEL - low
        return pose

    def _xz_box(self, obj, pose):
        w = _corners(obj) @ pose[:3, :3].T + pose[:3, 3]
        return np.stack([w.min(0), w.max(0)])[:, [0, 2]]

    def _place(self, poses):
        """Uniform xz positions without overlap (``sample_locations``)."""
        rng, placed, out = self.rng, [], []
        boxes = [self._xz_box(obj, p) for obj, p in zip(self.objects, poses)]
        if sum(np.prod(b[1] - b[0]) for b in boxes) \
                > np.prod(self.xz - 2 * WALL_THICKNESS):
            raise ValueError("the objects cover more than the floor")
        for box, p in zip(boxes, poses):
            bounds = box[1] - box[0]

            def draw(k):
                loc0 = (-self.xz / 2 + WALL_THICKNESS + rng.rand(k, 2)
                        * (self.xz - bounds - 2 * WALL_THICKNESS))
                return np.stack([loc0, loc0 + bounds], 1), loc0 - box[0]

            out.append(self._shifted(p, _first_clear(draw, placed), placed))
        return out

    def _move(self, poses):
        """Each object shifted by 0.02-0.04 along x and z, either sign,
        inside the room and clear of the objects moved before it
        (``dynamic_locations``)."""
        rng, placed, out = self.rng, [], []
        lo = -self.xz / 2 + WALL_THICKNESS
        for obj, p in zip(self.objects, poses):
            box = self._xz_box(obj, p)

            def draw(k):
                shift = rng.uniform(*MOT_TRANSL_RANGE, (k, 2))
                shift = np.where(rng.rand(k, 2) < 0.5, shift, -shift)
                cands = box[None] + shift[:, None]
                inside = ((cands[:, 0] >= lo) & (cands[:, 1] <= -lo)).all(-1)
                return cands[inside], shift[inside]

            out.append(self._shifted(p, _first_clear(draw, placed), placed))
        return out

    @staticmethod
    def _shifted(pose, found, placed):
        """pose moved along x and z by a clear candidate's shift, the
        candidate's box placed; a ValueError where none was found."""
        if found is None:
            raise ValueError("no place for an object")
        box, shift = found
        placed.append(box)
        pose = pose.copy()
        pose[[0, 2], 3] += shift
        return pose

    def frame(self, f: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """n points of frame f on the objects' faces: (pc (n, 3), segm (n,)
        with the object ids from 1)."""
        rng = self.rng
        parts = [_faces(obj) for obj in self.objects]
        origin, u, v, area = (np.concatenate([q[i] for q in parts])
                              for i in range(4))
        owner = np.concatenate([np.full(len(q[0]), k)
                                for k, q in enumerate(parts)])
        cum = np.cumsum(area)
        face = np.searchsorted(cum, (rng.rand() + np.arange(n)) / n * cum[-1])
        face = np.minimum(face, len(area) - 1)
        a, b = rng.rand(n, 1), rng.rand(n, 1)
        local = origin[face] + a * u[face] + b * v[face]
        pose = self.poses[f][owner[face]]
        pc = np.einsum("nij,nj->ni", pose[:, :3, :3], local) + pose[:, :3, 3]
        return pc, owner[face] + 1


def compute_flow(pc1, segm1, pose1, pose2):
    """Flow from the object pose change (``data/ogcdr.py::compute_flow``)."""
    flow = np.zeros_like(pc1)
    for k in range(pose1.shape[0]):
        rel = pose2[k] @ np.linalg.inv(pose1[k])
        sel = segm1 == (k + 1)
        flow[sel] = pc1[sel] @ rel[:3, :3].T + rel[:3, 3] - pc1[sel]
    return flow


def augment_transform(pcs, flows, aug, rng, n_view=2):
    """``data/augment.py::augment_transform`` with ``aug_pc2``: per view a
    random scale, rotation and shift of the pair, then frame 2 rotated and
    shifted on its own, the flows carried along.  (2, N, 3) pairs ->
    (2 n_view, N, 3)."""
    out_p, out_f = [], []
    for _ in range(n_view):
        degree = rng.uniform(-np.array(aug["degree_range"]),
                             np.array(aug["degree_range"]))
        rot = Rotation.from_euler("zyx", degree, degrees=True).as_matrix()
        scale = rng.uniform(aug["scale_low"], aug["scale_high"], 3)
        shift = rng.uniform(-np.array(aug["shift_range"]),
                            np.array(aug["shift_range"]))
        p1, p2 = scale * (pcs[0] @ rot.T) + shift, scale * (pcs[1] @ rot.T) \
            + shift
        f1, f2 = scale * (flows[0] @ rot.T), scale * (flows[1] @ rot.T)
        if "aug_pc2" in aug:
            a2 = aug["aug_pc2"]
            degree2 = rng.uniform(-np.array(a2["degree_range"]),
                                  np.array(a2["degree_range"]))
            rot2 = Rotation.from_euler("zyx", degree2,
                                       degrees=True).as_matrix()
            shift2 = rng.uniform(-np.array(a2["shift_range"]),
                                 np.array(a2["shift_range"]))
            warped2 = p2 + f2
            p2 = p2 @ rot2.T + shift2
            f2 = warped2 - p2
            f1 = (p1 + f1) @ rot2.T + shift2 - p1
        out_p.extend([p1, p2])
        out_f.extend([f1, f2])
    return np.stack(out_p), np.stack(out_f)


def room_items(rng, params: Dict, cfg: Dict) -> List[Tuple[np.ndarray, ...]]:
    """A room's training items, one a view pair, as ``train_flow``'s
    dataset yields them: (pcs (4, N, 3), segms (4, N), flows (4, N, 3),
    valids (4, N)), float32 / int32 / float32 / float32; clouds (0, 1) are
    the first augmented view's pair."""
    room = Room(rng)
    n = params["n_points"]
    frames = [room.frame(f, n) for f in range(N_FRAME)]
    out = []
    for v1, v2 in VIEW_SELS:
        (pc1, s1), (pc2, s2) = frames[v1], frames[v2]
        flows = np.stack([
            compute_flow(pc1, s1, room.poses[v1], room.poses[v2]),
            compute_flow(pc2, s2, room.poses[v2], room.poses[v1])])
        _, segms = np.unique(np.stack([s1, s2]), return_inverse=True)
        pcs, flows = augment_transform(np.stack([pc1, pc2]), flows,
                                       cfg["aug_transform_args"], rng)
        segms = np.tile(segms.reshape(2, n), (2, 1))
        out.append((pcs.astype(np.float32), segms.astype(np.int32),
                    flows.astype(np.float32),
                    np.ones(segms.shape, np.float32)))
    return out


def batches(params: Dict, cfg: Dict, seed: int) -> List[Tuple[np.ndarray, ...]]:
    """``params["batches"]`` batches of ``params["batch"]`` items, drawn
    from as many rooms as that takes and shuffled, each field stacked:
    (pcs (B, 4, N, 3), segms (B, 4, N), flows (B, 4, N, 3), valids (B, 4,
    N))."""
    rng = rng_for(seed)
    total = params["batches"] * params["batch"]
    pool: List[Tuple[np.ndarray, ...]] = []
    while len(pool) < total:
        pool.extend(room_items(rng, params, cfg))
    pool = [pool[i] for i in rng.permutation(len(pool))[:total]]
    B = params["batch"]
    return [tuple(np.stack(f) for f in zip(*pool[i:i + B]))
            for i in range(0, total, B)]
