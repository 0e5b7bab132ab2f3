"""The port's copies of the outdoor datasets (ogc_tpu_torch/data/{waymo,
kittidet,semantickitti}.py) against the JAX package's, item by item and
bit for bit, on small synthetic roots (ogc_tpu_torch/tools/synth.py), and
their prediction writers.  Both are numpy-only, so both run here; the
augmented items draw from numpy's global generator, seeded alike before
each side.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest

from ogc_tpu.data.kittidet import KITTIDetectionDataset as JaxDet
from ogc_tpu.data.semantickitti import SemanticKITTIDataset as JaxSem
from ogc_tpu.data.waymo import WaymoOpenDataset as JaxWaymo
from ogc_tpu.data.waymo import WaymoOpenSingleFrameDataset as JaxWaymo1
from ogc_tpu_torch.data.kittidet import KITTIDetectionDataset as PortDet
from ogc_tpu_torch.data.semantickitti import SemanticKITTIDataset as PortSem
from ogc_tpu_torch.data.waymo import WaymoOpenDataset as PortWaymo
from ogc_tpu_torch.data.waymo import WaymoOpenSingleFrameDataset as PortWaymo1
from ogc_tpu_torch.tools.synth import make_single_frame_root, make_waymo_root

AUG = {"scale_low": 0.95, "scale_high": 1.05, "degree_range": [0, 180, 0],
       "shift_range": [1, 0.1, 1]}
SEQS = ["seq_a", "seq_b"]


def _same_items(a, b, n=None):
    assert len(a) == len(b) > 0
    for i in range(len(a) if n is None else n):
        np.random.seed(i)
        want = a[i]
        np.random.seed(i)
        got = b[i]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, list):
                assert len(g) == len(w)
                for gg, ww in zip(g, w):
                    np.testing.assert_array_equal(gg, ww)
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_outdoor_data")
    full = make_waymo_root(str(tmp / "waymo"), SEQS, 3, (300, 500), seed=1)
    down = make_waymo_root(str(tmp / "waymo_ds"), SEQS, 4, 256, seed=2,
                           downsampled=True)
    for root in (full, down):
        with open(osp.join(root, "train.txt"), "w") as f:
            f.write("\n".join(s + ".tfrecord" for s in SEQS + ["absent"]))
    # Saved flow predictions for the downsampled two-frame items.
    rng = np.random.RandomState(3)
    for seq in SEQS:
        d = osp.join(down, "flow_preds", "flowstep3d_gpf", seq)
        os.makedirs(d)
        for t in range(1, 4):
            np.save(osp.join(d, "flow_%04d_%04d.npy" % (t, t - 1)),
                    rng.randn(256, 3).astype(np.float32))
    with open(osp.join(down, "select2.json"), "w") as f:
        json.dump([[SEQS[1], 3, 2], [SEQS[0], 1, 0]], f)
    with open(osp.join(down, "select1.json"), "w") as f:
        json.dump([[SEQS[1], 0], [SEQS[0], 3]], f)
    det = make_single_frame_root(str(tmp / "kittidet"),
                                 ["%06d" % i for i in range(3)], 200, seed=4)
    with open(osp.join(det, "val.txt"), "w") as f:
        f.write("\n".join("%06d" % i for i in range(3)))
    pred = osp.join(det, "segm_preds", "OGC")
    for i in range(3):
        os.makedirs(osp.join(pred, "%06d" % i))
        np.save(osp.join(pred, "%06d" % i, "segm.npy"),
                rng.randint(0, 5, 200))
        np.save(osp.join(pred, "%06d" % i, "conf.npy"), rng.rand(18))
    sem = make_single_frame_root(
        str(tmp / "semantickitti"), ["00_000001", "03_000002", "12_000003",
                                     "08_000004"], 200, seed=5)
    return {"full": full, "down": down, "det": det, "sem": sem,
            "tmp": tmp}


@pytest.mark.parametrize("kw", [
    {},
    {"downsampled": True},
    {"downsampled": True, "decentralize": True, "ignore_class_ids": [2, 3],
     "ignore_npoint_thresh": 50},
    {"downsampled": True, "predflow_path": "flowstep3d_gpf",
     "aug_transform": True, "aug_transform_args": AUG},
    {"downsampled": True, "sampled_interval": 2},
    {"downsampled": True, "select_frame": "select2.json",
     "decentralize": True},
], ids=["raw", "down", "ignore", "predflow_aug", "interval", "select"])
def test_waymo_items_match_jax(roots, kw):
    root = roots["full"] if not kw else roots["down"]
    kw = dict(kw)
    if "select_frame" in kw:
        kw["select_frame"] = osp.join(root, kw["select_frame"])
    mapping = osp.join(root, "train.txt")
    a = JaxWaymo(data_root=root, mapping_path=mapping, **kw)
    b = PortWaymo(data_root=root, mapping_path=mapping, **kw)
    assert a.data_ids == b.data_ids
    _same_items(a, b)


@pytest.mark.parametrize("kw", [
    {},
    {"downsampled": True, "ignore_class_ids": [2, 3],
     "ignore_npoint_thresh": 30},
    {"downsampled": True, "onehot_label": True, "max_n_object": 22,
     "ignore_class_ids": [2, 3], "ignore_npoint_thresh": 30,
     "aug_transform": True, "aug_transform_args": AUG,
     "decentralize": True},
    {"downsampled": True, "select_frame": "select1.json",
     "onehot_label": True, "max_n_object": 10},
], ids=["raw", "ignore", "onehot_aug", "select"])
def test_waymo_single_frame_items_match_jax(roots, kw):
    root = roots["down"]
    kw = dict(kw)
    if "select_frame" in kw:
        kw["select_frame"] = osp.join(root, kw["select_frame"])
    mapping = osp.join(root, "train.txt")
    _same_items(JaxWaymo1(data_root=root, mapping_path=mapping, **kw),
                PortWaymo1(data_root=root, mapping_path=mapping, **kw))


def test_waymo_writers_match_jax(roots, tmp_path):
    root = roots["down"]
    mapping = osp.join(root, "train.txt")
    rng = np.random.RandomState(6)
    flow = rng.randn(3, 256, 3).astype(np.float32)
    mask = rng.rand(4, 256, 10).astype(np.float32)
    for name, two, one in (("jax", JaxWaymo, JaxWaymo1),
                           ("port", PortWaymo, PortWaymo1)):
        two(data_root=root, mapping_path=mapping)._save_predflow(
            flow, str(tmp_path / name / "flow"), batch_size=3, offset=1)
        one(data_root=root, mapping_path=mapping)._save_predsegm(
            mask, str(tmp_path / name / "segm"), batch_size=4, offset=1)
    files = sorted(osp.relpath(osp.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 7
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f),
                                      np.load(tmp_path / "jax" / f))


@pytest.mark.parametrize("kw", [
    {},
    {"decentralize": True, "onehot_label": True, "ignore_npoint_thresh": 20},
    {"onehot_label": True, "load_prediction": "OGC"},
    {"onehot_label": True, "load_prediction": "OGC", "load_confidence": True,
     "aug_transform": True, "aug_transform_args": AUG},
], ids=["plain", "onehot", "pred", "pred_conf_aug"])
def test_kittidet_items_match_jax(roots, kw):
    root = roots["det"]
    mapping = osp.join(root, "val.txt")
    a = JaxDet(data_root=root, mapping_path=mapping, **kw)
    b = PortDet(data_root=root, mapping_path=mapping, **kw)
    _same_items(a, b)


@pytest.mark.parametrize("kw", [
    {"sequence_list": list(range(11))},
    {"decentralize": True, "onehot_label": True, "ignore_npoint_thresh": 20},
], ids=["seq0_10", "all_onehot"])
def test_semantickitti_items_match_jax(roots, kw):
    a = JaxSem(data_root=roots["sem"], **kw)
    b = PortSem(data_root=roots["sem"], **kw)
    assert a.data_ids == b.data_ids
    assert len(a) == (3 if "sequence_list" in kw else 4)
    _same_items(a, b)


def test_single_frame_writers_match_jax(roots, tmp_path):
    rng = np.random.RandomState(7)
    mask = rng.rand(3, 200, 10).astype(np.float32)
    det, sem = roots["det"], roots["sem"]
    for name, make_det, make_sem in (("jax", JaxDet, JaxSem),
                                     ("port", PortDet, PortSem)):
        make_det(data_root=det, mapping_path=osp.join(det, "val.txt")) \
            ._save_predsegm(mask, str(tmp_path / name / "det"), batch_size=3)
        make_sem(data_root=sem)._save_predsegm(
            mask, str(tmp_path / name / "sem"), batch_size=3)
    files = sorted(osp.relpath(osp.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 6
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f),
                                      np.load(tmp_path / "jax" / f))
