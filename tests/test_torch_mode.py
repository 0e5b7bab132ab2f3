"""The neighbour mode of ``ogc_tpu_torch.train_seg`` follows the JAX
package's: with no ``OGC_EXACT_NEIGHBORS`` it trains in approximate mode,
with ``OGC_EXACT_NEIGHBORS=1`` in exact mode.  The two modes differ in the
model's FPS: approximate mode samples SA1 as a prefix of SA0's FPS output
(nested FPS), so a forward of the 2-stage SAPIEN arch runs FPS once instead
of twice.  ``train_seg.main`` runs in the torch helper's process on a tiny
synthetic SAPIEN root, counting forwards and FPS calls."""

import os.path as osp

import numpy as np
import pytest
import yaml

from tests.synth import make_sapien_root
from tests.torch_port_helper import REPO, pack, run_torch

SEGNET = {"n_slot": 4, "n_point": 64, "use_xyz": True,
          "n_transformer_layer": 1, "transformer_embed_dim": 32,
          "transformer_input_pos_enc": False}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mode")
    make_sapien_root(str(tmp / "MBS_SAPIEN" / "mbs-shapepart"), n_scenes=4,
                     n_points=64)
    with open(osp.join(REPO, "config/seg/sapien/sapien_unsup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"predflow_path": None, "aug_transform_epoch": 0,
                "epochs": 1, "batch_size": 2, "segnet": SEGNET})
    cfg["data"]["root"] = str(tmp / "MBS_SAPIEN")
    out = {}
    for exact in (False, True):
        name = "exact" if exact else "default"
        cfg["save_path"] = str(tmp / "ckpt" / name)
        path = str(tmp / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        (out[name],) = run_torch([(
            "train_mode", pack(str(tmp / f"{name}.in.npz"), {},
                               {"argv": [path, "--round", "1", "--device",
                                         "cpu"]}),
            str(tmp / f"{name}.out.npz"))], exact=exact)
    return out


def test_train_seg_trains_approximate_with_no_env(runs):
    r = runs["default"]
    assert not bool(r["exact_mode"])
    assert int(r["forward"]) > 0
    assert int(r["fps"]) == int(r["forward"])  # SA0 only: nested FPS
    np.testing.assert_array_equal(r["launches"], [0, 0, 0, 0])


def test_train_seg_trains_exact_with_env(runs):
    r = runs["exact"]
    assert bool(r["exact_mode"])
    assert int(r["forward"]) == int(runs["default"]["forward"])
    assert int(r["fps"]) == 2 * int(r["forward"])  # one per SA stage
