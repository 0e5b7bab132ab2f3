"""``python -m ogc_tpu_torch.test_seg`` against the repo's test_seg.py on a
tiny synthetic SAPIEN set with the same weights (a flax checkpoint, and the
port checkpoint converted from it), plus the port's import hygiene.

At 64 points the second SA stage asks for k = 64 neighbours among 32 points,
so the k > M padding runs.  The clouds are continuous, so a neighbour tie
broken differently by the two distance forms could move a mask slightly;
AP@50, PQ and F1 must agree within 1e-3.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import yaml

from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.synth import make_sapien_root
from tests.torch_port_helper import REPO, pack, run_torch

SEGNET = {"n_slot": 4, "n_point": 64, "use_xyz": True,
          "n_transformer_layer": 1, "transformer_embed_dim": 64,
          "transformer_input_pos_enc": False}
METRICS = ("AveragePrecision@50", "PanopticQuality@50", "F1-score@50")


def _random_flax_params(seed):
    model = MaskFormer3D(n_slot=SEGNET["n_slot"], n_point=SEGNET["n_point"],
                         arch="sapien",
                         n_transformer_layer=SEGNET["n_transformer_layer"],
                         transformer_embed_dim=SEGNET["transformer_embed_dim"])
    pc = np.zeros((1, SEGNET["n_point"], 3), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), pc, pc)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        z = rng.randn(*s.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return 1 + 0.1 * z if path[-1].key == "scale" else z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _metrics(stdout):
    return {m: float(re.search(re.escape(m) + r":? (\S+)", stdout).group(1))
            for m in METRICS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    root = str(tmp / "MBS_SAPIEN")
    make_sapien_root(osp.join(root, "mbs-sapien"), n_scenes=2, n_points=64)
    save_path = str(tmp / "ckpt" / "sapien_unsup")
    cfg = {"dataset": "sapien", "save_path": save_path,
           "data": {"root": root, "decentralize": False}, "segnet": SEGNET}
    cfg_path = str(tmp / "sapien_unsup.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    params = _random_flax_params(3)
    best = osp.join(save_path + "_R1", "best")
    os.makedirs(osp.dirname(best))
    save_checkpoint({"model_state": params}, True,
                    filename=osp.join(osp.dirname(best), "current"),
                    bestname=best)

    flags = ["--split", "test", "--round", "1", "--test_batch_size", "4"]
    jax_run = subprocess.Popen(
        [sys.executable, "test_seg.py", cfg_path, *flags], cwd=REPO,
        env=dict(os.environ, OGC_PLATFORM="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        imports, _ = run_torch([
            ("imports", pack(str(tmp / "imp.in.npz"), {}),
             str(tmp / "imp.out.npz")),
            ("save_ckpt",
             pack(str(tmp / "ckpt.in.npz"), {}, {"path": best},
                  segnet_state_dict_from_jax(params)),
             str(tmp / "ckpt.out.npz")),
        ])
        port = subprocess.run(
            [sys.executable, "-m", "ogc_tpu_torch.test_seg", cfg_path, *flags,
             "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        jax_out, jax_err = jax_run.communicate(timeout=600)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, jax_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    return imports, jax_out, port.stdout, cfg_path


def test_test_seg_cli_matches_jax(runs):
    _, jax_out, port_out, _ = runs
    want, got = _metrics(jax_out), _metrics(port_out)
    for m in METRICS:
        assert abs(got[m] - want[m]) <= 1e-3, (m, got, want)
    assert "Evaluation on sapien-test" in port_out


def test_importing_the_port_leaves_jax_out(runs):
    """Importing test_seg and train_seg loads no jax, flax or ogc_tpu
    module."""
    imports, _, _, _ = runs
    assert str(imports["leaked"]) == "[]"


def test_approx_knn_is_refused(runs):
    """Approximate mode also changes the model (nested FPS); until it is
    ported the CLI must refuse it rather than run exact."""
    cfg_path = runs[3]
    r = subprocess.run(
        [sys.executable, "-m", "ogc_tpu_torch.test_seg", cfg_path,
         "--approx_knn", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and "queue B" in r.stderr


def test_port_sources_import_no_jax_and_no_ogc_tpu():
    """The port and chip_smoke.py import neither jax/flax nor any module of
    the JAX package (they carry their own copies of its jax-free parts)."""
    pkg = osp.join(REPO, "ogc_tpu_torch")
    paths = [osp.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [osp.join(dirpath, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b",
                             src, re.M), path
        assert not re.search(r"^\s*(import|from)\s+ogc_tpu(\.\w+)*\b",
                             src, re.M), path
