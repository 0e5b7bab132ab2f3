"""``python -m ogc_tpu_torch.test_flow`` against the repo's test_flow.py on a
tiny synthetic SAPIEN set with the same weights (a flax checkpoint, and the
port checkpoint converted from it), and the port's copy of the OGC-DR
dataset against the JAX package's.

Both CLIs run 2 iterations with ``--save`` on their own copy of the root:
the printed EPE / AccS / AccR / Outlier must agree within 1e-4 and the saved
flows within 2e-5 (the per-iteration flow tolerance, PARITY.md:238-241).
A 4-iteration run of the port checks the saved files' format only (the
recurrence is chaotic past ~2 iterations); so does a run on OGC-DR.
"""

import ast
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu_torch.utils.params import flownet_state_dict_from_jax
from tests.synth import make_ogcdr_root, make_sapien_root
from tests.test_torch_flownet import random_flow_variables
from tests.torch_port_helper import REPO, pack, run_torch

FLOWNET = {"npoint": 64, "use_instance_norm": False, "loc_flow_nn": 8,
           "loc_flow_rad": 0.1, "k_decay_fact": 1.0}
N_SCENES, N_PAIRS = 2, 6
METRICS = ("EPE", "AccS", "AccR", "Outlier")


def _report(stdout, title):
    m = re.search(re.escape(f"Evaluation on {title}:") + r" (\{.*\})", stdout)
    assert m, stdout[-2000:]
    return ast.literal_eval(m.group(1))


def _config(tmp, name, dataset, root, save_path):
    cfg = {"dataset": dataset, "save_path": save_path,
           "data": {"root": root, "decentralize": False}, "flownet": FLOWNET}
    path = str(tmp / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _port_cli(cfg_path, *flags):
    return subprocess.run(
        [sys.executable, "-m", "ogc_tpu_torch.test_flow", cfg_path, *flags,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flow_cli")
    base = str(tmp / "MBS_SAPIEN")
    make_sapien_root(osp.join(base, "mbs-sapien"), n_scenes=N_SCENES,
                     n_points=FLOWNET["npoint"])
    roots = {}
    for side in ("jax", "port", "port4"):
        roots[side] = str(tmp / f"MBS_SAPIEN_{side}")
        shutil.copytree(base, roots[side])
    save_path = str(tmp / "ckpt" / "flow_sapien")
    model = FlowStep3D(npoint=FLOWNET["npoint"], arch="sapien")
    variables = random_flow_variables(model, FLOWNET["npoint"], 5)
    os.makedirs(save_path)
    save_checkpoint({"model_state": variables}, True,
                    filename=osp.join(save_path, "current"),
                    bestname=osp.join(save_path, "best"))
    cfgs = {side: _config(tmp, side, "sapien", root, save_path)
            for side, root in roots.items()}

    flags = ["--split", "test", "--test_batch_size", str(N_PAIRS),
             "--test_model_iters", "2", "--save"]
    jax_run = subprocess.Popen(
        [sys.executable, "test_flow.py", cfgs["jax"], *flags], cwd=REPO,
        env=dict(os.environ, OGC_PLATFORM="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        run_torch([("save_ckpt",
                    pack(str(tmp / "ckpt.in.npz"), {},
                         {"path": osp.join(save_path, "best")},
                         flownet_state_dict_from_jax(variables)),
                    str(tmp / "ckpt.out.npz"))])
        port = _port_cli(cfgs["port"], *flags)
        port4 = _port_cli(cfgs["port4"], *flags[:-2], "4", "--save")
        jax_out, jax_err = jax_run.communicate(timeout=900)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, jax_err[-3000:]
    for r in (port, port4):
        assert r.returncode == 0, r.stderr[-3000:]
    return roots, jax_out, port.stdout, port4.stdout


def _saved(root):
    d = osp.join(root, "mbs-sapien", "flow_preds", "flowstep3d")
    with open(d + ".json") as f:
        meta = json.load(f)
    return meta, {n: np.load(osp.join(d, n)) for n in sorted(os.listdir(d))}


def test_test_flow_cli_metrics_match_jax(runs):
    _, jax_out, port_out, _ = runs
    want = _report(jax_out, "sapien-test")
    got = _report(port_out, "sapien-test")
    for m in METRICS:
        assert abs(got[m] - want[m]) <= 1e-4, (m, got, want)
    assert "Loaded weights from" in port_out


def test_test_flow_cli_saved_flows_match_jax(runs):
    roots, _, _, _ = runs
    want_meta, want = _saved(roots["jax"])
    got_meta, got = _saved(roots["port"])
    assert got_meta == want_meta
    assert sorted(got) == sorted(want) and len(got) == N_SCENES
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape == (N_PAIRS, FLOWNET["npoint"], 3)
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= 2e-5 * scale, name


def test_test_flow_cli_four_iterations_format(runs):
    """4 iterations (the CLI's default): the saved files keep the format
    that the segmentation stage's SapienDataset(predflow_path=...) reads."""
    roots, jax_out, _, port4_out = runs
    want_meta, want = _saved(roots["jax"])
    meta, got = _saved(roots["port4"])
    assert meta == want_meta
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype
        assert np.isfinite(got[name]).all()
    got_report = _report(port4_out, "sapien-test")
    assert set(got_report) == set(_report(jax_out, "sapien-test"))


def test_ogcdr_dataset_items_match_jax(tmp_path):
    """The port's data/ogcdr.py (a copy) gives the JAX package's items,
    with true flows and with saved flow predictions."""
    from ogc_tpu.data.ogcdr import OGCDynamicRoomDataset as JaxDataset
    from ogc_tpu_torch.data.ogcdr import OGCDynamicRoomDataset as PortDataset

    root = str(tmp_path / "ogcdr")
    make_ogcdr_root(root, n_scenes=2, n_points=48)
    views = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]
    pred = osp.join(root, "flow_preds", "flowstep3d")
    os.makedirs(pred)
    rng = np.random.RandomState(0)
    for sid in ("scene000", "scene001"):
        np.save(osp.join(pred, sid + ".npy"),
                rng.randn(6, 48, 3).astype(np.float32))
    with open(pred + ".json", "w") as f:
        json.dump({"view_sel": views}, f)
    for kw in ({}, {"predflow_path": "flowstep3d"}):
        a = JaxDataset(root, split="test", view_sels=views, **kw)
        b = PortDataset(root, split="test", view_sels=views, **kw)
        assert len(a) == len(b) == 12
        for i in range(len(a)):
            for x, y in zip(a[i], b[i]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_test_flow_cli_runs_on_ogcdr(tmp_path):
    """dataset: ogcdr, which the port now reads: the CLI evaluates and saves
    the flows in the format the OGC-DR seg configs read."""
    root = str(tmp_path / "ogcdr")
    make_ogcdr_root(root, n_scenes=2, n_points=FLOWNET["npoint"])
    model = FlowStep3D(npoint=FLOWNET["npoint"], arch="ogcdr")
    state = flownet_state_dict_from_jax(
        random_flow_variables(model, FLOWNET["npoint"], 6))
    save_path = str(tmp_path / "ckpt")
    run_torch([("save_ckpt",
                pack(str(tmp_path / "ckpt.in.npz"), {},
                     {"path": osp.join(save_path, "best")}, state),
                str(tmp_path / "ckpt.out.npz"))])
    cfg = _config(tmp_path, "ogcdr", "ogcdr", root, save_path)
    r = _port_cli(cfg, "--split", "test", "--test_batch_size", "6",
                  "--test_model_iters", "2", "--save")
    assert r.returncode == 0, r.stderr[-3000:]
    report = _report(r.stdout, "ogcdr-test")
    assert all(np.isfinite(report[m]) for m in METRICS)
    d = osp.join(root, "flow_preds", "flowstep3d")
    for sid in ("scene000", "scene001"):
        assert np.load(osp.join(d, sid + ".npy")).shape == (6, 64, 3)
