"""``python -m ogc_tpu_torch.train_flow --device cpu`` end to end on a tiny
synthetic SAPIEN set (config/flow/sapien/sapien_unsup.yaml at 64 points,
B=4, 2 iterations): one epoch writes ``current`` and ``best`` (the full
train state) and per-iteration losses and EPE3D; ``--resume`` continues
with epoch 2 from Adam's restored count and the BatchNorm statistics;
``--bn_sync global`` gives the same epoch as ``local`` (one device);
the port's ``test_flow`` reads ``best`` unchanged; and the options the
port refuses (``--remat`` other than off, the bf16 compute mode,
InstanceNorm) raise."""

import json
import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import pytest
import yaml

from tests.synth import make_sapien_root
from tests.torch_port_helper import REPO

FLOWNET = {"npoint": 64, "use_instance_norm": False, "loc_flow_nn": 8,
           "loc_flow_rad": 0.1, "k_decay_fact": 1.0}
ITERS = 2


def _port(module, *args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", f"ogc_tpu_torch.{module}", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "2", "OGC_EXACT_NEIGHBORS": "1"})


def _config(tmp, name, **over):
    with open(osp.join(REPO, "config/flow/sapien/sapien_unsup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"save_path": str(tmp / "ckpt" / name), "epochs": 1,
                "batch_size": 4, "model_iters": ITERS, "flownet": FLOWNET})
    cfg["loss"]["iters_w"] = cfg["loss"]["iters_w"][:ITERS]
    cfg["data"]["root"] = str(tmp / "MBS_SAPIEN")
    cfg.update(over)
    path = str(tmp / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def _ckpt(path):
    """epoch, Adam's count and the BatchNorms' num_batches_tracked of a
    train-state checkpoint, read with torch in a process of its own."""
    code = ("import json, sys, torch; s = torch.load(sys.argv[1], "
            "weights_only=True); print(json.dumps({'epoch': s['epoch'], "
            "'count': s['optimizer_state']['count'], 'bn': [int(v) for k, v "
            "in s['model_state'].items() if k.endswith('num_batches_tracked')"
            "]}))")
    r = subprocess.run([sys.executable, "-c", code, path], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout)


def _epoch(out, n, what):
    m = re.search(rf"\[epoch +{n}\] +{what}: (.*)", out)
    assert m, out[-2000:]
    return m.group(1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_flow_cli")
    for part in ("mbs-shapepart", "mbs-sapien"):
        make_sapien_root(str(tmp / "MBS_SAPIEN" / part), n_scenes=3,
                         n_points=FLOWNET["npoint"])
    path, cfg = _config(tmp, "sapien_unsup")
    train = _port("train_flow", path)
    assert train.returncode == 0, train.stderr[-3000:]
    return tmp, path, cfg, train.stdout


def test_train_flow_cli_trains_and_checkpoints(trained):
    _, _, cfg, out = trained
    train = _epoch(out, 1, "train")
    keys = [f"{t}_#{i}" for i in range(ITERS)
            for t in ("chamfer_loss", "smooth_loss", "epe3d")] + ["sum"]
    for k in keys:
        m = re.search(re.escape(k) + r"=([0-9.]+)", train)
        assert m and np.isfinite(float(m.group(1))), (k, train)
    val = _epoch(out, 1, "val")
    assert re.match(r"loss=[0-9.]+ ", val), val
    state = _ckpt(osp.join(cfg["save_path"], "current.pth.tar"))
    # 2 train scenes x 6 view pairs at B=4: 3 Adam steps; every BatchNorm
    # updated its statistics (once per cloud and iteration it saw).
    assert state["epoch"] == 1 and state["count"] == 3
    assert state["bn"] and min(state["bn"]) >= 3
    for name in ("current", "best"):
        assert osp.exists(osp.join(cfg["save_path"], name + ".pth.tar"))
    with open(osp.join(cfg["save_path"], "log", "scalars.jsonl")) as f:
        assert any('"train/epe3d_#1"' in line for line in f)


def test_train_flow_cli_resumes(trained):
    tmp, _, cfg, _ = trained
    path2, _ = _config(tmp, "sapien_unsup", epochs=2)
    r = _port("train_flow", path2, "--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Resumed from epoch 1" in r.stdout
    _epoch(r.stdout, 2, "train")
    assert not re.search(r"\[epoch +1\] train:", r.stdout)
    state = _ckpt(osp.join(cfg["save_path"], "current.pth.tar"))
    assert state["epoch"] == 2 and state["count"] == 6


def test_test_flow_reads_the_trained_checkpoint(trained):
    _, path, _, _ = trained
    r = _port("test_flow", path, "--split", "test", "--test_batch_size",
              "6", "--test_model_iters", str(ITERS))
    assert r.returncode == 0, r.stderr[-3000:]
    m = re.search(r"Evaluation on sapien-test: \{'EPE': ([0-9.]+)", r.stdout)
    assert m and np.isfinite(float(m.group(1))), r.stdout[-2000:]


def test_bn_sync_global_is_local_on_one_device(trained):
    """Without augmentation (whose draws depend on the loader's threads)
    an epoch is deterministic: the same with either --bn_sync."""
    tmp = trained[0]
    outs = []
    for sync in ("local", "global"):
        path, cfg = _config(tmp, f"bn_sync_{sync}")
        cfg["data"]["aug_transform"] = False
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        r = _port("train_flow", path, "--bn_sync", sync)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(r.stdout)
    for what in ("train", "val"):
        assert _epoch(outs[0], 1, what) == _epoch(outs[1], 1, what)


@pytest.mark.parametrize("refusal", ["remat", "bf16", "instance_norm"])
def test_train_flow_cli_refusals(trained, refusal):
    tmp, path, _, _ = trained
    args = []
    if refusal == "remat":
        args = ["--remat", "scan"]
    elif refusal == "bf16":
        path, _ = _config(tmp, "bf16", compute_dtype="bf16")
    else:
        path, _ = _config(tmp, "inorm",
                          flownet={**FLOWNET, "use_instance_norm": True})
    r = _port("train_flow", path, *args)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr, r.stderr[-2000:]
