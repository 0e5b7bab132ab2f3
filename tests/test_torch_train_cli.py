"""``python -m ogc_tpu_torch.train_seg --device cpu`` end to end on a tiny
synthetic SAPIEN set: one epoch with the augmented views phased in at once
(4 frames per item), a checkpoint that ``python -m ogc_tpu_torch.test_seg``
evaluates, a resumed second epoch, and the options the port refuses."""

import os
import os.path as osp
import re
import subprocess
import sys

import pytest
import yaml

from tests.synth import make_sapien_root
from tests.torch_port_helper import REPO

SEGNET = {"n_slot": 4, "n_point": 64, "use_xyz": True,
          "n_transformer_layer": 1, "transformer_embed_dim": 32,
          "transformer_input_pos_enc": False}


def _port(module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"ogc_tpu_torch.{module}", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "2"})


def _config(tmp, name, **over):
    with open(osp.join(REPO, "config/seg/sapien/sapien_unsup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"save_path": str(tmp / "ckpt" / "sapien_unsup"),
                "predflow_path": None, "aug_transform_epoch": 0,
                "epochs": 1, "batch_size": 2, "segnet": SEGNET})
    cfg["data"]["root"] = str(tmp / "MBS_SAPIEN")
    cfg.update(over)
    path = str(tmp / name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_train_cli")
    for part in ("mbs-shapepart", "mbs-sapien"):
        make_sapien_root(str(tmp / "MBS_SAPIEN" / part), n_scenes=4,
                         n_points=64)
    cfg = _config(tmp, "sapien_unsup.yaml")
    train = _port("train_seg", cfg, "--round", "1")
    assert train.returncode == 0, train.stderr[-3000:]
    test = _port("test_seg", cfg, "--split", "test", "--round", "1",
                 "--test_batch_size", "4")
    assert test.returncode == 0, test.stderr[-3000:]
    return tmp, cfg, train.stdout, test.stdout


def test_train_seg_cli_trains_and_checkpoints(trained):
    tmp, _, out, _ = trained
    assert re.search(r"\[epoch   1\] train: dynamic=\S+, smooth=\S+, "
                     r"invariance=\S+", out), out
    assert "[epoch   1]   val: loss=" in out
    exp = tmp / "ckpt" / "sapien_unsup_R1"
    for name in ("current.pth.tar", "best.pth.tar", "log/scalars.jsonl"):
        assert (exp / name).exists(), name
    assert "epoch_sum_val/PQ@50" in (exp / "log" / "scalars.jsonl").read_text()


def test_test_seg_reads_the_trained_checkpoint(trained):
    _, _, _, out = trained
    assert "Evaluation on sapien-test" in out
    pq = float(re.search(r"PanopticQuality@50: (\S+)", out).group(1))
    assert 0.0 <= pq <= 1.0


def test_resume_continues_from_the_saved_epoch(trained):
    tmp, _, _, _ = trained
    cfg = _config(tmp, "sapien_unsup_2ep.yaml", epochs=2)
    r = _port("train_seg", cfg, "--round", "1", "--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Resumed from epoch 1" in r.stdout
    assert "[epoch   2] train:" in r.stdout
    assert "[epoch   1]" not in r.stdout


def test_remat_and_unported_loss_options_are_refused(trained):
    tmp, cfg, _, _ = trained
    r = _port("train_seg", cfg, "--remat", "full", timeout=120)
    assert r.returncode != 0 and "NotImplementedError" in r.stderr
    with open(cfg) as f:
        mutual = yaml.safe_load(f)
    mutual["loss"]["smooth_loss_params"]["graph"] = "mutual"
    path = str(tmp / "mutual.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(mutual, f)
    r = _port("train_seg", path, timeout=120)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and "A.13" in r.stderr
