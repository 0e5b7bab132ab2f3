"""``python -m ogc_tpu_torch.test_seg --visualize`` against the repo's
``test_seg.py --visualize`` on a tiny synthetic SAPIEN test split with the
same weights (tests/test_torch_cli.py's setup), each run from a working
directory of its own.

Both write ``vis_seg/{i:04d}_{t}_{gt,pred}.png`` for the first 20 scenes
(here both, 4 frames each) and exit 0.  The port's PNGs (numpy and zlib,
utils/visual.py) decode to 512 x 512 RGB images whose colours are white
and the palette colours of the segments drawn: the ground truth's and,
for a prediction, its argmax slots.
"""

import os
import os.path as osp
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import yaml

from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu.utils.visual import COLOR20
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.synth import make_sapien_root
from tests.test_torch_cli import SEGNET, _random_flax_params
from tests.torch_port_helper import REPO, pack, run_torch

N_SCENES, N_FRAMES = 2, 4


def _read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG with filter type 0 rows."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = size[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_visualize")
    root = str(tmp / "MBS_SAPIEN")
    make_sapien_root(osp.join(root, "mbs-sapien"), n_scenes=N_SCENES,
                     n_points=64)
    save_path = str(tmp / "ckpt" / "sapien_unsup")
    cfg_path = str(tmp / "sapien_unsup.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"dataset": "sapien", "save_path": save_path,
                        "data": {"root": root, "decentralize": False},
                        "segnet": SEGNET}, f)
    params = _random_flax_params(5)
    best = osp.join(save_path + "_R1", "best")
    os.makedirs(osp.dirname(best))
    save_checkpoint({"model_state": params}, True,
                    filename=osp.join(osp.dirname(best), "current"),
                    bestname=best)
    flags = [cfg_path, "--split", "test", "--round", "1", "--visualize"]
    cwd = {side: tmp / side for side in ("jax", "port")}
    for d in cwd.values():
        d.mkdir()
    jax_run = subprocess.Popen(
        [sys.executable, osp.join(REPO, "test_seg.py"), *flags],
        cwd=cwd["jax"], env=dict(os.environ, OGC_PLATFORM="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_torch([("save_ckpt", pack(str(tmp / "ckpt.in.npz"), {},
                                      {"path": best},
                                      segnet_state_dict_from_jax(params)),
                    str(tmp / "ckpt.out.npz"))])
        port = subprocess.run(
            [sys.executable, "-m", "ogc_tpu_torch.test_seg", *flags,
             "--device", "cpu"], cwd=cwd["port"], capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
        _, jax_err = jax_run.communicate(timeout=600)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, jax_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    return {side: sorted(os.listdir(d / "vis_seg")) for side, d in
            cwd.items()}, cwd["port"] / "vis_seg"


def test_visualize_writes_the_jax_clis_files(runs):
    files, _ = runs
    assert files["port"] == files["jax"]
    assert len(files["port"]) == N_SCENES * N_FRAMES * 2
    assert files["port"][:2] == ["0000_0_gt.png", "0000_0_pred.png"]


def test_visualize_pngs_show_the_segments(runs):
    files, vis = runs
    palette = {tuple(c) for c in np.round(COLOR20 * 255).astype(int)}
    for name in files["port"]:
        img = _read_png(str(vis / name))
        assert img.shape == (512, 512, 3)
        colours = {tuple(c) for c in np.unique(img.reshape(-1, 3), axis=0)}
        assert (255, 255, 255) in colours
        drawn = colours - {(255, 255, 255)}
        assert drawn and drawn <= palette, name
