"""``--remat`` on the port (ogc_tpu_torch/ops/remat.py), on the CPU.

One step of each trainer from the same seeded weights under ``off``,
``full``, ``dots`` and, for the flow trainer, ``scan`` (each refinement
iteration checkpointed): the loss terms, the parameters after the Adam
step and the running statistics are bit-equal to ``off``.  The backward of
a remat step runs the norms again (the recompute happened) and no
neighbour search (the forward's selections were handed back); the flow
trainer's BatchNorm statistics moved once.  Sizes: SAPIEN's MaskFormer3D
at 64 points (one transformer layer), FlowStep3D ``sapien`` at 64 points,
2 iterations, B=2, two frames, exact neighbours.

Every train CLI refuses an unknown ``--remat`` (argparse's choices, as the
JAX CLIs), and an unknown ``OGC_REMAT`` raises ValueError (one torch
process asks every parser).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from tests.torch_port_helper import REPO, pack, run_torch

B, N, ITERS = 2, 64, 2
SEGNET = {"n_slot": 4, "n_point": N, "arch": "sapien",
          "n_transformer_layer": 1, "transformer_embed_dim": 32}
FLOW = {"npoint": N, "arch": "sapien"}
LR = {"lr": 1e-3, "lr_decay": 0.5, "lr_clip": 1e-5, "decay_step": 400000,
      "batch_size": B}
MODES = ["full", "dots", "scan"]
CLIS = ["train_seg", "train_flow", "train_seg_sup", "train_seg_waymo",
        "train_seg_waymo_sup"]


def _flow_loss():
    with open(f"{REPO}/config/flow/sapien/sapien_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["iters_w"] = loss["iters_w"][:ITERS]
    return loss


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_remat")
    rng = np.random.RandomState(8)
    pcs = (np.round(rng.rand(B, 2, N, 3) * 64) / 64).astype(np.float32)
    flows = (np.round(rng.randn(B, 2, N, 3) * 0.02 * 256) / 256).astype(
        np.float32)
    cfg = {"segnet": SEGNET, "flow": FLOW, "iters": ITERS, "lr": LR,
           "loss": _flow_loss(), "modes": MODES,
           "exp_base": str(tmp / "exp")}
    (out,) = run_torch([("remat", pack(
        str(tmp / "remat.in.npz"),
        {"pcs": pcs, "flows": flows,
         "segms": rng.randint(0, 4, (B, N)).astype(np.int32)}, cfg),
        str(tmp / "remat.out.npz"))], timeout=600)
    return out


def _part(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("kind,mode", [(k, m) for k in ("seg", "sup", "flow")
                                       for m in MODES
                                       if m != "scan" or k == "flow"])
def test_remat_step_is_bit_equal_to_off(steps, kind, mode):
    got, want = _part(steps, f"{kind}/{mode}/"), _part(steps, f"{kind}/off/")
    keys = sorted(k for k in want if k != "backward")
    assert sorted(k for k in got if k != "backward") == keys
    assert any(k.startswith("p/") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    norms, searches = got["backward"]
    assert norms > 0, "the backward recomputed nothing"
    assert searches == 0, "the recompute searched again"
    assert tuple(want["backward"]) == (0, 0)
    if kind == "flow":
        # the statistics moved in the forward (and, being equal to off's,
        # not again in the recompute)
        tracked = [v for k, v in got.items()
                   if k.endswith("num_batches_tracked")]
        assert tracked and all(int(t) > 0 for t in tracked)


REFUSALS = r'''import contextlib, importlib, io, json, sys
from ogc_tpu_torch.ops import remat
out = {}
for cli in sys.argv[1:]:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            importlib.import_module("ogc_tpu_torch." + cli).parse_args(
                ["cfg.yaml", "--remat", "everything"])
            out[cli] = [0, ""]
        except SystemExit as e:
            out[cli] = [e.code, err.getvalue()]
out["env"] = [str(remat.resolve(None)), str(remat.resolve("off"))]
try:
    remat.resolve("scan")
except ValueError as e:
    out["scan"] = str(e)
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def refusals():
    r = subprocess.run([sys.executable, "-c", REFUSALS, *CLIS], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "OGC_REMAT": "full"})
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("cli", CLIS)
def test_unknown_remat_value_is_refused(refusals, cli):
    code, err = refusals[cli]
    assert code == 2
    assert "invalid choice: 'everything'" in err, err[-2000:]


def test_unknown_remat_environment_raises(refusals):
    assert refusals["env"] == ["full", "None"]
    assert refusals["scan"].startswith("remat must be one of off/full/dots")
