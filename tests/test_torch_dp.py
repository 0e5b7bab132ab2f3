"""The port's data-parallel pieces (ogc_tpu_torch/parallel/mesh.py, the
kernel build's lock) and its data-parallel entry points against the JAX
package's.

* ``pad_batch`` / ``shard_padded``: 11 rows over 4 ranks, every rank's
  block and true count against the per-device blocks of
  ``ogc_tpu.parallel.mesh.shard_padded`` on a 4-device mesh (exact).
* ``dp_eval_fwd`` on an 11-row tree-valued function over 4 CPU shards,
  against the JAX ``dp_eval_fwd`` over 4 devices and the port's own single
  shard (tests/test_sharding.py:86); ``eval_devices``: ``--dp N`` on the
  CPU is N replicas, and ``--dp 2`` with one card raises the JAX message.
* The kernel build under concurrency: two processes build at once with a
  stub compiler; the compiler runs for one build only.
* ``torchrun --nproc_per_node 2 -m ogc_tpu_torch.train_seg ... --device
  cpu`` (gloo) against ``train_seg.py`` on 2 virtual CPU devices, from the
  same weights (each CLI wrapped to load them), exact neighbours, on a
  tiny synthetic SAPIEN root: every logged per-step scalar and the epoch's
  validation loss within rtol 1e-3; rank 0 alone writes the log.
* ``test_seg --dp 2`` and ``test_flow --dp 2`` (``--device cpu``: 2
  replicas) against the JAX CLIs' ``--dp 2``: AP@50 / PQ / F1 and EPE /
  AccS / AccR / Outlier within 1e-3.
"""

import json
import os
import os.path as osp
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.parallel import mesh as pmesh
from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu_torch.utils.params import (flownet_state_dict_from_jax,
                                        segnet_state_dict_from_jax)
from tests.synth import make_sapien_root
from tests.test_torch_cli import SEGNET, _random_flax_params
from tests.test_torch_flownet import random_flow_variables
from tests.torch_port_helper import REPO, pack, run_torch, start_torch

ROWS, RANKS = 11, 4
SEG_METRICS = ("AveragePrecision@50", "PanopticQuality@50", "F1-score@50")
FLOW_METRICS = ("EPE", "AccS", "AccR", "Outlier")
FLOWNET = {"npoint": 64, "use_instance_norm": False, "loc_flow_nn": 8,
           "loc_flow_rad": 0.1, "k_decay_fact": 1.0}


@pytest.fixture(scope="module")
def mesh_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dp_mesh")
    rng = np.random.RandomState(0)
    x = {"rows": np.arange(ROWS * 3, dtype=np.float32).reshape(ROWS, 3),
         "a": rng.randn(ROWS, 3).astype(np.float32),
         "c": rng.randn(ROWS, 3).astype(np.float32)}
    (out,) = run_torch([("dp_mesh", pack(str(tmp / "in.npz"), x,
                                         {"size": RANKS}),
                         str(tmp / "out.npz"))])
    return x, out


def test_shard_padded_blocks_match_the_jax_mesh(mesh_out):
    x, out = mesh_out
    rows = x["rows"]
    np.testing.assert_array_equal(
        out["padded"], pmesh.pad_batch(rows, -(-ROWS // RANKS) * RANKS))
    (sharded,), b = pmesh.shard_padded(
        pmesh.make_mesh(jax.devices()[:RANKS]), [rows])
    shards = sorted(sharded.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    assert b == ROWS and len(shards) == RANKS
    true = 0
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(out[f"block{r}"], np.asarray(s.data))
        assert out[f"true{r}"][0] == ROWS
        true += int(out[f"true{r}"][1])
    assert [int(out[f"true{r}"][1]) for r in range(RANKS)] == [3, 3, 3, 2]
    assert true == ROWS


def test_dp_eval_fwd_tree_matches_jax(mesh_out):
    x, out = mesh_out
    jitted = jax.jit(lambda p, a, c: {"a": a * p, "b": [a + c, a.sum(-1)]})
    want = pmesh.dp_eval_fwd(jitted, jnp.float32(2.0), RANKS)(x["a"], x["c"])
    assert int(out["dp/n_devices"]) == RANKS
    assert int(out["dp1/n_devices"]) == 1
    for key, w in (("a", want["a"]), ("b0", want["b"][0]),
                   ("b1", want["b"][1])):
        assert out[f"dp/{key}"].shape == w.shape
        np.testing.assert_allclose(out[f"dp/{key}"], w, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(out[f"dp/{key}"], out[f"dp1/{key}"])


def test_dp_above_the_card_count_raises_the_jax_message(mesh_out):
    _, out = mesh_out
    assert str(out["raises"]) == (
        "n_devices=2 exceeds the 1 local devices (multi-host serving "
        "shards each process's loader separately; pass 0 for all local "
        "devices)")


STUB = r'''import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(out + "\n")
time.sleep(0.2)
open(out, "w").close()
'''

BUILD = r'''import sys
from ogc_tpu_torch.ops import _build
_build._nvcc = lambda: sys.argv[1]
_build.BUILD_DIR = sys.argv[2]
print(_build.build())
'''


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes that build at once: one runs the compiler (one
    process a source and the link), the other waits on the lock and loads
    the same library."""
    stub = tmp_path / "nvcc"
    stub.write_text("#!" + sys.executable + "\n" + STUB)
    stub.chmod(0o755)
    log = tmp_path / "log"
    env = dict(os.environ, STUB_LOG=str(log))
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD, str(stub), str(tmp_path / "build")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and osp.exists(paths.pop())
    n_sources = len([f for f in os.listdir(f"{REPO}/ogc_tpu_torch/csrc")
                     if f.endswith(".cu")])
    compiled = log.read_text().split()
    assert len(compiled) == n_sources + 1, compiled


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

JAX_TRAIN = r'''import pickle, sys
from ogc_tpu.models.segnet import MaskFormer3D
with open(sys.argv[1], "rb") as f:
    params = pickle.load(f)
MaskFormer3D.init = lambda self, *a, **k: params
sys.argv = ["train_seg.py"] + sys.argv[2:]
import train_seg
train_seg.main()
'''

PORT_TRAIN = r'''import sys
import numpy as np
import torch
import ogc_tpu_torch.train_seg as cli
state = {k: torch.from_numpy(v) for k, v in np.load(sys.argv[1]).items()}
real = cli.segnet_for
def segnet_for(*a, **k):
    model = real(*a, **k)
    model.load_state_dict(state)
    return model
cli.segnet_for = segnet_for
cli.main(sys.argv[2:])
'''


def _scalars(path):
    """{(tag, step): value} of a scalars.jsonl."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in rows}


def _seg_metrics(stdout):
    return {m: float(re.search(re.escape(m) + r":? (\S+)", stdout).group(1))
            for m in SEG_METRICS}


def _flow_report(stdout):
    import ast

    m = re.search(r"Evaluation on sapien-test: (\{.*\})", stdout)
    assert m, stdout[-2000:]
    return ast.literal_eval(m.group(1))


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Every JAX and port run of this module's entry points, all started
    together."""
    tmp = tmp_path_factory.mktemp("torch_dp_cli")
    root = str(tmp / "MBS_SAPIEN")
    for part in ("mbs-shapepart", "mbs-sapien"):
        make_sapien_root(osp.join(root, part), n_scenes=4, n_points=64)

    # train_seg: one epoch of B = 4 (2 a rank), no augmented views.
    with open(f"{REPO}/config/seg/sapien/sapien_unsup.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update({"predflow_path": None, "aug_transform_epoch": 100,
                "epochs": 1, "batch_size": 4, "segnet": SEGNET})
    cfg["data"]["root"] = root
    cfg["loss"]["start_steps"] = [0, 0, 0]
    params = _random_flax_params(3)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    np.savez(tmp / "state.npz", **segnet_state_dict_from_jax(params))
    train_cfgs = {}
    for side in ("jax", "port"):
        c = dict(cfg, save_path=str(tmp / side / "sapien_unsup"))
        train_cfgs[side] = str(tmp / f"train_{side}.yaml")
        with open(train_cfgs[side], "w") as f:
            yaml.safe_dump(c, f)
    for script, text in (("jax_train.py", JAX_TRAIN),
                         ("port_train.py", PORT_TRAIN)):
        (tmp / script).write_text(text)

    # test_seg and test_flow read one checkpoint each.
    seg_save = str(tmp / "ckpt" / "sapien_unsup")
    seg_best = osp.join(seg_save + "_R1", "best")
    os.makedirs(osp.dirname(seg_best))
    save_checkpoint({"model_state": params}, True,
                    filename=osp.join(osp.dirname(seg_best), "current"),
                    bestname=seg_best)
    seg_cfg = str(tmp / "seg.yaml")
    with open(seg_cfg, "w") as f:
        yaml.safe_dump({"dataset": "sapien", "save_path": seg_save,
                        "data": {"root": root, "decentralize": False},
                        "segnet": SEGNET}, f)
    flow_save = str(tmp / "ckpt" / "flow_sapien")
    variables = random_flow_variables(
        FlowStep3D(npoint=FLOWNET["npoint"], arch="sapien"),
        FLOWNET["npoint"], 5)
    os.makedirs(flow_save)
    save_checkpoint({"model_state": variables}, True,
                    filename=osp.join(flow_save, "current"),
                    bestname=osp.join(flow_save, "best"))
    flow_cfg = str(tmp / "flow.yaml")
    with open(flow_cfg, "w") as f:
        yaml.safe_dump({"dataset": "sapien", "save_path": flow_save,
                        "data": {"root": root, "decentralize": False},
                        "flownet": FLOWNET}, f)
    finish = start_torch([
        ("save_ckpt", pack(str(tmp / "seg_ckpt.in.npz"), {},
                           {"path": seg_best},
                           segnet_state_dict_from_jax(params)),
         str(tmp / "seg_ckpt.out.npz")),
        ("save_ckpt", pack(str(tmp / "flow_ckpt.in.npz"), {},
                           {"path": osp.join(flow_save, "best")},
                           flownet_state_dict_from_jax(variables)),
         str(tmp / "flow_ckpt.out.npz"))])

    exact = {"OGC_EXACT_NEIGHBORS": "1", "OGC_WRITER": "jsonl",
             "PYTHONPATH": REPO}
    jax_env = dict(os.environ, OGC_PLATFORM="cpu", **exact,
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
    port_env = dict(os.environ, OMP_NUM_THREADS="2", **exact)
    seg_flags = ["--split", "test", "--round", "1", "--test_batch_size", "4",
                 "--dp", "2"]
    flow_flags = ["--split", "test", "--test_batch_size", "6",
                  "--test_model_iters", "2", "--dp", "2"]

    def start(argv, env):
        return subprocess.Popen(argv, cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = {
        ("train", "jax"): start(
            [sys.executable, str(tmp / "jax_train.py"),
             str(tmp / "params.pkl"), train_cfgs["jax"], "--round", "1"],
            jax_env),
        ("train", "port"): start(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", str(tmp / "port_train.py"),
             str(tmp / "state.npz"), train_cfgs["port"], "--round", "1",
             "--device", "cpu"], port_env),
        ("seg", "jax"): start([sys.executable, "test_seg.py", seg_cfg,
                               *seg_flags], jax_env),
        ("flow", "jax"): start([sys.executable, "test_flow.py", flow_cfg,
                                *flow_flags], jax_env)}
    try:
        finish()
        for what, cfg_path, flags in (("seg", seg_cfg, seg_flags),
                                      ("flow", flow_cfg, flow_flags)):
            procs[what, "port"] = start(
                [sys.executable, "-m", f"ogc_tpu_torch.test_{what}",
                 cfg_path, *flags, "--device", "cpu"], port_env)
        outs = {k: p.communicate(timeout=900) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][1][-3000:])
    return {"tmp": tmp, "out": {k: o for k, (o, _) in outs.items()}}


def test_torchrun_train_seg_matches_the_jax_cli_on_two_devices(clis):
    tmp, out = clis["tmp"], clis["out"]
    logs = {side: _scalars(tmp / side / "sapien_unsup_R1" / "log"
                           / "scalars.jsonl") for side in ("jax", "port")}
    steps = [k for k in logs["jax"] if k[0].startswith("train/")]
    assert steps and sorted(k for k in logs["port"]
                            if k[0].startswith("train/")) == sorted(steps)
    for k in steps + [("epoch_sum_val/dynamic", 1),
                      ("epoch_sum_val/smooth", 1)]:
        np.testing.assert_allclose(logs["port"][k], logs["jax"][k],
                                   rtol=1e-3, atol=1e-6, err_msg=str(k))
    val = [re.search(r"val: loss=(\S+)", out["train", side]).group(1)
           for side in ("jax", "port")]
    assert abs(float(val[0]) - float(val[1])) <= 1e-3 * abs(float(val[0]))
    # One writer, one line per scalar: rank 0 alone wrote the log.
    lines = (tmp / "port" / "sapien_unsup_R1" / "log"
             / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == len(logs["port"])
    assert out["train", "port"].count("[epoch   1] train:") == 1
    assert (tmp / "port" / "sapien_unsup_R1" / "best.pth.tar").exists()


def test_test_seg_dp2_matches_the_jax_cli(clis):
    out = clis["out"]
    want, got = _seg_metrics(out["seg", "jax"]), _seg_metrics(out["seg",
                                                                  "port"])
    for m in SEG_METRICS:
        assert abs(got[m] - want[m]) <= 1e-3, (m, got, want)


def test_test_flow_dp2_matches_the_jax_cli(clis):
    out = clis["out"]
    want, got = _flow_report(out["flow", "jax"]), _flow_report(
        out["flow", "port"])
    for m in FLOW_METRICS:
        assert abs(got[m] - want[m]) <= 1e-3, (m, got, want)
