"""The port's outdoor entry points against the JAX package's, on small
synthetic roots (ogc_tpu_torch/tools/synth.py) with the same weights (a
flax checkpoint, and the port checkpoint converted from it by
ogc_tpu_torch.utils.params).

* ``test_flow_kittisf`` (per scene and ``--scene_batch 2 --dp 2``: each
  batched call sharded over 2 CPU replicas) and ``test_flow_waymo`` (GPF
  and ICP, ``--bound``; per scene and ``--scene_batch 2 --dp 2``),
  ``--save``, 2 iterations of the ``kitti`` flownet
  at npoint 128 on clouds of 600-900 points, exact neighbours: each port
  run against the JAX CLI's per-scene run (which the JAX package holds
  equal to its batched path).  EPE3D within 2e-4 (relative 1e-3), AccS,
  AccR and Outlier within 2 points of a scene, and every saved flow within
  5e-3 m at every point and 1e-3 m at the median one.  Measured: EPE 1.5e-4
  apart at most, the rates equal, flows 1.6e-4 m apart at most on KITTI-SF
  and 3.3e-3 m (median 6.9e-4) on the Waymo pair whose ICP is least
  determined, for flows of up to 3.1 m: the two float32 pipelines part at
  the ICP's transforms (tests/test_torch_outdoor_utils.py), which scale
  with the distance of a point.
  ``--use_odometry --denoise`` (GT poses; batched on both sides: the JAX
  CLI's per-scene ``--denoise`` writes into a read-only array and raises)
  and KITTI-SF ``--host_preproc`` (the numpy ICP) as well.
* One step of the ``train_seg_waymo`` trainer (SegTrainer with frame
  stride 2 on augmented WaymoOpenDataset items, waymo_unsup.yaml's loss
  with every term on) and of the ``train_seg_waymo_sup`` one
  (SupSegTrainer on WaymoOpenSingleFrameDataset's one-hot items, zero
  flows): every loss term within rtol 1e-4 of JAX's, exact neighbours and
  the reference-shaped SA chain on both sides, on a 1/16 grid (both d2
  forms exact).  And both port CLIs run an epoch on CPU and checkpoint.
* ``test_seg_waymo`` (``--dp 2``: each batch over 2 CPU replicas) and
  ``test_seg`` on ``kittidet`` and ``semantickitti``: every printed metric
  within 1e-6 of the JAX CLI's.
  Both packages run from a working directory holding the fixed split
  files they read (``data_prepare/...``) over the synthetic roots.

* ``test_flow_kittisf_benchmark``: the FlowStep3D report (the network's
  5 iterations on the protocol's seeded sample) and the "Ours" report (the
  saved flow of ``<root>_downsampled`` upsampled onto that sample), both
  within the flow CLIs' metric tolerances of the JAX CLI's.  The protocol
  draws 8192 points a frame; both sides draw BENCH_N here (the port's
  ``N_SAMPLE_POINT``, the JAX CLI's ``preproc`` wrapped), from the same
  numpy seed, so they sample the same points.
"""

import ast
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import yaml

from ogc_tpu import ops
from ogc_tpu.data.waymo import WaymoOpenDataset, WaymoOpenSingleFrameDataset
from ogc_tpu.losses.seg_sup import SupLossConfig
from ogc_tpu.losses.seg_unsup import OGCLossConfig
from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.train.seg import SegTrainer, make_optimizer
from ogc_tpu.train.seg_sup import SupSegTrainer
from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu_torch.tools.synth import (make_kittisf_full_root,
                                       make_single_frame_root,
                                       make_waymo_root)
from ogc_tpu_torch.utils.params import (flownet_state_dict_from_jax,
                                        segnet_state_dict_from_jax)
from tests.test_torch_flownet import random_flow_variables
from tests.test_torch_losses import _random_params
from tests.torch_port_helper import REPO, pack, run_torch

FLOWNET = {"npoint": 128, "use_instance_norm": False, "loc_flow_nn": 4,
           "loc_flow_rad": 1.5}
SEGNET = {"n_slot": 6, "n_point": 256, "use_xyz": True,
          "n_transformer_layer": 1, "transformer_embed_dim": 32,
          "transformer_input_pos_enc": False}
METRICS = ("EPE", "AccS", "AccR", "Outlier")
KITTI_IDS = ["%06d" % i for i in range(3)]
SEQ = "seq_a"
LR = {"lr": 1e-3, "lr_decay": 0.7, "lr_clip": 1e-5, "decay_step": 200000}
AUG = {"scale_low": 0.95, "scale_high": 1.05, "degree_range": [0, 180, 0],
       "shift_range": [1, 0.1, 1]}
TRAIN_B = 2
BENCH_N = 256
SEG_REPORT = ("AveragePrecision@50", "PanopticQuality@50", "F1-score@50",
              "Prec@50", "Recall@50")


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO, **extra)


def _jax(script, cfg, *flags, cwd=REPO):
    return subprocess.Popen(
        [sys.executable, osp.join(REPO, script), cfg, *flags], cwd=cwd,
        env=_env(OGC_PLATFORM="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _port(module, cfg, *flags, cwd=REPO):
    return subprocess.Popen(
        [sys.executable, "-m", f"ogc_tpu_torch.{module}", cfg, *flags,
         "--device", "cpu"], cwd=cwd, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _bench(side, cfg, cwd):
    """test_flow_kittisf_benchmark drawing BENCH_N points a frame: the
    port's through its N_SAMPLE_POINT, the JAX CLI's through its
    ``preproc`` (called with n_sample_point=8192)."""
    if side == "jax":
        code = ("import sys; import test_flow_kittisf_benchmark as m; "
                "f = m.preproc; m.preproc = lambda *a, **k: f(*a, **dict("
                f"k, n_sample_point={BENCH_N})); sys.argv = ['x', {cfg!r}]; "
                "m.main()")
        env = _env(OGC_PLATFORM="cpu")
    else:
        code = ("import ogc_tpu_torch.test_flow_kittisf_benchmark as m; "
                f"m.N_SAMPLE_POINT = {BENCH_N}; "
                f"m.main([{cfg!r}, '--device', 'cpu'])")
        env = _env()
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _bench_root(full, ids, seed):
    """``<full>_downsampled``: 300 points of each KITTI-SF scene
    (data/<id>/{pc,flow,segm}{1,2}.npy) and, as the predictions the
    benchmark reads (flowstep3d_for-benchmark_R2), their flows with 5 cm
    of noise."""
    rng = np.random.RandomState(seed)
    root = full + "_downsampled"
    for i in ids:
        src = osp.join(full, "processed", i)
        pc1, pc2 = (np.load(osp.join(src, f"pc{k}.npy")) for k in (1, 2))
        sel = np.sort(rng.choice(len(pc1), 300, replace=False))
        pc1, pc2 = pc1[sel], pc2[sel]
        segm = np.load(osp.join(src, "segm.npy"))[sel]
        flow = pc2 - pc1
        d = osp.join(root, "data", i)
        os.makedirs(d)
        for name, a in (("pc1", pc1), ("pc2", pc2), ("flow1", flow),
                        ("flow2", -flow), ("segm1", segm), ("segm2", segm)):
            np.save(osp.join(d, name + ".npy"), a)
        d = osp.join(root, "flow_preds", "flowstep3d_for-benchmark_R2", i)
        os.makedirs(d)
        for k, f in ((1, flow), (2, -flow)):
            noise = rng.normal(0, 0.05, f.shape).astype(np.float32)
            np.save(osp.join(d, f"flow{k}.npy"), f + noise)
    return full


def _yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _flow_roots(tmp):
    base = {"kitti": make_kittisf_full_root(str(tmp / "kitti"), KITTI_IDS,
                                            [700, 900, 800], seed=11),
            "waymo": make_waymo_root(str(tmp / "waymo"), [SEQ], 3,
                                     (600, 900), seed=12)}
    with open(osp.join(base["kitti"], "val.txt"), "w") as f:
        f.write("\n".join(KITTI_IDS))
    with open(osp.join(base["waymo"], "train.txt"), "w") as f:
        f.write(SEQ + ".tfrecord")
    return base


def _seg_roots(tmp, cwd):
    """Roots for the segmentation CLIs and trainers (1/16 grid) and the
    working directory holding the split files the CLIs read."""
    waymo = make_waymo_root(str(tmp / "waymo_ds"), [SEQ], 3, SEGNET["n_point"],
                            seed=13, downsampled=True)
    for d, _, files in os.walk(waymo):
        for f in files:
            if f.startswith("pc_"):
                p = osp.join(d, f)
                np.save(p, np.round(np.load(p) * 16) / 16)
    det = make_single_frame_root(str(tmp / "kittidet"),
                                 ["%06d" % i for i in range(4)],
                                 SEGNET["n_point"], seed=14)
    sem = make_single_frame_root(str(tmp / "semantickitti"),
                                 ["00_000000", "05_000001", "10_000002",
                                  "12_000003"], SEGNET["n_point"], seed=15)
    splits = {"waymo/splits/val.txt": SEQ + ".tfrecord",
              "waymo/splits/train.txt": SEQ + ".tfrecord",
              "kittidet/splits/val.txt": "\n".join("%06d" % i
                                                   for i in range(4)),
              "kittisf/splits/kitti142.txt": "\n".join(KITTI_IDS)}
    for name, text in splits.items():
        path = osp.join(cwd, "data_prepare", name)
        os.makedirs(osp.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return waymo, det, sem


def _trainer_batches(waymo):
    """One augmented two-frame batch and one one-hot single-frame batch of
    B = TRAIN_B items, as the two Waymo trainers' loaders give them."""
    mapping = osp.join(waymo, "train.txt")
    with open(mapping, "w") as f:
        f.write(SEQ + ".tfrecord")
    two = WaymoOpenDataset(waymo, mapping, downsampled=True,
                           aug_transform=True, aug_transform_args=AUG)
    one = WaymoOpenSingleFrameDataset(
        waymo, mapping, downsampled=True, aug_transform=True,
        aug_transform_args=AUG, onehot_label=True,
        max_n_object=SEGNET["n_slot"], ignore_class_ids=[2, 3],
        ignore_npoint_thresh=20)
    np.random.seed(0)
    unsup = [np.stack(a) for a in zip(*(two[i] for i in range(TRAIN_B)))]
    items = [one[i] for i in range(TRAIN_B)]
    pcs, segms, valids = (np.stack(a) for a in zip(*items))
    sup = [pcs, segms, np.zeros_like(pcs), valids]
    return ({k: v for k, v in zip(("pcs", "segms", "flows", "valids"),
                                  unsup)},
            {k: v for k, v in zip(("pcs", "segms", "flows", "valids"), sup)})


def _loss_block():
    with open(f"{REPO}/config/seg/waymo/waymo_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["start_steps"] = [0, 0, 0]
    return loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_outdoor_cli")
    cwd = str(tmp / "cwd")
    os.makedirs(cwd)
    base = _flow_roots(tmp)
    roots = {}
    for name in ("kitti", "waymo"):
        for side in ("jax", "port", "port_b", "odo"):
            roots[name, side] = str(tmp / f"{name}_{side}")
            shutil.copytree(base[name], roots[name, side])
    waymo_ds, det, sem = _seg_roots(tmp, cwd)

    # The same weights on both sides.
    flow_vars = random_flow_variables(
        FlowStep3D(npoint=FLOWNET["npoint"], arch="kitti"),
        FLOWNET["npoint"], 5)
    jax_flow = str(tmp / "ckpt" / "jax_flow")
    os.makedirs(osp.dirname(jax_flow))
    save_checkpoint(jax.device_get(flow_vars), False, filename=jax_flow)
    seg_model = MaskFormer3D(arch="waymo", **SEGNET)
    seg_params = _random_params(seg_model, 21)
    os.makedirs(tmp / "ckpt" / "jax_seg")
    save_checkpoint(jax.device_get(seg_params), False,
                    filename=str(tmp / "ckpt" / "jax_seg" / "best"))
    port_flow = str(tmp / "ckpt" / "port_flow")
    cases = [("save_ckpt", pack(str(tmp / "f.in.npz"), {},
                                {"path": port_flow},
                                flownet_state_dict_from_jax(flow_vars)),
              str(tmp / "f.out.npz")),
             ("save_ckpt", pack(str(tmp / "s.in.npz"), {},
                                {"path": str(tmp / "ckpt" / "port_seg" /
                                             "best")},
                                segnet_state_dict_from_jax(seg_params)),
              str(tmp / "s.out.npz"))]
    unsup, sup = _trainer_batches(waymo_ds)
    x = {f"unsup/{k}": v for k, v in unsup.items()}
    x.update({f"sup/{k}": v for k, v in sup.items()})
    state = {f"{t}.{k}": v for t in ("unsup", "sup")
             for k, v in segnet_state_dict_from_jax(seg_params).items()}
    segnet = {"arch": "waymo", **SEGNET}
    cases.append(("waymo_train", pack(
        str(tmp / "t.in.npz"), x,
        {"unsup_segnet": segnet, "sup_segnet": segnet, "loss": _loss_block(),
         "lr": {**LR, "batch_size": TRAIN_B}, "ignore_npoint_thresh": 50,
         "sup_weights": [2.0, 0.1], "exp_base": str(tmp / "exp_")}, state),
        str(tmp / "t.out.npz")))

    cfgs = {}
    for name, dataset in (("kitti", "kittisf"), ("waymo", "waymo")):
        for side in ("jax", "port", "port_b", "odo"):
            root = roots[name, side]
            cfgs[name, side] = _yaml(tmp / f"{name}_{side}.yaml", {
                "dataset": dataset,
                "save_path": jax_flow if side == "jax" else port_flow,
                "data": {"root": root, "mapping_path": osp.join(
                    root, "val.txt" if name == "kitti" else "train.txt")},
                "flownet": FLOWNET})
    bench = _bench_root(base["kitti"], KITTI_IDS, 16)
    for side, sp in (("jax", jax_flow), ("port", port_flow)):
        cfgs["bench", side] = _yaml(tmp / f"bench_{side}.yaml", {
            "dataset": "kittisf", "save_path": sp, "data": {"root": bench},
            "flownet": FLOWNET})
    cfgs["waymo", "odo_jax"] = _yaml(tmp / "waymo_odo_jax.yaml", {
        **yaml.safe_load(open(cfgs["waymo", "odo"])), "save_path": jax_flow})
    for side in ("jax", "port"):
        sp = str(tmp / "ckpt" / f"{side}_seg")
        for ds, root in (("waymo", waymo_ds), ("kittidet", det),
                         ("semantickitti", sem)):
            cfgs["seg_" + ds, side] = _yaml(tmp / f"seg_{ds}_{side}.yaml", {
                "dataset": ds, "save_path": sp, "segnet": SEGNET,
                "data": {"root": root, "decentralize": True}})
    kflags = ["--split", "val", "--test_model_iters", "2", "--save"]
    wflags = ["--split", "train", "--test_model_iters", "2", "--bound",
              "--save"]
    # The JAX CLI's per-scene --denoise writes into a read-only array
    # (np.asarray of a JAX array), so the JAX side runs it batched.
    oflags = ["--use_odometry", "--denoise", "--scene_batch", "2"]
    procs = {
        ("kitti", "jax"): _jax("test_flow_kittisf.py", cfgs["kitti", "jax"],
                               *kflags),
        ("waymo", "jax"): _jax("test_flow_waymo.py", cfgs["waymo", "jax"],
                               *wflags),
        ("waymo", "odo_jax"): _jax("test_flow_waymo.py",
                                   cfgs["waymo", "odo_jax"], *wflags,
                                   *oflags),
        ("seg", "jax"): _jax("test_seg_waymo.py", cfgs["seg_waymo", "jax"],
                             "--split", "val", "--test_batch_size", "2",
                             cwd=cwd),
        ("det", "jax"): _jax("test_seg.py", cfgs["seg_kittidet", "jax"],
                             "--split", "val", "--test_batch_size", "2",
                             cwd=cwd),
        ("sem", "jax"): _jax("test_seg.py", cfgs["seg_semantickitti", "jax"],
                             "--split", "test", "--test_batch_size", "3",
                             cwd=cwd),
        ("bench", "jax"): _bench("jax", cfgs["bench", "jax"], cwd),
    }
    try:
        run_torch(cases[:2])
        port_procs = {
            ("kitti", "port"): _port("test_flow_kittisf",
                                     cfgs["kitti", "port"], *kflags),
            ("kitti", "port_b"): _port("test_flow_kittisf",
                                       cfgs["kitti", "port_b"], *kflags,
                                       "--scene_batch", "2", "--dp", "2"),
            ("kitti", "odo"): _port("test_flow_kittisf", cfgs["kitti", "odo"],
                                    *kflags, "--host_preproc"),
            ("waymo", "port"): _port("test_flow_waymo", cfgs["waymo", "port"],
                                     *wflags),
            ("waymo", "port_b"): _port("test_flow_waymo",
                                       cfgs["waymo", "port_b"], *wflags,
                                       "--scene_batch", "2", "--dp", "2"),
            ("seg", "port"): _port("test_seg_waymo", cfgs["seg_waymo", "port"],
                                   "--split", "val", "--test_batch_size",
                                   "2", "--dp", "2", cwd=cwd),
            ("det", "port"): _port("test_seg", cfgs["seg_kittidet", "port"],
                                   "--split", "val", "--test_batch_size",
                                   "2", cwd=cwd),
            ("sem", "port"): _port("test_seg", cfgs["seg_semantickitti", "port"],
                                   "--split", "test", "--test_batch_size",
                                   "3", cwd=cwd),
            ("bench", "port"): _bench("port", cfgs["bench", "port"], cwd),
        }
        procs.update(port_procs)
        train_out = run_torch(cases[2:])[0]
        # The JAX side of the trainer steps, in this process.
        jax_ld = _jax_trainer_steps(tmp, seg_model, seg_params, unsup, sup)
        outs = {}
        for key, p in procs.items():
            out, err = p.communicate(timeout=900)
            assert p.returncode == 0, (key, err[-3000:])
            outs[key] = out
        # The Waymo odometry run of the port needs the JAX one's files gone
        # first: both wrote into the "odo" root's save directory.
        odo = {f: np.load(f) for f in _saved(roots["waymo", "odo"],
                                             "flowstep3d_gpf_odo_bound_"
                                             "denoise")}
        r = subprocess.run(
            [sys.executable, "-m", "ogc_tpu_torch.test_flow_waymo",
             cfgs["waymo", "odo"], *wflags, *oflags, "--device", "cpu"],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        outs["waymo", "odo"] = r.stdout
    finally:
        for p in procs.values():
            p.kill()
    return {"roots": roots, "outs": outs, "train": train_out,
            "jax_ld": jax_ld, "odo_jax_files": odo, "tmp": tmp}


def _jax_trainer_steps(tmp, model, params, unsup, sup):
    """The first step of the JAX package's SegTrainer (frame stride 2) and
    SupSegTrainer on the same batches: their loss terms."""
    prev = ops.exact_neighbors()
    ops.set_exact_neighbors(True)
    mp = pytest.MonkeyPatch()
    mp.setenv("OGC_EVAL_FOLD", "off")
    try:
        opt = make_optimizer(batch_size=TRAIN_B, **LR)
        seg = SegTrainer(model, params,
                         OGCLossConfig.from_dict(_loss_block()), opt,
                         aug_transform_epoch=0, ignore_npoint_thresh=50,
                         exp_base=str(tmp / "jax_unsup"), frame_stride=2)
        ld_u, _, _ = seg.train_it(0, tuple(unsup[k] for k in (
            "pcs", "segms", "flows", "valids")), aug_transform=True)
        sup_t = SupSegTrainer(model, params, SupLossConfig(weights=(2.0, 0.1)),
                              make_optimizer(batch_size=TRAIN_B, **LR),
                              ignore_npoint_thresh=50,
                              exp_base=str(tmp / "jax_sup"))
        ld_s, _, _ = sup_t.train_it(0, tuple(sup[k] for k in (
            "pcs", "segms", "flows", "valids")))
    finally:
        ops.set_exact_neighbors(prev)
        mp.undo()
    return {"unsup": ld_u, "sup": ld_s}


def _report(stdout, title):
    m = re.search(re.escape(title) + r":? (\{.*\})", stdout)
    assert m, stdout[-2000:]
    return ast.literal_eval(m.group(1))


def _saved(root, name):
    d = osp.join(root, "flow_preds", name)
    return sorted(osp.join(p, f) for p, _, fs in os.walk(d) for f in fs
                  if f.endswith(".npy"))


def _close_metrics(got, want, n_points):
    """EPE within 2e-4 (relative 1e-3); the rates within 2 points."""
    assert abs(got["EPE"] - want["EPE"]) <= max(2e-4, 1e-3 * want["EPE"]), \
        (got, want)
    for m in METRICS[1:]:
        assert abs(got[m] - want[m]) <= 2.0 / n_points, (m, got, want)


def _close_flows(got_files, want_files):
    assert [osp.basename(f) for f in got_files] == \
        [osp.basename(f) for f in want_files] and got_files
    for g_f, w_f in zip(got_files, want_files):
        g, w = np.load(g_f), np.load(w_f)
        assert g.shape == w.shape and g.dtype == w.dtype
        gap = np.abs(g - w).max(-1)
        assert np.median(gap) <= 1e-3 and gap.max() <= 5e-3, \
            (w_f, np.median(gap), gap.max())


@pytest.mark.parametrize("side", ["port", "port_b"])
def test_flow_kittisf_matches_jax(runs, side):
    outs, roots = runs["outs"], runs["roots"]
    want = _report(outs["kitti", "jax"], "Evaluation on kittisf-val")
    got = _report(outs["kitti", side], "Evaluation on kittisf-val")
    _close_metrics(got, want, 700)
    assert "Loaded weights from" in outs["kitti", side]
    _close_flows(_saved(roots["kitti", side], "flowstep3d"),
                 _saved(roots["kitti", "jax"], "flowstep3d"))


@pytest.mark.parametrize("side", ["port", "port_b"])
def test_flow_waymo_matches_jax(runs, side):
    outs, roots = runs["outs"], runs["roots"]
    for title in ("Evaluation on waymo-train", "Ground points",
                  "Above ground points"):
        _close_metrics(_report(outs["waymo", side], title),
                       _report(outs["waymo", "jax"], title), 300)
    _close_flows(_saved(roots["waymo", side], "flowstep3d_gpf_bound"),
                 _saved(roots["waymo", "jax"], "flowstep3d_gpf_bound"))


def test_flow_host_preproc_and_odometry_match_jax(runs):
    """--use_odometry --denoise on Waymo (GT poses, batched), and
    --host_preproc (the numpy ICP) on KITTI-SF against the JAX per-scene
    run (ICP by icp_xla: the two agree within the ICP tolerances)."""
    outs, roots = runs["outs"], runs["roots"]
    for title in ("Evaluation on waymo-train", "Ground points",
                  "Above ground points"):
        _close_metrics(_report(outs["waymo", "odo"], title),
                       _report(outs["waymo", "odo_jax"], title), 300)
    got = _saved(roots["waymo", "odo"], "flowstep3d_gpf_odo_bound_denoise")
    want = runs["odo_jax_files"]
    assert got == sorted(want)
    for f in got:
        gap = np.abs(np.load(f) - want[f]).max(-1)
        assert np.median(gap) <= 1e-3 and gap.max() <= 5e-3
    _close_metrics(_report(outs["kitti", "odo"], "Evaluation on kittisf-val"),
                   _report(outs["kitti", "jax"], "Evaluation on kittisf-val"),
                   700)


def test_flow_kittisf_benchmark_matches_jax(runs):
    """The FlowStep3D report (the network on the protocol's sample) and the
    "Ours" report (the saved flow upsampled onto it) against the JAX
    CLI's."""
    outs = runs["outs"]
    for title in ("FlowStep3D", "Ours"):
        got = _report(outs["bench", "port"], title)
        want = _report(outs["bench", "jax"], title)
        _close_metrics(got, want, BENCH_N)
        assert want["EPE"] > 0.0, (title, want)
    assert 0.0 < want["AccR"] < 1.0, want  # the noisy flows: some points


@pytest.mark.parametrize("tag", ["unsup", "sup"])
def test_waymo_trainer_step_matches_jax(runs, tag):
    want = runs["jax_ld"][tag]
    got = {k[len(tag) + 1:]: float(v) for k, v in runs["train"].items()
           if k.startswith(tag + "/")}
    keys = ("sum", "dynamic", "smooth", "invariance") if tag == "unsup" \
        else ("sum", "cross_entropy", "dice")
    for k in keys:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert all(float(want[k]) != 0.0 for k in keys)


@pytest.mark.parametrize("key", ["seg", "det", "sem"])
def test_seg_metrics_match_jax(runs, key):
    """test_seg_waymo (ignore masks) and test_seg on kittidet and
    semantickitti."""
    outs = runs["outs"]
    want, got = outs[key, "jax"], outs[key, "port"]
    for name in SEG_REPORT:
        w = float(re.search(re.escape(name) + r": (\S+)", want).group(1))
        g = float(re.search(re.escape(name) + r": (\S+)", got).group(1))
        assert abs(g - w) <= 1e-6, (name, g, w)
    scans = [ast.literal_eval(o.strip().splitlines()[-1]) for o in (want, got)]
    for k in scans[0]:
        assert abs(scans[1][k] - scans[0][k]) <= 1e-6, (k, scans)


def test_waymo_train_clis_run_an_epoch(runs, tmp_path):
    """The port's train_seg_waymo and train_seg_waymo_sup CLIs: one epoch
    on CPU (B=2), checkpoints written, under --remat full / dots, which
    the port refused when this test was written (--dp, once refused by the
    evaluating CLIs, runs: the ``--scene_batch 2 --dp 2`` flow runs and
    ``test_seg_waymo --dp 2`` above)."""
    tmp = runs["tmp"]
    root = osp.join(tmp, "waymo_ds")
    sel2, sel1 = str(tmp_path / "two.json"), str(tmp_path / "one.json")
    import json

    with open(sel2, "w") as f:
        json.dump([[SEQ, 1, 0], [SEQ, 2, 1]], f)
    with open(sel1, "w") as f:
        json.dump([[SEQ, 0], [SEQ, 1], [SEQ, 2]], f)
    procs = []
    for module, src, sel, remat in (
            ("train_seg_waymo", "waymo_unsup.yaml", sel2, "full"),
            ("train_seg_waymo_sup", "waymo_sup.yaml", sel1, "dots")):
        with open(f"{REPO}/config/seg/waymo/{src}") as f:
            cfg = yaml.safe_load(f)
        cfg.update({"save_path": str(tmp_path / module), "epochs": 1,
                    "batch_size": 2, "segnet": SEGNET, "predflow_path":
                    "None"})
        cfg["data"].update({"root": root, "train_mapping":
                            osp.join(root, "train.txt"), "val_mapping":
                            osp.join(root, "train.txt"),
                            "train_select_frame": sel, "val_select_frame":
                            sel})
        procs.append((module, _port(module, _yaml(tmp_path / src, cfg),
                                    "--remat", remat)))
    for module, p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        exp = tmp_path / (module + ("_R0" if module == "train_seg_waymo"
                                    else ""))
        assert (exp / "best.pth.tar").exists() and \
            (exp / "current.pth.tar").exists()
        assert "[epoch   1]   val: loss=" in out
