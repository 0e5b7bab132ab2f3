"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ogc_tpu_torch/csrc with nvcc.
3. Kernel phase.  Holds each kernel against its plain PyTorch version on the
   card at every shape the two paths give it, on grid-quantized clouds
   (1/8 grid: every d2 is exact, ties are common); outputs must be
   bit-equal.  Eval path (B=8 x 8192): 3 FPS and 6 KNN shapes.  Train path
   (B=4 items x 4 frames = 16 clouds of 8192): the same FPS and model KNN
   shapes at batch 16, the smooth KnnLoss KNN (4 x 8192 x 8192, k=32), the
   smooth BallQLoss ball query (4 x 8192 x 8192, ns 64, r 2), and the
   scatter-add of every grouping backward (5 model groups + 8 smooth-loss
   groups).  Prints median CUDA-event times of kernel and plain version,
   the bound of each call, and for the scatter-add the time of
   ``index_add_`` (deterministic mode) on the same inputs.
4. Train phase (the main path): writes a synthetic KITTI-SF root (the
   write_kittisf layout plus flow_preds/flowstep3d/<id>/flow{1,2}.npy),
   train/val mappings of 40 and 20 ids, and a copy of
   config/seg/kittisf/kittisf_unsup.yaml with epochs 1; runs
   ogc_tpu_torch.train_seg.main: 10 steps at B=4 x 4 frames x 8192, then
   the val epoch (5 batches of 4 items x 2 frames).  Asserts finite loss
   terms and the launch counts derived below.  Then, past every start
   step (so every loss term and every scatter-add carries a gradient): two
   2-step runs from one seed on one batch must give bit-equal parameters
   (no atomics), and one step on the card must agree with the same step on
   the CPU (plain versions): loss terms rtol 1e-4, gradients rtol 3e-3 per
   leaf.
5. Profile: torch.profiler over 3 warm train steps, all terms on; prints
   the device's busy share of the steps and the operators and kernels that
   take the most device time.
6. Eval phase: ogc_tpu_torch.test_seg.main on the 100 ids of
   data_prepare/kittisf/splits/val.txt with the checkpoint the train phase
   wrote (25 batches of 8); asserts 3 FPS and 6 KNN launches per batch,
   finite metrics, and card masks within 2e-4 of the CPU run.

Every phase raises on failure (exit code != 0).  The line before the last is
a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import os

# cuBLAS reads this when its first handle is made; deterministic mode
# raises on a matmul without it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import math  # noqa: E402
import os.path as osp  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = osp.dirname(osp.abspath(__file__))
BATCH, N_POINT = 8, 8192
TRAIN_B, TRAIN_T = 4, 4
# Device of the train and eval phases (the kernel phase is CUDA only).
DEVICE = "cuda"
SEED = 0
MASK_TOL = 2e-4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 3e-3, 2e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s.
HBM_BPS, F32_OPS = 3.35e12, 67e12
# (N, npoint) of the three FPS calls and (n_query, n_points, k) of the six
# KNN calls in one KITTI-SF forward (SA stages 8192 -> 2048 -> 1024 -> 512).
FPS_SHAPES = [(8192, 2048), (2048, 1024), (1024, 512)]
KNN_SHAPES = [(2048, 8192, 64), (1024, 2048, 64), (512, 1024, 64),
              (8192, 2048, 3), (2048, 1024, 3), (1024, 512, 3)]
# Smooth-loss shapes (kittisf_unsup.yaml): KNN k=32 r=1, ball ns=64 r=2.
SMOOTH_K, SMOOTH_R, BALL_NS, BALL_R = 32, 1.0, 64, 2.0
# Derived launches of one train step (16 clouds forward + backward, loss on
# 4 frames of B=4):
#   fps 3       one per SA stage, all 16 clouds in one launch;
#   knn_exact 10  3 SA + 3 FP in the forward, 1 smooth KnnLoss per frame;
#   ball_query 4  1 smooth BallQLoss per frame;
#   scatter_add 13  the backward of every group whose source needs a
#     gradient: SA1 and SA2 (SA0 groups the input cloud, no gradient), the
#     3 FP interpolations, and the KNN and ball smooth groups of 4 frames.
# And of one val batch (8 clouds forward, loss on 2 frames, no backward).
STEP_LAUNCHES = {"fps": 3, "knn_exact": 10, "ball_query": 4,
                 "scatter_add": 13}
VAL_LAUNCHES = {"fps": 3, "knn_exact": 8, "ball_query": 2, "scatter_add": 0}
N_TRAIN_IDS, N_VAL_IDS = 40, 20


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes, nops):
    """(least ms, what bounds it): bytes over HBM rate vs f32 operations
    over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def box_pairs(q, p, half, last=None):
    """(query, point) pairs a search pruned by spatial cells must test, on
    this data: per query, the points in the cube of half-width ``half``
    (B, N) around it, and with ``last`` (B, N) only those of index <= last
    (a ball full by then needs no later point)."""
    total = torch.zeros((), dtype=torch.int64, device=q.device)
    idx = torch.arange(p.shape[1], device=q.device)
    for b in range(q.shape[0]):
        for s in range(0, q.shape[1], 512):
            inside = ((p[b][None] - q[b, s:s + 512, None]).abs().amax(-1)
                      <= half[b, s:s + 512, None])
            if last is not None:
                inside &= idx <= last[b, s:s + 512, None]
            total += inside.sum()
    return int(total.item())


class Report:
    """Per kernel: max abs error, and per call kernel ms, plain ms, bound ms
    (with what bounds it) and library ms, weighted by the call's launches
    per train step."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain, bound, by, lib=None, per_step=1):
        r = self.rows.setdefault(name, {"err": 0.0, "ms": 0.0, "plain": 0.0,
                                        "bound": 0.0, "by": {}, "lib": None})
        r["err"] = max(r["err"], float(err))
        r["ms"] += per_step * ms
        r["plain"] += per_step * plain
        r["bound"] += per_step * bound
        r["by"][by] = r["by"].get(by, 0.0) + per_step * bound
        if lib is not None:
            r["lib"] = (r["lib"] or 0.0) + per_step * lib

    def entry(self, name):
        r = self.rows[name]
        return {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
                "bound_ms": r["bound"],
                "bound_by": max(r["by"], key=r["by"].get),
                "library_ms": r["lib"]}


def grid_cloud(gen, b, n, extent=30.0):
    """Coordinates on a 1/8 grid: direct-form d2 is exact, ties are common."""
    x = torch.rand((b, n, 3), generator=gen, device="cuda") * extent
    return torch.round(x * 8) / 8


def scene_cloud(rng, n):
    """Outdoor-like continuous cloud: a ground plane plus a few clusters."""
    ground = np.c_[40 * rng.rand(n // 2, 2) - 20, 0.2 * rng.rand(n // 2, 1)]
    k = 8
    clusters = [np.r_[40 * rng.rand(2) - 20, 1.0]
                + rng.randn(-(-(n - n // 2) // k), 3) * [1.5, 1.5, 0.8]
                for _ in range(k)]
    return np.vstack([ground] + clusters)[:n].astype(np.float32)


def check_fps(report, gen, b, per_step):
    from ogc_tpu_torch.ops.fps import fps, fps_plain

    for n, npoint in FPS_SHAPES:
        x = grid_cloud(gen, b, n)
        got, want = fps(x, npoint), fps_plain(x, npoint)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"FPS ({b},{n})->{npoint}: kernel != plain "
                                 f"at {(got != want).sum().item()} indices")
        ms = cuda_ms(lambda: fps(x, npoint), 20)
        pms = cuda_ms(lambda: fps_plain(x, npoint), 3)
        # 10 f32 operations per point per step: 3 sub, 3 mul, 2 add, min,
        # and the compare of the max.
        bnd, by = bound_ms(b * (n * 12 + npoint * 4),
                           b * (npoint - 1) * n * 10)
        report.add("fps", 0, ms, pms, bnd, by, per_step=per_step)
        log(f"fps ({b},{n},3)->{npoint}: bit-equal; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")


def check_knn(report, gen, shapes, per_step):
    from ogc_tpu_torch.ops.knn import knn_exact, knn_exact_plain

    for b, nq, m, k, reps in shapes:
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        (d, i), (pd, pi) = knn_exact(q, p, k), knn_exact_plain(q, p, k)
        torch.cuda.synchronize()
        if not (torch.equal(i, pi) and torch.equal(d, pd)):
            raise AssertionError(
                f"knn b{b} q{nq} p{m} k{k}: kernel != plain at "
                f"{(i != pi).sum().item()} indices, "
                f"max dist diff {(d - pd).abs().max().item()}")
        ms = cuda_ms(lambda: knn_exact(q, p, k), 20)
        pms = cuda_ms(lambda: knn_exact_plain(q, p, k), 3)
        # 9 f32 operations (3 sub, 3 mul, 2 add, a compare) per pair a pruned
        # search must test: the points within the k-th distance's cube.
        pairs = box_pairs(q, p, d[..., -1])
        bnd, by = bound_ms(b * ((nq + m) * 12 + nq * k * 8), pairs * 9)
        report.add("knn_exact", 0, ms, pms, bnd, by, per_step=reps)
        log(f"knn_exact ({b},{nq} q,{m} p,k={k}) x{reps}/{per_step}: idx "
            f"and dist bit-equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; {pairs} pairs a pruned search tests)")


def check_ball(report, gen):
    from ogc_tpu_torch.ops.ball import ball_query_exact, ball_query_plain

    for extent in (8.0, 30.0):  # crowded balls, then under-full ones
        x = grid_cloud(gen, TRAIN_B, N_POINT, extent)
        got = ball_query_exact(x, x, BALL_R, BALL_NS)
        want = ball_query_plain(x, x, BALL_R, BALL_NS)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"ball query extent {extent}: kernel != plain at "
                f"{(got != want).sum().item()} slots")
        full = got[..., -1] != got[..., 0]
        log(f"ball_query ({TRAIN_B},{N_POINT} c,{N_POINT} p,ns={BALL_NS},"
            f"r={BALL_R}) extent {extent}: bit-equal; full balls "
            f"{full.float().mean().item():.4f}")
    # Timed on the under-full cloud.  Pairs the data needs: a search pruned
    # by cells tests the points in the cube of half-width r around a centre,
    # and for a full ball only those up to its ns-th hit.
    pairs = box_pairs(x, x, torch.full(full.shape, BALL_R, device="cuda"),
                      torch.where(full, got[..., -1], N_POINT - 1))
    ms = cuda_ms(lambda: ball_query_exact(x, x, BALL_R, BALL_NS), 20)
    pms = cuda_ms(lambda: ball_query_plain(x, x, BALL_R, BALL_NS), 3)
    bnd, by = bound_ms(TRAIN_B * (2 * N_POINT * 12 + N_POINT * BALL_NS * 4),
                       pairs * 9)
    report.add("ball_query", 0, ms, pms, bnd, by, per_step=4)
    log(f"ball_query x4/step: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}; {pairs} pairs a pruned search tests)")


def check_scatter(report, gen):
    from ogc_tpu_torch.ops import knn
    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain)

    B = TRAIN_B * TRAIN_T
    x = grid_cloud(gen, TRAIN_B, N_POINT)
    d, i = knn(SMOOTH_K, x, x)
    # (name, idx (B, M, S), C, n_dest, calls per step): the smooth-loss
    # groups of the 10-slot mask, then the model's SA and FP groups.
    cases = [("smooth knn", torch.where(d > SMOOTH_R, i[..., :1], i), 10,
              N_POINT, 4),
             ("smooth ball", ball_query_exact(x, x, BALL_R, BALL_NS), 10,
              N_POINT, 4)]
    for name, nq, m, k, radius, C in (("SA1", 1024, 2048, 64, 4.0, 99),
                                      ("SA2", 512, 1024, 64, 8.0, 131),
                                      ("FP2", 1024, 512, 3, None, 256),
                                      ("FP1", 2048, 1024, 3, None, 128),
                                      ("FP0", 8192, 2048, 3, None, 64)):
        p = grid_cloud(gen, B, m)
        q = p[:, :nq] if nq <= m else grid_cloud(gen, B, nq)
        d, i = knn(k, q, p)
        if radius is not None:
            i = torch.where(d > radius, i[..., :1], i)
        cases.append((name, i, C, m, 1))
    for name, idx, C, n_dest, calls in cases:
        b = idx.shape[0]
        flat = idx.reshape(b, -1)
        R = flat.shape[1]
        g = torch.randn((b, R, C), generator=gen, device="cuda")
        got = scatter_add_rows(flat, g, n_dest)
        want = scatter_add_rows_plain(flat, g, n_dest)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"scatter {name}: kernel != plain, max diff "
                f"{(got - want).abs().max().item()}")
        ms = cuda_ms(lambda: scatter_add_rows(flat, g, n_dest), 20)
        pms = cuda_ms(lambda: scatter_add_rows_plain(flat, g, n_dest), 3)
        key = (flat.long() + torch.arange(b, device="cuda")[:, None] * n_dest
               ).reshape(-1)
        rows = g.reshape(-1, C)
        acc = torch.zeros((b * n_dest, C), device="cuda")
        lib = cuda_ms(lambda: acc.zero_().index_add_(0, key, rows), 20)
        bnd, by = bound_ms(b * (R * C * 4 + R * 4 + n_dest * C * 4),
                           b * R * C)
        report.add("scatter_add", 0, ms, pms, bnd, by, lib, per_step=calls)
        log(f"scatter_add {name} ({b},{R} rows,C={C})->{n_dest} x{calls}/"
            f"step: bit-equal; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"index_add_ {lib:.4f} ms, bound {bnd:.4f} ms ({by})")


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eval_report, train_report = Report(), Report()
    log("-- eval path shapes (B=8)")
    check_fps(eval_report, gen, BATCH, 1)
    check_knn(eval_report, gen, [(BATCH, nq, m, k, 1)
                                 for nq, m, k in KNN_SHAPES], 6)
    from ogc_tpu_torch.ops.fps import fps, fps_plain

    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(np.stack([scene_cloud(rng, N_POINT)
                                   for _ in range(BATCH)])).cuda()
    mism = int((fps(x, 2048) != fps_plain(x, 2048)).sum().item())
    log(f"fps scene-like continuous cloud ({BATCH},{N_POINT},3)->2048: "
        f"{mism} mismatched indices (expected 0)")
    log("-- train path shapes (16 clouds; loss at B=4 per frame)")
    B = TRAIN_B * TRAIN_T
    check_fps(train_report, gen, B, 1)
    check_knn(train_report, gen,
              [(B, nq, m, k, 1) for nq, m, k in KNN_SHAPES]
              + [(TRAIN_B, N_POINT, N_POINT, SMOOTH_K, 4)], 10)
    check_ball(train_report, gen)
    check_scatter(train_report, gen)
    for name in ("fps", "knn_exact"):
        e = eval_report.entry(name)
        log(f"per eval forward: {name} kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms")
    for name in STEP_LAUNCHES:
        e = train_report.entry(name)
        log(f"per train step: {name} kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}), library {e['library_ms']}")
    return train_report


def write_kittisf(root, ids, seed):
    """KITTI-SF downsampled layout (data/<id>/{pc,flow,segm}{1,2}.npy): a
    static ground plane plus 3-6 rigid objects that move between frames;
    flow_preds/flowstep3d/<id>/flow{1,2}.npy hold the same flows as the
    predictions training reads."""
    rng = np.random.RandomState(seed)
    for sid in ids:
        n_obj = rng.randint(3, 7)
        counts = [N_POINT // 2] + [(N_POINT - N_POINT // 2) // n_obj] * n_obj
        counts[-1] += N_POINT - sum(counts)
        pc = [np.c_[60 * rng.rand(counts[0], 2) - 30,
                    0.1 * rng.randn(counts[0], 1)]]
        segm = [np.zeros(counts[0], np.int64)]
        flow = [np.zeros((counts[0], 3))]
        for o in range(1, n_obj + 1):
            center = np.r_[50 * rng.rand(2) - 25, 0.8]
            pts = center + (rng.rand(counts[o], 3) - 0.5) * [4.0, 1.8, 1.5]
            a = rng.uniform(-0.1, 0.1)
            rot = np.array([[math.cos(a), -math.sin(a), 0],
                            [math.sin(a), math.cos(a), 0], [0, 0, 1]])
            moved = (pts - center) @ rot.T + center + np.r_[rng.randn(2), 0]
            pc.append(pts)
            segm.append(np.full(counts[o], o))
            flow.append(moved - pts)
        pc1 = np.vstack(pc).astype(np.float32)
        flow1 = np.vstack(flow).astype(np.float32)
        segm1 = np.concatenate(segm)
        perm = rng.permutation(N_POINT)
        pc1, flow1, segm1 = pc1[perm], flow1[perm], segm1[perm]
        d = osp.join(root, "data", sid)
        os.makedirs(d)
        for name, arr in (("pc1", pc1), ("pc2", pc1 + flow1), ("flow1", flow1),
                          ("flow2", -flow1), ("segm1", segm1),
                          ("segm2", segm1)):
            np.save(osp.join(d, name + ".npy"), arr)
        d = osp.join(root, "flow_preds", "flowstep3d", sid)
        os.makedirs(d)
        np.save(osp.join(d, "flow1.npy"), flow1)
        np.save(osp.join(d, "flow2.npy"), -flow1)


def counters():
    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    return {"fps": fps, "knn_exact": knn_exact,
            "ball_query": ball_query_exact, "scatter_add": scatter_add_rows}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def setup_data(tmp):
    """Synthetic KITTI-SF root, mapping files and the config copy."""
    import yaml

    with open("data_prepare/kittisf/splits/train.txt") as f:
        train_ids = f.read().split()[:N_TRAIN_IDS]
    with open("data_prepare/kittisf/splits/val.txt") as f:
        val_ids = f.read().split()
    root = osp.join(tmp, "kittisf")
    t0 = time.perf_counter()
    write_kittisf(root, sorted(set(train_ids) | set(val_ids)), SEED)
    maps = {}
    for split, ids in (("train", train_ids), ("val", val_ids[:N_VAL_IDS])):
        maps[split] = osp.join(tmp, f"{split}.txt")
        with open(maps[split], "w") as f:
            f.write("\n".join(ids))
    with open("config/seg/kittisf/kittisf_unsup.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(root=root, train_mapping=maps["train"],
                       val_mapping=maps["val"])
    cfg["save_path"] = osp.join(tmp, "ckpt", "kittisf_unsup")
    cfg["epochs"] = 1
    cfg_path = osp.join(tmp, "kittisf_unsup.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    log(f"setup: {len(set(train_ids) | set(val_ids))} scenes x {N_POINT} "
        f"points in {time.perf_counter() - t0:.3f} s")
    return cfg, cfg_path


def make_model(cfg, device):
    from ogc_tpu_torch.models.segnet import MaskFormer3D

    sn = cfg["segnet"]
    return MaskFormer3D(
        n_slot=sn["n_slot"], n_point=sn["n_point"], arch=cfg["dataset"],
        use_xyz=sn["use_xyz"], n_transformer_layer=sn["n_transformer_layer"],
        transformer_embed_dim=sn["transformer_embed_dim"],
        transformer_input_pos_enc=sn["transformer_input_pos_enc"],
        generator=torch.Generator().manual_seed(SEED)).to(device)


def make_trainer(cfg, model, device, exp_base):
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
    from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule

    opt = Adam(dict(model.named_parameters()),
               make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                                cfg["decay_step"], cfg["batch_size"]))
    return SegTrainer(model, OGCLossConfig.from_dict(cfg["loss"]), opt,
                      aug_transform_epoch=0, ignore_npoint_thresh=0,
                      exp_base=exp_base, device=device)


def fixed_batch(cfg, n_items):
    """One augmented batch (4 frames per item) drawn with a fixed seed."""
    from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

    d = cfg["data"]
    ds = KITTISceneFlowDataset(
        data_root=d["root"], mapping_path=d["train_mapping"],
        downsampled=True, view_sels=[[0, 1]],
        predflow_path=cfg["predflow_path"], decentralize=d["decentralize"],
        aug_transform=True, aug_transform_args=d["aug_transform_args"])
    np.random.seed(SEED)
    items = [ds[i] for i in range(n_items)]
    return tuple(np.stack(f, 0) for f in zip(*items))


def run_train(tmp):
    from ogc_tpu_torch import train_seg

    cfg, cfg_path = setup_data(tmp)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_seg.main([cfg_path, "--round", "1", "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = read_counts()
    trainer = res["trainer"]
    steps = len(trainer.step_seconds)
    n_val = -(-N_VAL_IDS // TRAIN_B)
    want = {k: steps * STEP_LAUNCHES[k] + n_val * VAL_LAUNCHES[k]
            for k in STEP_LAUNCHES}
    log(f"train main path: {steps} steps of B={TRAIN_B} x {TRAIN_T} frames x "
        f"{N_POINT}, val epoch of {n_val} batches; launches {launches}, "
        f"derived {want} (per step {STEP_LAUNCHES}, per val batch "
        f"{VAL_LAUNCHES})")
    if steps != N_TRAIN_IDS // TRAIN_B or launches != want:
        raise AssertionError(f"expected {N_TRAIN_IDS // TRAIN_B} steps and "
                             f"launches {want}, got {steps} and {launches}")
    with open(osp.join(trainer.exp_base, "log", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    terms = [s for s in scalars if s["tag"].startswith("train/")]
    if len(terms) != 6 * steps or not all(math.isfinite(s["value"])
                                          for s in terms):
        raise AssertionError(f"loss terms not all finite: {terms}")
    last = {s["tag"]: s["value"] for s in terms}
    step_ms = np.array(trainer.step_seconds) * 1e3
    med = float(np.median(step_ms[1:]))
    clouds = TRAIN_B * TRAIN_T
    log(f"train step (host clock around a synchronised step, steps 2-"
        f"{steps}): median {med:.4f} ms, min {step_ms[1:].min():.4f}, max "
        f"{step_ms[1:].max():.4f}; {1e3 / med:.4f} steps/s, "
        f"{clouds * 1e3 / med:.4f} clouds/s; first step {step_ms[0]:.4f} ms; "
        f"val epoch {trainer.val_seconds[0] * 1e3:.4f} ms; whole train_seg "
        f"{wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"last step's terms: {last}; best val loss {res['best_loss']}")
    check_determinism(cfg, tmp)
    check_card_vs_cpu(cfg, tmp)
    return cfg, cfg_path, launches


def first_it_all_terms(cfg):
    """The first step whose samples seen pass every start step, so that
    every loss term (and every scatter-add) carries a gradient."""
    return -(-max(cfg["loss"]["start_steps"]) // TRAIN_B)


def check_determinism(cfg, tmp):
    """Two 2-step runs from one seed on one batch, all loss terms on:
    bit-equal parameters."""
    batch = fixed_batch(cfg, TRAIN_B)
    it0 = first_it_all_terms(cfg)
    params = []
    for run in range(2):
        model = make_model(cfg, DEVICE)
        trainer = make_trainer(cfg, model, torch.device(DEVICE),
                               osp.join(tmp, f"det{run}"))
        for it in range(it0, it0 + 2):
            trainer.train_it(it, batch, aug_transform=True)
        params.append({k: v.detach().clone()
                       for k, v in model.named_parameters()})
    diff = [k for k in params[0] if not torch.equal(params[0][k],
                                                    params[1][k])]
    if diff:
        raise AssertionError(f"two seeded 2-step runs differ in {diff[:5]}")
    log(f"determinism: two seeded 2-step runs (steps {it0}-{it0 + 1}, all "
        f"terms on) give bit-equal parameters ({len(params[0])} tensors)")


def check_card_vs_cpu(cfg, tmp):
    """One train step (all terms on: the samples seen pass every start
    step) on the card and on the CPU with the plain versions."""
    batch = fixed_batch(cfg, 1)
    it_samples = max(cfg["loss"]["start_steps"])
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        model = make_model(cfg, dev)
        trainer = make_trainer(cfg, model, torch.device(dev),
                               osp.join(tmp, f"step_{dev}"))
        pcs, flows = trainer._to_device(batch[0], batch[2])
        loss, ld, _ = trainer._loss(pcs, flows, it_samples, True, True)
        loss.backward()
        out[dev] = ({k: float(v.detach()) for k, v in ld.items()},
                    {k: p.grad.detach().cpu().double().numpy()
                     for k, p in model.named_parameters()})
        log(f"one step B=1 x {TRAIN_T} frames x {N_POINT} on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    (ld_c, g_c), (ld_r, g_r) = out[DEVICE], out["cpu"]
    for k in ld_r:
        if not math.isclose(ld_c[k], ld_r[k], rel_tol=LOSS_RTOL,
                            abs_tol=1e-12):
            raise AssertionError(f"term {k}: card {ld_c[k]} cpu {ld_r[k]}")
    c_all = np.concatenate([g_c[k].ravel() for k in g_r])
    r_all = np.concatenate([g_r[k].ravel() for k in g_r])
    gscale = np.sqrt((r_all ** 2).mean()) + 1e-12
    cos = c_all @ r_all / (np.linalg.norm(c_all) * np.linalg.norm(r_all))
    worst = max((np.linalg.norm(g_c[k] - g_r[k])
                 / (GRAD_RTOL * np.linalg.norm(g_r[k])
                    + GRAD_ATOL_FRAC * gscale * np.sqrt(g_r[k].size)), k)
                for k in g_r)
    log(f"card vs CPU, one step: terms {ld_c} vs {ld_r}; gradient cosine "
        f"{cos:.8f}, worst leaf at {worst[0]:.4f} of its tolerance "
        f"({worst[1]})")
    if not (cos > 0.9999 and worst[0] <= 1.0):
        raise AssertionError("card and CPU gradients disagree")


def profile_train(cfg, tmp, steps=3):
    """torch.profiler over ``steps`` warm train steps on one fixed batch:
    the device's busy share of the steps' host-clock time (device-side
    events' time over wall time; the profiler's own host cost lowers it a
    little), the operators whose kernels take the most device time, and the
    kernels that do.  The port's ctypes kernels are launched by no operator,
    so they show among the kernels only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = fixed_batch(cfg, TRAIN_B)
    model = make_model(cfg, DEVICE)
    trainer = make_trainer(cfg, model, torch.device(DEVICE),
                           osp.join(tmp, "prof"))
    it0 = first_it_all_terms(cfg)
    trainer.train_it(it0, batch, aug_transform=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(it0 + 1, it0 + steps + 1):
            trainer.train_it(it, batch, aug_transform=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in kernels)
    log(f"profile of {steps} train steps: device time {dev_us / 1e3:.4f} ms "
        f"of {wall_us / 1e3:.4f} ms wall, busy share {dev_us / wall_us:.4f}; "
        f"{sum(e.count for e in kernels) // steps} device-side events per "
        f"step")
    for title, rows, n in (("operators", ops, 12), ("kernels", kernels, 8)):
        log(f"  top {title} by device time (share, ms per step, count per "
            f"step):")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:n]:
            name = e.key.removeprefix("void ").removeprefix(
                "(anonymous namespace)::").split("(")[0]
            log(f"  {e.self_device_time_total / dev_us:7.4f} "
                f"{e.self_device_time_total / 1e3 / steps:9.4f} "
                f"x{e.count // steps:<5d} {name[:100]}")


def run_eval(tmp, cfg, cfg_path):
    from ogc_tpu_torch import test_seg
    from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset
    from ogc_tpu_torch.utils.checkpoint import load_model_state, weight_path

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = test_seg.main([cfg_path, "--split", "val", "--round", "1",
                         "--test_batch_size", str(BATCH), "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_batch = len(res["forward_s"])
    log(f"eval path: {n_batch} forward batches of B={BATCH} x {N_POINT}; "
        f"launches {launches}")
    if n_batch != 25 or launches != {"fps": 3 * n_batch,
                                     "knn_exact": 6 * n_batch,
                                     "ball_query": 0, "scatter_add": 0}:
        raise AssertionError(f"expected 25 batches with 3 FPS and 6 KNN "
                             f"launches each, got {n_batch} and {launches}")
    for k in ("AP", "PQ", "F1", "per_scan_iou_avg", "per_scan_ri_avg"):
        if not math.isfinite(res[k]):
            raise AssertionError(f"metric {k} is {res[k]}")
    fwd = np.array(res["forward_s"][1:]) * 1e3
    log(f"AP@50 {res['AP']} PQ@50 {res['PQ']} F1 {res['F1']} "
        f"mIoU {res['per_scan_iou_avg']} RI {res['per_scan_ri_avg']}")
    q1, med, q3 = np.percentile(fwd, [25, 50, 75])
    log(f"forward (host clock, incl. copy to host; first batch excluded, "
        f"{fwd.size} samples): median {med:.4f} ms, quartiles {q1:.4f} / "
        f"{q3:.4f} ms, min {fwd.min():.4f} ms, max {fwd.max():.4f} ms per "
        f"batch of {BATCH}; "
        f"{BATCH * 1e3 / med:.4f} frames/s; first batch "
        f"{res['forward_s'][0] * 1e3:.4f} ms; whole eval incl. loading and "
        f"metrics {wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # The trained model on the CPU (plain versions) as the reference.
    model = make_model(cfg, "cpu")
    model.load_state_dict(load_model_state(weight_path(cfg["save_path"], 1)))
    ds = KITTISceneFlowDataset(
        data_root=cfg["data"]["root"],
        mapping_path="data_prepare/kittisf/splits/val.txt", downsampled=True,
        view_sels=[[0, 1], [1, 0]], decentralize=cfg["data"]["decentralize"])
    pc = torch.from_numpy(np.stack([ds[i][0][0] for i in range(2)]))
    model.eval()
    with torch.no_grad():
        ref = model(pc, pc)
        got = model.to(DEVICE)(pc.to(DEVICE), pc.to(DEVICE)).cpu()
    if got.shape != (2, N_POINT, cfg["segnet"]["n_slot"]) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"bad mask {tuple(got.shape)}")
    diff = (got - ref).abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"card vs CPU reference, 2 frames x {N_POINT}: max abs mask diff "
        f"{diff:.3e} (tolerance {MASK_TOL}), argmax agreement {agree:.6f}")
    if not diff <= MASK_TOL:
        raise AssertionError(f"mask diff {diff} > {MASK_TOL}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.train_seg import set_deterministic

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    set_deterministic(torch.device("cuda"))
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built from {_build.CSRC_DIR} in {_build.build_seconds:.3f} s "
        f"(load {time.perf_counter() - t0:.3f} s): {_build.library_path()}")

    report = check_kernels()
    log(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        cfg, cfg_path, launches = run_train(tmp)
        log(f"train phase done at {time.perf_counter() - t_start:.1f} s")
        profile_train(cfg, tmp)
        run_eval(tmp, cfg, cfg_path)
    log(f"eval phase done at {time.perf_counter() - t_start:.1f} s")

    meta = {
        "fps": ("ogc_tpu_torch/csrc/fps.cu",
                "ogc_tpu/ops/pallas_kernels.py:24"),
        "knn_exact": ("ogc_tpu_torch/csrc/knn_exact.cu",
                      "ogc_tpu/ops/pallas_knn.py:378"),
        "ball_query": ("ogc_tpu_torch/csrc/ball_query.cu",
                       "ogc_tpu/ops/pallas_knn.py:836"),
        "scatter_add": ("ogc_tpu_torch/csrc/scatter_add.cu",
                        "ogc_tpu/ops/pallas_scatter.py:54"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **report.entry(name)}
               for name, (src, rep) in meta.items()]
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
