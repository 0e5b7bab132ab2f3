"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ogc_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at every
   shape the KITTI-SF eval forward gives it (B=8 x 8192 points), on
   grid-quantized clouds: indices and distances must be bit-equal.  FPS is
   also run on a continuous scene-like cloud, where the mismatch count is
   printed (expected 0).  Prints median times from CUDA events.
4. Drives the main path: writes a synthetic KITTI-SF-layout dataset (the 100
   ids of data_prepare/kittisf/splits/val.txt, 8192 points per frame) and a
   seeded random checkpoint, then runs ogc_tpu_torch.test_seg.main on
   config/seg/kittisf/kittisf_unsup.yaml pointed at them: 200 frames in 25
   forward batches.  Asserts the kernel launch counters rose by exactly 3
   (FPS) and 6 (KNN) per batch, that the metrics are finite, and that the
   card's masks for one batch agree with the same model run on the CPU with
   the plain versions (max abs diff <= 2e-4, the segnet parity tolerance).

Every phase raises on failure (exit code != 0).  The line before the last is
a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import math
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = osp.dirname(osp.abspath(__file__))
BATCH, N_POINT = 8, 8192
SEED = 0
MASK_TOL = 2e-4
# (N, npoint) of the three FPS calls and (n_query, n_points, k) of the six
# KNN calls in one KITTI-SF forward (SA stages 8192 -> 2048 -> 1024 -> 512).
FPS_SHAPES = [(8192, 2048), (2048, 1024), (1024, 512)]
KNN_SHAPES = [(2048, 8192, 64), (1024, 2048, 64), (512, 1024, 64),
              (8192, 2048, 3), (2048, 1024, 3), (1024, 512, 3)]


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


def check_kernels():
    from ogc_tpu_torch.ops.fps import fps, fps_plain
    from ogc_tpu_torch.ops.knn import knn_exact, knn_exact_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}

    fps_err, fps_ms, fps_plain_ms = 0, 0.0, 0.0
    for n, npoint in FPS_SHAPES:
        x = grid_cloud(gen, BATCH, n)
        got, want = fps(x, npoint), fps_plain(x, npoint)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"FPS ({BATCH},{n})->{npoint}: kernel != plain "
                                 f"at {(got != want).sum().item()} indices")
        fps_err = max(fps_err, int((got - want).abs().max().item()))
        ms = cuda_ms(lambda: fps(x, npoint), 20)
        pms = cuda_ms(lambda: fps_plain(x, npoint), 3)
        fps_ms += ms
        fps_plain_ms += pms
        log(f"fps ({BATCH},{n},3)->{npoint}: bit-equal; kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms")
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(np.stack([scene_cloud(rng, N_POINT)
                                   for _ in range(BATCH)])).cuda()
    mism = int((fps(x, 2048) != fps_plain(x, 2048)).sum().item())
    log(f"fps scene-like continuous cloud ({BATCH},{N_POINT},3)->2048: "
        f"{mism} mismatched indices (expected 0)")
    report["fps"] = (fps_err, fps_ms, fps_plain_ms)

    knn_err, knn_ms, knn_plain_ms = 0.0, 0.0, 0.0
    for nq, m, k in KNN_SHAPES:
        q, p = grid_cloud(gen, BATCH, nq), grid_cloud(gen, BATCH, m)
        (d, i), (pd, pi) = knn_exact(q, p, k), knn_exact_plain(q, p, k)
        torch.cuda.synchronize()
        if not (torch.equal(i, pi) and torch.equal(d, pd)):
            raise AssertionError(
                f"knn q{nq} p{m} k{k}: kernel != plain at "
                f"{(i != pi).sum().item()} indices, "
                f"max dist diff {(d - pd).abs().max().item()}")
        knn_err = max(knn_err, float((d - pd).abs().max().item()))
        ms = cuda_ms(lambda: knn_exact(q, p, k), 20)
        pms = cuda_ms(lambda: knn_exact_plain(q, p, k), 3)
        knn_ms += ms
        knn_plain_ms += pms
        log(f"knn_exact ({BATCH},{nq} q,{m} p,k={k}): idx and dist bit-equal; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    report["knn_exact"] = (knn_err, knn_ms, knn_plain_ms)
    log(f"per-forward kernel time (sum over the path's shapes): "
        f"fps {fps_ms:.4f} ms vs plain {fps_plain_ms:.4f} ms; knn_exact "
        f"{knn_ms:.4f} ms vs plain {knn_plain_ms:.4f} ms")
    return report


def write_kittisf(root, ids, seed):
    """KITTI-SF downsampled layout (data/<id>/{pc,flow,segm}{1,2}.npy): a
    static ground plane plus 3-6 rigid objects that move between frames."""
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


def run_main_path(tmp):
    import yaml

    from ogc_tpu_torch import test_seg
    from ogc_tpu_torch.models.segnet import MaskFormer3D
    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.utils.checkpoint import save_model_state, weight_path

    with open("data_prepare/kittisf/splits/val.txt") as f:
        ids = f.read().split()
    t0 = time.perf_counter()
    write_kittisf(osp.join(tmp, "kittisf"), ids, SEED)
    with open("config/seg/kittisf/kittisf_unsup.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["root"] = osp.join(tmp, "kittisf")
    cfg["save_path"] = osp.join(tmp, "ckpt", "kittisf_unsup")
    cfg_path = osp.join(tmp, "kittisf_unsup.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    sn = cfg["segnet"]
    model = MaskFormer3D(
        n_slot=sn["n_slot"], n_point=sn["n_point"], arch=cfg["dataset"],
        use_xyz=sn["use_xyz"], n_transformer_layer=sn["n_transformer_layer"],
        transformer_embed_dim=sn["transformer_embed_dim"],
        transformer_input_pos_enc=sn["transformer_input_pos_enc"],
        generator=torch.Generator().manual_seed(SEED))
    save_model_state(model.state_dict(), weight_path(cfg["save_path"]))
    log(f"setup: {len(ids)} scenes x {N_POINT} points and a seeded checkpoint "
        f"in {time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    fps.launches = 0
    knn_exact.launches = 0
    t0 = time.perf_counter()
    res = test_seg.main([cfg_path, "--split", "val", "--test_batch_size",
                         str(BATCH)])
    wall = time.perf_counter() - t0
    launches = {"fps": fps.launches, "knn_exact": knn_exact.launches}
    n_batch = len(res["forward_s"])
    log(f"main path: {n_batch} forward batches of B={BATCH} x {N_POINT}; "
        f"launches {launches}")
    if n_batch != 25 or launches != {"fps": 3 * n_batch,
                                     "knn_exact": 6 * n_batch}:
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

    # The same model on the CPU (plain versions) as the reference.
    from ogc_tpu.data.kittisf import KITTISceneFlowDataset

    ds = KITTISceneFlowDataset(
        data_root=cfg["data"]["root"],
        mapping_path="data_prepare/kittisf/splits/val.txt", downsampled=True,
        view_sels=[[0, 1], [1, 0]], decentralize=cfg["data"]["decentralize"])
    pc = torch.from_numpy(np.stack([ds[i][0][0] for i in range(2)]))
    model.eval()
    with torch.no_grad():
        ref = model(pc, pc)
        got = model.cuda()(pc.cuda(), pc.cuda()).cpu()
    if got.shape != (2, N_POINT, sn["n_slot"]) or not torch.isfinite(got).all():
        raise AssertionError(f"bad mask {tuple(got.shape)}")
    diff = (got - ref).abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"card vs CPU reference, 2 frames x {N_POINT}: max abs mask diff "
        f"{diff:.3e} (tolerance {MASK_TOL}), argmax agreement {agree:.6f}")
    if not diff <= MASK_TOL:
        raise AssertionError(f"mask diff {diff} > {MASK_TOL}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from ogc_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built from {_build.CSRC_DIR} in {_build.build_seconds:.3f} s "
        f"(load {time.perf_counter() - t0:.3f} s): {_build.library_path()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report = check_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_main_path(tmp)

    meta = {
        "fps": ("ogc_tpu_torch/csrc/fps.cu",
                "ogc_tpu/ops/pallas_kernels.py:24"),
        "knn_exact": ("ogc_tpu_torch/csrc/knn_exact.cu",
                      "ogc_tpu/ops/pallas_knn.py:378"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": report[name][0],
         "ms": report[name][1], "plain_ms": report[name][2]}
        for name, (src, rep) in meta.items()
    ]
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
