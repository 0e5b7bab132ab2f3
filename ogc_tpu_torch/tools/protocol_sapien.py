"""The reference-length SAPIEN protocol through the PyTorch port's CLIs, on
synthetic coherent scenes (port of tools/protocol_sapien.py).

Modes, as the JAX runner's: ``default`` trains with the training defaults
(float32, approximate neighbours); ``fast`` with bf16 and approximate
neighbours; ``parity`` with float32 and exact neighbours
(``OGC_EXACT_NEIGHBORS=1`` in the train processes).  The evaluating CLIs
keep their exact default in every mode.  ``--graph mutual`` trains the
smooth loss on the mutual graph (the JAX runner's arm).

The reference's R-round recipe (reference README.md:215-222):

  round 1..R-1:  train_seg <woinv cfg> --round r             (40 epochs)
                 oa_icp    <woinv cfg> --split train/val --round r --save
  round R:       train_seg <full cfg>  --round R             (40 epochs,
                 invariance and the augmented views from epoch 20)
  eval:          test_seg --split test --round R;  vote --use_gt_flow

each stage a ``python -m ogc_tpu_torch.<cli>`` process.  Epoch-denominated
settings (40 epochs, aug phase-in at 20, B=32, lr) are those of
config/seg/sapien/sapien_unsup*.yaml; the sample-denominated ones
(decay_step 200000, smooth start step 1000) are scaled by n_scenes /
ref_scenes so each fires at the same fraction of training.  Round-1
"flowstep3d" predictions are the ground-truth flows.

    python -m ogc_tpu_torch.tools.protocol_sapien --seed 0 \
        [--mode default|fast|parity] [--graph reference|mutual] \
        [--device cuda]

Writes <out>/summary.json: final metrics of test_seg and vote, the OA-ICP
flow reports, per-epoch trajectories and stage wall times.
"""

import argparse
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import yaml

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

VIEW_SELS = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]
METRICS = {"AP": r"AveragePrecision@50: (\S+)",
           "PQ": r"PanopticQuality@50: (\S+)", "F1": r"F1-score@50: (\S+)",
           "Pre": r"Prec@50: (\S+)", "Rec": r"Recall@50: (\S+)",
           "mIoU": r"'per_scan_iou_avg': ([^,}]+)",
           "RI": r"'per_scan_ri_avg': ([^,}]+)"}


def build_cfg(args, root, save_root, woinv: bool):
    """The protocol's config: sapien_unsup{_woinv}.yaml with the landmark
    scaling of the JAX runner."""
    scale = args.n_scenes / float(args.ref_scenes)
    decay_step = max(1, int(round(200000 * scale)))
    smooth_start = max(1, int(round(1000 * scale)))
    cfg = {
        "dataset": "sapien",
        "save_path": osp.join(
            save_root, "sapien_unsup_woinv" if woinv else "sapien_unsup"),
        "random_seed": 10 + args.seed,
        "data": {
            "root": root, "decentralize": False,
            "aug_transform_args": None if woinv else {
                "scale_low": 0.95, "scale_high": 1.05,
                "degree_range": [0, 180, 0], "shift_range": [0, 0, 0],
            },
        },
        "predflow_path": "flowstep3d",
        "aug_transform_epoch": 9999 if woinv else 20,
        "ignore_npoint_thresh": 0,
        "epochs": args.epochs,
        "batch_size": 32,
        "lr": 1.0e-3, "lr_decay": 0.7, "lr_clip": 1.0e-5,
        "decay_step": decay_step, "weight_decay": 0.0,
        "bn_momentum": 0.9, "bn_decay": 1.0,
        "segnet": {"n_slot": 8, "n_point": 512, "use_xyz": True,
                   "n_transformer_layer": 2, "transformer_embed_dim": 128,
                   "transformer_input_pos_enc": False},
        "loss": {
            "weights": [10.0, 0.1, 0.0 if woinv else 0.1],
            "start_steps": [0, smooth_start, 0],
            "dynamic_loss_params": {"loss_norm": 2},
            "smooth_loss_params": {
                "graph": args.graph, "ref_bwd": "autodiff",
                "w_knn": 3.0, "w_ball_q": 1.0,
                "knn_loss_params": {"k": 8, "radius": 0.1, "loss_norm": 1},
                "ball_q_loss_params": {"k": 16, "radius": 0.2,
                                       "loss_norm": 1},
            },
            "invariance_loss_params": {"loss_norm": 2},
        },
    }
    if args.mode == "fast":
        cfg["compute_dtype"] = "bf16"
    return cfg, {"decay_step": decay_step, "smooth_start": smooth_start,
                 "n_pairs": args.n_scenes * 3}


def write_data(args, root):
    """The coherent synthetic roots and the round-1 flow predictions (the
    ground-truth flows, standing in for a trained flow network)."""
    from ogc_tpu_torch.data.sapien import SapienDataset
    from ogc_tpu_torch.tools.synth import make_sapien_root_coherent

    part = osp.join(root, "mbs-shapepart")
    if not osp.exists(osp.join(part, "meta.json")):
        make_sapien_root_coherent(part, n_scenes=args.n_scenes, n_points=512,
                                  seed=100 + args.seed)
        make_sapien_root_coherent(
            osp.join(root, "mbs-sapien"), n_scenes=args.n_test_scenes,
            n_points=512, seed=900 + args.seed, test_frac=0.99)
    pf_dir = osp.join(part, "flow_preds", "flowstep3d")
    if osp.exists(pf_dir + ".json"):
        return
    os.makedirs(pf_dir, exist_ok=True)
    with open(pf_dir + ".json", "w") as f:
        json.dump({"view_sel": VIEW_SELS}, f)
    n_frame = len(VIEW_SELS)
    for split in ("train", "val"):
        ds = SapienDataset(part, split=split, view_sels=VIEW_SELS)
        for sid in range(0, len(ds), n_frame):
            flows = np.stack([ds[sid + k][2][0] for k in range(n_frame)], 0)
            ds._save_predflow(flows, save_root=pf_dir, batch_size=n_frame,
                              n_frame=n_frame, offset=sid // n_frame)


def read_trajectory(save_path):
    """Per-epoch scalar trajectories from the JSONL writer."""
    traj = {}
    p = osp.join(save_path, "log", "scalars.jsonl")
    if not osp.exists(p):
        return traj
    with open(p) as f:
        for line in f:
            d = json.loads(line)
            if d["tag"].startswith("epoch_sum_"):
                traj.setdefault(d["tag"], []).append([d.get("step"),
                                                      d["value"]])
    return traj


def parse_metrics(stdout):
    out = {}
    for k, pat in METRICS.items():
        m = re.search(pat, stdout)
        if m:
            out[k] = float(m.group(1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=("default", "fast", "parity"),
                    default="default",
                    help="default: approx+f32 (training defaults); fast: "
                         "bf16+approx; parity: f32+exact neighbours")
    ap.add_argument("--graph", choices=("reference", "mutual"),
                    default="reference",
                    help="the smooth loss's graph (smooth_loss_params."
                         "graph)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--n_scenes", type=int, default=120)
    ap.add_argument("--n_test_scenes", type=int, default=24)
    ap.add_argument("--ref_scenes", type=int, default=2000)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--keep_data", action="store_true")
    args = ap.parse_args(argv)

    tag = f"s{args.seed}_{args.mode}_{args.graph}"
    out = args.out or osp.join(tempfile.gettempdir(),
                               f"ogc_torch_protocol_{tag}")
    os.makedirs(out, exist_ok=True)
    root = osp.join(out, "MBS_SAPIEN")
    t0 = time.time()
    write_data(args, root)
    cfg_w, scales = build_cfg(args, root, osp.join(out, "ckpt"), True)
    cfg_f, _ = build_cfg(args, root, osp.join(out, "ckpt"), False)
    paths = {}
    for name, cfg in (("woinv", cfg_w), ("full", cfg_f)):
        paths[name] = osp.join(out, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    print(f"[protocol {tag}] scales: {scales}; data in "
          f"{time.time() - t0:.1f} s", flush=True)

    stages = []

    def run(cli, *flags, env=None):
        cmd = [sys.executable, "-m", f"ogc_tpu_torch.{cli}", *flags,
               "--device", args.device]
        print("::", " ".join(cmd[1:]), flush=True)
        ts = time.time()
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=14000, env={**os.environ, **(env or {})})
        stages.append({"cmd": " ".join(cmd[2:]), "s": time.time() - ts})
        sys.stdout.write(r.stdout[-1800:])
        sys.stdout.flush()
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-6000:])
            raise SystemExit(f"FAILED: {' '.join(cmd)}")
        return r.stdout

    # Training-mode env: parity trains with exact neighbour search.
    tr_env = {"OGC_EXACT_NEIGHBORS": "1"} if args.mode == "parity" else {}

    summary = {"tag": tag, "args": vars(args), "scales": scales,
               "rounds": {}}
    for r in range(1, args.rounds + 1):
        last = r == args.rounds
        name = "full" if last else "woinv"
        cfg = cfg_f if last else cfg_w
        run("train_seg", paths[name], "--round", str(r), env=tr_env)
        summary["rounds"][r] = {"train_traj": read_trajectory(
            cfg["save_path"] + f"_R{r}")}
        if not last:
            for split in ("train", "val"):
                o = run("oa_icp", paths[name], "--split", split, "--round",
                        str(r), "--save", "--test_batch_size", "12")
                summary["rounds"][r][f"oaicp_{split}"] = o[-900:]

    o = run("test_seg", paths["full"], "--split", "test", "--round",
            str(args.rounds))
    summary["test_seg"] = parse_metrics(o)
    o = run("vote", paths["full"], "--split", "test", "--round",
            str(args.rounds), "--use_gt_flow", "--test_batch_size", "12",
            "--time_window_size", "3")
    summary["vote"] = parse_metrics(o)
    summary["stages"] = stages
    summary["wall_s"] = time.time() - t0
    if args.device.startswith("cuda"):
        import torch

        summary["device"] = torch.cuda.get_device_name(0)
    with open(osp.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"PROTOCOL OK [{tag}] wall={summary['wall_s']:.1f}s test_seg "
          f"{summary['test_seg']} vote {summary['vote']} -> "
          f"{out}/summary.json", flush=True)
    if not args.keep_data:
        shutil.rmtree(root, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()
