"""Evaluate / extract scene flow on full-resolution Waymo scenes with the
PyTorch port: ground removal (height + GPF), ego-motion (GT odometry or
ICP), FOV register-bounding, FPS to 8192 points, FlowStep3D, 3-NN
upsampling, optional flow-norm denoising, ego + residual composition.

Usage (the flags of the repo's test_flow_waymo.py):
    python -m ogc_tpu_torch.test_flow_waymo config/flow/waymo/kittisf_unsup.yaml \\
        --split train [--use_odometry] [--bound] [--denoise] [--save] \\
        [--test_model_iters 4] [--approx_knn] [--host_preproc] \\
        [--scene_batch K] [--device cuda]

Weights are read from the config's ``save_path``.  ``--save`` writes
``<root>/flow_preds/flowstep3d_gpf[_odo][_bound][_denoise]/<seq>/
flow_<v1>_<v2>.npy``, the flows the Waymo segmentation configs read.  GPF
runs batched on the device (``utils/gpf.py::ground_plane_fitting_batched``
over clouds padded to a multiple of 4096 points, fitted on an FPS-2048
subcloud) and ICP as in test_flow_kittisf; ``--host_preproc`` takes the
numpy oracles.  ``--scene_batch K`` runs K scenes a dispatch in three
device phases (GPF over the 2K clouds, ICP, network and upsample), the
next group's phases in a worker thread while the main thread scores and
saves the last group, as the JAX CLI does; with ``--scene_batch``, ``--dp
N`` shards each batched call over N devices (``outdoor.OutdoorFlow``).
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ogc_tpu_torch.data.waymo import WaymoOpenDataset
from ogc_tpu_torch.outdoor import (MAX_ICP_ITERS, N_POINT_ICP, OutdoorFlow,
                                   add_flow_metrics, bucket, check_flags,
                                   flow_parser, pad_rows)
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.gpf import (ground_plane_fitting,
                                     ground_plane_fitting_batched)
from ogc_tpu_torch.utils.icp import icp
from ogc_tpu_torch.utils.meters import AverageMeter

# Hyperparameters (reference test_flow_waymo.py:113-126).
N_POINT_GPF, N_GPF_ITER, N_GPF_LPR = 2048, 5, 50
THRESH_SEED, THRESH_DIST = 0.4, 0.4
THRESH_FLOW_NORM = 2.5


def register_bound(pc1, pc2, rot, transl, bound=True):
    """Keep frame-1 points that remain inside frame-2's FOV after warping
    (reference test_flow_waymo.py:18-46)."""
    pc1_t = pc1 @ rot.T + transl
    select = np.ones(pc1.shape[0], dtype=bool)
    if bound:
        front = pc1_t[:, 2] > np.abs(pc1_t[:, 0])
        in_range = (pc1_t**2).sum(1) < 60 * 60
        in_bound = np.abs(pc1_t[:, 0]) < 50
        in_depth = pc1_t[:, 2] < 35
        select = np.logical_and(select, front & in_range & in_bound & in_depth)
    return select


def pad_batch(a: np.ndarray, k: int) -> np.ndarray:
    """Pad the leading (batch) axis to k by repeating row 0; the extras are
    sliced off after the device call."""
    if len(a) >= k:
        return a
    return np.concatenate([a, np.broadcast_to(a[:1], (k - len(a),)
                                              + a.shape[1:])], 0)


class WaymoFlow:
    """The JAX CLI's per-scene and batched paths over one dataset."""

    def __init__(self, args, dev: OutdoorFlow, test_set, save_dir):
        self.args, self.dev, self.test_set = args, dev, test_set
        self.save_dir = save_dir
        self.meters = AverageMeter(), AverageMeter(), AverageMeter()
        self.scene_s = []

    def gpf(self, P: np.ndarray, V: np.ndarray, FV) -> np.ndarray:
        """Batched GPF on the device: (K, N, 3), valid, fit-valid -> (K, N)
        ground marks."""
        def gpf(_, p, v, fv=None):
            return ground_plane_fitting_batched(
                p, valid=v.bool(), fit_valid=None if fv is None
                else fv.bool(), n_iter=N_GPF_ITER, n_lpr=N_GPF_LPR,
                thresh_seed=THRESH_SEED, thresh_dist=THRESH_DIST)

        return self.dev.shard(gpf, P, V, *(() if FV is None else (FV,)))

    def not_ground(self, pc: np.ndarray) -> np.ndarray:
        """Per scene: ground by height OR GPF (the numpy oracle with
        --host_preproc, else one cloud padded to a 4096 bucket, the plane
        fitted on its FPS-2048 subcloud when it has more points)."""
        g_h = pc[:, 1] < 0.3
        if self.args.host_preproc:
            g_gpf = ground_plane_fitting(
                pc, n_sample_point=N_POINT_GPF, n_iter=N_GPF_ITER,
                n_lpr=N_GPF_LPR, thresh_seed=THRESH_SEED,
                thresh_dist=THRESH_DIST, device=self.dev.device)
        else:
            N = pc.shape[0]
            Nb = max(4096, bucket(N))
            # Padded with the first point: FPS never prefers duplicates,
            # and padding is masked out of every reduction.
            pcp = pad_rows(pc.astype(np.float32), Nb)
            valid = np.zeros(Nb, bool)
            valid[:N] = True
            fit_valid = None
            if N > N_POINT_GPF:
                fit_valid = np.zeros((1, Nb), bool)
                fit_valid[0, self.dev.fps(pcp[None], N_POINT_GPF)[0]] = True
            g_gpf = self.gpf(pcp[None], valid[None], fit_valid)[0, :N]
        return np.logical_not(np.logical_or(g_h, g_gpf.astype(bool)))

    def odometry(self, seq):
        """(rot, transl) of frame v1 into frame v2 from the GT poses."""
        sequence_name, v1, v2 = seq
        seq_path = osp.join(self.args.data["root"], "data", sequence_name)
        pose1 = np.load(osp.join(seq_path, "pose_%04d.npy" % v1))
        pose2 = np.load(osp.join(seq_path, "pose_%04d.npy" % v2))
        return (pose2[:3, :3].T @ pose1[:3, :3],
                pose2[:3, :3].T @ (pose1[:3, 3] - pose2[:3, 3]))

    def select(self, s) -> bool:
        """Ego flow, the warped non-ground cloud and the FOV selections of a
        scene with its (rot, transl); True if both selections hold
        points."""
        rot, transl = s["rot"], s["transl"]
        s["flow_pred_org"] = (s["pc1_org"] @ rot.T + transl
                              - s["pc1_org"]).astype(np.float32)
        pc1w = (s["pc1"] @ rot.T + transl).astype(np.float32)
        select1 = register_bound(pc1w, s["pc2"], rot, transl, self.args.bound)
        pc1_sel = pc1w[select1]
        select2 = register_bound(s["pc2"], pc1_sel, rot.T, -rot.T @ transl,
                                 self.args.bound)
        s.update(pc1w=pc1w, select1=select1, pc1_sel=pc1_sel,
                 pc2_sel=s["pc2"][select2])
        return min(len(pc1_sel), len(s["pc2_sel"])) > 0

    def residual(self, s, flow_sel: np.ndarray) -> None:
        """Adds the network's flow on the selected points to the ego flow."""
        if self.args.denoise:
            flow_sel[np.linalg.norm(flow_sel, axis=1) > THRESH_FLOW_NORM] = 0
        flow_pred = np.zeros((s["pc1w"].shape[0], 3), np.float32)
        flow_pred[s["select1"]] = flow_sel
        s["flow_pred_org"][s["not_ground1"]] += flow_pred

    def load(self, sid: int):
        """A scene, or None for an empty frame (skipped with zero flow,
        reference :147-154)."""
        seq = self.test_set.data_ids[sid]
        pcs, _, flows, _ = self.test_set[sid]
        if min(pcs[0].shape[0], pcs[1].shape[0]) < 1:
            if self.save_dir is not None:
                self.test_set._save_predflow(
                    np.zeros_like(pcs[0])[None], save_root=self.save_dir,
                    batch_size=1, n_frame=1, offset=sid)
            return None
        return dict(sid=sid, seq=seq, pc1_org=pcs[0], pc2_org=pcs[1],
                    flow_org=flows[0])

    def finalize(self, s) -> None:
        """Metrics on all, ground and above-ground points; the saved flow."""
        meter, meter_g, meter_ng = self.meters
        add_flow_metrics(meter, s["flow_org"], s["flow_pred_org"])
        for m, sel in ((meter_g, ~s["not_ground1"]),
                       (meter_ng, s["not_ground1"])):
            if sel.any():
                add_flow_metrics(m, s["flow_org"][sel],
                                 s["flow_pred_org"][sel])
        if self.save_dir is not None:
            self.test_set._save_predflow(
                s["flow_pred_org"][None], save_root=self.save_dir,
                batch_size=1, n_frame=1, offset=s["sid"])

    # -- the per-scene path ---------------------------------------------

    def scene(self, sid: int) -> None:
        t0 = time.perf_counter()
        s = self.load(sid)
        if s is None:
            return
        dev = self.dev
        s["not_ground1"] = self.not_ground(s["pc1_org"])
        s["not_ground2"] = self.not_ground(s["pc2_org"])
        pc1 = s["pc1"] = s["pc1_org"][s["not_ground1"]]
        pc2 = s["pc2"] = s["pc2_org"][s["not_ground2"]]
        if self.args.use_odometry:
            s["rot"], s["transl"] = self.odometry(s["seq"])
        else:
            center = np.concatenate((pc1, pc2), 0).mean(0)
            pc1_fps = dev.subsample(pc1 - center, N_POINT_ICP)
            pc2_fps = dev.subsample(pc2 - center, N_POINT_ICP)
            if self.args.host_preproc:
                T, _, _ = icp(pc1_fps, pc2_fps, max_iterations=MAX_ICP_ITERS)
            else:
                T = dev.icp(pc1_fps[None], pc2_fps[None])[0]
            s["rot"], s["transl"] = T[:3, :3], T[:3, 3]
        if self.select(s):
            self.residual(s, dev.flow(
                dev.subsample(s["pc1_sel"], dev.n_point)[None],
                dev.subsample(s["pc2_sel"], dev.n_point)[None],
                s["pc1_sel"][None])[0])
        self.finalize(s)
        self.scene_s.append(time.perf_counter() - t0)

    # -- the batched path -----------------------------------------------

    def group(self, sids: List[int]):
        """Device phases A-C for one group of scenes (the JAX CLI's
        _process_group); fills each scene's flow in place."""
        K, dev = self.args.scene_batch, self.dev
        scenes = [s for s in map(self.load, sids) if s is not None]
        if not scenes:
            return scenes
        S = len(scenes)
        # A: GPF over the 2K raw clouds.  FPS-ing the fit subcloud
        # unconditionally is the per-scene path's choice: with npoint >= N
        # every real point is selected before any duplicate, and `valid`
        # masks the duplicates' marks.
        clouds = [s["pc1_org"] for s in scenes] + [s["pc2_org"]
                                                  for s in scenes]
        n = bucket(max(len(c) for c in clouds))
        P = np.stack([pad_rows(c.astype(np.float32), n) for c in clouds])
        V = np.zeros((len(clouds), n), bool)
        for i, c in enumerate(clouds):
            V[i, :len(c)] = True
        Pp = pad_batch(P, 2 * K)
        FV = np.zeros((len(Pp), n), bool)
        np.put_along_axis(FV, dev.fps(Pp, N_POINT_GPF), True, axis=1)
        G = self.gpf(Pp, pad_batch(V, 2 * K), FV)[:len(clouds)]
        for t, s in enumerate(scenes):
            for j, key in ((t, 1), (S + t, 2)):
                c = clouds[j]
                s["not_ground%d" % key] = np.logical_not(np.logical_or(
                    c[:, 1] < 0.3, G[j, :len(c)].astype(bool)))
            s["pc1"] = s["pc1_org"][s["not_ground1"]]
            s["pc2"] = s["pc2_org"][s["not_ground2"]]

        # B: ego-motion, GT odometry or ICP on decentralised FPS subclouds.
        # A scene left empty by ground removal takes the identity.
        icp_scenes = []
        for s in scenes:
            if self.args.use_odometry:
                s["rot"], s["transl"] = self.odometry(s["seq"])
            elif min(len(s["pc1"]), len(s["pc2"])) > 0:
                icp_scenes.append(s)
            else:
                s["rot"], s["transl"] = np.eye(3), np.zeros(3)
        if icp_scenes:
            n = bucket(max(max(len(s["pc1"]), len(s["pc2"]))
                           for s in icp_scenes))
            C = np.stack([np.concatenate((s["pc1"], s["pc2"]), 0).mean(0)
                          for s in icp_scenes])[:, None, :]
            P1 = pad_batch((np.stack([pad_rows(s["pc1"], n)
                                      for s in icp_scenes]) - C)
                           .astype(np.float32), K)
            P2 = pad_batch((np.stack([pad_rows(s["pc2"], n)
                                      for s in icp_scenes]) - C)
                           .astype(np.float32), K)
            T = dev.icp(
                np.take_along_axis(P1, dev.fps(P1, N_POINT_ICP)[..., None], 1),
                np.take_along_axis(P2, dev.fps(P2, N_POINT_ICP)[..., None], 1))
            for t, s in enumerate(icp_scenes):
                s["rot"], s["transl"] = T[t, :3, :3], T[t, :3, 3]

        # C: FOV selections (host), then the network and the upsample.
        net_scenes = [s for s in scenes if self.select(s)]
        if net_scenes:
            n = bucket(max(max(len(s["pc1_sel"]), len(s["pc2_sel"]))
                           for s in net_scenes), dev.n_point)
            P1s = pad_batch(np.stack([pad_rows(s["pc1_sel"].astype(
                np.float32), n) for s in net_scenes]), K)
            P2s = pad_batch(np.stack([pad_rows(s["pc2_sel"].astype(
                np.float32), n) for s in net_scenes]), K)
            flow_up = dev.flow(
                np.take_along_axis(P1s, dev.fps(P1s, dev.n_point)[..., None],
                                   1),
                np.take_along_axis(P2s, dev.fps(P2s, dev.n_point)[..., None],
                                   1), P1s)
            for t, s in enumerate(net_scenes):
                self.residual(s, flow_up[t, :len(s["pc1_sel"])].copy())
        return scenes

    def batched(self) -> None:
        """Groups of K scenes: group k + 1's device phases run in a worker
        thread while this thread finalizes group k, in order, so the
        metrics and files are those of a serial loop."""
        K = self.args.scene_batch
        sids = list(range(len(self.test_set)))
        groups = [sids[g0:g0 + K] for g0 in range(0, len(sids), K)]

        def finalize(scenes, t0):
            for s in scenes:
                self.finalize(s)
            self.scene_s.append((time.perf_counter() - t0) / max(len(scenes),
                                                                 1))

        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = deque()
            for g in groups:
                pending.append((ex.submit(self.group, g), time.perf_counter()))
                if len(pending) >= 2:
                    fut, t0 = pending.popleft()
                    finalize(fut.result(), t0)
            while pending:
                fut, t0 = pending.popleft()
                finalize(fut.result(), t0)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Evaluate; print the JAX CLI's three reports and return them with the
    wall seconds per scene."""
    np.random.seed(0)
    parser = flow_parser()
    parser.add_argument("--use_odometry", default=False, action="store_true")
    parser.add_argument("--denoise", default=False, action="store_true")
    parser.add_argument("--bound", default=False, action="store_true")
    args = parser.parse_args(argv)
    check_flags(args)
    load_config_into_args(args)
    dev = OutdoorFlow(args)

    data_root = args.data["root"]
    # YAML-overridable mapping (the tests point it at a synthetic root).
    mapping_path = args.data.get("mapping_path") or (
        "data_prepare/waymo/splits/val.txt" if args.split == "val"
        else "data_prepare/waymo/splits/train.txt")
    test_set = WaymoOpenDataset(data_root=data_root, mapping_path=mapping_path)
    save_dir = None
    if args.save:
        save_dir = osp.join(data_root, "flow_preds/flowstep3d_gpf")
        save_dir += "_odo" * args.use_odometry + "_bound" * args.bound \
            + "_denoise" * args.denoise
        os.makedirs(save_dir, exist_ok=True)

    run = WaymoFlow(args, dev, test_set, save_dir)
    t0 = time.perf_counter()
    if args.scene_batch > 1:
        run.batched()
        dt = time.perf_counter() - t0
        print(f"# batched eval wall: {dt:.2f} s for {len(test_set)} scenes "
              f"({len(test_set) / dt:.3f} scenes/s)", file=sys.stderr)
    else:
        for sid in range(len(test_set)):
            run.scene(sid)
    res = [m.get_mean_loss_dict() for m in run.meters]
    print("Evaluation on waymo-%s:" % args.split, res[0])
    print("Ground points:", res[1])
    print("Above ground points:", res[2])
    return {**res[0], "ground": res[1], "above_ground": res[2],
            "scene_s": run.scene_s}


if __name__ == "__main__":
    main()
