"""Evaluate / extract scene flow on full-resolution KITTI-SF scenes with the
PyTorch port: ground removal by height, ICP ego-motion on FPS-1024
subclouds, FlowStep3D (``kitti`` arch) on FPS-8192 points, 3-NN upsampling
back to the full cloud, ego + residual flow composition.

Usage (the flags of the repo's test_flow_kittisf.py):
    python -m ogc_tpu_torch.test_flow_kittisf config/flow/kittisf/kittisf_unsup.yaml \\
        --split train [--test_model_iters 4] [--save] [--approx_knn] \\
        [--host_preproc] [--scene_batch K] [--device cuda]

Weights are read from the config's ``save_path`` (``{"model_state":
state_dict}``, ``.pth.tar`` optional).  ``--save`` writes
``<root>/flow_preds/flowstep3d/<id>/flow{1,2}.npy``, the flows the KITTI-SF
segmentation configs read.  FPS (kernel #1; clouds above 14464 points take
its cluster instance), the ICP's 1-NN (#2, or #3 with ``--approx_knn``),
the network and the upsample (#2 or #3) run on ``--device``; the ICP's
Kabsch SVD is ``torch.linalg.svd``.  ``--host_preproc`` runs ICP with the
numpy oracle.  ``--scene_batch K`` runs K scenes a dispatch over clouds
padded to a multiple of 4096 points with duplicates of their first point
(``outdoor.pad_rows``), as the JAX CLI does; with it ``--dp N`` shards
each batched call over N devices (``outdoor.OutdoorFlow``).
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np

from ogc_tpu_torch.outdoor import (MAX_ICP_ITERS, N_POINT_ICP, OutdoorFlow,
                                   add_flow_metrics, bucket, check_flags,
                                   flow_parser, pad_rows)
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.icp import icp
from ogc_tpu_torch.utils.meters import AverageMeter

def scene_cloud_pair(test_set, sid: int):
    """A KITTI-SF scene: the full clouds, the ground mask by height
    (reference :84-86), the non-ground clouds and their centre (ICP runs
    decentralised)."""
    pcs, _, flows, _ = test_set[sid]
    pc1_org, pc2_org = pcs[0], pcs[1]
    not_ground = np.logical_not(np.logical_and(pc1_org[:, 1] < -1.4,
                                               pc2_org[:, 1] < -1.4))
    pc1, pc2 = pc1_org[not_ground], pc2_org[not_ground]
    center = np.concatenate((pc1, pc2), 0).mean(0)
    return dict(sid=sid, pc1_org=pc1_org, flow_org=flows[0],
                not_ground=not_ground, pc1=pc1, pc2=pc2, center=center)


def batched_eval(args, dev: OutdoorFlow, test_set, meter, save_dir,
                 scene_s) -> None:
    """K scenes a dispatch (the JAX CLI's _batched_eval): clouds padded to
    a shared multiple of 4096 points; FPS, ICP, the network and the upsample
    batched; the padded rows dropped before composition and metrics."""
    K = args.scene_batch
    for g0 in range(0, len(test_set), K):
        t0 = time.perf_counter()
        group = list(range(g0, min(g0 + K, len(test_set))))
        scenes = [scene_cloud_pair(test_set, sid) for sid in group]
        scenes += [scenes[-1]] * (K - len(scenes))  # extras discarded
        nmax = max(max(len(s["pc1"]), len(s["pc2"])) for s in scenes)
        n = bucket(nmax, dev.n_point)
        P1 = np.stack([pad_rows(s["pc1"], n) for s in scenes])
        P2 = np.stack([pad_rows(s["pc2"], n) for s in scenes])
        C = np.stack([s["center"] for s in scenes])[:, None, :]

        # ICP ego-motion on FPS subclouds (decentralised).
        P1_icp = (P1 - C).astype(np.float32)
        P2_icp = (P2 - C).astype(np.float32)
        T = dev.icp(
            np.take_along_axis(P1_icp, dev.fps(P1_icp, N_POINT_ICP)[..., None],
                               1),
            np.take_along_axis(P2_icp, dev.fps(P2_icp, N_POINT_ICP)[..., None],
                               1))
        rot, transl = T[:, :3, :3], T[:, :3, 3]

        # Ego-compensated non-ground clouds: network and upsample.
        P1e = (np.einsum("kni,kji->knj", P1, rot)
               + transl[:, None, :]).astype(np.float32)
        P2f = P2.astype(np.float32)
        pc1_net = np.take_along_axis(P1e, dev.fps(P1e, dev.n_point)[..., None],
                                     1)
        pc2_net = np.take_along_axis(P2f, dev.fps(P2f, dev.n_point)[..., None],
                                     1)
        flow_up = dev.flow(pc1_net, pc2_net, P1e)
        for t, sid in enumerate(group):
            s = scenes[t]
            flow_pred = (s["pc1_org"] @ rot[t].T + transl[t]
                         - s["pc1_org"]).astype(np.float32)
            flow_pred[s["not_ground"]] += flow_up[t, :len(s["pc1"])]
            add_flow_metrics(meter, s["flow_org"], flow_pred)
            if save_dir is not None:
                test_set._save_predflow(flow_pred[None], save_root=save_dir,
                                        batch_size=1, n_frame=2, offset=sid)
        scene_s.append((time.perf_counter() - t0) / len(group))


def eval_scene(args, dev: OutdoorFlow, test_set, sid: int, meter,
               save_dir: Optional[str]) -> None:
    """One scene (the JAX CLI's per-scene loop)."""
    s = scene_cloud_pair(test_set, sid)
    pc1_icp, pc2_icp = s["pc1"] - s["center"], s["pc2"] - s["center"]
    pc1_fps = dev.subsample(pc1_icp, N_POINT_ICP)
    pc2_fps = dev.subsample(pc2_icp, N_POINT_ICP)
    # Ego-motion from ICP on the background points: on the device, or the
    # numpy oracle with --host_preproc.
    if args.host_preproc:
        T, _, _ = icp(pc1_fps, pc2_fps, max_iterations=MAX_ICP_ITERS)
    else:
        T = dev.icp(pc1_fps[None], pc2_fps[None])[0]
    rot, transl = T[:3, :3], T[:3, 3].T
    pc1_org = s["pc1_org"]
    flow_pred = (pc1_org @ rot.T + transl - pc1_org).astype(np.float32)

    # Residual flow from the network on the ego-compensated points.
    pc1 = (s["pc1"] @ rot.T + transl).astype(np.float32)
    flow_pred[s["not_ground"]] += dev.flow(
        dev.subsample(pc1, dev.n_point)[None],
        dev.subsample(s["pc2"], dev.n_point)[None], pc1[None])[0]
    add_flow_metrics(meter, s["flow_org"], flow_pred)
    if save_dir is not None:
        test_set._save_predflow(flow_pred[None], save_root=save_dir,
                                batch_size=1, n_frame=2, offset=sid)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Evaluate; print the JAX CLI's report and return the mean metrics and
    the wall seconds per scene."""
    args = flow_parser().parse_args(argv)
    check_flags(args)
    load_config_into_args(args)
    dev = OutdoorFlow(args)
    from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

    data_root = args.data["root"]
    # YAML-overridable mapping (the tests point it at a synthetic root).
    mapping_path = args.data.get("mapping_path") or (
        "data_prepare/kittisf/splits/val.txt" if args.split == "val"
        else "data_prepare/kittisf/splits/train.txt")
    test_set = KITTISceneFlowDataset(data_root=data_root,
                                     mapping_path=mapping_path,
                                     downsampled=False,
                                     view_sels=[[0, 1], [1, 0]])
    save_dir = None
    if args.save:
        save_dir = osp.join(data_root, "flow_preds/flowstep3d")
        os.makedirs(save_dir, exist_ok=True)

    meter = AverageMeter()
    scene_s = []
    if args.scene_batch > 1:
        batched_eval(args, dev, test_set, meter, save_dir, scene_s)
    else:
        for sid in range(len(test_set)):
            t0 = time.perf_counter()
            eval_scene(args, dev, test_set, sid, meter, save_dir)
            scene_s.append(time.perf_counter() - t0)

    res = meter.get_mean_loss_dict()
    print("Evaluation on kittisf-%s:" % args.split, res)
    return {**res, "scene_s": scene_s}


if __name__ == "__main__":
    main()
