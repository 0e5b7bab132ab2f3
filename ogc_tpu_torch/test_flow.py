"""Evaluate scene flow (EPE3D, AccS, AccR, Outlier) with the PyTorch port's
FlowStep3D and optionally save the flow predictions that the segmentation
stage reads (``predflow_path: flowstep3d``).

Usage (the flags of the repo's test_flow.py):
    python -m ogc_tpu_torch.test_flow <config.yaml> --split test \\
        [--test_batch_size 48] [--test_model_iters 4] [--save] \\
        [--approx_knn] [--device cuda]

Weights are read from ``<save_path>/best.pth.tar`` as ``{"model_state":
state_dict}`` with the reference's keys.  ``--save`` writes
``<root>/flow_preds/flowstep3d/<id>.npy`` (the 6 view pairs of a scene) and
``flowstep3d.json``.  Neighbour search is exact unless ``--approx_knn``
(block-min search, nested FPS, frozen self-KNN), as in the JAX package's
test_flow.py; ``--dp`` other than 1 raises.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.metrics.flow import eval_flow
from ogc_tpu_torch.models.flownet import FlowStep3D
from ogc_tpu_torch.utils.checkpoint import load_model_state
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.meters import AverageMeter

VIEW_SELS = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="test",
                        help="Dataset split")
    parser.add_argument("--test_batch_size", type=int, default=48)
    parser.add_argument("--test_model_iters", type=int, default=4,
                        help="FlowStep3D unroll iterations in testing")
    parser.add_argument("--save", default=False, action="store_true",
                        help="Save flow predictions")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested "
                             "FPS, frozen self-KNN)")
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel devices (only 1 is ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    return parser.parse_args(argv)


def build_flownet(args) -> FlowStep3D:
    """The config's FlowStep3D, k_decay_fact 0.5 at test time (reference
    test_flow.py:52)."""
    fn = args.flownet
    return FlowStep3D(npoint=fn["npoint"], arch=args.dataset,
                      use_instance_norm=fn["use_instance_norm"],
                      loc_flow_nn=fn["loc_flow_nn"],
                      loc_flow_rad=fn["loc_flow_rad"], k_decay_fact=0.5)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Evaluate; print the reference's report and return the mean metrics
    plus the per-batch forward times (seconds)."""
    args = parse_args(argv)
    if args.dp != 1:
        raise NotImplementedError(
            "--dp: data-parallel evaluation is not ported yet (ROADMAP.md "
            "A.12)")
    load_config_into_args(args)
    ops.set_exact_neighbors(not args.approx_knn)
    # Full float32 matmuls (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)

    data_root = args.data["root"]
    if args.dataset == "sapien":
        from ogc_tpu_torch.data.sapien import SapienDataset as TestDataset

        data_root = osp.join(data_root, "mbs-sapien" if args.split == "test"
                             else "mbs-shapepart")
    elif args.dataset == "ogcdr":
        from ogc_tpu_torch.data.ogcdr import \
            OGCDynamicRoomDataset as TestDataset
    else:
        raise KeyError("Unrecognized dataset!")
    epe_norm_thresh = 0.01

    flownet = build_flownet(args)
    path = osp.join(args.save_path, "best")
    flownet.load_state_dict(load_model_state(path))
    flownet.to(device).eval()
    print("Loaded weights from", path)

    test_set = TestDataset(data_root=data_root, split=args.split,
                           view_sels=VIEW_SELS)
    batch_size = args.test_batch_size
    n_frame = len(VIEW_SELS)
    if args.save:
        if batch_size % n_frame:
            raise ValueError("Frame pairs of one scene should be in the same "
                             "batch!")
        save_dir = osp.join(data_root, "flow_preds/flowstep3d")
        os.makedirs(save_dir, exist_ok=True)
        with open(save_dir + ".json", "w") as f:
            json.dump({"view_sel": VIEW_SELS}, f)

    meter = AverageMeter()
    forward_s = []
    loader = DataLoader(test_set, batch_size=batch_size, shuffle=False,
                        num_workers=4)
    for i, (pcs, _, flows, _) in enumerate(loader):
        t0 = time.perf_counter()
        with torch.no_grad():
            pc1 = torch.from_numpy(pcs[:, 0]).to(device)
            pc2 = torch.from_numpy(pcs[:, 1]).to(device)
            flow_pred = flownet(pc1, pc2, pc1, pc2,
                                args.test_model_iters)[-1].cpu().numpy()
        forward_s.append(time.perf_counter() - t0)
        epe, acc_s, acc_r, outlier = eval_flow(flows[:, 0], flow_pred,
                                               epe_norm_thresh=epe_norm_thresh)
        meter.append_loss({"EPE": epe, "AccS": acc_s, "AccR": acc_r,
                           "Outlier": outlier})
        if args.save:
            test_set._save_predflow(flow_pred, save_root=save_dir,
                                    batch_size=batch_size, n_frame=n_frame,
                                    offset=i)

    res = meter.get_mean_loss_dict()
    print("Evaluation on %s-%s:" % (args.dataset, args.split), res)
    return {**res, "forward_s": forward_s}


if __name__ == "__main__":
    main()
