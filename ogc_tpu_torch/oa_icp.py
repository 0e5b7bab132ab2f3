"""Object-Aware ICP with the PyTorch port: refine flow predictions with the
learned segmentation and write a new flow directory for the next training
round.

Usage (the flags of the repo's oa_icp.py):
    python -m ogc_tpu_torch.oa_icp <config.yaml> --split train --round R \
        [--test_batch_size 48] [--save] [--saveflow_path P] [--device cuda]

Weights are read from ``<save_path>_R<round>/best.pth.tar``; flow
predictions from ``flow_preds/flowstep3d`` (round 1) or
``flow_preds/flowstep3d_R<round-1>``.  ``--save`` writes
``flow_preds/<saveflow_path>_R<round>`` (plus its ``.json`` view list on
SAPIEN) in the layout the datasets of both packages read.  Runs with TF32
off and exact neighbours unless ``--approx_knn``.  The segnet on both
clouds, the weighted Kabsch and OA-ICP run as one sharded call: ``--dp N``
spreads each batch over N devices, as test_seg.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import Dict, List, Optional

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.metrics.flow import eval_flow
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.refine.oa_icp import object_aware_icp, weighted_kabsch
from ogc_tpu_torch.test_seg import load_segnet
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.meters import AverageMeter

# OA-ICP iterations per alternation round (reference oa_icp.py:175-176).
ICP_ITERS = {1: 20, 2: 10, 3: 5, 4: 3}


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="train",
                        help="Dataset split")
    parser.add_argument("--round", type=int, default=1,
                        help="Which round of iterative optimization")
    parser.add_argument("--test_batch_size", type=int, default=48)
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel devices (0 = all local devices)")
    parser.add_argument("--save", default=False, action="store_true",
                        help="Save updated flow predictions")
    parser.add_argument("--saveflow_path", type=str, default=None)
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested FPS)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the refinement runs on")
    args = parser.parse_args(argv)
    if args.round < 1:
        parser.error("--round must be >= 1 (got %d)" % args.round)
    return args


def build_datasets(args):
    """(test_set, test_set_predflow, view_sels, epe_norm_thresh, data_root)
    as the repo's oa_icp.py builds them."""
    data_root = args.data["root"]
    predflow_path = ("flowstep3d_R%d" % (args.round - 1) if args.round > 1
                     else "flowstep3d")
    if args.dataset in ("sapien", "ogcdr"):
        if args.dataset == "sapien":
            from ogc_tpu_torch.data.sapien import SapienDataset as make

            data_root = osp.join(data_root, "mbs-sapien"
                                 if args.split == "test" else "mbs-shapepart")
        else:
            from ogc_tpu_torch.data.ogcdr import OGCDynamicRoomDataset as make
        view_sels = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]
        common = dict(data_root=data_root, split=args.split,
                      view_sels=view_sels,
                      decentralize=args.data["decentralize"])
        thresh = 0.01
    elif args.dataset == "kittisf":
        from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

        mapping_path = ("data_prepare/kittisf/splits/val.txt"
                        if args.split == "val"
                        else "data_prepare/kittisf/splits/train.txt")
        view_sels = [[0, 1], [1, 0]]
        common = dict(data_root=data_root, mapping_path=mapping_path,
                      downsampled=True, view_sels=view_sels,
                      decentralize=args.data["decentralize"])
        make, thresh = KITTISceneFlowDataset, 0.05
    else:
        raise KeyError("Unrecognized dataset!")
    return (make(**common), make(**common, predflow_path=predflow_path),
            view_sels, thresh, data_root)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Refine; print the reference's three flow reports and return them."""
    args = parse_args(argv)
    load_config_into_args(args)
    devices = mesh.eval_devices(args.dp, args.device)
    segnet, _ = load_segnet(args)

    test_set, test_set_pf, view_sels, thresh, data_root = \
        build_datasets(args)
    n_frame = len(view_sels)
    batch_size = args.test_batch_size
    # Rounds beyond the reference's table clamp to its last entry.
    icp_iter = ICP_ITERS.get(args.round, ICP_ITERS[max(ICP_ITERS)])
    if args.save:
        if batch_size % n_frame:
            raise ValueError("Frames of one scene should be in the same "
                             "batch!")
        save_dir = osp.join(data_root, "flow_preds",
                            (args.saveflow_path or "flowstep3d")
                            + "_R%d" % args.round)
        os.makedirs(save_dir, exist_ok=True)
        if args.dataset in ("sapien", "ogcdr"):
            with open(save_dir + ".json", "w") as f:
                json.dump({"view_sel": view_sels}, f)

    def refine_batch(m, pc1, pc2, f):
        m1, m2 = m(pc1, pc1), m(pc2, pc2)
        return (weighted_kabsch(pc1, f, m1),
                object_aware_icp(pc1, pc2, f, m1, m2, icp_iter=icp_iter))

    refine = mesh.dp_eval_fwd(refine_batch, devices, segnet)
    meters = {"Original flow": AverageMeter(),
              "Weighted Kabsch flow": AverageMeter(),
              "Object-Aware ICP flow": AverageMeter()}
    loader = DataLoader(test_set, batch_size=batch_size, shuffle=False,
                        num_workers=4)
    loader_pf = DataLoader(test_set_pf, batch_size=batch_size, shuffle=False,
                           num_workers=4)
    for i, (batch1, batch2) in enumerate(zip(loader, loader_pf)):
        pcs, _, flows, _ = batch1
        flow_pred = batch2[2][:, 0]
        gt_flow = flows[:, 0]
        flow_kabsch, flow_oaicp = refine(pcs[:, 0], pcs[:, 1], flow_pred)
        for meter, fl in zip(meters.values(),
                             (flow_pred, flow_kabsch, flow_oaicp)):
            epe, acc_s, acc_r, outlier = eval_flow(gt_flow, fl,
                                                   epe_norm_thresh=thresh)
            meter.append_loss({"EPE": epe, "AccS": acc_s, "AccR": acc_r,
                               "Outlier": outlier})
        if args.save:
            test_set._save_predflow(flow_oaicp, save_root=save_dir,
                                    batch_size=batch_size, n_frame=n_frame,
                                    offset=i)

    out = {}
    for name, meter in meters.items():
        out[name] = meter.get_mean_loss_dict()
        print(f"{name}:", out[name])
    return out


if __name__ == "__main__":
    main()
