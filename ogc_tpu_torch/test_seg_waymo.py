"""Evaluate segmentation on Waymo Open with per-point ignore masks, with the
PyTorch port (the protocol of the repo's test_seg_waymo.py: AP@50,
PQ/F1/Pre/Rec@50 with ``accumulate_eval_results_ignmask``, and the per-scan
mIoU / RI with the ignore mask).

Usage (the flags of the repo's test_seg_waymo.py):
    python -m ogc_tpu_torch.test_seg_waymo config/seg/waymo/waymo_unsup.yaml \\
        --split val --round R [--test_batch_size 64] [--save] \\
        [--approx_knn] [--device cuda]

Weights are read from ``<save_path>[_R<round>]/best.pth.tar``.  Classes 2
and 3 (pedestrians, cyclists) and objects under 50 points are ignored, as
in the JAX CLI.  Neighbour search is exact unless ``--approx_knn``;
``--dp N`` shards each batch over N devices, as test_seg.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.data.waymo import WaymoOpenSingleFrameDataset
from ogc_tpu_torch.metrics.seg import (
    accumulate_eval_results_ignmask,
    calculate_AP,
    calculate_PQ_F1,
    clustering_metrics,
)
from ogc_tpu_torch.test_seg import segnet_forward
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.meters import AverageMeter


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--round", type=int, default=0)
    parser.add_argument("--test_batch_size", type=int, default=64)
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel devices (0 = all local devices)")
    parser.add_argument("--save", default=False, action="store_true")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested "
                             "FPS)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Evaluate; print the JAX CLI's report and return its numbers plus the
    per-batch forward times (seconds)."""
    args = parse_args(argv)
    load_config_into_args(args)
    forward = segnet_forward(args)

    data_root = args.data["root"]
    mapping_path = ("data_prepare/waymo/splits/val.txt" if args.split == "val"
                    else "data_prepare/waymo/splits/train.txt")
    # Eval-time ignore configuration (reference test_seg_waymo.py:63-71).
    test_set = WaymoOpenSingleFrameDataset(
        data_root=data_root, mapping_path=mapping_path, downsampled=True,
        sampled_interval=1, decentralize=args.data["decentralize"],
        ignore_class_ids=[2, 3], ignore_npoint_thresh=50)
    batch_size = args.test_batch_size
    if args.save:
        save_dir = osp.join(data_root, "segm_preds/OGC" + "_R%d" % args.round)
        os.makedirs(save_dir, exist_ok=True)

    scans = AverageMeter()
    ap = {"Pred_IoU": [], "Pred_Matched": [], "Confidence": [],
          "N_GT_Inst": []}
    forward_s = []
    loader = DataLoader(test_set, batch_size=batch_size, shuffle=False,
                        num_workers=4)
    for i, (pcs, segms, valids) in enumerate(loader):
        segm, ignore = segms[:, 0], 1 - valids[:, 0]
        t0 = time.perf_counter()
        mask = forward(pcs[:, 0])
        forward_s.append(time.perf_counter() - t0)
        for key, v in zip(ap, accumulate_eval_results_ignmask(segm, mask,
                                                              ignore)):
            ap[key].append(v)
        for b in range(segm.shape[0]):
            mbs = clustering_metrics(mask[b:b + 1], segm[b:b + 1],
                                     ignore_mask=ignore[b:b + 1])
            scans.append_loss({
                "per_scan_iou_avg": float(np.mean(mbs["iou"])),
                "per_scan_iou_std": float(np.std(mbs["iou"])),
                "per_scan_ri_avg": float(np.mean(mbs["ri"])),
                "per_scan_ri_std": float(np.std(mbs["ri"])),
            })
        if args.save:
            test_set._save_predsegm(mask, save_root=save_dir,
                                    batch_size=batch_size, n_frame=1,
                                    offset=i)

    print("Evaluation on waymo-%s:" % args.split)
    pred_iou = np.concatenate(ap["Pred_IoU"])
    pred_matched = np.concatenate(ap["Pred_Matched"])
    n_gt_inst = int(np.sum(ap["N_GT_Inst"]))
    ap50 = calculate_AP(pred_matched, np.concatenate(ap["Confidence"]),
                        n_gt_inst)
    print("AveragePrecision@50:", ap50)
    pq, f1, pre, rec = calculate_PQ_F1(pred_iou, pred_matched, n_gt_inst)
    print("PanopticQuality@50:", pq, "F1-score@50:", f1, "Prec@50:", pre,
          "Recall@50:", rec)
    clustering = scans.get_mean_loss_dict()
    print(clustering)
    return {"AP": ap50, "PQ": pq, "F1": f1, "Pre": pre, "Rec": rec,
            **clustering, "forward_s": forward_s}


if __name__ == "__main__":
    main()
