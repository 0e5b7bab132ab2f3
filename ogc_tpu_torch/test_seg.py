"""Evaluate the object segmentation network (AP@50, PQ/F1/Pre/Rec, mIoU, RI)
with the PyTorch port.

Usage (the flags of the repo's test_seg.py, minus --visualize):
    python -m ogc_tpu_torch.test_seg <config.yaml> --split val --round R \
        [--test_batch_size 8] [--dp N] [--device cuda] [--save]

Weights are read from ``<save_path>[_R<round>]/best.pth.tar`` as
``{"model_state": state_dict}``.  Neighbour search is exact unless
``--approx_knn`` asks for the approximate mode (block-min search, nested
FPS), as in the JAX package's test_seg.py.  ``--dp N`` shards each batch
over N local cards (0: all; more than the machine has raises), or N
replicas with ``--device cpu`` (parallel/mesh.py::dp_eval_fwd).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.metrics.seg import (
    accumulate_eval_results,
    calculate_AP,
    calculate_PQ_F1,
    clustering_metrics,
)
from ogc_tpu_torch.models.segnet import MaskFormer3D
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.utils.checkpoint import load_model_state, weight_path
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.meters import AverageMeter


def build_test_dataset(args, predflow_path: Optional[str] = None):
    """(test_set, n_frame, ignore_npoint_thresh, data_root), as test_seg.py
    (sapien, ogcdr, kittisf, and the single-frame kittidet and
    semantickitti); vote.py passes the flow predictions to read (None: the
    true flows)."""
    data_root = args.data["root"]
    if args.dataset in ("sapien", "ogcdr"):
        if args.dataset == "sapien":
            from ogc_tpu_torch.data.sapien import SapienDataset as make

            data_root = osp.join(data_root, "mbs-sapien"
                                 if args.split == "test" else "mbs-shapepart")
        else:
            from ogc_tpu_torch.data.ogcdr import OGCDynamicRoomDataset as make
        view_sels = [[0, 1], [1, 2], [2, 3], [3, 2]]
        test_set = make(
            data_root=data_root, split=args.split, view_sels=view_sels,
            predflow_path=predflow_path,
            decentralize=args.data["decentralize"])
        return test_set, len(view_sels), 0, data_root
    if args.dataset == "kittisf":
        from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

        mapping_path = ("data_prepare/kittisf/splits/val.txt"
                        if args.split == "val"
                        else "data_prepare/kittisf/splits/train.txt")
        view_sels = [[0, 1], [1, 0]]
        test_set = KITTISceneFlowDataset(
            data_root=data_root, mapping_path=mapping_path, downsampled=True,
            view_sels=view_sels, predflow_path=predflow_path,
            decentralize=args.data["decentralize"])
        return test_set, len(view_sels), 50, data_root
    if args.dataset == "kittidet":
        from ogc_tpu_torch.data.kittidet import KITTIDetectionDataset

        mapping_path = ("data_prepare/kittidet/splits/val.txt"
                        if args.split == "val"
                        else "data_prepare/kittidet/splits/train.txt")
        test_set = KITTIDetectionDataset(
            data_root=data_root, mapping_path=mapping_path,
            decentralize=args.data["decentralize"])
        return test_set, 1, 50, data_root
    if args.dataset == "semantickitti":
        from ogc_tpu_torch.data.semantickitti import SemanticKITTIDataset

        test_set = SemanticKITTIDataset(
            data_root=data_root, sequence_list=list(range(11)),
            decentralize=args.data["decentralize"])
        return test_set, 1, 50, data_root
    raise KeyError("Unrecognized dataset!")


def load_segnet(args) -> Tuple[MaskFormer3D, torch.device]:
    """The config's MaskFormer3D with the weights of ``args.round``, on
    ``args.device`` in eval mode; sets the neighbour mode (exact unless
    ``--approx_knn``) and turns TF32 off for the evaluating entry points
    (test_seg, oa_icp, vote)."""
    ops.set_exact_neighbors(not args.approx_knn)
    # Full float32 matmuls and convolutions (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    sn = args.segnet
    segnet = MaskFormer3D(
        n_slot=sn["n_slot"], n_point=sn["n_point"], arch=args.dataset,
        use_xyz=sn["use_xyz"], n_transformer_layer=sn["n_transformer_layer"],
        transformer_embed_dim=sn["transformer_embed_dim"],
        transformer_input_pos_enc=sn["transformer_input_pos_enc"])
    path = weight_path(args.save_path, args.round)
    segnet.load_state_dict(load_model_state(path))
    segnet.to(device).eval()
    print("Loaded weights from", path)
    return segnet, device


class SegMetrics:
    """AP@50, PQ/F1/Pre/Rec@50 and the per-scan IoU/RI over the batches of
    one evaluation (the report of test_seg.py and vote.py)."""

    def __init__(self, ignore_npoint_thresh: int):
        self.thresh = ignore_npoint_thresh
        self.ap = {"Pred_IoU": [], "Pred_Matched": [], "Confidence": [],
                   "N_GT_Inst": []}
        self.scans = AverageMeter()

    def add(self, segm: np.ndarray, mask: np.ndarray, n_frame: int) -> None:
        """One batch of whole scenes: segm (B, N), mask (B, N, K)."""
        iou, matched, conf, n_gt = accumulate_eval_results(
            segm, mask, ignore_npoint_thresh=self.thresh)
        self.ap["Pred_IoU"].append(iou)
        self.ap["Pred_Matched"].append(matched)
        self.ap["Confidence"].append(conf)
        self.ap["N_GT_Inst"].append(n_gt)
        for sid in range(segm.shape[0] // n_frame):
            sl = slice(n_frame * sid, n_frame * (sid + 1))
            mbs = clustering_metrics(mask[sl], segm[sl],
                                     ignore_npoint_thresh=self.thresh)
            self.scans.append_loss({
                "per_scan_iou_avg": float(np.mean(mbs["iou"])),
                "per_scan_iou_std": float(np.std(mbs["iou"])),
                "per_scan_ri_avg": float(np.mean(mbs["ri"])),
                "per_scan_ri_std": float(np.std(mbs["ri"])),
            })

    def report(self, title: str) -> Dict[str, float]:
        """Print the reference's report and return its numbers."""
        print("Evaluation on %s:" % title)
        pred_iou = np.concatenate(self.ap["Pred_IoU"])
        pred_matched = np.concatenate(self.ap["Pred_Matched"])
        confidence = np.concatenate(self.ap["Confidence"])
        n_gt_inst = int(np.sum(self.ap["N_GT_Inst"]))
        ap = calculate_AP(pred_matched, confidence, n_gt_inst)
        print("AveragePrecision@50:", ap)
        pq, f1, pre, rec = calculate_PQ_F1(pred_iou, pred_matched, n_gt_inst)
        print("PanopticQuality@50:", pq, "F1-score@50:", f1, "Prec@50:", pre,
              "Recall@50:", rec)
        clustering = self.scans.get_mean_loss_dict()
        print(clustering)
        return {"AP": ap, "PQ": pq, "F1": f1, "Pre": pre, "Rec": rec,
                **clustering}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="test", help="Dataset split")
    parser.add_argument("--round", type=int, default=0,
                        help="Trained segmentation model of which round")
    parser.add_argument("--test_batch_size", type=int, default=64)
    parser.add_argument("--curate_by_object", type=int, default=0,
                        help="Only evaluate scenes with more objects than this")
    parser.add_argument("--save", default=False, action="store_true",
                        help="Save segmentation predictions")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested FPS)")
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel devices (0 = all local devices)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")
    return parser.parse_args(argv)


def segnet_forward(args):
    """The loaded segnet's forward sharded over ``--dp`` devices:
    (B, N, 3) points -> (B, N, K) masks on the host."""
    devices = mesh.eval_devices(args.dp, args.device)
    segnet, _ = load_segnet(args)
    return mesh.dp_eval_fwd(lambda m, x: m(x, x), devices, segnet)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Run the evaluation; print the reference's report and return the
    metrics plus the per-batch forward times (seconds)."""
    args = parse_args(argv)
    load_config_into_args(args)
    forward = segnet_forward(args)

    test_set, n_frame, ignore_npoint_thresh, data_root = build_test_dataset(args)
    batch_size = args.test_batch_size
    if args.curate_by_object > 0:
        batch_size = n_frame
    if batch_size % n_frame:
        raise ValueError("Frames of one scene should be in the same batch!")

    if args.save:
        save_dir = osp.join(data_root, "segm_preds/OGC" + "_R%d" % args.round)
        os.makedirs(save_dir, exist_ok=True)
        print("Save segmentation predictions into", save_dir, "...")

    metrics = SegMetrics(ignore_npoint_thresh)
    forward_s = []
    loader = DataLoader(test_set, batch_size=batch_size, shuffle=False,
                        num_workers=4)
    for i, batch in enumerate(loader):
        pcs, segms, _, _ = batch
        pc = pcs[:, 0]
        segm = segms[:, 0]
        if np.unique(segm[0]).shape[0] <= args.curate_by_object:
            continue

        t0 = time.perf_counter()
        mask = forward(pc)  # the copy to the host waits for the device
        forward_s.append(time.perf_counter() - t0)
        metrics.add(segm, mask, n_frame)

        if args.save:
            test_set._save_predsegm(mask, save_root=save_dir,
                                    batch_size=batch_size, n_frame=n_frame,
                                    offset=i)

    return {**metrics.report("%s-%s" % (args.dataset, args.split)),
            "forward_s": forward_s}


if __name__ == "__main__":
    main()
