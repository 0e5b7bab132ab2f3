"""Multi-frame co-segmentation voting evaluation with the PyTorch port.

Usage (the flags of the repo's vote.py):
    python -m ogc_tpu_torch.vote <config.yaml> --split test --round R \
        [--time_window_size 3] [--use_gt_flow] [--test_batch_size 64] \
        [--save] [--device cuda]

Weights are read from ``<save_path>[_R<round>]/best.pth.tar``.  Every batch
holds whole scenes (test_batch_size a multiple of the 4 frames); the
segnet runs on all their frames in one forward, then the masks are voted
scene by scene, all scenes of the batch at once.  Prints AP@50,
PQ/F1/Pre/Rec@50 and the per-scan IoU/RI.  Runs with TF32 off and exact
neighbours unless ``--approx_knn``; ``--dp`` other than 1 raises.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, List, Optional

import torch

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.refine.vote import mask_voting_batch
from ogc_tpu_torch.test_seg import SegMetrics, build_test_dataset, load_segnet
from ogc_tpu_torch.utils.config import load_config_into_args


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--round", type=int, default=0)
    parser.add_argument("--test_batch_size", type=int, default=64)
    parser.add_argument("--time_window_size", type=int, default=3)
    parser.add_argument("--use_gt_flow", default=False, action="store_true")
    parser.add_argument("--save", default=False, action="store_true")
    parser.add_argument("--approx_knn", default=False, action="store_true",
                        help="Approximate neighbour search (block-min, nested FPS)")
    parser.add_argument("--dp", type=int, default=1,
                        help="Data-parallel devices (only 1 is ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model and voting run on")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Vote and evaluate; print the reference's report and return it."""
    args = parse_args(argv)
    if args.dp != 1:
        raise NotImplementedError(
            "--dp: data-parallel voting is not ported yet (ROADMAP.md A.12)")
    load_config_into_args(args)
    segnet, device = load_segnet(args)

    if args.use_gt_flow:
        predflow_path = None
    elif args.round > 1:
        predflow_path = args.predflow_path + "_R%d" % (args.round - 1)
    else:
        predflow_path = args.predflow_path
    test_set, n_frame, ignore_npoint_thresh, data_root = build_test_dataset(
        args, predflow_path)
    batch_size = args.test_batch_size
    if batch_size % n_frame:
        raise ValueError("Frames of one scene should be in the same batch!")
    if args.save:
        save_dir = osp.join(data_root,
                            "segm_preds/Vote_T%d" % args.time_window_size)
        os.makedirs(save_dir, exist_ok=True)

    metrics = SegMetrics(ignore_npoint_thresh)
    loader = DataLoader(test_set, batch_size=batch_size, shuffle=False,
                        num_workers=4)
    for i, (pcs, segms, flows, _) in enumerate(loader):
        segm = segms[:, 0]
        n_scene = segm.shape[0] // n_frame
        with torch.no_grad():
            pc = torch.from_numpy(pcs[:, 0]).to(device)
            mask = segnet(pc, pc)
            N, K = mask.shape[1:]
            fl = torch.from_numpy(flows).to(device).reshape(
                n_scene, n_frame, 2, N, 3)[:, :n_frame - 1]
            voted = mask_voting_batch(
                pc.reshape(n_scene, n_frame, N, 3),
                mask.reshape(n_scene, n_frame, N, K), fl,
                time_window_size=args.time_window_size)
            mask_voted = voted.reshape(n_scene * n_frame, N, K).cpu().numpy()
        metrics.add(segm, mask_voted, n_frame)
        if args.save:
            test_set._save_predsegm(mask_voted, save_root=save_dir,
                                    batch_size=batch_size, n_frame=n_frame,
                                    offset=i)

    return metrics.report("%s-%s" % (args.dataset, args.split))


if __name__ == "__main__":
    main()
