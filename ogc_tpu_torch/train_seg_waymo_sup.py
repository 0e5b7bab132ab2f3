"""Train the fully supervised segmentation baseline on Waymo Open with the
PyTorch port (single-frame items with per-point valid masks).

Usage (the flags of the repo's train_seg_waymo_sup.py):
    python -m ogc_tpu_torch.train_seg_waymo_sup config/seg/waymo/waymo_sup.yaml \\
        [--resume] [--device cuda]

As ``ogc_tpu_torch.train_seg_sup`` (its ``run``: SupSegTrainer, Adam,
checkpoints ``<save_path>/{current,best}.pth.tar`` and log; approximate
neighbours unless ``OGC_EXACT_NEIGHBORS=1``; deterministic on CUDA) on
``WaymoOpenSingleFrameDataset`` with one-hot labels of ``n_slot`` objects,
classes 2 and 3 and objects under ``ignore_npoint_thresh`` points ignored,
and the ``waymo`` (KITTI) segnet.  The items' two frames (the frame and,
with ``aug_transform``, its augmented view) get zero flows, as the JAX
CLI's ``_FlowPad``.  ``--remat`` as in train_seg.  Under
``torchrun`` it trains data parallel, as train_seg_sup.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch.data.waymo import WaymoOpenSingleFrameDataset
from ogc_tpu_torch.losses.seg_sup import SupLossConfig
from ogc_tpu_torch.train_seg import segnet_for, set_deterministic
from ogc_tpu_torch.train_seg_sup import run
from ogc_tpu_torch.utils.config import load_config_into_args


class FlowPad:
    """Single-frame 3-tuple items as the trainers' 4-tuple (zero flows)."""

    def __init__(self, ds):
        self.ds = ds
        self.aug_transform = ds.aug_transform

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        pcs, segms, valids = self.ds[i]
        return pcs, segms, np.zeros_like(pcs), valids


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="Resume from <save_path>/current (full train "
                             "state)")
    parser.add_argument("--remat", type=str, default=None,
                        choices=["off", "full", "dots"],
                        help="Rematerialize the model forward in the "
                             "backward (ops/remat.py; default $OGC_REMAT "
                             "or off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model trains on")
    return parser.parse_args(argv)


def build_datasets(args):
    """(train_set, val_set) as the JAX CLI (train_seg_waymo_sup.py:48-93)."""
    data = args.data
    common = dict(data_root=data["root"], downsampled=True,
                  decentralize=data["decentralize"], onehot_label=True,
                  max_n_object=args.segnet["n_slot"], ignore_class_ids=[2, 3],
                  ignore_npoint_thresh=args.ignore_npoint_thresh)
    train_set = WaymoOpenSingleFrameDataset(
        mapping_path=data["train_mapping"],
        select_frame=data["train_select_frame"],
        aug_transform=data.get("aug_transform", False),
        aug_transform_args=data["aug_transform_args"], **common)
    val_set = WaymoOpenSingleFrameDataset(
        mapping_path=data["val_mapping"],
        select_frame=data["val_select_frame"], **common)
    return FlowPad(train_set), FlowPad(val_set)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Train; returns the best validation loss and the trainer."""
    args = parse_args(argv)
    load_config_into_args(args)
    set_deterministic(torch.device(args.device))

    np.random.seed(args.random_seed)
    model = segnet_for(args, "waymo",
                       torch.Generator().manual_seed(args.random_seed))
    train_set, val_set = build_datasets(args)
    return run(args, model, train_set, val_set, SupLossConfig(
        weights=tuple(args.loss["weights"]),
        use_focal=args.loss.get("use_focal", False)))


if __name__ == "__main__":
    main()
