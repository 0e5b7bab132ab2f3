"""Train unsupervised segmentation on Waymo Open with the PyTorch port
(backward flow only: each item's one frame pair, the loss on frame 1).

Usage (the flags of the repo's train_seg_waymo.py):
    python -m ogc_tpu_torch.train_seg_waymo config/seg/waymo/waymo_unsup.yaml \\
        [--round R] [--resume] [--device cuda]

As ``ogc_tpu_torch.train_seg`` (its ``run``: SegTrainer, Adam, checkpoints
``<save_path>_R<round>/{current,best}.pth.tar`` and log; approximate
neighbours unless ``OGC_EXACT_NEIGHBORS=1``; the config's compute dtype;
deterministic on CUDA), on ``WaymoOpenDataset`` with the ``waymo`` (KITTI)
segnet, taking every second frame of an item (the reference's
pcs[:, ::2]).  The flows are ``<root>/flow_preds/<predflow_path>`` (with
``_R<round - 1>`` from round 2), or the dataset's own with
``predflow_path: None``.  ``--remat`` as in train_seg.  Under
``torchrun`` it trains data parallel, as train_seg.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch.data.waymo import WaymoOpenDataset
from ogc_tpu_torch.train_seg import (round_predflow, run, segnet_for,
                                     set_deterministic)
from ogc_tpu_torch.utils.config import load_config_into_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="Resume from <save_path>_R<round>/current")
    parser.add_argument("--remat", type=str, default=None,
                        choices=["off", "full", "dots"],
                        help="Rematerialize the model forward in the "
                             "backward (ops/remat.py; default $OGC_REMAT "
                             "or off)")
    parser.add_argument("--round", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model trains on")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Train; returns the best validation loss and the trainer."""
    args = parse_args(argv)
    load_config_into_args(args)
    set_deterministic(torch.device(args.device))

    np.random.seed(args.random_seed)
    model = segnet_for(args, "waymo",
                       torch.Generator().manual_seed(args.random_seed))
    data = args.data
    common = dict(data_root=data["root"], downsampled=True,
                  predflow_path=None if args.predflow_path == "None"
                  else round_predflow(args),
                  decentralize=data["decentralize"])
    train_set = WaymoOpenDataset(
        mapping_path=data["train_mapping"],
        select_frame=data["train_select_frame"],
        aug_transform_args=data["aug_transform_args"], **common)
    val_set = WaymoOpenDataset(mapping_path=data["val_mapping"],
                               select_frame=data["val_select_frame"],
                               **common)
    return run(args, model, train_set, val_set, frame_stride=2)


if __name__ == "__main__":
    main()
