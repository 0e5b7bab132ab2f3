"""Train the fully supervised segmentation baseline with the PyTorch port.

Usage (the flags of the repo's train_seg_sup.py):
    python -m ogc_tpu_torch.train_seg_sup <config.yaml> [--resume] \
        [--device cuda]

Datasets ``sapien``, ``ogcdr`` and ``kittisf`` with one-hot labels of
``n_slot`` objects and their valid masks; frame 0 of every pair trains.
Writes ``<save_path>/{current,best}.pth.tar`` (full train state;
``model_state`` is what ``ogc_tpu_torch.test_seg`` reads) and
``<save_path>/log/scalars.jsonl``.  Neighbour search follows
``OGC_EXACT_NEIGHBORS`` (approximate by default), as in train_seg.  On CUDA
it runs deterministic, with TF32 off.  ``--remat`` as in train_seg.  Under ``torchrun`` it trains data parallel, one
rank a card (gloo with ``--device cpu``), as train_seg does.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.losses.seg_sup import SupLossConfig
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.train.seg import Adam, make_lr_schedule
from ogc_tpu_torch.train.seg_sup import SupSegTrainer
from ogc_tpu_torch.train_seg import segnet_for, set_deterministic
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.logging import JsonlWriter


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
    """(train_set, val_set) with one-hot labels (train_seg_sup.py:48-93)."""
    data_root = args.data["root"]
    labels = dict(decentralize=args.data["decentralize"], onehot_label=True,
                  max_n_object=args.segnet["n_slot"])
    if args.dataset in ("sapien", "ogcdr"):
        if args.dataset == "sapien":
            from ogc_tpu_torch.data.sapien import \
                SapienDataset as TrainDataset

            data_root = osp.join(data_root, "mbs-shapepart")
        else:
            from ogc_tpu_torch.data.ogcdr import \
                OGCDynamicRoomDataset as TrainDataset
        view_sels = [[0, 1], [1, 2], [2, 3]]
        return tuple(TrainDataset(data_root=data_root, split=split,
                                  view_sels=view_sels, **labels)
                     for split in ("train", "val"))
    if args.dataset != "kittisf":
        raise KeyError("Unrecognized dataset!")
    from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

    return tuple(KITTISceneFlowDataset(
        data_root=data_root, mapping_path=args.data[f"{split}_mapping"],
        downsampled=True, view_sels=[[0, 1]],
        ignore_npoint_thresh=args.ignore_npoint_thresh, **labels)
        for split in ("train", "val"))


def run(args, model, train_set, val_set,
        loss_cfg: SupLossConfig) -> Dict[str, object]:
    """Train ``model`` on ``args.device`` over the datasets with
    ``loss_cfg``: the loaders, Adam with the config's schedule,
    SupSegTrainer writing ``<save_path>``, ``--resume``.  Returns the best
    validation loss and the trainer.  Under torchrun each rank trains on
    its card (parallel/mesh.py)."""
    device = mesh.init_data_parallel(args.device)
    model.to(device)
    train_loader = DataLoader(train_set, batch_size=args.batch_size,
                              shuffle=True, seed=args.random_seed,
                              num_workers=4, drop_last=True)
    val_loader = DataLoader(val_set, batch_size=args.batch_size,
                            shuffle=False, num_workers=4)
    optimizer = Adam(dict(model.named_parameters()),
                     make_lr_schedule(args.lr, args.lr_decay, args.lr_clip,
                                      args.decay_step, args.batch_size),
                     args.weight_decay)
    trainer = SupSegTrainer(
        model, loss_cfg, optimizer,
        ignore_npoint_thresh=args.ignore_npoint_thresh,
        exp_base=args.save_path, device=device,
        writer=JsonlWriter(osp.join(args.save_path, "log")),
        remat=args.remat)
    start_epoch = 1
    if args.resume:
        start_epoch = trainer.resume(osp.join(args.save_path, "current")) + 1
        trainer._print(f"Resumed from epoch {start_epoch - 1}")
    best = trainer.train(args.epochs, train_loader, val_loader,
                         start_epoch=start_epoch)
    mesh.shutdown()
    return {"best_loss": best, "trainer": trainer}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Train; returns what ``run`` returns."""
    args = parse_args(argv)
    load_config_into_args(args)
    set_deterministic(torch.device(args.device))

    np.random.seed(args.random_seed)
    model = segnet_for(args, args.dataset,
                       torch.Generator().manual_seed(args.random_seed))
    train_set, val_set = build_datasets(args)
    return run(args, model, train_set, val_set,
               SupLossConfig(weights=tuple(args.loss["weights"])))


if __name__ == "__main__":
    main()
