"""Train the self-supervised scene-flow network (FlowStep3D) with the
PyTorch port.

Usage (the flags of the repo's train_flow.py):
    python -m ogc_tpu_torch.train_flow <config.yaml> [--resume] \
        [--bn_sync local] [--device cuda]

Datasets ``sapien`` and ``ogcdr``, on the six adjacent view pairs (large
motions are out of the self-supervised loss's reach, reference
train_flow.py:246).  Writes ``<save_path>/{current,best}.pth.tar`` (full
train state; ``model_state`` is what ``ogc_tpu_torch.test_flow`` reads) and
``<save_path>/log/scalars.jsonl``.  Neighbour search follows
``OGC_EXACT_NEIGHBORS``, as in the JAX package's train_flow.py:
approximate (block-min search where the searched cloud has >= 1024
points, nested FPS) by default, exact with ``OGC_EXACT_NEIGHBORS=1``.  On
CUDA it runs deterministic, with TF32 off (``train_seg.set_deterministic``).
Under ``torchrun`` it trains data parallel, one rank a card (gloo with
``--device cpu``; parallel/mesh.py), ``batch_size`` being the global batch;
``--bn_sync`` picks each rank's (``local``, the default) or the global
batch's (``global``) BatchNorm statistics, the same computation on one
rank.  ``--remat full|dots`` recomputes the whole model forward in the
backward, ``scan`` each refinement iteration (ops/remat.py), with the same
gradients and running statistics.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig
from ogc_tpu_torch.models.flownet import FlowStep3D
from ogc_tpu_torch.ops import remat
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.train.flow import FlowTrainer, make_bn_schedule
from ogc_tpu_torch.train.seg import Adam, make_lr_schedule
from ogc_tpu_torch.train_seg import set_deterministic
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.logging import JsonlWriter

VIEW_SELS = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="Resume from <save_path>/current (full train "
                             "state)")
    parser.add_argument("--remat", type=str, default=None,
                        choices=["off", "full", "dots", "scan"],
                        help="Rematerialize the forward in the backward: "
                             "full/dots the whole model, scan each "
                             "refinement iteration (ops/remat.py; default "
                             "$OGC_REMAT or off)")
    parser.add_argument("--bn_sync", type=str, default="local",
                        choices=["local", "global"],
                        help="BatchNorm statistics under data parallelism: "
                             "each rank's (local) or the global batch's")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model trains on")
    return parser.parse_args(argv)


def build_datasets(args):
    """(train_set, val_set) of the config's dataset on VIEW_SELS."""
    data_root = args.data["root"]
    if args.dataset == "sapien":
        from ogc_tpu_torch.data.sapien import SapienDataset as TrainDataset

        data_root = osp.join(data_root, "mbs-shapepart")
    elif args.dataset == "ogcdr":
        from ogc_tpu_torch.data.ogcdr import \
            OGCDynamicRoomDataset as TrainDataset
    else:
        raise KeyError("Unrecognized dataset!")
    train_set = TrainDataset(
        data_root=data_root, split="train", view_sels=VIEW_SELS,
        aug_transform=args.data["aug_transform"],
        aug_transform_args=args.data["aug_transform_args"])
    val_set = TrainDataset(data_root=data_root, split="val",
                           view_sels=VIEW_SELS, aug_transform=False)
    return train_set, val_set


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Train; returns the best validation loss and the trainer (whose
    ``step_seconds``/``val_seconds`` hold the host-clock times)."""
    args = parse_args(argv)
    load_config_into_args(args)
    set_deterministic(torch.device(args.device))
    device = mesh.init_data_parallel(args.device)

    mode = remat.resolve(args.remat, ("full", "dots", "scan"))
    np.random.seed(args.random_seed)
    fn = args.flownet
    model = FlowStep3D(
        npoint=fn["npoint"], arch=args.dataset,
        use_instance_norm=fn["use_instance_norm"],
        loc_flow_nn=fn["loc_flow_nn"], loc_flow_rad=fn["loc_flow_rad"],
        k_decay_fact=fn["k_decay_fact"],
        generator=torch.Generator().manual_seed(args.random_seed)
    ).to(device)
    model.remat_refine = mode == "scan"
    train_set, val_set = build_datasets(args)
    train_loader = DataLoader(train_set, batch_size=args.batch_size,
                              shuffle=True, seed=args.random_seed,
                              num_workers=4, drop_last=True)
    val_loader = DataLoader(val_set, batch_size=args.batch_size,
                            shuffle=False, num_workers=4)
    optimizer = Adam(dict(model.named_parameters()),
                     make_lr_schedule(args.lr, args.lr_decay, args.lr_clip,
                                      args.decay_step, args.batch_size),
                     args.weight_decay)
    trainer = FlowTrainer(
        model, args.model_iters, FlowLossConfig.from_dict(args.loss),
        optimizer, exp_base=args.save_path, device=device,
        bn_schedule=make_bn_schedule(args.bn_momentum, args.bn_decay,
                                     args.decay_step, args.batch_size),
        writer=JsonlWriter(osp.join(args.save_path, "log")),
        bn_sync=args.bn_sync, remat="off" if mode == "scan" else mode)
    start_epoch = 1
    if args.resume:
        start_epoch = trainer.resume(osp.join(args.save_path, "current")) + 1
        trainer._print(f"Resumed from epoch {start_epoch - 1}")
    best = trainer.train(args.epochs, train_loader, val_loader,
                         start_epoch=start_epoch)
    mesh.shutdown()
    return {"best_loss": best, "trainer": trainer}


if __name__ == "__main__":
    main()
