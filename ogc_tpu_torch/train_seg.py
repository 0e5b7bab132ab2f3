"""Train the unsupervised object segmentation network with the PyTorch port.

Usage (the flags of the repo's train_seg.py):
    python -m ogc_tpu_torch.train_seg <config.yaml> [--round R] [--resume] \
        [--device cuda]

Writes ``<save_path>_R<round>/{current,best}.pth.tar`` (full train state;
``model_state`` is what ``ogc_tpu_torch.test_seg`` reads) and
``<save_path>_R<round>/log/scalars.jsonl``.  Neighbour search follows
``OGC_EXACT_NEIGHBORS``, as in the JAX package's train_seg.py: approximate
(block-min search and nested FPS) by default, exact with
``OGC_EXACT_NEIGHBORS=1``.  The config's ``compute_dtype`` (or
``OGC_COMPUTE_DTYPE``) picks float32 or bf16.  On CUDA it turns on
``torch.use_deterministic_algorithms`` (with the cuBLAS workspace setting
that mode requires) and turns TF32 off, so two runs from one seed give the
same bits.  ``--remat full|dots`` (or ``OGC_REMAT``) recomputes the model
forward in the backward (ops/remat.py), with the same gradients.

Data parallel: launched by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N -m ogc_tpu_torch.train_seg ...``) it runs one rank a
card (NCCL; with ``--device cpu``, gloo), ``batch_size`` being the global
batch, each rank loading its row block of it (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from ogc_tpu_torch.data.base import DataLoader
from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
from ogc_tpu_torch.models.segnet import MaskFormer3D
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule
from ogc_tpu_torch.utils.config import load_config_into_args
from ogc_tpu_torch.utils.logging import JsonlWriter


def segnet_for(args, arch: str,
               generator: Optional[torch.Generator] = None) -> MaskFormer3D:
    """The config's MaskFormer3D with the architecture ``arch``."""
    sn = args.segnet
    return MaskFormer3D(
        n_slot=sn["n_slot"], n_point=sn["n_point"], arch=arch,
        use_xyz=sn["use_xyz"], n_transformer_layer=sn["n_transformer_layer"],
        transformer_embed_dim=sn["transformer_embed_dim"],
        transformer_input_pos_enc=sn["transformer_input_pos_enc"],
        generator=generator)


def round_predflow(args) -> str:
    """The config's ``predflow_path``, from round 2 with the suffix
    ``_R<round - 1>`` (the flows the last round's OA-ICP wrote)."""
    if args.round > 1:
        return args.predflow_path + "_R%d" % (args.round - 1)
    return args.predflow_path


def build_model_and_datasets(args, predflow_path: Optional[str],
                             generator: Optional[torch.Generator] = None):
    """(model, train_set, val_set) as the repo's train_seg.py:22-80."""
    data_root = args.data["root"]
    if args.dataset == "sapien":
        from ogc_tpu_torch.data.sapien import SapienDataset as TrainDataset

        data_root = osp.join(data_root, "mbs-shapepart")
    elif args.dataset == "kittisf":
        from ogc_tpu_torch.data.kittisf import \
            KITTISceneFlowDataset as TrainDataset
    elif args.dataset == "ogcdr":
        from ogc_tpu_torch.data.ogcdr import \
            OGCDynamicRoomDataset as TrainDataset
    else:
        raise KeyError("Unrecognized dataset!")

    model = segnet_for(args, args.dataset, generator)
    common = dict(predflow_path=predflow_path,
                  decentralize=args.data["decentralize"])
    if args.dataset in ("sapien", "ogcdr"):
        view_sels = [[0, 1], [1, 2], [2, 3]]
        train_set = TrainDataset(
            data_root=data_root, split="train", view_sels=view_sels,
            aug_transform_args=args.data["aug_transform_args"], **common)
        val_set = TrainDataset(data_root=data_root, split="val",
                               view_sels=view_sels, **common)
    else:  # KITTI-SF
        view_sels = [[0, 1]]
        train_set = TrainDataset(
            data_root=data_root, mapping_path=args.data["train_mapping"],
            downsampled=True, view_sels=view_sels,
            aug_transform_args=args.data["aug_transform_args"], **common)
        val_set = TrainDataset(
            data_root=data_root, mapping_path=args.data["val_mapping"],
            downsampled=True, view_sels=view_sels, **common)
    return model, train_set, val_set


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str, help="Config file")
    parser.add_argument("--round", type=int, default=0,
                        help="Which round of iterative optimization")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="Resume from <save_path>_R<round>/current")
    parser.add_argument("--remat", type=str, default=None,
                        choices=["off", "full", "dots"],
                        help="Rematerialize the model forward in the "
                             "backward (ops/remat.py; default $OGC_REMAT "
                             "or off)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model trains on")
    return parser.parse_args(argv)


def set_deterministic(device: torch.device) -> None:
    """Bitwise-reproducible CUDA training: deterministic algorithms, the
    cuBLAS workspace setting they need (set before the first cuBLAS call,
    else the first matmul raises), and full float32 matmuls/convolutions."""
    if device.type != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run(args, model: MaskFormer3D, train_set, val_set,
        frame_stride: int = 1) -> Dict[str, object]:
    """Train ``model`` on ``args.device`` (this rank's card under torchrun)
    over the datasets: the loaders, Adam with the config's schedule,
    SegTrainer writing ``<save_path>_R<round>``, ``--resume``.  Returns the
    best validation loss and the trainer (whose
    ``step_seconds``/``val_seconds`` hold the host-clock times)."""
    device = mesh.init_data_parallel(args.device)
    model.to(device)
    train_loader = DataLoader(train_set, batch_size=args.batch_size,
                              shuffle=True, seed=args.random_seed,
                              num_workers=4, drop_last=True)
    val_loader = DataLoader(val_set, batch_size=args.batch_size,
                            shuffle=False, num_workers=4)
    schedule = make_lr_schedule(args.lr, args.lr_decay, args.lr_clip,
                                args.decay_step, args.batch_size)
    optimizer = Adam(dict(model.named_parameters()), schedule,
                     args.weight_decay)
    exp_base = args.save_path + "_R%d" % args.round
    trainer = SegTrainer(
        model, OGCLossConfig.from_dict(args.loss), optimizer,
        aug_transform_epoch=args.aug_transform_epoch,
        ignore_npoint_thresh=args.ignore_npoint_thresh, exp_base=exp_base,
        device=device, writer=JsonlWriter(osp.join(exp_base, "log")),
        frame_stride=frame_stride, remat=args.remat)
    start_epoch = 1
    if args.resume:
        start_epoch = trainer.resume(osp.join(exp_base, "current")) + 1
        trainer._print(f"Resumed from epoch {start_epoch - 1}")
    best = trainer.train(args.epochs, train_set, train_loader, val_loader,
                         start_epoch=start_epoch)
    mesh.shutdown()
    return {"best_loss": best, "trainer": trainer}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Train; returns what ``run`` returns."""
    args = parse_args(argv)
    load_config_into_args(args)
    set_deterministic(torch.device(args.device))

    np.random.seed(args.random_seed)
    gen = torch.Generator().manual_seed(args.random_seed)
    model, train_set, val_set = build_model_and_datasets(
        args, round_predflow(args), gen)
    return run(args, model, train_set, val_set)


if __name__ == "__main__":
    main()
