"""Fully supervised segmentation trainer, the baseline (counterpart of
ogc_tpu/train/seg_sup.py; reference train_seg_sup.py).

One step: MaskFormer3D on frame 0 of every item, the Hungarian-matched CE
+ Dice loss against the one-hot ground truth with its valid mask, its
backward, and the port's Adam (train/seg.py).  Epochs report PQ/F1,
evaluate on the validation set and keep the best checkpoint by validation
loss; ``save``/``resume`` carry the full train state.  Under data
parallelism each rank matches (the numpy LAP) and computes the loss on its
own rows, and the gradients and terms are averaged over ranks before Adam,
as in train/seg.py.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.losses.seg_sup import SupLossConfig, supervised_mask_loss
from ogc_tpu_torch.parallel.mesh import local_values
from ogc_tpu_torch.train.base import (EpochTrainer, add_ap, batch_counts,
                                      new_ap, step_collective)
from ogc_tpu_torch.train.seg import Adam
from ogc_tpu_torch.utils.meters import AverageMeter


class SupSegTrainer(EpochTrainer):
    """:param model: MaskFormer3D on ``device``.
    :param exp_base: directory of the ``current``/``best`` checkpoints."""

    def __init__(self, model: torch.nn.Module, loss_cfg: SupLossConfig,
                 optimizer: Adam, ignore_npoint_thresh: int, exp_base: str,
                 device: torch.device, writer=None,
                 remat: Optional[str] = None):
        super().__init__(model, optimizer, exp_base, device, writer, remat)
        self.loss_cfg = loss_cfg
        self.ignore_npoint_thresh = ignore_npoint_thresh

    def _inputs(self, batch):
        pcs, segms, _, valids = batch
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (pcs[:, 0], segms[:, 0], valids[:, 0])]

    def _loss(self, pc, gt_mask, valid):
        mask = self._remat(self.model)(pc, pc)
        loss, ld = supervised_mask_loss(mask, gt_mask, valid, self.loss_cfg)
        return loss, ld, mask

    def train_step(self, pc, gt_mask, valid
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Forward, backward and optimizer step on device tensors: the loss
        terms (device scalars) and the masks."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        loss, ld, mask = self._loss(pc, gt_mask, valid)
        loss.backward()
        vals = torch.stack([v.detach().to(self._scalar_dtype())
                            for v in ld.values()])
        step_collective(self.model.parameters(), vals)
        self.optimizer.step()
        return dict(zip(ld.keys(), vals)), mask.detach()

    def train_it(self, it: int, batch):
        """:return: (loss terms, ground-truth segmentation (b, N), masks
        (b, N, K)) on the host, b this rank's true rows."""
        t0 = time.perf_counter()
        true_b, _ = batch_counts(batch)
        pc, gt_mask, valid = self._inputs(batch)
        ld, mask = self.train_step(pc, gt_mask, valid)
        vals = torch.stack([v.double() for v in ld.values()]).tolist()
        mask = local_values(mask, true_b)
        self.step_seconds.append(time.perf_counter() - t0)
        return (dict(zip(ld.keys(), vals)), batch[1][:true_b, 0].argmax(2),
                mask)

    @torch.no_grad()
    def eval_epoch(self, loader):
        t0 = time.perf_counter()
        self.model.eval()
        meter = AverageMeter()
        total_loss, count = 0.0, 0
        ap = new_ap()
        for batch in loader:
            true_b, global_b = batch_counts(batch)
            loss, ld, mask = self._loss(*self._inputs(batch))
            loss, ld = self._mean_eval(loss, ld)
            total_loss += loss * global_b
            count += global_b
            meter.append_loss(ld)
            add_ap(ap, batch[1][:true_b, 0].argmax(2),
                   local_values(mask, true_b), self.ignore_npoint_thresh)
        self.val_seconds.append(time.perf_counter() - t0)
        return total_loss / max(count, 1), meter.get_mean_loss_dict(), ap

    def _train_batch(self, it: int, batch):
        ld, segm, mask = self.train_it(it, batch)
        return ld, (segm, mask)

    def _validate(self, loader):
        return self.eval_epoch(loader)
