"""Unsupervised segmentation trainer (counterpart of ogc_tpu/train/seg.py;
reference train_seg.py:19-227).

One step: the MaskFormer3D forward over all B*T clouds of the batch as one
batch, the OGC loss, its backward (every grouping backward is the
deterministic scatter-add kernel), and an Adam step with optax's constants,
the staircase learning rate and a finite-gradient guard.  Epochs report
PQ/F1 of frame 0, evaluate on the validation set, and keep the best
checkpoint by validation loss.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, ogc_loss
from ogc_tpu_torch.metrics.seg import accumulate_eval_results, calculate_PQ_F1
from ogc_tpu_torch.utils.checkpoint import load_train_state, save_train_state
from ogc_tpu_torch.utils.meters import AverageMeter


def make_lr_schedule(lr: float, lr_decay: float, lr_clip: float,
                     decay_step: int, batch_size: int
                     ) -> Callable[[int], float]:
    """Exponential staircase decay with a floor (reference lr_curve,
    train_seg.py:230-234), in float32 as ogc_tpu/train/seg.py:31-40."""
    f32 = np.float32

    def schedule(step: int) -> float:
        exp = np.floor(f32(step * batch_size) / f32(decay_step))
        factor = np.maximum(f32(lr_decay) ** exp, f32(lr_clip / lr))
        return float(f32(lr) * factor)

    return schedule


class Adam:
    """optax ``chain(add_decayed_weights, scale_by_adam,
    scale_by_learning_rate(schedule))`` under ``apply_if_finite``, as
    ogc_tpu/train/seg.py::make_optimizer builds it.

    Moments: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias-corrected
    by 1 - b^count; update -lr(step) * mu_hat / (sqrt(nu_hat) + eps), with
    the L2 weight decay added to the gradient first.  When any gradient is
    not finite, nothing advances: neither the parameters, the moments nor
    the step that the learning rate reads.
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Callable[[int], float], weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.notfinite_count = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one update from the parameters' ``.grad``; returns False
        (and changes nothing) when a gradient is not finite."""
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()])
        if not bool(finite.all()):
            self.notfinite_count += 1
            return False
        lr = self.schedule(self.count)
        count = self.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        for k, p in self.params.items():
            g = grads[k]
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu, nu = self.mu[k], self.nu[k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(upd * -lr)
        self.count = count
        return True

    def state_dict(self) -> dict:
        return {"mu": {k: v.cpu() for k, v in self.mu.items()},
                "nu": {k: v.cpu() for k, v in self.nu.items()},
                "count": self.count, "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: dict) -> None:
        for k in self.params:
            self.mu[k].copy_(state["mu"][k])
            self.nu[k].copy_(state["nu"][k])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])


class SegTrainer:
    """:param model: MaskFormer3D on ``device``.
    :param exp_base: directory of ``current``/``best`` checkpoints and the
        ``log/scalars.jsonl`` writer's output."""

    def __init__(self, model: torch.nn.Module, loss_cfg: OGCLossConfig,
                 optimizer: Adam, aug_transform_epoch: int,
                 ignore_npoint_thresh: int, exp_base: str,
                 device: torch.device, writer=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.aug_transform_epoch = aug_transform_epoch
        self.ignore_npoint_thresh = ignore_npoint_thresh
        self.exp_base = exp_base
        self.device = device
        self.writer = writer
        os.makedirs(exp_base, exist_ok=True)
        self.checkpoint_name = osp.join(exp_base, "current")
        self.best_name = osp.join(exp_base, "best")
        #: host seconds of each train_it (ends synchronised) and eval_epoch
        self.step_seconds = []
        self.val_seconds = []

    # -- checkpoints: full train state ------------------------------------

    def save(self, is_best: bool, epoch: int = 0) -> None:
        state = {"model_state": {k: v.detach().cpu() for k, v in
                                 self.model.state_dict().items()},
                 "optimizer_state": self.optimizer.state_dict(),
                 "epoch": epoch}
        save_train_state(state, is_best, self.checkpoint_name, self.best_name)

    def resume(self, path: str) -> int:
        """Restore weights, optimizer state and epoch; returns the epoch."""
        state = load_train_state(path)
        self.model.load_state_dict(state["model_state"])
        self.optimizer.load_state_dict(state["optimizer_state"])
        return int(state["epoch"])

    # -- steps --------------------------------------------------------------

    def _forward_masks(self, pcs: torch.Tensor) -> torch.Tensor:
        """(B, T, N, 3) -> (B, T, N, K): every cloud in one forward."""
        B, T, N, _ = pcs.shape
        flat = pcs.reshape(B * T, N, 3)
        return self.model(flat, flat).reshape(B, T, N, -1)

    def _loss(self, pcs, flows, it_samples: int, step_w: bool, aug: bool
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        masks = self._forward_masks(pcs)
        T = pcs.shape[1]
        loss, ld = ogc_loss([pcs[:, t] for t in range(T)],
                            [masks[:, t] for t in range(T)],
                            [flows[:, t] for t in range(T)], self.loss_cfg,
                            step_w=step_w, it=it_samples, aug_transform=aug)
        return loss, ld, masks

    def train_step(self, pcs: torch.Tensor, flows: torch.Tensor,
                   it_samples: int, aug: bool
                   ) -> Tuple[Dict[str, float], torch.Tensor]:
        """Forward, backward and optimizer step on device tensors; returns
        the loss terms (host floats, which waits for the step) and masks."""
        self.model.train()
        for p in self.model.parameters():
            p.grad = None
        loss, ld, masks = self._loss(pcs, flows, it_samples, True, aug)
        loss.backward()
        self.optimizer.step()
        vals = torch.stack([v.detach().float() for v in ld.values()]).tolist()
        return dict(zip(ld.keys(), vals)), masks.detach()

    def _to_device(self, *arrays: np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def train_it(self, it: int, batch, aug_transform: bool = False):
        t0 = time.perf_counter()
        pcs, segms, flows, _ = batch
        pcs_d, flows_d = self._to_device(pcs, flows)
        # start_steps gate on the number of samples seen (reference
        # train_seg.py:101).
        ld, masks = self.train_step(pcs_d, flows_d, it * pcs.shape[0],
                                    aug_transform)
        mask = masks[:, 0].cpu().numpy()
        self.step_seconds.append(time.perf_counter() - t0)
        return ld, segms[:, 0], mask

    @torch.no_grad()
    def eval_epoch(self, loader):
        t0 = time.perf_counter()
        self.model.eval()
        meter = AverageMeter()
        total_loss, count = 0.0, 0
        ap = {"Pred_IoU": [], "Pred_Matched": [], "Confidence": [],
              "N_GT_Inst": []}
        for pcs, segms, flows, _ in loader:
            pcs_d, flows_d = self._to_device(pcs, flows)
            loss, ld, masks = self._loss(pcs_d, flows_d, 0, False, False)
            b = pcs.shape[0]
            total_loss += float(loss) * b
            count += b
            meter.append_loss({k: float(v) for k, v in ld.items()})
            iou, matched, _, n_gt = accumulate_eval_results(
                segms[:, 0], masks[:, 0].cpu().numpy(),
                self.ignore_npoint_thresh)
            ap["Pred_IoU"].append(iou)
            ap["Pred_Matched"].append(matched)
            ap["N_GT_Inst"].append(n_gt)
        self.val_seconds.append(time.perf_counter() - t0)
        return total_loss / max(count, 1), meter.get_mean_loss_dict(), ap

    def _log(self, prefix: str, scalars: Dict[str, float], step: int):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(prefix + k, v, global_step=step)

    def train(self, n_epochs: int, train_set, train_loader, test_loader=None,
              start_epoch: int = 1) -> float:
        it = (start_epoch - 1) * len(train_loader)
        best_loss = 1e10
        aug_transform = False
        if start_epoch > self.aug_transform_epoch + 1:
            aug_transform = True
            train_set.aug_transform = True
        if start_epoch == 1:
            self.save(True, 0)

        for epoch in range(start_epoch, n_epochs + 1):
            meter = AverageMeter()
            # Phase in the augmented views and their invariance loss
            # (reference train_seg.py:150-154).
            if epoch == self.aug_transform_epoch + 1:
                aug_transform = True
                train_set.aug_transform = True
                best_loss = 1e10
            ap = {"Pred_IoU": [], "Pred_Matched": [], "N_GT_Inst": []}
            for batch in train_loader:
                ld, segm, mask = self.train_it(it, batch, aug_transform)
                it += 1
                meter.append_loss(ld)
                self._log("train/", ld, it)
                iou, matched, _, n_gt = accumulate_eval_results(
                    segm, mask, self.ignore_npoint_thresh)
                ap["Pred_IoU"].append(iou)
                ap["Pred_Matched"].append(matched)
                ap["N_GT_Inst"].append(n_gt)
            train_avg = meter.get_mean_loss_dict()
            pq, f1, pre, rec = _pq_f1(ap)
            msg = ", ".join(f"{k}={v:.4f}" for k, v in train_avg.items())
            print(f"[epoch {epoch:3d}] train: {msg} | PQ@50={pq:.4f} "
                  f"F1@50={f1:.4f}", flush=True)
            self._log("epoch_sum_train/", {**train_avg, "PQ@50": pq,
                                           "F1@50": f1, "Pre@50": pre,
                                           "Rec@50": rec}, epoch)
            if test_loader is not None:
                val_loss, val_avg, val_ap = self.eval_epoch(test_loader)
                pq, f1, pre, rec = _pq_f1(val_ap)
                print(f"[epoch {epoch:3d}]   val: loss={val_loss:.4f} "
                      f"PQ@50={pq:.4f} F1@50={f1:.4f} Pre@50={pre:.4f} "
                      f"Rec@50={rec:.4f}", flush=True)
                self._log("epoch_sum_val/", {**val_avg, "PQ@50": pq,
                                             "F1@50": f1, "Pre@50": pre,
                                             "Rec@50": rec}, epoch)
                is_best = val_loss < best_loss
                best_loss = min(best_loss, val_loss)
                self.save(is_best, epoch)
        if self.writer is not None:
            self.writer.flush()
        return best_loss


def _pq_f1(ap: Dict[str, list]):
    cat = (lambda k: np.concatenate(ap[k]) if ap[k] else np.zeros(0))
    return calculate_PQ_F1(cat("Pred_IoU"), cat("Pred_Matched"),
                           int(np.sum(ap["N_GT_Inst"])))
