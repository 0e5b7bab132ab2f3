"""Unsupervised segmentation trainer (counterpart of ogc_tpu/train/seg.py;
reference train_seg.py:19-227).

One step: the MaskFormer3D forward over all B*T clouds of the batch as one
batch, the OGC loss, its backward (every grouping backward is the
deterministic scatter-add kernel), and an Adam step with optax's constants,
the staircase learning rate and a finite-gradient guard.  Epochs report
PQ/F1 of frame 0, evaluate on the validation set, and keep the best
checkpoint by validation loss.  Under data parallelism each rank computes
the loss on its rows, the gradients and loss terms are averaged over ranks
before Adam (whose finite-gradient guard then decides alike on every
rank), and the start-steps gate counts global samples.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, ogc_loss
from ogc_tpu_torch.parallel.mesh import local_values
from ogc_tpu_torch.train.base import (EpochTrainer, add_ap, batch_counts,
                                      new_ap, step_collective)
from ogc_tpu_torch.utils import trace
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
        with trace.span("train.optimizer"):
            return self._step()

    def _step(self) -> bool:
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()])
        with trace.span("sync.finite_guard"):
            finite = bool(finite.all())
        if not finite:
            self.notfinite_count += 1
            return False
        lr = self.schedule(self.count)
        count = self.count + 1
        # optax's bias corrections, in the parameters' precision.
        f = (np.float64 if next(iter(self.params.values())).dtype
             == torch.float64 else np.float32)
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))
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


class SegTrainer(EpochTrainer):
    """:param model: MaskFormer3D on ``device``.
    :param exp_base: directory of ``current``/``best`` checkpoints and the
        ``log/scalars.jsonl`` writer's output.
    :param frame_stride: take every ``frame_stride``-th frame of an item
        (Waymo items duplicate their one frame: the reference takes
        pcs[:, ::2], train_seg_waymo.py:58)."""

    def __init__(self, model: torch.nn.Module, loss_cfg: OGCLossConfig,
                 optimizer: Adam, aug_transform_epoch: int,
                 ignore_npoint_thresh: int, exp_base: str,
                 device: torch.device, writer=None, frame_stride: int = 1,
                 remat: Optional[str] = None):
        super().__init__(model, optimizer, exp_base, device, writer, remat)
        self.frame_stride = frame_stride
        self.loss_cfg = loss_cfg
        self.aug_transform_epoch = aug_transform_epoch
        self.ignore_npoint_thresh = ignore_npoint_thresh
        self._train_set, self._aug = None, False

    # -- steps --------------------------------------------------------------

    def _forward_masks(self, pcs: torch.Tensor) -> torch.Tensor:
        """(B, T, N, 3) -> (B, T, N, K): every cloud in one forward."""
        B, T, N, _ = pcs.shape
        flat = pcs.reshape(B * T, N, 3)
        return self._remat(self.model)(flat, flat).reshape(B, T, N, -1)

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
        vals = torch.stack([v.detach().to(self._scalar_dtype())
                            for v in ld.values()])
        step_collective(self.model.parameters(), vals)
        self.optimizer.step()
        with trace.span("sync.loss_terms"):
            terms = vals.tolist()
        return dict(zip(ld.keys(), terms)), masks.detach()

    def _frames(self, batch):
        """(pcs, segms, flows) of a batch at the trainer's frame stride."""
        s = self.frame_stride
        return tuple(a[:, ::s] for a in batch[:3])

    def train_it(self, it: int, batch, aug_transform: bool = False):
        with trace.span("train.step", step=True):
            t0 = time.perf_counter()
            pcs, segms, flows = self._frames(batch)
            true_b, global_b = batch_counts(batch)
            pcs_d, flows_d = self._to_device(pcs, flows)
            # start_steps gate on the number of global samples seen
            # (reference train_seg.py:101, ogc_tpu/train/seg.py:313-318).
            ld, masks = self.train_step(pcs_d, flows_d, it * global_b,
                                        aug_transform)
            with trace.span("sync.masks_out"):
                mask = local_values(masks[:, 0], true_b)
            self.step_seconds.append(time.perf_counter() - t0)
            return ld, segms[:true_b, 0], mask

    @torch.no_grad()
    def eval_epoch(self, loader):
        t0 = time.perf_counter()
        self.model.eval()
        meter = AverageMeter()
        total_loss, count = 0.0, 0
        ap = new_ap()
        for batch in loader:
            pcs, segms, flows = self._frames(batch)
            true_b, global_b = batch_counts(batch)
            pcs_d, flows_d = self._to_device(pcs, flows)
            loss, ld, masks = self._loss(pcs_d, flows_d, 0, False, False)
            loss, ld = self._mean_eval(loss, ld)
            total_loss += loss * global_b
            count += global_b
            meter.append_loss(ld)
            add_ap(ap, segms[:true_b, 0], local_values(masks[:, 0], true_b),
                   self.ignore_npoint_thresh)
        self.val_seconds.append(time.perf_counter() - t0)
        return total_loss / max(count, 1), meter.get_mean_loss_dict(), ap

    # -- the epoch loop's hooks ---------------------------------------------

    def _set_aug(self) -> None:
        """Phase in the augmented views and their invariance loss
        (reference train_seg.py:150-154)."""
        self._aug = True
        self._train_set.aug_transform = True

    def _begin_epoch(self, epoch: int) -> bool:
        if epoch == self.aug_transform_epoch + 1:
            self._set_aug()
            return True
        return False

    def _train_batch(self, it: int, batch):
        ld, segm, mask = self.train_it(it, batch, self._aug)
        return ld, (segm, mask)

    def _validate(self, loader):
        return self.eval_epoch(loader)

    def train(self, n_epochs: int, train_set, train_loader, test_loader=None,
              start_epoch: int = 1) -> float:
        self._train_set, self._aug = train_set, False
        if start_epoch > self.aug_transform_epoch + 1:
            self._set_aug()
        return super().train(n_epochs, train_loader, test_loader,
                             start_epoch)
