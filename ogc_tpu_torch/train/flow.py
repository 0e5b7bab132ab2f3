"""Self-supervised scene-flow trainer (counterpart of ogc_tpu/train/flow.py;
reference train_flow.py:33-189).

One step: FlowStep3D in train mode over the full recurrent unroll (the
BatchNorms take the scheduled momentum), the unsupervised flow loss, its
backward, and the port's Adam (train/seg.py: optax's constants, the
staircase learning rate, the finite-gradient guard).  Every step reports
the per-iteration EPE3D against the true flow (reference epe_metric,
train_flow.py:18-30); epochs evaluate on the validation set in eval mode
and keep the best checkpoint by validation loss.

Under data parallelism each rank steps on its rows, and its gradients, loss
terms and EPEs are averaged over ranks before Adam.  ``bn_sync`` says what
the BatchNorms do (ogc_tpu/train/flow.py:64-76): ``local`` normalises with
each rank's batch statistics and averages the running statistics over
ranks in the same collective; ``global`` normalises with the global batch's
statistics (``SchedulableBatchNorm``'s two-pass mean over ranks).  On one
rank the two are the same computation.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig, flowstep3d_loss
from ogc_tpu_torch.nn.flowstep3d import (SchedulableBatchNorm,
                                         set_bn_momentum)
from ogc_tpu_torch.train.base import (EpochTrainer, batch_counts,
                                      step_collective)
from ogc_tpu_torch.train.seg import Adam
from ogc_tpu_torch.utils.meters import AverageMeter


def make_bn_schedule(bn_momentum: float, bn_decay: float, decay_step: int,
                     batch_size: int) -> Callable[[int], float]:
    """Reference bn_curve (train_flow.py:199-207): the torch momentum
    decayed by ``bn_decay`` every ``decay_step`` samples, floored at 1e-2
    (ogc_tpu/train/flow.py:26)."""

    def schedule(it: int) -> float:
        if decay_step == -1:
            return bn_momentum
        exp = np.floor(it * batch_size / decay_step)
        return max(bn_momentum * (bn_decay ** exp), 1e-2)

    return schedule


def epe3d(flow_preds: List[torch.Tensor], gt_flow: torch.Tensor
          ) -> Dict[str, torch.Tensor]:
    """Mean end-point error of every iteration's flow."""
    return {f"epe3d_#{i}": torch.linalg.vector_norm(fp - gt_flow,
                                                    dim=-1).mean()
            for i, fp in enumerate(flow_preds)}


class FlowTrainer(EpochTrainer):
    """:param model: FlowStep3D on ``device``.
    :param bn_schedule: iteration -> BatchNorm momentum (default 0.9, as
        the JAX package's).
    :param exp_base: directory of the ``current``/``best`` checkpoints.
    :param bn_sync: ``local`` or ``global`` BatchNorm statistics under
        data parallelism."""

    def __init__(self, model: torch.nn.Module, model_iters: int,
                 loss_cfg: FlowLossConfig, optimizer: Adam, exp_base: str,
                 device: torch.device,
                 bn_schedule: Optional[Callable[[int], float]] = None,
                 writer=None, bn_sync: str = "local"):
        super().__init__(model, optimizer, exp_base, device, writer)
        if bn_sync not in ("local", "global"):
            raise ValueError(f"bn_sync must be local or global: {bn_sync!r}")
        self.model_iters = model_iters
        self.loss_cfg = loss_cfg
        self.bn_schedule = bn_schedule or (lambda it: 0.9)
        self.bns = [m for m in model.modules()
                    if isinstance(m, SchedulableBatchNorm)]
        for m in self.bns:
            m.sync = bn_sync

    def _inputs(self, batch) -> Tuple[torch.Tensor, ...]:
        pcs, _, flows, _ = batch
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (pcs[:, 0], pcs[:, 1], flows[:, 0]))

    def train_step(self, it: int, pc1: torch.Tensor, pc2: torch.Tensor,
                   gt_flow: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Forward, backward and optimizer step on device tensors, with the
        BatchNorm momentum of iteration ``it``; returns the loss terms and
        the per-iteration EPE3D (device scalars, averaged over ranks)."""
        self.model.train()
        set_bn_momentum(self.model, self.bn_schedule(it))
        for p in self.model.parameters():
            p.grad = None
        flow_preds = self.model(pc1, pc2, pc1, pc2, self.model_iters)
        loss, ld = flowstep3d_loss(pc1, pc2, flow_preds, self.loss_cfg)
        loss.backward()
        with torch.no_grad():
            ld.update(epe3d(flow_preds, gt_flow))
        vals = torch.stack([v.detach().to(self._scalar_dtype())
                            for v in ld.values()])
        # Under local sync the running statistics are linear in each rank's
        # batch moments: their average is the update from the averaged
        # moments (ogc_tpu/train/flow.py:114-119).
        stats = [t for m in self.bns if m.sync == "local"
                 for t in (m.running_mean, m.running_var)]
        step_collective(self.model.parameters(), vals, stats)
        self.optimizer.step()
        return dict(zip(ld.keys(), vals))

    def train_it(self, it: int, batch) -> Dict[str, float]:
        t0 = time.perf_counter()
        ld = self.train_step(it, *self._inputs(batch))
        vals = torch.stack([v.double() for v in ld.values()]).tolist()
        self.step_seconds.append(time.perf_counter() - t0)
        return dict(zip(ld.keys(), vals))

    @torch.no_grad()
    def eval_epoch(self, loader) -> Tuple[float, Dict[str, float]]:
        t0 = time.perf_counter()
        self.model.eval()
        meter = AverageMeter()
        total_loss, count = 0.0, 0
        for batch in loader:
            _, global_b = batch_counts(batch)
            pc1, pc2, gt_flow = self._inputs(batch)
            flow_preds = self.model(pc1, pc2, pc1, pc2, self.model_iters)
            loss, ld = flowstep3d_loss(pc1, pc2, flow_preds, self.loss_cfg)
            ld.update(epe3d(flow_preds, gt_flow))
            loss, ld = self._mean_eval(loss, ld)
            total_loss += loss * global_b
            count += global_b
            meter.append_loss(ld)
        self.val_seconds.append(time.perf_counter() - t0)
        return total_loss / max(count, 1), meter.get_mean_loss_dict()

    def _train_batch(self, it: int, batch):
        return self.train_it(it, batch), None

    def _validate(self, loader):
        return (*self.eval_epoch(loader), None)
