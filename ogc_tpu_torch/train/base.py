"""What the port's three trainers share (train/seg.py, train/seg_sup.py,
train/flow.py): full-state checkpoints, the scalar writer, the host seconds
of every step and validation pass, and the epoch loop (a save before the
first epoch, the train batches, a validation pass, ``best`` by validation
loss; PQ/F1 of frame 0 where the trainer segments), and what data
parallelism adds to a step (``step_collective``: the gradients and the
step's scalars averaged over ranks in one collective).

Under data parallelism (parallel/mesh.py) every rank runs this loop on its
row blocks: the validation loss is each batch's mean over the padded
global batch weighted by its true global size (ogc_tpu/train/seg.py:
336-341), the same on every rank, so every rank reaches the same ``best``;
PQ/F1 come from every rank's true rows; rank 0 prints, logs and writes the
checkpoints.

``remat`` (the CLIs' ``--remat``, ops/remat.py) checkpoints the model
forward of a train step: ``full`` or ``dots``, gradients and running
statistics bit-equal to none.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.metrics.seg import accumulate_eval_results, calculate_PQ_F1
from ogc_tpu_torch.ops import remat as remat_mod
from ogc_tpu_torch.parallel import mesh
from ogc_tpu_torch.utils import trace
from ogc_tpu_torch.utils.checkpoint import resume_trainer, save_trainer
from ogc_tpu_torch.utils.meters import AverageMeter


def new_ap() -> Dict[str, list]:
    return {"Pred_IoU": [], "Pred_Matched": [], "N_GT_Inst": []}


def add_ap(ap: Dict[str, list], segm: np.ndarray, mask: np.ndarray,
           ignore_npoint_thresh: int) -> None:
    """Accumulate one batch's matched IoUs (segm (B, N), mask (B, N, K))."""
    iou, matched, _, n_gt = accumulate_eval_results(segm, mask,
                                                    ignore_npoint_thresh)
    ap["Pred_IoU"].append(iou)
    ap["Pred_Matched"].append(matched)
    ap["N_GT_Inst"].append(n_gt)


def pq_scalars(ap: Dict[str, list]) -> Dict[str, float]:
    """PQ@50, F1@50, Pre@50 and Rec@50 of the batches every rank
    accumulated."""
    ap = {k: [x for r in mesh.all_gather_objects(v) for x in r]
          for k, v in ap.items()}
    cat = (lambda k: np.concatenate(ap[k]) if ap[k] else np.zeros(0))
    pq, f1, pre, rec = calculate_PQ_F1(cat("Pred_IoU"), cat("Pred_Matched"),
                                       int(np.sum(ap["N_GT_Inst"])))
    return {"PQ@50": pq, "F1@50": f1, "Pre@50": pre, "Rec@50": rec}


def batch_counts(batch) -> Tuple[int, int]:
    """(this rank's true rows, the global batch's true rows) of a batch: a
    loader's ``Batch`` carries both; a plain tuple is one process's whole
    batch, refused under data parallelism."""
    if hasattr(batch, "true_b"):
        return batch.true_b, batch.global_b
    if mesh.world()[1] > 1:
        raise ValueError("under data parallelism a batch is the loader's "
                         "Batch, which carries its true and global rows")
    b = len(batch[0])
    return b, b


def step_collective(params, scalars: torch.Tensor, extra=()) -> None:
    """After the backward: the gradients, the step's scalars and ``extra``
    (BatchNorm running statistics under local sync) averaged over ranks in
    one collective a dtype, in place (``jax.lax.pmean`` of the gradients and
    scalars, ogc_tpu/train/seg.py:261).  A no-op without a process
    group."""
    grads = [p.grad for p in params if p.grad is not None]
    mesh.all_reduce_mean(grads + [scalars, *extra])


class EpochTrainer:
    """:param exp_base: directory of the ``current``/``best`` checkpoints.

    A subclass supplies ``_train_batch(it, batch)`` -> (loss terms, frame
    0's (segmentation, masks) or None) and ``_validate(loader)`` -> (loss,
    mean terms, accumulated IoUs or None), and may restart the best loss at
    an epoch with ``_begin_epoch``."""

    #: the PQ/F1 accumulation's ``ignore_npoint_thresh``
    ignore_npoint_thresh = 0

    def __init__(self, model: torch.nn.Module, optimizer, exp_base: str,
                 device: torch.device, writer=None,
                 remat: Optional[str] = None):
        self.model = model
        #: the model forward's rematerialisation under grad (ops/remat.py:
        #: None, "full" or "dots"; None reads OGC_REMAT)
        self.remat = remat_mod.resolve(remat)
        self.optimizer = optimizer
        self.exp_base = exp_base
        self.device = device
        self.writer = writer
        os.makedirs(exp_base, exist_ok=True)
        self.checkpoint_name = osp.join(exp_base, "current")
        self.best_name = osp.join(exp_base, "best")
        #: host seconds of each train_it (ends synchronised) and eval_epoch
        self.step_seconds: List[float] = []
        self.val_seconds: List[float] = []

    def _remat(self, fn):
        """``fn`` under the trainer's remat mode where grad is on."""
        return remat_mod.checkpoint(
            fn, self.remat if torch.is_grad_enabled() else None)

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Host arrays copied to the trainer's device."""
        with trace.span("train.h2d"):
            out = []
            for a in arrays:
                a = torch.from_numpy(np.ascontiguousarray(a))
                # a copy from pageable memory waits for the stream
                with trace.span("sync.to_device"):
                    out.append(a.to(self.device))
            return out

    def _scalar_dtype(self) -> torch.dtype:
        """The step scalars' dtype: the parameters' (float32, or float64
        for a float64 model)."""
        return next(self.model.parameters()).dtype

    def _mean_eval(self, loss: torch.Tensor, ld: Dict[str, torch.Tensor]
                   ) -> Tuple[float, Dict[str, float]]:
        """A validation batch's loss and terms averaged over ranks."""
        vals = torch.stack([v.detach().to(self._scalar_dtype())
                            for v in (loss, *ld.values())])
        mesh.all_reduce_mean([vals])
        vals = vals.tolist()
        return vals[0], dict(zip(ld.keys(), vals[1:]))

    def save(self, is_best: bool, epoch: int = 0) -> None:
        save_trainer(self.model, self.optimizer, epoch, is_best,
                     self.checkpoint_name, self.best_name)

    def resume(self, path: str) -> int:
        """Restore weights, BatchNorm statistics, the optimizer's moments
        and count, and the epoch; returns the epoch."""
        return resume_trainer(self.model, self.optimizer, path)

    def sync_replicas(self) -> None:
        """Rank 0's weights, buffers and Adam moments on every rank, one
        broadcast a dtype: each rank built or loaded its own, and only the
        gradients are averaged after (the JAX mesh replicates the state by
        construction).  A no-op without a process group."""
        opt = self.optimizer
        mesh.broadcast_from_main([*self.model.parameters(),
                                  *self.model.buffers(), *opt.mu.values(),
                                  *opt.nu.values()])

    def _print(self, msg: str) -> None:
        if mesh.is_main():
            print(msg, flush=True)

    def _log(self, prefix: str, scalars: Dict[str, float], step: int):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(prefix + k, v, global_step=step)

    def _begin_epoch(self, epoch: int) -> bool:
        """Called before each epoch; True restarts the best loss."""
        return False

    def _train_batch(self, it: int, batch
                     ) -> Tuple[Dict[str, float], Optional[tuple]]:
        raise NotImplementedError

    def _validate(self, loader
                  ) -> Tuple[float, Dict[str, float], Optional[dict]]:
        raise NotImplementedError

    def train(self, n_epochs: int, train_loader, val_loader=None,
              start_epoch: int = 1) -> float:
        # The iteration counter (the schedules' input) continues from the
        # restored epoch.
        it = (start_epoch - 1) * len(train_loader)
        best_loss = 1e10
        self.sync_replicas()
        if start_epoch == 1:
            self.save(True, 0)
        for epoch in range(start_epoch, n_epochs + 1):
            if self._begin_epoch(epoch):
                best_loss = 1e10
            meter, ap = AverageMeter(), new_ap()
            for batch in train_loader:
                ld, seg = self._train_batch(it, batch)
                it += 1
                meter.append_loss(ld)
                self._log("train/", ld, it)
                if seg is not None:
                    add_ap(ap, *seg, self.ignore_npoint_thresh)
            train_avg = meter.get_mean_loss_dict()
            msg = ", ".join(f"{k}={v:.4f}" for k, v in train_avg.items())
            pq = pq_scalars(ap) if ap["N_GT_Inst"] else {}
            if pq:
                msg += (f" | PQ@50={pq['PQ@50']:.4f} "
                        f"F1@50={pq['F1@50']:.4f}")
            self._print(f"[epoch {epoch:3d}] train: {msg}")
            self._log("epoch_sum_train/", {**train_avg, **pq}, epoch)
            if val_loader is None:
                continue
            val_loss, val_avg, val_ap = self._validate(val_loader)
            pq = pq_scalars(val_ap) if val_ap is not None else {}
            msg = (" ".join(f"{k}={v:.4f}" for k, v in pq.items()) if pq
                   else ", ".join(f"{k}={v:.4f}" for k, v in val_avg.items()))
            self._print(f"[epoch {epoch:3d}]   val: loss={val_loss:.4f} "
                        f"{msg}")
            self._log("epoch_sum_val/", {**val_avg, **pq}, epoch)
            is_best = val_loss < best_loss
            best_loss = min(best_loss, val_loss)
            self.save(is_best, epoch)
        if self.writer is not None:
            self.writer.flush()
        return best_loss
