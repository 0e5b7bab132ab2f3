"""Supervised mask loss: Hungarian-matched binary CE (or focal) + Dice
(counterpart of ogc_tpu/losses/seg_sup.py; reference
losses/seg_loss_sup.py).

The matching cost is built from the detached prediction and solved on the
host by utils/lap.py, which returns the JAX package's ``col_ind`` (ties
included); the ground-truth slots are then permuted to the matched order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ogc_tpu_torch.utils.lap import linear_sum_assignment

_EPS = 1e-7


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(pred, _EPS, 1.0 - _EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def _focal(pred, target, alpha, gamma):
    loss = _bce(pred, target)
    p_t = target * pred + (1 - target) * (1 - pred)
    loss = loss * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * target + (1 - alpha) * (1 - target)) * loss
    return loss


def _pairs(pred, target):
    """(B, N, K) pair -> (B, N, K, 1) predictions, (B, N, 1, K) targets."""
    return pred[:, :, :, None], target[:, :, None, :]


def ce_loss(pred: torch.Tensor, target: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, K) binary cross-entropy, valid-masked mean
    (seg_loss_sup.py:8-24)."""
    loss = _bce(pred, target)
    if valid is not None:
        loss = loss * valid[..., None]
    return loss.mean()


def ce_match_cost(pred: torch.Tensor, target: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise (B, K, K) CE cost grid (seg_loss_sup.py:26-38)."""
    loss = _bce(*_pairs(pred, target))
    if valid is not None:
        loss = loss * valid[:, :, None, None]
    return loss.mean(1)


def focal_loss(pred: torch.Tensor, target: torch.Tensor,
               valid: Optional[torch.Tensor] = None, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """(B, N, K) focal loss (seg_loss_sup.py:41-66)."""
    loss = _focal(pred, target, alpha, gamma)
    if valid is not None:
        loss = loss * valid[..., None]
    return loss.mean()


def focal_match_cost(pred: torch.Tensor, target: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    loss = _focal(*_pairs(pred, target), alpha, gamma)
    if valid is not None:
        loss = loss * valid[:, :, None, None]
    return loss.mean(1)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, K) Dice loss (seg_loss_sup.py:90-110)."""
    if valid is not None:
        v = valid[..., None]
        num = (2 * pred * target * v).sum(1)
        den = (pred * v).sum(1) + (target * v).sum(1)
    else:
        num = 2 * (pred * target).sum(1)
        den = pred.sum(1) + target.sum(1)
    return (1 - (num + 1) / (den + 1)).mean()


def dice_match_cost(pred: torch.Tensor, target: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    p, t = _pairs(pred, target)
    if valid is not None:
        v = valid[:, :, None, None]
        num = (2 * p * t * v).sum(1)
        den = (p * v).sum(1) + (t * v).sum(1)
    else:
        num = (2 * p * t).sum(1)
        den = p.sum(1) + t.sum(1)
    return 1 - (num + 1) / (den + 1)


@dataclasses.dataclass(frozen=True)
class SupLossConfig:
    weights: Tuple[float, float] = (2.0, 0.1)  # (ce, dice)
    use_focal: bool = False
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def match_cost(mask: torch.Tensor, gt_mask: torch.Tensor,
               valid: Optional[torch.Tensor], cfg: SupLossConfig
               ) -> torch.Tensor:
    """The (B, K, K) matching cost of the detached prediction."""
    w_ce, w_dice = cfg.weights
    pred = mask.detach()
    if cfg.use_focal:
        cost_ce = focal_match_cost(pred, gt_mask, valid, cfg.focal_alpha,
                                   cfg.focal_gamma)
    else:
        cost_ce = ce_match_cost(pred, gt_mask, valid)
    return w_ce * cost_ce + w_dice * dice_match_cost(pred, gt_mask, valid)


def supervised_mask_loss(mask: torch.Tensor, gt_mask: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         cfg: SupLossConfig = SupLossConfig()
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Hungarian-matched CE + Dice (SupervisedMaskLoss,
    seg_loss_sup.py:148-182).

    :param mask: (B, N, K) prediction; :param gt_mask: (B, N, K) one-hot
        ground truth; :param valid: (B, N) or None.
    """
    w_ce, w_dice = cfg.weights
    cost = match_cost(mask, gt_mask, valid, cfg)
    col_ind = torch.from_numpy(linear_sum_assignment(
        cost.cpu().numpy(), False)).to(mask.device).long()
    # Slot i of the prediction is matched to ground-truth slot col_ind[i].
    gt_mask = torch.gather(gt_mask, 2, col_ind[:, None, :].expand(
        gt_mask.shape)).detach()
    if cfg.use_focal:
        l_ce = focal_loss(mask, gt_mask, valid, cfg.focal_alpha,
                          cfg.focal_gamma)
    else:
        l_ce = ce_loss(mask, gt_mask, valid)
    l_dice = dice_loss(mask, gt_mask, valid)
    loss = w_ce * l_ce + w_dice * l_dice
    return loss, {"cross_entropy": l_ce, "dice": l_dice, "sum": loss}
