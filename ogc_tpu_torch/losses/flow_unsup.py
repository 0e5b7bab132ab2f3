"""Unsupervised FlowStep3D losses: bidirectional nearest-neighbour Chamfer
and local flow smoothness, weighted per refinement iteration (counterpart
of ogc_tpu/losses/flow_unsup.py; reference losses/flow_loss_unsup.py).

Every neighbour search runs on detached inputs: the indices are piecewise
constant in the warp, as the reference's index-only CUDA KNN.  Gradients
flow through the warped cloud in the Chamfer distances and through the
groups of the flow.  Norms take the JAX package's forms (``_norm``), so a
zero-length Chamfer residual gives its NaN gradient, which the optimizer's
finite guard skips, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.losses.seg_unsup import _SymGradDiscrepancy
from ogc_tpu_torch.utils import trace


def _norm(x: torch.Tensor, ord: int) -> torch.Tensor:
    """``jnp.linalg.norm(x, ord, axis=-1)`` of a vector, in its forms:
    sqrt(sum(x^2)) for 2, sum(|x|) for 1, else sum(|x|^ord)^(1/ord)."""
    if ord == 2:
        return torch.sqrt((x * x).sum(-1))
    if ord == 1:
        return x.abs().sum(-1)
    return (x.abs() ** ord).sum(-1) ** (1.0 / ord)


def chamfer_loss(pc1: torch.Tensor, pc2: torch.Tensor, flow: torch.Tensor,
                 loss_norm: int = 2) -> torch.Tensor:
    """Bidirectional 1-NN Chamfer between pc1 warped by ``flow`` and pc2
    (flow_loss_unsup.py:7-35).  :param pc1, pc2, flow: (B, N, 3)."""
    warped = pc1 + flow
    warped_ng = warped.detach()
    _, idx1 = ops.knn(1, warped_ng, pc2)
    nn1 = ops.group(pc2, idx1)[:, :, 0, :]
    dist1 = _norm(warped - nn1, loss_norm)
    _, idx2 = ops.knn(1, pc2, warped_ng)
    nn2 = ops.group(warped, idx2)[:, :, 0, :]
    dist2 = _norm(pc2 - nn2, loss_norm)
    return (dist1 + dist2).mean()


def _discrepancy(flow: torch.Tensor, idx: torch.Tensor, loss_norm: int,
                 symmetric_grad: bool) -> torch.Tensor:
    if symmetric_grad:
        # Scatter-free backward under the symmetric-graph assumption
        # (losses/seg_unsup.py::_SymGradDiscrepancy over the 3 channels).
        return _SymGradDiscrepancy.apply(flow, idx, loss_norm)
    diff = flow[:, :, None, :] - ops.group(flow, idx)
    return _norm(diff, loss_norm).mean()


def knn_flow_smooth(pc: torch.Tensor, flow: torch.Tensor, k: int,
                    radius: float, loss_norm: int = 1,
                    symmetric_grad: bool = False) -> torch.Tensor:
    """KNN flow smoothness with the radius clamp (flow_loss_unsup.py:
    38-62): neighbours beyond ``radius`` are replaced by the nearest."""
    dist, idx = ops.knn(k, pc.detach(), pc.detach())
    idx = torch.where(dist > radius, idx[..., :1], idx)
    return _discrepancy(flow, idx, loss_norm, symmetric_grad)


def ball_q_flow_smooth(pc: torch.Tensor, flow: torch.Tensor, k: int,
                       radius: float, loss_norm: int = 1,
                       symmetric_grad: bool = False) -> torch.Tensor:
    """Ball-query flow smoothness (flow_loss_unsup.py:65-87)."""
    idx = ops.ball_query(radius, k, pc.detach(), pc.detach())
    return _discrepancy(flow, idx, loss_norm, symmetric_grad)


@dataclasses.dataclass(frozen=True)
class FlowLossConfig:
    """The YAML ``loss:`` block (config/flow/sapien/sapien_unsup.yaml)."""

    weights: Tuple[float, float] = (0.75, 0.25)  # chamfer, smooth
    iters_w: Tuple[float, ...] = (1.0,)
    chamfer_loss_norm: int = 2
    smooth_w_knn: float = 3.0
    smooth_w_ball_q: float = 1.0
    knn_k: int = 4
    knn_radius: float = 0.05
    knn_loss_norm: int = 1
    ball_q_k: int = 8
    ball_q_radius: float = 0.1
    ball_q_loss_norm: int = 1
    # Scatter-free smooth backward (symmetric-graph assumption); opt-in.
    symmetric_smooth_grad: bool = False

    @classmethod
    def from_dict(cls, loss_cfg: dict) -> "FlowLossConfig":
        c = loss_cfg.get("chamfer_loss_params", {})
        s = loss_cfg.get("smooth_loss_params", {})
        kp = s.get("knn_loss_params", {})
        bp = s.get("ball_q_loss_params", {})
        return cls(
            weights=tuple(loss_cfg.get("weights", (0.75, 0.25))),
            iters_w=tuple(loss_cfg.get("iters_w", (1.0,))),
            chamfer_loss_norm=c.get("loss_norm", 2),
            smooth_w_knn=s.get("w_knn", 3.0),
            smooth_w_ball_q=s.get("w_ball_q", 1.0),
            knn_k=kp.get("k", 4),
            knn_radius=kp.get("radius", 0.05),
            knn_loss_norm=kp.get("loss_norm", 1),
            ball_q_k=bp.get("k", 8),
            ball_q_radius=bp.get("radius", 0.1),
            ball_q_loss_norm=bp.get("loss_norm", 1),
            symmetric_smooth_grad=s.get("symmetric_grad", False),
        )


def flow_smooth_loss(pc: torch.Tensor, flow: torch.Tensor,
                     cfg: FlowLossConfig) -> torch.Tensor:
    return cfg.smooth_w_knn * knn_flow_smooth(
        pc, flow, cfg.knn_k, cfg.knn_radius, cfg.knn_loss_norm,
        cfg.symmetric_smooth_grad,
    ) + cfg.smooth_w_ball_q * ball_q_flow_smooth(
        pc, flow, cfg.ball_q_k, cfg.ball_q_radius, cfg.ball_q_loss_norm,
        cfg.symmetric_smooth_grad,
    )


def flowstep3d_loss(pc1: torch.Tensor, pc2: torch.Tensor,
                    flow_preds: List[torch.Tensor], cfg: FlowLossConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-iteration weighted sum (UnsupervisedFlowStep3DLoss,
    flow_loss_unsup.py:112-140): (loss, {chamfer_loss_#i, smooth_loss_#i,
    sum})."""
    if len(flow_preds) != len(cfg.iters_w):
        raise ValueError(f"{len(flow_preds)} flow iterations vs "
                         f"{len(cfg.iters_w)} weights")
    with trace.span("loss.flow"):
        loss_dict: Dict[str, torch.Tensor] = {}
        total = pc1.new_zeros(())
        for i, flow_pred in enumerate(flow_preds):
            l_ch = chamfer_loss(pc1, pc2, flow_pred, cfg.chamfer_loss_norm)
            l_sm = flow_smooth_loss(pc1, flow_pred, cfg)
            loss_dict[f"chamfer_loss_#{i}"] = l_ch
            loss_dict[f"smooth_loss_#{i}"] = l_sm
            total = total + cfg.iters_w[i] * (cfg.weights[0] * l_ch
                                              + cfg.weights[1] * l_sm)
        loss_dict["sum"] = total
        return total, loss_dict
