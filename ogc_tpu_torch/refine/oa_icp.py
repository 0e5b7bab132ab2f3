"""Object-Aware ICP flow refinement (counterpart of ogc_tpu/refine/oa_icp.py;
reference oa_icp.py:16-84).

Weighted Kabsch projection of a flow per object, and the OA-ICP loop: soft
correspondences from a temperature softmax over distances, masked by the
object consistency of the two frames, re-fit per object with Kabsch at every
iteration.  The softmax-matvec streams over pc2 tiles (refine/streaming.py):
one tile at SAPIEN's 512 points, and KITTI-SF's 8192 points never form an
N x N matrix.  Plain PyTorch in float32 (TF32 off in the entry points),
under no_grad.
"""

from __future__ import annotations

import torch

from ogc_tpu_torch.losses.seg_unsup import (
    _permute_slots,
    fit_motion_svd_batch,
    interpolate_mask_by_flow,
    match_mask_by_iou,
)
from ogc_tpu_torch.refine.streaming import softmax_corr_apply


def _rigid_project(pc: torch.Tensor, flow: torch.Tensor,
                   mask_kn: torch.Tensor) -> torch.Tensor:
    """Fit one rigid motion per object to ``flow`` and blend them by mask.

    :param pc, flow: (B, N, 3); :param mask_kn: (B, K, N).
    :return: the rigidified flow (B, N, 3).
    """
    B, K, N = mask_kn.shape
    pc_rep = pc[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    flow_rep = flow[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    R, t = fit_motion_svd_batch(pc_rep, pc_rep + flow_rep,
                                mask_kn.reshape(B * K, N))
    pc_tr = torch.einsum("bij,bnj->bni", R, pc_rep) + t[:, None, :]
    return torch.einsum("bkn,bkni->bni", mask_kn,
                        pc_tr.reshape(B, K, N, 3)) - pc


@torch.no_grad()
def weighted_kabsch(pc: torch.Tensor, flow: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Per-object rigid projection of a flow field (oa_icp.py:16-38).

    :param pc, flow: (B, N, 3); :param mask: (B, N, K).
    """
    return _rigid_project(pc, flow, mask.transpose(1, 2))


@torch.no_grad()
def object_aware_icp(pc1: torch.Tensor, pc2: torch.Tensor, flow: torch.Tensor,
                     mask1: torch.Tensor, mask2: torch.Tensor,
                     icp_iter: int = 10, temperature: float = 0.01,
                     tile: int = 1024) -> torch.Tensor:
    """OA-ICP (oa_icp.py:41-84).

    :param pc1, pc2: (B, N, 3); :param flow: (B, N, 3) initial flow.
    :param mask1, mask2: (B, N, K) soft object masks of the two frames.
    :param tile: pc2 points per step of the streaming softmax.
    :return: the refined flow (B, N, 3).
    """
    # Align mask2's slots to mask1's through the flow-warped IoU matching.
    mask2_interp = interpolate_mask_by_flow(pc1, pc2, mask1, flow)
    mask2 = _permute_slots(mask2, match_mask_by_iou(mask2_interp, mask2))
    mask1_kn = mask1.transpose(1, 2)
    for _ in range(icp_iter):
        # The distances keep the reference cdist's sqrt (softmax_corr_apply),
        # since the softmax is not invariant to squaring them.
        # corr12 @ pc2 = num / (s0 * max(s1 / s0, 1e-10)), s1 / s0 being the
        # dense post-softmax row sum of softmax(-d / T) * consistency12.
        num, s0, s1 = softmax_corr_apply(
            pc1 + flow, pc2, pc2, temperature, cons_q=mask1, cons_p=mask2,
            tile=tile)
        denom = s0 * torch.clamp(s1 / s0, min=1e-10)
        new_flow = num / denom[..., None] - pc1
        flow = _rigid_project(pc1, new_flow, mask1_kn)
    return flow
