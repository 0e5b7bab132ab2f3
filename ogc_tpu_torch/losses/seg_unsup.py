"""Unsupervised OGC segmentation losses in PyTorch (counterpart of
ogc_tpu/losses/seg_unsup.py on its parity path).

Rigid dynamic consistency via weighted Kabsch, local smoothness on the
reference's KNN and ball-query graphs, invariance across augmented views
after Hungarian matching by IoU, plus the entropy and rank monitors
(reference losses/seg_loss_unsup.py).

The smooth terms differentiate through ``ops.group``, whose backward is the
deterministic scatter-add kernel; with ``symmetric_grad`` (the fast configs)
their backward is the scatter-free symmetric-graph formula instead.  The
``mxu`` edge engine (``smooth_loss_params.edge_engine``) sorts the cloud by
Morton code and groups both edge tables in one block-sparse call
(``_smooth_mxu``, kernels #9/#10).  The Hungarian matching runs on the host
(utils/lap.py, the JAX package's solver step for step).  Options of the JAX
package that no shipped config of the port's paths uses -- the mutual graph,
lean/remat smooth backwards, the opt-in scatter routing flag and
``monitor_terms: false`` -- are not ported (ROADMAP A.13): asking for them
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch import ops
from ogc_tpu_torch.ops.blocksparse import group_blocksparse
from ogc_tpu_torch.ops.knn_pruned import _argsort_rows, morton_codes
from ogc_tpu_torch.utils.lap import linear_sum_assignment


@torch.no_grad()
def fit_motion_svd_batch(pc1: torch.Tensor, pc2: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Kabsch: per-batch rigid (R, t) aligning pc1 -> pc2.

    :param pc1, pc2: (B, N, 3); :param mask: optional (B, N) weights.
    :return: R (B, 3, 3), t (B, 3).  Reflection fix by the sign of det and
        the identity for ill-posed batches (zero weight or non-finite
        covariance), as ogc_tpu/losses/seg_unsup.py:27-85.  Full float32
        products (TF32 is off in the port's entry points).
    """
    B, N, _ = pc1.shape
    w = torch.ones((B, N), dtype=pc1.dtype, device=pc1.device) \
        if mask is None else mask
    w_sum = w.sum(1, keepdim=True)
    valid = w_sum[:, 0] > 1e-12
    safe = torch.clamp(w_sum, min=1e-12)
    pc1_mean = torch.einsum("bnd,bn->bd", pc1, w) / safe
    pc2_mean = torch.einsum("bnd,bn->bd", pc2, w) / safe
    pc1_c = pc1 - pc1_mean[:, None, :]
    pc2_c = pc2 - pc2_mean[:, None, :]
    S = torch.einsum("bnd,bn,bne->bde", pc1_c, w, pc2_c)
    valid = valid & torch.isfinite(S).all(dim=(1, 2))
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    S_safe = torch.where(valid[:, None, None], S, eye)
    u, _, vt = torch.linalg.svd(S_safe)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    diag = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = torch.einsum("bij,bj,bkj->bik", v, diag, u)
    t = pc2_mean - torch.einsum("bij,bj->bi", R, pc1_mean)
    R = torch.where(valid[:, None, None], R, eye)
    t = torch.where(valid[:, None], t, torch.zeros_like(t))
    return R, t


def dynamic_loss(pc: torch.Tensor, mask: torch.Tensor, flow: torch.Tensor,
                 loss_norm: int = 2) -> torch.Tensor:
    """Fit one rigid motion per object slot from the soft mask, blend the
    (detached) transformed clouds by the mask, penalise the distance to
    pc + flow (reference DynamicLoss, losses/seg_loss_unsup.py:64-98)."""
    B, N, K = mask.shape
    pc2 = pc + flow
    mask_f = mask.transpose(1, 2).reshape(B * K, N)
    pc_rep = pc[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    pc2_rep = pc2[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    R, t = fit_motion_svd_batch(pc_rep, pc2_rep, mask_f.detach())
    with torch.no_grad():
        pc_tr = (torch.einsum("bij,bnj->bni", R, pc_rep)
                 + t[:, None, :]).reshape(B, K, N, 3)
    blended = (mask_f.reshape(B, K, N)[..., None] * pc_tr).sum(1)
    resid = torch.linalg.vector_norm(blended - pc2, ord=loss_norm, dim=-1)
    return resid.mean()


def _norm(x: torch.Tensor, loss_norm: int) -> torch.Tensor:
    """Norm over the last axis.  L1 is ``abs().sum()``: a zero difference
    has a zero subgradient, as in JAX."""
    if loss_norm == 1:
        return x.abs().sum(-1)
    return torch.linalg.vector_norm(x, ord=loss_norm, dim=-1)


def _neighbor_discrepancy(mask: torch.Tensor, nn_mask: torch.Tensor,
                          loss_norm: int) -> torch.Tensor:
    """mean over points and neighbours of ||m_i - m_j||
    (mask (B, N, K), nn_mask (B, N, S, K))."""
    return _norm(mask[:, :, None, :] - nn_mask, loss_norm).mean()


class _SymGradDiscrepancy(torch.autograd.Function):
    """Neighbour discrepancy with a symmetric-graph gradient
    (ogc_tpu/losses/seg_unsup.py::_sym_grad_discrepancy).

    The forward is mean_{i,s} ||m_i - m_j(i,s)|| through ``ops.group``.  The
    backward assumes j in N(i) <=> i in N(j), under which the scatter-add
    transpose of the neighbour gather equals the gather itself:
    grad_i = 2 g / (B N S) sum_s d||.||(m_i - m_j(i,s)), a gather and no
    scatter.  The KNN and ball graphs are only roughly symmetric, so this
    is the fast configs' deliberate deviation from the exact gradient.
    """

    @staticmethod
    def _diff(mask, idx):
        return mask[:, :, None, :] - ops.group(mask, idx)

    @staticmethod
    def forward(ctx, mask, idx, loss_norm):
        ctx.save_for_backward(mask, idx)
        ctx.loss_norm = loss_norm
        diff = _SymGradDiscrepancy._diff(mask, idx)
        if loss_norm == 1:
            return diff.abs().sum(-1).mean()
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24)).mean()

    @staticmethod
    def backward(ctx, g):
        mask, idx = ctx.saved_tensors
        with torch.no_grad():
            diff = _SymGradDiscrepancy._diff(mask, idx)
            if ctx.loss_norm == 1:
                d = torch.sign(diff)
            else:
                d = diff / torch.sqrt(torch.clamp(
                    (diff * diff).sum(-1, keepdim=True), min=1e-24))
            B, N, S, _ = diff.shape
            return (2.0 * g / (B * N * S)) * d.sum(2), None, None


def _smooth_term(mask: torch.Tensor, idx: torch.Tensor, loss_norm: int,
                 symmetric_grad: bool) -> torch.Tensor:
    if symmetric_grad:
        return _SymGradDiscrepancy.apply(mask, idx, loss_norm)
    return _neighbor_discrepancy(mask, ops.group(mask, idx), loss_norm)


def knn_smooth_loss(pc: torch.Tensor, mask: torch.Tensor, k: int,
                    radius: float, loss_norm: int = 1,
                    symmetric_grad: bool = False,
                    exact: Optional[bool] = None) -> torch.Tensor:
    """KNN smoothness with the radius clamp (reference KnnLoss,
    losses/seg_loss_unsup.py:101-129): neighbours farther than ``radius``
    are replaced by the nearest one.  ``exact``: the search's neighbour
    mode (None: the global one)."""
    with torch.no_grad():
        dist, idx = ops.knn(k, pc, pc, exact=exact)
        idx = torch.where(dist > radius, idx[..., :1], idx)
    return _smooth_term(mask, idx, loss_norm, symmetric_grad)


def ball_q_smooth_loss(pc: torch.Tensor, mask: torch.Tensor, k: int,
                       radius: float, loss_norm: int = 1,
                       symmetric_grad: bool = False,
                       exact: Optional[bool] = None) -> torch.Tensor:
    """Ball-query smoothness (reference BallQLoss,
    losses/seg_loss_unsup.py:132-158)."""
    with torch.no_grad():
        idx = ops.ball_query(radius, k, pc, pc, exact=exact)
    return _smooth_term(mask, idx, loss_norm, symmetric_grad)


# The MXU edge engine (ogc_tpu/losses/seg_unsup.py:450-571).  The cloud and
# mask are permuted into Morton order inside the loss, so both edge tables
# become block-coherent and one block-sparse grouping call (#9 forward, #10
# backward) serves them; the loss is a mean over edges, so the order only
# changes which tied or filling edges are picked.  Approximate search runs
# against a stride-shuffled copy of the sorted cloud (j -> j * s mod N, s
# coprime to N): on the sorted order the block-min thinning would collapse
# a neighbourhood into a couple of runs.


def _coprime_stride(n: int) -> int:
    """The shuffle stride: ~0.618 n, odd, coprime to n."""
    s = max(3, int(n * 0.618) | 1)
    while math.gcd(s, n) != 1:
        s += 2
    return s


def _shuffled_approx_tables(pc_s: torch.Tensor, knn_k: int, ball_k: int,
                            ball_radius: float):
    """Approximate KNN and ball tables of a sorted cloud (B, N, 3), searched
    against its stride-shuffled copy and mapped back by the same closed
    form.  :return: (knn_dist, knn_idx, ball_idx), indices in sorted
    order."""
    N = pc_s.shape[1]
    s = _coprime_stride(N)
    pos = torch.arange(N, device=pc_s.device) * s % N
    shuffled = pc_s[:, pos]
    dist, idx_shuf = ops.knn(knn_k, pc_s, shuffled, exact=False)
    ball_shuf = ops.ball_query(ball_radius, ball_k, shuffled, pc_s,
                               exact=False)
    return dist, idx_shuf * s % N, ball_shuf * s % N


def _edge_phi(diff: torch.Tensor, loss_norm: int) -> torch.Tensor:
    """Per-edge norm over the mask channels: (..., S, K) -> (..., S)."""
    if loss_norm == 1:
        return diff.abs().sum(-1)
    return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))


@torch.no_grad()
def mxu_tables(pc: torch.Tensor, cfg: "OGCLossConfig"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mxu engine's Morton order and edge table of ``pc`` (B, N, 3).

    :return: (perm (B, N) int64, the stable Morton argsort; cat (B, N,
        knn_k + ball_q_k) int32, the radius-clamped KNN table and the ball
        table of the sorted cloud, in sorted indices)."""
    B, N, _ = pc.shape
    perm = _argsort_rows(morton_codes(pc.float()))
    pc_s = torch.gather(pc.float(), 1, perm[..., None].expand(B, N, 3))
    exact = (ops.exact_neighbors() if cfg.smooth_exact is None
             else bool(cfg.smooth_exact))
    if exact:
        dist, idx_raw = ops.knn(cfg.knn_k, pc_s, pc_s, exact=True)
        ball_idx = ops.ball_query(cfg.ball_q_radius, cfg.ball_q_k, pc_s, pc_s,
                                  exact=True)
    else:
        dist, idx_raw, ball_idx = _shuffled_approx_tables(
            pc_s, cfg.knn_k, cfg.ball_q_k, cfg.ball_q_radius)
    knn_idx = torch.where(dist > cfg.knn_radius, idx_raw[..., :1], idx_raw)
    return perm, torch.cat([knn_idx, ball_idx], -1).to(torch.int32)


def _smooth_mxu(pc: torch.Tensor, mask: torch.Tensor,
                cfg: "OGCLossConfig") -> torch.Tensor:
    """w_knn * KnnLoss + w_ball_q * BallQLoss on the reference graphs with
    both tables through one ``group_blocksparse`` call
    (ogc_tpu/losses/seg_unsup.py::_smooth_mxu).

    The ball fill: an under-full ball repeats its first member, and on the
    sorted cloud "first" is another point than on the original one.  The
    original index rides the gather as one more channel (a float, exact
    below 2^24), and the fill's weight moves to the member of least
    original index, as the reference fills.  The mask reaches the sorted
    order through ``ops.gather``, whose backward is the deterministic
    scatter-add (#11)."""
    K = mask.shape[-1]
    perm, cat = mxu_tables(pc, cfg)
    mask_s = ops.gather(mask, perm)
    src = torch.cat([mask_s, perm.to(mask_s.dtype)[..., None]], -1)
    nn = group_blocksparse(src, cat)  # (B, N, S1 + S2, K + 1)
    k1, S2 = cfg.knn_k, cfg.ball_q_k
    l_knn = _neighbor_discrepancy(mask_s, nn[:, :, :k1, :K],
                                  cfg.knn_loss_norm)
    phi = _edge_phi(mask_s[:, :, None, :] - nn[:, :, k1:, :K],
                    cfg.ball_q_loss_norm)  # (B, N, S2)
    with torch.no_grad():
        bidx = cat[:, :, k1:]
        fills = (bidx[..., 1:] == bidx[..., :1]).float().sum(-1)
        # The member of least original index; a one-hot pick of its phi
        # (no gather: its backward would scatter with atomics).
        star = (torch.argmin(nn[:, :, k1:, K], -1, keepdim=True)
                == torch.arange(S2, device=pc.device))
    phi_star = torch.where(star, phi, 0.0).sum(-1)
    row = phi.sum(-1) + fills * (phi_star - phi[..., 0])
    l_bq = row.mean() / S2
    return cfg.smooth_w_knn * l_knn + cfg.smooth_w_ball_q * l_bq


def interpolate_mask_by_flow(pc1: torch.Tensor, pc2: torch.Tensor,
                             mask1: torch.Tensor, flow1: torch.Tensor,
                             k: int = 1) -> torch.Tensor:
    """Warp pc1 by flow1 and carry its mask onto pc2 through the k nearest
    warped points, inverse-distance weighted for k > 1 (reference
    losses/seg_loss_unsup.py:183-209).  Used by OA-ICP.

    :param pc1, pc2, flow1: (B, N, 3); :param mask1: (B, N, K).
    :return: (B, N, K) mask on pc2.
    """
    dist, idx = ops.knn(k, pc2, pc1 + flow1)
    nn_mask = ops.group(mask1, idx.detach())  # (B, N, k, K)
    if k == 1:
        return nn_mask[:, :, 0, :]
    recip = 1.0 / torch.clamp(dist, min=1e-10)
    weight = recip / recip.sum(-1, keepdim=True)
    return (weight[..., None] * nn_mask).sum(2)


def match_mask_by_iou(mask1: torch.Tensor, mask2: torch.Tensor) -> np.ndarray:
    """Hungarian-match the argmax object masks by IoU on the host.

    :return: col_ind (B, K) int64: mask2's slot matched to each of mask1's
        slots (reference losses/seg_loss_unsup.py:212-240; the JAX package's
        one-hot permutation matrix is ``one_hot(col_ind)``).
    """
    K = mask1.shape[-1]
    seg1 = mask1.detach().argmax(-1).cpu().numpy()
    seg2 = mask2.detach().argmax(-1).cpu().numpy()
    eye = np.eye(K, dtype=np.float32)
    oh1, oh2 = eye[seg1], eye[seg2]
    inter = np.einsum("bng,bnp->bgp", oh1, oh2)
    union = oh1.sum(1)[..., None] + oh2.sum(1)[:, None, :] - inter
    iou = inter / np.maximum(union, np.float32(1e-10))
    return linear_sum_assignment(iou, True).astype(np.int64)


def _permute_slots(mask: torch.Tensor, col_ind: np.ndarray) -> torch.Tensor:
    """out[b, n, i] = mask[b, n, col_ind[b, i]]: the exact product with the
    one-hot permutation."""
    col = torch.from_numpy(col_ind).to(mask.device)
    return torch.gather(mask, 2, col[:, None, :].expand(-1, mask.shape[1], -1))


def invariance_loss(mask1: torch.Tensor, mask2: torch.Tensor,
                    loss_norm: int = 2) -> torch.Tensor:
    """Symmetric invariance between two augmented views after Hungarian
    alignment (reference InvarianceLoss, losses/seg_loss_unsup.py:243-280)."""
    target1 = _permute_slots(mask2.detach(), match_mask_by_iou(mask1, mask2))
    target2 = _permute_slots(mask1.detach(), match_mask_by_iou(mask2, mask1))
    return (_norm(mask1 - target1, loss_norm).mean()
            + _norm(mask2 - target2, loss_norm).mean())


def entropy_loss(mask: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Per-point entropy of the soft mask (monitor only;
    losses/seg_loss_unsup.py:283-297)."""
    return (-(mask * torch.log(torch.clamp(mask, min=epsilon))).sum(-1)).mean()


def rank_loss(mask: torch.Tensor, ns_iters: int = 24) -> torch.Tensor:
    """Nuclear norm of the (N, K) mask (monitor only;
    losses/seg_loss_unsup.py:300-314): tr(sqrtm(M^T M)) by ``ns_iters``
    Newton-Schulz steps in float32 on the normalised K x K Gram matrix."""
    gram = torch.einsum("bnk,bnl->bkl", mask, mask)
    K = gram.shape[-1]
    eye = torch.eye(K, dtype=gram.dtype, device=gram.device)
    scale = gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-6
    y = gram / scale + 1e-9 * eye
    z = eye.expand_as(y)
    for _ in range(ns_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    tr = y.diagonal(dim1=-2, dim2=-1).sum(-1) * torch.sqrt(scale[..., 0, 0])
    return tr.mean()


@dataclasses.dataclass(frozen=True)
class OGCLossConfig:
    """Weights and scheduling of the combined loss (the YAML ``loss:``
    block, e.g. config/seg/kittisf/kittisf_unsup.yaml)."""

    weights: Tuple[float, float, float] = (10.0, 0.1, 0.1)  # dyn/smooth/inv
    start_steps: Tuple[int, int, int] = (0, 0, 0)
    dynamic_loss_norm: int = 2
    smooth_w_knn: float = 3.0
    smooth_w_ball_q: float = 1.0
    knn_k: int = 8
    knn_radius: float = 0.1
    knn_loss_norm: int = 1
    ball_q_k: int = 16
    ball_q_radius: float = 0.2
    ball_q_loss_norm: int = 1
    invariance_loss_norm: int = 2
    # Scatter-free symmetric-graph smooth gradient (_SymGradDiscrepancy).
    symmetric_smooth_grad: bool = False
    # Neighbour mode of the smooth-loss tables only (None: the global one).
    smooth_exact: Optional[bool] = None
    # Smooth-loss edge engine: "gather" groups on the original point order;
    # "mxu" is _smooth_mxu (Morton order, kernels #9/#10), taken only
    # without symmetric_smooth_grad, as in the JAX package.
    smooth_edge_engine: str = "gather"

    # Keys of the JAX package's extensions, with the only value the port
    # implements: smooth_loss_params keys, and the loss block's
    # monitor_terms (the port always computes the entropy/rank monitors).
    _UNPORTED = {"graph": "reference", "ref_bwd": "autodiff",
                 "scatter_kernel": False}

    @classmethod
    def from_dict(cls, loss_cfg: dict) -> "OGCLossConfig":
        """Build from a reference-style YAML dict (train_seg.py:333-339)."""
        d = loss_cfg.get("dynamic_loss_params", {})
        s = loss_cfg.get("smooth_loss_params", {})
        i = loss_cfg.get("invariance_loss_params", {})
        unported = [(f"smooth_loss_params.{k}", s.get(k, want), want)
                    for k, want in cls._UNPORTED.items()]
        unported.append(("monitor_terms", loss_cfg.get("monitor_terms", True),
                         True))
        for key, got, want in unported:
            if got != want:
                raise NotImplementedError(
                    f"{key}={got!r} is not ported: the port runs "
                    f"{want!r} only (ROADMAP.md A.13)")
        engine = s.get("edge_engine", "gather")
        if engine not in ("gather", "mxu"):
            raise ValueError(f"smooth_loss_params.edge_engine must be "
                             f"'gather' or 'mxu', got {engine!r}")
        kp = s.get("knn_loss_params", {})
        bp = s.get("ball_q_loss_params", {})
        return cls(
            weights=tuple(loss_cfg.get("weights", (10.0, 0.1, 0.1))),
            start_steps=tuple(loss_cfg.get("start_steps", (0, 0, 0))),
            dynamic_loss_norm=d.get("loss_norm", 2),
            smooth_w_knn=s.get("w_knn", 3.0),
            smooth_w_ball_q=s.get("w_ball_q", 1.0),
            knn_k=kp.get("k", 8),
            knn_radius=kp.get("radius", 0.1),
            knn_loss_norm=kp.get("loss_norm", 1),
            ball_q_k=bp.get("k", 16),
            ball_q_radius=bp.get("radius", 0.2),
            ball_q_loss_norm=bp.get("loss_norm", 1),
            invariance_loss_norm=i.get("loss_norm", 2),
            symmetric_smooth_grad=s.get("symmetric_grad", False),
            smooth_edge_engine=engine,
        )


def smooth_loss(pc: torch.Tensor, mask: torch.Tensor,
                cfg: OGCLossConfig) -> torch.Tensor:
    """w_knn * KnnLoss + w_ball_q * BallQLoss (reference SmoothLoss,
    losses/seg_loss_unsup.py:161-180)."""
    if cfg.smooth_edge_engine == "mxu" and not cfg.symmetric_smooth_grad:
        return _smooth_mxu(pc, mask, cfg)
    l_knn = knn_smooth_loss(pc, mask, cfg.knn_k, cfg.knn_radius,
                            cfg.knn_loss_norm, cfg.symmetric_smooth_grad,
                            cfg.smooth_exact)
    l_bq = ball_q_smooth_loss(pc, mask, cfg.ball_q_k, cfg.ball_q_radius,
                              cfg.ball_q_loss_norm, cfg.symmetric_smooth_grad,
                              cfg.smooth_exact)
    return cfg.smooth_w_knn * l_knn + cfg.smooth_w_ball_q * l_bq


def ogc_loss(pcs: List[torch.Tensor], masks: List[torch.Tensor],
             flows: List[torch.Tensor], cfg: OGCLossConfig,
             step_w: bool = False, it: int = 0, aug_transform: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined unsupervised OGC loss over 2 (or 4, with augmentation)
    frames (reference UnsupervisedOGCLoss, losses/seg_loss_unsup.py:
    317-409).  With ``step_w`` a term's weight is 0 while ``it`` (the count
    of samples seen) is below its start step.  With augmentation the frame
    sums are halved and frames (i, i + T/2) are the invariance pairs.

    :return: (scalar loss, dict of scalar terms).
    """
    assert len(pcs) == len(masks) == len(flows)
    n_frames = len(pcs)

    def gate(weight: float, start_step: int) -> float:
        return 0.0 if step_w and it < start_step else weight

    half = 0.5 if aug_transform else 1.0
    loss_dict: Dict[str, torch.Tensor] = {}
    l_dyn = half * sum(dynamic_loss(pcs[f], masks[f], flows[f],
                                    cfg.dynamic_loss_norm)
                       for f in range(n_frames))
    l_smooth = half * sum(smooth_loss(pcs[f], masks[f], cfg)
                          for f in range(n_frames))
    loss_dict["dynamic"] = l_dyn
    loss_dict["smooth"] = l_smooth
    total = (gate(cfg.weights[0], cfg.start_steps[0]) * l_dyn
             + gate(cfg.weights[1], cfg.start_steps[1]) * l_smooth)
    if aug_transform:
        pairs = n_frames // 2
        l_inv = sum(invariance_loss(masks[i], masks[i + pairs],
                                    cfg.invariance_loss_norm)
                    for i in range(pairs))
        total = total + gate(cfg.weights[2], cfg.start_steps[2]) * l_inv
    else:
        l_inv = torch.zeros((), device=l_dyn.device)
    loss_dict["invariance"] = l_inv

    with torch.no_grad():
        loss_dict["entropy"] = half * sum(entropy_loss(m) for m in masks)
        loss_dict["rank"] = half * sum(rank_loss(m) for m in masks)
    loss_dict["sum"] = total
    return total, loss_dict
