"""The unsupervised OGC loss and its Adam step in plain PyTorch, as the OGC
reference's losses/seg_loss_unsup.py and train_seg.py describe them.

* Dynamic: per object slot a rigid motion fitted by weighted Kabsch from
  the (detached) soft mask, the transformed clouds blended by the mask,
  the L2 distance to pc + flow, mean over points.
* Smooth: the L1 mask discrepancy over each point's KNN graph (radius
  clamp: a neighbour farther than the radius is replaced by the nearest)
  and its ball-query graph (an under-full ball repeats its first member).
* Invariance: the two augmented views' masks matched by IoU of their
  argmax segmentations (linear assignment), the L2 gap to the matched
  (detached) masks, both ways.
With the augmented views (4 clouds an item) the per-frame sums are halved
and clouds (i, i + 2) are the invariance pairs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ogcbench.reference import search as S
from ogcbench.reference.lap import assign_max
from ogcbench.reference.nn import Products


@torch.no_grad()
def kabsch(pc1, pc2, w, pr: Products):
    """Weighted rigid fit pc1 -> pc2 per row: R (B, 3, 3), t (B, 3); the
    reflection fixed by det's sign; the identity where the weights sum to
    ~0 or the covariance is not finite."""
    w_sum = w.sum(1, keepdim=True)
    valid = w_sum[:, 0] > 1e-12
    safe = torch.clamp(w_sum, min=1e-12)
    m1 = (pc1 * w[..., None]).sum(1) / safe
    m2 = (pc2 * w[..., None]).sum(1) / safe
    c1, c2 = pc1 - m1[:, None], pc2 - m2[:, None]
    cov = pr.bmm((c1 * w[..., None]).transpose(1, 2), c2)
    valid = valid & torch.isfinite(cov).all(dim=(1, 2))
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    cov = torch.where(valid[:, None, None], cov, eye)
    u, _, vt = torch.linalg.svd(cov)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (v * d[:, None, :]) @ u.transpose(-1, -2)
    t = m2 - (R @ m1[..., None])[..., 0]
    R = torch.where(valid[:, None, None], R, eye)
    t = torch.where(valid[:, None], t, torch.zeros_like(t))
    return R, t


def dynamic(pc, mask, flow, pr: Products):
    B, N, K = mask.shape
    pc2 = pc + flow
    w = mask.detach().transpose(1, 2).reshape(B * K, N)
    rep = pc[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    rep2 = pc2[:, None].expand(B, K, N, 3).reshape(B * K, N, 3)
    R, t = kabsch(rep, rep2, w, pr)
    with torch.no_grad():
        moved = (rep @ R.transpose(1, 2) + t[:, None]).reshape(B, K, N, 3)
    blended = (mask.transpose(1, 2)[..., None] * moved).sum(1)
    return torch.linalg.vector_norm(blended - pc2, ord=2, dim=-1).mean()


def _l1_discrepancy(mask, idx):
    return (mask[:, :, None, :] - S.group(mask, idx)).abs().sum(-1).mean()


def smooth(pc, mask, lc: dict, search: S.Search):
    kp, bp = lc["knn_loss_params"], lc["ball_q_loss_params"]
    with torch.no_grad():
        dist, idx = search.knn(kp["k"], pc, pc)
        idx = torch.where(dist > kp["radius"], idx[..., :1], idx)
        ball = search.ball(bp["radius"], bp["k"], pc, pc)
    return (lc["w_knn"] * _l1_discrepancy(mask, idx)
            + lc["w_ball_q"] * _l1_discrepancy(mask, ball))


def _match(m1, m2) -> np.ndarray:
    """m2's slot matched to each of m1's slots by the IoU of the argmax
    segmentations, (B, K)."""
    K = m1.shape[-1]
    eye = np.eye(K, dtype=np.float32)
    oh1 = eye[m1.detach().argmax(-1).cpu().numpy()]
    oh2 = eye[m2.detach().argmax(-1).cpu().numpy()]
    inter = np.einsum("bng,bnp->bgp", oh1, oh2)
    union = oh1.sum(1)[..., None] + oh2.sum(1)[:, None, :] - inter
    return assign_max(inter / np.maximum(union, np.float32(1e-10)))


def _permuted(mask, col):
    col = torch.from_numpy(col).to(mask.device)
    return torch.gather(mask, 2, col[:, None, :].expand(-1, mask.shape[1], -1))


def invariance(m1, m2):
    t1 = _permuted(m2.detach(), _match(m1, m2))
    t2 = _permuted(m1.detach(), _match(m2, m1))
    return (torch.linalg.vector_norm(m1 - t1, dim=-1).mean()
            + torch.linalg.vector_norm(m2 - t2, dim=-1).mean())


def ogc_loss(pcs: List[torch.Tensor], masks: List[torch.Tensor],
             flows: List[torch.Tensor], lc: dict, search: S.Search,
             pr: Products = Products()):
    """Every term on (its start steps passed): (total, {term: value})."""
    T = len(pcs)
    half = 0.5 if T == 4 else 1.0
    sm = lc["smooth_loss_params"]
    l_dyn = half * sum(dynamic(pcs[f], masks[f], flows[f], pr)
                       for f in range(T))
    l_smooth = half * sum(smooth(pcs[f], masks[f], sm, search)
                          for f in range(T))
    l_inv = (sum(invariance(masks[i], masks[i + T // 2])
                 for i in range(T // 2)) if T == 4
             else torch.zeros((), device=pcs[0].device))
    w = lc["weights"]
    total = w[0] * l_dyn + w[1] * l_smooth + w[2] * l_inv
    return total, {"dynamic": l_dyn, "smooth": l_smooth, "invariance": l_inv}


class Adam:
    """Adam as optax's chain (L2 decay added to the gradient, bias-corrected
    moments in float32, eps 1e-8 outside the root) with the staircase
    learning rate lr * max(decay ** floor(step * B / decay_step), clip /
    lr), step counted before the update."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 batch_size: int, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.cfg, self.batch = params, cfg, batch_size
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def lr(self) -> float:
        c, f = self.cfg, np.float32
        e = np.floor(f(self.count * self.batch) / f(c["decay_step"]))
        return float(f(c["lr"]) * np.maximum(f(c["lr_decay"]) ** e,
                                             f(c["lr_clip"] / c["lr"])))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr()
        self.count += 1
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(self.count))
        bc2 = float(f(1) - f(self.b2) ** f(self.count))
        for k, p in self.params.items():
            g = grads[k] + self.cfg["weight_decay"] * p
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            p -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                            + self.eps)
