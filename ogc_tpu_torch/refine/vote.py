"""Multi-frame co-segmentation by voting (counterpart of
ogc_tpu/refine/vote.py; reference vote.py:17-131).

Soft correspondences from flow-warped distances, propagated to
non-adjacent frames, Hungarian alignment of the object channels on the host
(utils/lap.py, the JAX package's solver step for step, so tied costs pick
the same column), and averaging within a time window.  The warped masks
come from chained streaming softmax-matvecs (refine/streaming.py), never an
(N, N) matrix; ``collect_correspondences`` keeps the dense form for the
tests.  The batched functions take a leading scene axis S.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ogc_tpu_torch.refine.streaming import softmax_corr_apply, square_distance
from ogc_tpu_torch.utils.lap import linear_sum_assignment


def pairwise_correspondence(pc1: torch.Tensor, pc2: torch.Tensor,
                            flow: torch.Tensor,
                            temperature: float = 0.01) -> torch.Tensor:
    """Softmaxed negative-distance correspondence (vote.py:17-28).

    :param pc1, pc2, flow: (..., N, 3).  :return: (..., N, N).
    """
    d = torch.sqrt(square_distance(pc1 + flow, pc2))
    return torch.softmax(-d / temperature, dim=-1)


def collect_correspondences(pc: torch.Tensor,
                            flows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All pairwise correspondences by transitive propagation, dense
    (vote.py:31-59).

    :param pc: (T, N, 3); :param flows: (T-1, 2, N, 3) adjacent fwd/bwd flows.
    """
    T, N, _ = pc.shape
    corrs: Dict[str, torch.Tensor] = {}
    eye = torch.eye(N, dtype=pc.dtype, device=pc.device)
    for t in range(T):
        corrs[f"{t}_{t}"] = eye
    for t in range(T - 1):
        corrs[f"{t}_{t + 1}"] = pairwise_correspondence(pc[t], pc[t + 1],
                                                        flows[t, 0])
        corrs[f"{t + 1}_{t}"] = pairwise_correspondence(pc[t + 1], pc[t],
                                                        flows[t, 1])

    def normalized(c):
        return c / torch.clamp(c.sum(-1, keepdim=True), min=1e-10)

    for interval in range(2, T):
        for t in range(0, T - interval):
            mid = t + interval - 1
            corrs[f"{t}_{t + interval}"] = normalized(
                corrs[f"{t}_{mid}"] @ corrs[f"{mid}_{t + interval}"])
            corrs[f"{t + interval}_{t}"] = normalized(
                corrs[f"{t + interval}_{mid}"] @ corrs[f"{mid}_{t}"])
    return corrs


def match_mask_by_cost(mask1: torch.Tensor, mask2: torch.Tensor,
                       measure: str = "ce") -> torch.Tensor:
    """Reorder mask2's object channels to match mask1 (vote.py:62-91).

    :param mask1, mask2: (..., N, K) soft masks.  :return: reordered mask2.
    """
    m1 = mask1[..., :, :, None]  # (..., N, K, 1)
    m2 = mask2[..., :, None, :]  # (..., N, 1, K)
    if measure == "ce":
        eps = 1e-7
        p = torch.clamp(m2, eps, 1.0 - eps)
        cost = -(m1 * torch.log(p) + (1.0 - m1) * torch.log(1.0 - p))
        col = linear_sum_assignment(cost.mean(-3).cpu().numpy(), False)
    else:
        inter = (m1 * m2).sum(-3)
        union = torch.clamp((m1 + m2).sum(-3), min=1e-10)
        col = linear_sum_assignment((inter / union).cpu().numpy(), True)
    col = torch.from_numpy(col.astype(np.int64)).to(mask2.device)
    return torch.gather(mask2, -1, col[..., None, :].expand(mask2.shape))


def _apply_adjacent_corr(pc: torch.Tensor, flows: torch.Tensor, a: int,
                         b: int, X: torch.Tensor, temperature: float,
                         tile: int) -> torch.Tensor:
    """The adjacent softmax correspondence C_{a->b} applied to X (S, N, C):
    b == a+1 uses the forward flow flows[:, a, 0], b == a-1 the backward
    flow flows[:, b, 1] (vote.py:41-48)."""
    if b == a + 1:
        q, p, fl = pc[:, a], pc[:, a + 1], flows[:, a, 0]
    else:
        assert b == a - 1
        q, p, fl = pc[:, a], pc[:, a - 1], flows[:, a - 1, 1]
    num, s0, _ = softmax_corr_apply(q + fl, p, X, temperature, tile=tile)
    return num / s0[..., None]


def warp_mask_chain_batch(pc: torch.Tensor, flows: torch.Tensor, t: int,
                          v: int, m: torch.Tensor, temperature: float = 0.01,
                          tile: int = 1024) -> torch.Tensor:
    """corrs[t_v] @ m for S scenes, with no (N, N) matrix.

    Every adjacent factor is row-stochastic, so the dense path's per-product
    row normalisations telescope into one final division, carried as an
    extra ones column: corrs[t_v] @ m = (C.. @ [m, 1])[:, :K] / (...)[:, K:].

    :param pc: (S, T, N, 3); :param flows: (S, T-1, 2, N, 3);
    :param m: (S, N, K).  :return: (S, N, K).
    """
    K = m.shape[-1]
    X = torch.cat([m, torch.ones_like(m[..., :1])], -1)
    step = 1 if v > t else -1
    # Innermost factor first: C_{v-step -> v}, ..., C_{t -> t+step}.
    for a in range(v - step, t - step, -step):
        X = _apply_adjacent_corr(pc, flows, a, a + step, X, temperature, tile)
    return X[..., :K] / torch.clamp(X[..., K:], min=1e-10)


def warp_mask_chain(pc: torch.Tensor, flows: torch.Tensor, t: int, v: int,
                    m: torch.Tensor, temperature: float = 0.01,
                    tile: int = 1024) -> torch.Tensor:
    """One scene: pc (T, N, 3), flows (T-1, 2, N, 3), m (N, K)."""
    return warp_mask_chain_batch(pc[None], flows[None], t, v, m[None],
                                 temperature, tile)[0]


@torch.no_grad()
def mask_voting_batch(pc: torch.Tensor, mask: torch.Tensor,
                      flows: torch.Tensor, time_window_size: int = 3,
                      tile: int = 1024) -> torch.Tensor:
    """Correspondence-warped voting over the frames of S scenes
    (vote.py:94-131).

    :param pc: (S, T, N, 3); :param mask: (S, T, N, K);
    :param flows: (S, T-1, 2, N, 3).  :return: voted masks (S, T, N, K).
    """
    T = pc.shape[1]
    voted = []
    for t in range(T):
        votes = []
        for v in range(max(0, t - time_window_size),
                       min(T, t + time_window_size + 1)):
            if v == t:
                votes.append(mask[:, t])
            else:
                warped = warp_mask_chain_batch(pc, flows, t, v, mask[:, v],
                                               tile=tile)
                votes.append(match_mask_by_cost(mask[:, t], warped))
        vote = torch.stack(votes, 0).mean(0)
        voted.append(vote / torch.clamp(vote.sum(-1, keepdim=True),
                                        min=1e-10))
    return torch.stack(voted, 1)


def mask_voting(pc: torch.Tensor, mask: torch.Tensor, flows: torch.Tensor,
                time_window_size: int = 3, tile: int = 1024) -> torch.Tensor:
    """One scene: pc (T, N, 3), mask (T, N, K), flows (T-1, 2, N, 3)."""
    return mask_voting_batch(pc[None], mask[None], flows[None],
                             time_window_size, tile)[0]
