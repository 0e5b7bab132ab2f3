"""Blockwise (streaming-softmax) correspondence products (counterpart of
ogc_tpu/refine/streaming.py).

The reference materializes dense (N, N) softmax correspondence matrices
(reference oa_icp.py:66, vote.py:26-27): 268 MB per scene in float32 at 8192
points.  Here the softmax-matvec runs over pc2 tiles with the running-max
rescaling of the flash-attention recurrence, so the transient is
(B, M, tile) and nothing N x N exists.  The dense expressions are recovered
exactly up to summation order.

Plain PyTorch in float32: the JAX package computes this outside any Pallas
kernel, and the port's entry points turn TF32 off, so the matmuls here are
full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances in the JAX
    package's expanded form |a|^2 - 2 a.b + |b|^2, clamped at 0
    (ogc_tpu/ops/core.py::square_distance)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    inner = torch.einsum("...nd,...md->...nm", a, b)
    return torch.clamp(a2 - 2.0 * inner + b2.transpose(-1, -2), min=0.0)


def softmax_corr_apply(
    q: torch.Tensor,
    p2: torch.Tensor,
    values: torch.Tensor,
    temperature: float,
    cons_q: Optional[torch.Tensor] = None,
    cons_p: Optional[torch.Tensor] = None,
    tile: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming exp(-|q - p2| / T) [* w] @ values, per row.

    With L[m, n] = -dist(q[m], p2[n]) / T and, given the consistency
    vectors, w[m, n] = cons_q[m] . cons_p[n]:

      num[m] = sum_n exp(L[m,n] - gmax[m]) * w[m,n] * values[n]   (B, M, C)
      s0[m]  = sum_n exp(L[m,n] - gmax[m])                        (B, M)
      s1[m]  = sum_n exp(L[m,n] - gmax[m]) * w[m,n]               (B, M)

    so softmax(L) @ values = num / s0 (w == 1), and the dense post-softmax
    row sum of softmax(L) * w is s1 / s0.

    :param q: (B, M, 3); :param p2: (B, N, 3); :param values: (B, N, C);
    :param cons_q: (B, M, K); :param cons_p: (B, N, K).
    """
    B, M = q.shape[:2]
    N, C = values.shape[1:]
    gmax = torch.full((B, M), -1e30, dtype=q.dtype, device=q.device)
    s0 = torch.zeros((B, M), dtype=q.dtype, device=q.device)
    s1 = torch.zeros_like(s0)
    num = torch.zeros((B, M, C), dtype=q.dtype, device=q.device)
    for lo in range(0, N, tile):
        d = torch.sqrt(square_distance(q, p2[:, lo:lo + tile]))
        logit = -d / temperature  # (B, M, tile)
        m_new = torch.maximum(gmax, logit.amax(-1))
        scale = torch.exp(gmax - m_new)
        p = torch.exp(logit - m_new[..., None])
        pw = p
        if cons_q is not None:
            pw = p * torch.einsum("bmk,btk->bmt", cons_q,
                                  cons_p[:, lo:lo + tile])
        s0 = s0 * scale + p.sum(-1)
        s1 = s1 * scale + pw.sum(-1)
        num = num * scale[..., None] + torch.einsum(
            "bmt,btc->bmc", pw, values[:, lo:lo + tile])
        gmax = m_new
    return num, s0, s1
