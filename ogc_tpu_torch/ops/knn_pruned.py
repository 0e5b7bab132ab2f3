"""Bound-pruned exact KNN: the CUDA kernel (csrc/knn_exact_pruned.cu) and its
plain PyTorch version.

Replaces ogc_tpu/ops/pallas_knn.py::_knn_exact_pruned_kernel (entry point
``knn_exact_pruned``).  The contract is #2's (ops/knn.py): ascending
direct-form d2, ties to the lower index, sqrt distances.  The prologue runs
in plain torch on the tensors' device, as pallas_knn.py:977-1083 does:

* queries and points are sorted by 30-bit Morton code (``morton_codes``),
  points padded with 1e6 (id 2^30) to a multiple of ``cb`` and queries with
  copies of the last sorted query to a multiple of ``qt``;
* exact lower bounds ``lb2`` between every query tile's and point block's
  bounding boxes;
* a flash pre-pass, the block-min KNN (#3, ops/knn_blockmin.py) at recall
  0.98 on the sorted queries against the points in their own order, gives
  each query an upper bound on its k-th d2, inflated by ``theta_inflate``
  to cover #3's truncated keys; a tile takes its queries' largest;
* a block survives for a tile when its lower bound is at most that bound;
  ``order`` lists the survivors first in ascending bound (a stable sort),
  ``count`` says how many.

Every true neighbour lies in a surviving block, so searching the survivors
alone gives #2's answer.  The kernel does that per tile; the plain version
computes the same survivors and searches each query's surviving candidates
with #2's plain arithmetic (direct-form d2 in the points' own order, a
stable sort), so it holds the pruning itself to #2 as well.

``knn_exact_pruned`` routes by the tensors' device: CPU tensors take
``knn_exact_pruned_plain``; CUDA tensors launch the kernel (after the
prologue, whose pre-pass launches #3) or raise.
``knn_exact_pruned.launches`` counts launches of this kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.knn import MAX_K, check_clouds, pair_d2
from ogc_tpu_torch.ops.knn_blockmin import TILE, knn_blockmin

CB = 128          # points per candidate block (pallas_knn.py::_CB_EXACT)
QT = 128          # queries per tile, one CUDA thread each
PAD = 1e6         # pad point coordinate
PAD_ID = 2 ** 30  # pad point id: loses every tie
RECALL = 0.98     # the flash pre-pass's recall target (pallas_knn.py:1081)


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every 3rd bit (pallas_knn.py:1144)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(pc: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of (B, N, 3) points quantized to each cloud's
    bounding box (pallas_knn.py::morton_codes): (B, N) int32."""
    lo = pc.amin(1, keepdim=True)
    hi = pc.amax(1, keepdim=True)
    u = (pc - lo) / torch.clamp(hi - lo, min=1e-6) * 1023.0
    u = torch.clamp(u, 0.0, 1023.0).to(torch.int32)
    return ((_expand_bits10(u[..., 0]) << 2) | (_expand_bits10(u[..., 1]) << 1)
            | _expand_bits10(u[..., 2]))


def theta_inflate(m_points: int) -> float:
    """pallas_knn.py::_theta_inflate: the relative margin that makes the
    pre-pass's k-th distance squared a proven upper bound on the true k-th
    d2 (the packed-key truncation of #3 plus the sqrt round trip)."""
    mp_flash = -(-m_points // TILE) * TILE
    idx_bits = max(1, (mp_flash - 1).bit_length())
    return 1.0 + max(2.0 ** -8, 2.0 ** (idx_bits - 22))


def _argsort_rows(codes: torch.Tensor) -> torch.Tensor:
    """Stable argsort of each row of (B, N) Morton codes (< 2^30) as one
    sort of the flat keys b * 2^30 + code: a single radix sort on the card,
    where a batched sort of long rows launches per row."""
    B, N = codes.shape
    rows = torch.arange(B, device=codes.device)[:, None]
    flat = torch.sort((codes.long() + (rows << 30)).reshape(-1),
                      stable=True).indices
    return flat.reshape(B, N) - rows * N


def _block_aabb(x: torch.Tensor, n_valid: int, nb: int, cb: int):
    """Per-block bounding boxes of sorted (B, nb * cb, 3) points, pads (index
    >= n_valid) left out (pallas_knn.py::_block_aabb)."""
    valid = (torch.arange(nb * cb, device=x.device) < n_valid).reshape(
        1, nb, cb, 1)
    xb = x.reshape(x.shape[0], nb, cb, 3)
    lo = torch.where(valid, xb, 1e9).amin(2)
    hi = torch.where(valid, xb, -1e9).amax(2)
    return lo, hi


class Prologue(NamedTuple):
    q_s: torch.Tensor    # (B, np, 3) sorted, padded queries
    p_s: torch.Tensor    # (B, mp, 3) sorted, padded points
    pid: torch.Tensor    # (B, mp) int32 original point ids (pads 2^30)
    lb2: torch.Tensor    # (B, nbq, nbp) tile-block lower bounds
    inv: torch.Tensor    # (B, N) int64: sorted position of each query


def prologue(query: torch.Tensor, points: torch.Tensor, cb: int,
             qt: int) -> Prologue:
    """pallas_knn.py::_pruned_prologue: Morton sort, padding, bounding boxes
    and their lower bounds."""
    B, N, _ = query.shape
    M = points.shape[1]
    mp = -(-M // cb) * cb
    np_ = -(-N // qt) * qt
    pperm = _argsort_rows(morton_codes(points))
    p_s = torch.gather(points.float(), 1, pperm[..., None].expand(B, M, 3))
    pid = pperm.to(torch.int32)
    if mp != M:
        p_s = torch.cat([p_s, p_s.new_full((B, mp - M, 3), PAD)], 1)
        pid = torch.cat([pid, pid.new_full((B, mp - M), PAD_ID)], 1)
    qperm = _argsort_rows(morton_codes(query))
    q_s = torch.gather(query.float(), 1, qperm[..., None].expand(B, N, 3))
    if np_ != N:
        q_s = torch.cat([q_s, q_s[:, -1:].expand(B, np_ - N, 3)], 1)
    nbp, nbq = mp // cb, np_ // qt
    p_lo, p_hi = _block_aabb(p_s, M, nbp, cb)
    q_lo, q_hi = _block_aabb(q_s, np_, nbq, qt)
    gap = torch.clamp(torch.maximum(q_lo[:, :, None] - p_hi[:, None],
                                    p_lo[:, None] - q_hi[:, :, None]), min=0.0)
    g2 = gap * gap
    lb2 = (g2[..., 0] + g2[..., 1]) + g2[..., 2]
    inv = torch.empty_like(qperm)
    inv.scatter_(1, qperm, torch.arange(N, device=query.device).expand(B, N))
    return Prologue(q_s, p_s, pid, lb2, inv)


def survivors(pro: Prologue, points: torch.Tensor, k: int, qt: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash pre-pass bound per tile and the surviving blocks
    (pallas_knn.py:1077-1084 and ::_survivor_order).

    :return: (order (B, nbq, nbp) int32, survivors first in ascending lb2;
        count (B, nbq) int32)."""
    B, np_ = pro.q_s.shape[:2]
    fd, _ = knn_blockmin(pro.q_s, points.float(), k, RECALL)
    kth = fd[..., k - 1]
    theta = kth * kth * theta_inflate(points.shape[1])
    theta_tile = theta.reshape(B, np_ // qt, qt).amax(-1)
    survive = pro.lb2 <= theta_tile[..., None]
    keyed = torch.where(survive, pro.lb2, torch.inf)
    order = torch.sort(keyed, dim=-1, stable=True).indices.to(torch.int32)
    return order, survive.sum(-1).to(torch.int32)


def _unsort(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Rows of sorted-query results (B, np, k) back in query order."""
    return torch.gather(x, 1, inv[..., None].expand(*inv.shape, x.shape[-1]))


def knn_exact_pruned_plain(query: torch.Tensor, points: torch.Tensor, k: int,
                           cb: int = CB, qt: int = QT, chunk: int = 512
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prologue, then per query the k smallest direct-form d2 over its
    tile's surviving blocks only (pruned candidates at +inf), by a stable
    sort over the points' own order, so ties go to the lower index.  Sorted
    queries go in chunks of ``chunk`` (a multiple of ``qt``).

    :param query: (B, N, 3); :param points: (B, M, 3); requires k <= M.
    :return: (dist (B, N, k) float32 = sqrt(max(d2, 0)), idx (B, N, k)
        int32)."""
    B, N, _ = query.shape
    M = points.shape[1]
    pro = prologue(query, points, cb, qt)
    order, count = survivors(pro, points, k, qt)
    nbq, nbp = order.shape[1:]
    surv = torch.arange(nbp, device=order.device) < count[..., None]
    keep = torch.zeros_like(surv).scatter_(-1, order.long(), surv)
    # Block of each original point: its sorted position // cb.
    pos = torch.empty((B, M), dtype=torch.int64, device=points.device)
    pos.scatter_(1, pro.pid[:, :M].long(),
                 torch.arange(M, device=points.device).expand(B, M))
    block_of = (pos // cb)[:, None, :].expand(B, nbq, M)
    keep_pts = torch.gather(keep, 2, block_of)       # (B, nbq, M)
    dists, idxs = [], []
    chunk = max(qt, chunk // qt * qt)
    for s in range(0, pro.q_s.shape[1], chunk):
        q = pro.q_s[:, s:s + chunk]
        tiles = torch.arange(s, s + q.shape[1], device=q.device) // qt
        d2 = torch.where(keep_pts[:, tiles], pair_d2(q, points), torch.inf)
        d2s, idx = torch.sort(d2, dim=-1, stable=True)
        # sqrt in float64, rounded once to float32, is the correctly rounded
        # float32 sqrt (the kernel's sqrtf).
        dists.append(torch.sqrt(torch.clamp(d2s[..., :k], min=0.0).double())
                     .float())
        idxs.append(idx[..., :k].to(torch.int32))
    dist, idx = torch.cat(dists, 1), torch.cat(idxs, 1)
    return _unsort(dist, pro.inv), _unsort(idx, pro.inv)


def knn_exact_pruned(query: torch.Tensor, points: torch.Tensor, k: int,
                     cb: int = CB, qt: int = QT
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN with Morton-block pruning; #2's contract.  Requires
    k <= M and ceil(M / 4) >= k (the pre-pass's smallest run length)."""
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_exact_pruned_plain(query, points, k, cb, qt)
    check_clouds("knn_exact_pruned", query, points, "query", "points")
    B, N, _ = query.shape
    M = points.shape[1]
    if not 1 <= k <= min(M, MAX_K):
        raise ValueError(f"knn_exact_pruned: k={k} must be in 1..min(M={M}, "
                         f"{MAX_K})")
    if not (1 <= cb <= 128 and 32 <= qt <= 1024 and qt % 32 == 0):
        raise ValueError(f"knn_exact_pruned: cb={cb}, qt={qt}")
    pro = prologue(query.contiguous(), points.contiguous(), cb, qt)
    order, count = survivors(pro, points.contiguous(), k, qt)
    np_, mp = pro.q_s.shape[1], pro.p_s.shape[1]
    dist = _build.empty((B, np_, k), torch.float32, query.device)
    idx = _build.empty((B, np_, k), torch.int32, query.device)
    if B * N == 0:
        return dist[:, :0], idx[:, :0]
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = _build.lib().ogc_knn_exact_pruned(
        pro.q_s.data_ptr(), pro.p_s.data_ptr(), pro.pid.data_ptr(),
        order.data_ptr(), count.data_ptr(), B, np_, mp, order.shape[1],
        order.shape[2], k, cb, qt, dist.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "ogc_knn_exact_pruned")
    knn_exact_pruned.launches += 1
    return _unsort(dist, pro.inv), _unsort(idx, pro.inv)


knn_exact_pruned.launches = 0
