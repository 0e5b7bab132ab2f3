"""Candidate-pruned approximate KNN: the CUDA kernels (csrc/pruned_prologue.cu,
then csrc/knn_cand_pruned.cu) and the plain PyTorch version.

Replaces ogc_tpu/ops/pallas_knn.py::_knn_pruned_kernel (#6, entry point
``knn_pruned``), step by step as its wrapper runs it:

* the default ``n_cand_blocks`` and ``blk`` and their rounding
  (``resolve``); when the candidate blocks cover every block the call is
  the block-min KNN (#3, ops/knn_blockmin.py), as in the JAX package;
* both clouds sorted by 30-bit Morton code (a stable sort), points padded
  with 1e6 to a multiple of ``cb`` with the pad id ``(1 << idx_bits) - 1``,
  queries padded with 1e6 to a multiple of ``qt``;
* pad-masked bounding boxes of every query tile and point block, the exact
  lower bound ``lb2`` between them, and the score ``lb2 + 1e-3 * c2c``
  (``c2c`` the squared distance of the box centres, doubled), rounded once
  as XLA computes it (it fuses the product and the sum); each tile takes the
  ``n_cand`` blocks of smallest score, ties to the lower block (a stable
  sort, as ``jax.lax.top_k`` breaks ties);
* the kernel: per query tile, the candidate blocks in chunks of ``blk``;
  at each within-block position the chunk's minimum (d2, original id) is
  one key ``(bits(d2) & ~mask_low) | id``; the k smallest distinct keys
  ascending give ``idx = key & mask_low`` and the truncated
  ``dist = sqrt(max(d2, 0))``;
* the rows back in query order (the kernel writes each row there).

The prologue is plain torch here (``prologue``) and the fused kernels of
ops/pruned_prologue.py on the card.  ``knn_cand`` routes by the tensors'
device: CPU tensors take ``knn_cand_plain``; CUDA tensors launch the fused
prologue's sort and selection and the search (three launches), or raise.
``knn_cand.launches`` counts launches of the search kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.knn import MAX_K, check_clouds
from ogc_tpu_torch.ops.knn_blockmin import knn_blockmin
from ogc_tpu_torch.ops.knn_pruned import (_argsort_rows, _block_aabb,
                                          morton_codes)
from ogc_tpu_torch.ops.pruned_prologue import (Selection, Sorted,
                                               select_blocks, sort_clouds)

CB = 128       # points per candidate block (pallas_knn.py::_CB)
QT = 128       # queries per tile (pallas_knn.py::_PQT)
PAD = 1e6      # pad coordinate of points and queries
_C2C_W = float(np.float32(1e-3))
_BIG = 2 ** 31 - 1


def resolve(m: int, k: int, n_cand_blocks: Optional[int] = None,
            blk: Optional[int] = None, cb: int = CB) -> Tuple[int, int, bool]:
    """pallas_knn.py::knn_pruned's sizes: the default candidate pool (~M/3
    points, at least 8k), ``blk`` 2 where the pool holds 16k points, the
    pool rounded up to a multiple of ``blk`` (``blk`` halved while that
    would pass the block count).

    :return: (n_cand_blocks, blk, whether the call is #3's)."""
    nbp = -(-m // cb)
    if n_cand_blocks is None:
        n_cand_blocks = max(2, -(-max(8 * k, m // 3) // cb))
    n_cand_blocks = min(n_cand_blocks, nbp)
    if blk is None:
        blk = 2 if n_cand_blocks * cb >= 16 * k else 1
    while blk > 1 and -(-n_cand_blocks // blk) * blk > nbp:
        blk //= 2
    n_cand_blocks = -(-n_cand_blocks // blk) * blk
    return n_cand_blocks, blk, n_cand_blocks >= nbp


def _check_pool(k: int, n_cand: int, cb: int) -> None:
    """The JAX wrapper's assertion: k real candidates even when the pad-tail
    block is among the chosen."""
    if n_cand * cb - (cb - 1) < k:
        raise ValueError(f"knn_cand: {n_cand} blocks of {cb} points hold "
                         f"fewer than k={k} real candidates")


class Prologue(NamedTuple):
    q_s: torch.Tensor    # (B, np, 3) sorted queries, pads at 1e6
    p_s: torch.Tensor    # (B, mp, 3) sorted points, pads at 1e6
    pid: torch.Tensor    # (B, mp) int32 original ids, pads mask_low
    cand: torch.Tensor   # (B, nbq, n_cand) int32 candidate blocks per tile
    inv: torch.Tensor    # (B, N) int64 sorted position of each query
    idx_bits: int
    qid: torch.Tensor    # (B, N) int64 original row of each sorted query
    q_box: torch.Tensor  # (B, nbq, 6) tile boxes (lo, hi), pads left out
    p_box: torch.Tensor  # (B, nbp, 6) block boxes, pads left out
    lb2: torch.Tensor    # (B, nbq, nbp) tile-block lower bounds
    score: torch.Tensor  # (B, nbq, nbp) lb2 + 1e-3 * c2c, rounded once


def _sorted_padded(x: torch.Tensor, size: int, pad_id: int):
    B, N, _ = x.shape
    perm = _argsort_rows(morton_codes(x))
    xs = torch.gather(x.float(), 1, perm[..., None].expand(B, N, 3))
    ids = perm.to(torch.int32)
    if size != N:
        xs = torch.cat([xs, xs.new_full((B, size - N, 3), PAD)], 1)
        ids = torch.cat([ids, ids.new_full((B, size - N), pad_id)], 1)
    return perm, xs, ids


def prologue(query: torch.Tensor, points: torch.Tensor, n_cand: int,
             cb: int = CB, qt: int = QT) -> Prologue:
    """pallas_knn.py::knn_pruned up to the kernel call."""
    B, N, _ = query.shape
    M = points.shape[1]
    nbp = -(-M // cb)
    mp, np_ = nbp * cb, -(-N // qt) * qt
    idx_bits = max(1, (mp - 1).bit_length())
    _, p_s, pid = _sorted_padded(points, mp, (1 << idx_bits) - 1)
    qperm, q_s, _ = _sorted_padded(query, np_, 0)
    p_lo, p_hi = _block_aabb(p_s, M, nbp, cb)
    q_lo, q_hi = _block_aabb(q_s, N, np_ // qt, qt)
    gap = torch.clamp(torch.maximum(q_lo[:, :, None] - p_hi[:, None],
                                    p_lo[:, None] - q_hi[:, :, None]), min=0.0)
    g2 = gap * gap
    lb2 = (g2[..., 0] + g2[..., 1]) + g2[..., 2]
    dc = (q_lo + q_hi)[:, :, None] - (p_lo + p_hi)[:, None]
    dc2 = dc * dc
    c2c = (dc2[..., 0] + dc2[..., 1]) + dc2[..., 2]
    # One rounding of lb2 + w * c2c: the float64 product is exact.
    score = (lb2.double() + c2c.double() * _C2C_W).float()
    cand = torch.sort(score, dim=-1, stable=True).indices[..., :n_cand]
    inv = torch.empty_like(qperm)
    inv.scatter_(1, qperm, torch.arange(N, device=query.device).expand(B, N))
    return Prologue(q_s, p_s, pid, cand.to(torch.int32).contiguous(), inv,
                    idx_bits, qperm, torch.cat([q_lo, q_hi], -1),
                    torch.cat([p_lo, p_hi], -1), lb2, score)


def _unsort(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Rows of sorted-query results (B, np, k) back in query order."""
    return torch.gather(x, 1, inv[..., None].expand(*inv.shape, x.shape[-1]))


def _smallest_distinct(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest distinct keys of each row, ascending; INT32_MAX where
    a row has fewer (the JAX extraction's ``min over keys > last``)."""
    s = torch.sort(keys, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return torch.sort(torch.where(dup, _BIG, s), dim=-1).values[..., :k]


def _candidate_keys(pro: Prologue, blk: int, cb: int, qt: int, tiles: slice
                   ) -> torch.Tensor:
    """The kernel's thinned keys of the query tiles ``tiles``:
    (B, T * qt, n_cand / blk * cb) int32."""
    B = pro.q_s.shape[0]
    cand = pro.cand[:, tiles].long()                   # (B, T, n_cand)
    T, n_cand = cand.shape[1:]
    rows = (cand[..., None] * cb + torch.arange(cb, device=cand.device)
            ).reshape(B, T * n_cand * cb)
    p = torch.gather(pro.p_s, 1, rows[..., None].expand(-1, -1, 3)).reshape(
        B, T, 1, n_cand * cb, 3)
    ids = torch.gather(pro.pid, 1, rows).reshape(B, T, 1, n_cand // blk, blk,
                                                 cb)
    q = pro.q_s[:, tiles.start * qt:tiles.stop * qt].reshape(B, T, qt, 1, 3)
    dx, dy, dz = (p[..., c] - q[..., c] for c in range(3))
    d2 = ((dx * dx + dy * dy) + dz * dz).reshape(B, T, qt, n_cand // blk, blk,
                                                 cb)
    vmin = d2.amin(4)
    amin = torch.where(d2 == vmin[..., None, :], ids, _BIG).amin(4)
    mask_low = (1 << pro.idx_bits) - 1
    keys = (vmin.view(torch.int32) & ~mask_low) | amin
    return keys.reshape(B, T * qt, -1)


def knn_cand_plain(query: torch.Tensor, points: torch.Tensor, k: int,
                   n_cand_blocks: Optional[int] = None,
                   recall_target: float = 0.95, blk: Optional[int] = None,
                   cb: int = CB, qt: int = QT, chunk: int = 1 << 24
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's steps with the kernel body in torch.  Query tiles go in
    groups whose (query, candidate) pairs stay under ``chunk``.

    :param query: (B, N, 3); :param points: (B, M, 3).
    :return: (dist (B, N, k) float32, truncated; idx (B, N, k) int32)."""
    n_cand, blk, blockmin = resolve(points.shape[1], k, n_cand_blocks, blk,
                                    cb)
    if blockmin:
        return knn_blockmin(query, points, k, recall_target)
    _check_pool(k, n_cand, cb)
    pro = prologue(query, points, n_cand, cb, qt)
    B, nbq = pro.cand.shape[:2]
    mask_low = (1 << pro.idx_bits) - 1
    per = max(1, chunk // (B * qt * n_cand * cb))
    tops = [_smallest_distinct(_candidate_keys(pro, blk, cb, qt,
                                              slice(t, min(t + per, nbq))), k)
            for t in range(0, nbq, per)]
    top = torch.cat(tops, 1)
    # sqrt in float64, rounded once to float32, is the correctly rounded
    # float32 sqrt (the kernel's sqrtf).
    d2 = torch.clamp((top & ~mask_low).view(torch.float32), min=0.0)
    dist = torch.sqrt(d2.double()).float()
    return _unsort(dist, pro.inv), _unsort(top & mask_low, pro.inv)


def fused_prologue(query: torch.Tensor, points: torch.Tensor, n_cand: int,
                   cb: int = CB, qt: int = QT) -> Tuple[Sorted, Selection]:
    """The card's prologue (ops/pruned_prologue.py): the fused sort and the
    fused choice of candidate blocks.  The same sorted clouds, boxes,
    bounds, scores and candidates as ``prologue``."""
    mp = -(-points.shape[1] // cb) * cb
    srt = sort_clouds(query, points, cb, qt,
                      (1 << max(1, (mp - 1).bit_length())) - 1,
                      repeat_last=False)
    return srt, select_blocks(srt, n_cand=n_cand)


def _launch(srt: Sorted, sel: Selection, N: int, M: int, k: int, blk: int,
            lib) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search kernel of library ``lib`` (``_build.lib()``, or one of
    chip_smoke.py's builds at other launch sizes) over ``fused_prologue``'s
    candidates."""
    B, np_ = srt.q_s.shape[:2]
    mp, nbp = srt.p4.shape[1], srt.p_box.shape[1]
    dev = srt.q_s.device
    dist = _build.empty((B, N, k), torch.float32, dev)
    idx = _build.empty((B, N, k), torch.int32, dev)
    err = lib.ogc_knn_cand(
        srt.q_s.data_ptr(), srt.p4.data_ptr(), srt.qid.data_ptr(),
        sel.blocks.data_ptr(), B, N, M, np_, mp, sel.blocks.shape[-1], k,
        blk, mp // nbp, np_ // srt.q_box.shape[1],
        max(1, (mp - 1).bit_length()), dist.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ogc_knn_cand")
    return dist, idx


def search(srt: Sorted, sel: Selection, N: int, M: int, k: int, blk: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search kernel over ``fused_prologue``'s candidates: (dist, idx),
    each (B, N, k), rows in the caller's query order."""
    out = _launch(srt, sel, N, M, k, blk, _build.lib())
    knn_cand.launches += 1
    return out


def knn_cand(query: torch.Tensor, points: torch.Tensor, k: int,
             n_cand_blocks: Optional[int] = None, recall_target: float = 0.95,
             blk: Optional[int] = None, cb: int = CB, qt: int = QT
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate-pruned approximate KNN of ``query`` (B, N, 3) in ``points``
    (B, M, 3): (dist, idx), each (B, N, k), ascending by key, bit-equal to
    the plain version."""
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_cand_plain(query, points, k, n_cand_blocks, recall_target,
                              blk, cb, qt)
    check_clouds("knn_cand", query, points, "query", "points")
    B, N, _ = query.shape
    M = points.shape[1]
    n_cand, blk, blockmin = resolve(M, k, n_cand_blocks, blk, cb)
    if blockmin:
        return knn_blockmin(query, points, k, recall_target)
    _check_pool(k, n_cand, cb)
    if not (1 <= k <= MAX_K and 1 <= cb <= 128 and blk * cb * 16 <= 49152
            and 32 <= qt <= 256 and qt % 32 == 0):
        raise ValueError(f"knn_cand: k={k}, n_cand={n_cand}, blk={blk}, "
                         f"cb={cb}, qt={qt} outside the kernel's limits")
    if B * N == 0:
        return (_build.empty((B, N, k), torch.float32, query.device),
                _build.empty((B, N, k), torch.int32, query.device))
    srt, sel = fused_prologue(query, points, n_cand, cb, qt)
    return search(srt, sel, N, M, k, blk)


knn_cand.launches = 0
