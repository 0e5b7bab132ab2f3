"""The fused prologue of the pruned KNNs #4 (ops/knn_pruned.py) and #6
(ops/knn_cand.py): the CUDA kernels of csrc/pruned_prologue.cu.

Both searches start as the JAX package's do (pallas_knn.py::
_pruned_prologue :977, _survivor_order :1032, knn_pruned :1345-1398); the
torch prologues of the two modules copy those steps op by op, a chain of
~100-300 small launches a call.  Here they take two launches:

* ``sort_clouds`` (``ogc_pruned_sort``, a CTA per cloud): both clouds
  sorted by 30-bit Morton code (a stable radix sort), padded, their
  original indices, and the box of every point block and query tile, pads
  left out as each module leaves them out.  A cloud of more than ``RUN``
  points is sorted in runs merged by rank, two launches more.
* ``select_blocks`` (``ogc_pruned_select``, a CTA per query tile): the lower
  bound ``lb2`` of every (tile, block) pair, then #4's survivors (``order``
  and ``count``, from the #3 pre-pass's distances) or #6's ``n_cand``
  blocks of smallest score (``cand``).

Their outputs are bit-equal to the torch prologues', which stay the CPU
path of both modules and the yardstick chip_smoke.py holds these kernels
to.  CUDA tensors only: the modules send CPU tensors to the torch
prologues.  ``sort_clouds.launches`` and ``select_blocks.launches`` count
the kernels each launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.knn import check_clouds

RUN = 16384  # points a CTA sorts: the shared memory's limit (csrc kMaxRun)


class Sorted(NamedTuple):
    q_s: torch.Tensor    # (B, np, 3) sorted queries, then pads
    p4: torch.Tensor     # (B, mp, 4) sorted points, then pads at 1e6: x, y,
    #                      z and the bits of the int32 original id (pads
    #                      pad_id)
    qid: torch.Tensor    # (B, np) int32 original query rows, pads -1
    q_box: torch.Tensor  # (B, np / qt, 6) tile boxes (lo x, y, z, hi ...)
    p_box: torch.Tensor  # (B, mp / cb, 6) block boxes


class Selection(NamedTuple):
    lb2: torch.Tensor                # (B, nbq, nbp) tile-block lower bounds
    score: Optional[torch.Tensor]    # #6: (B, nbq, nbp) lb2 + 1e-3 * c2c
    blocks: torch.Tensor             # #4: (B, nbq, nbp) order; #6: cand
    count: Optional[torch.Tensor]    # #4: (B, nbq) survivors per tile


def sort_launches(m: int, n: int) -> int:
    """Kernels ``sort_clouds`` launches for clouds of ``m`` points and ``n``
    queries: the sort, and the merge and finish past one CTA's RUN."""
    return 3 if max(m, n) > RUN else 1


def sort_clouds(query: torch.Tensor, points: torch.Tensor, cb: int, qt: int,
                pad_id: int, repeat_last: bool) -> Sorted:
    """Morton-sort ``query`` (B, N, 3) and ``points`` (B, M, 3), pad the
    points to a multiple of ``cb`` (at 1e6, id ``pad_id``) and the queries
    to a multiple of ``qt`` (copies of the last sorted query when
    ``repeat_last``, in its tiles' boxes, as #4 pads them; else at 1e6 and
    out of the boxes, as #6 does), and box every block and tile.  A CTA
    sorts up to RUN points; a longer cloud is sorted in runs and merged
    (two launches more).  Requires N, M >= 1."""
    check_clouds("sort_clouds", query, points, "query", "points")
    B, N, _ = query.shape
    M = points.shape[1]
    mp, np_ = -(-M // cb) * cb, -(-N // qt) * qt
    dev = query.device
    query, points = query.contiguous(), points.contiguous()
    p4 = _build.empty((B, mp, 4), torch.float32, dev)
    p_box = _build.empty((B, mp // cb, 6), torch.float32, dev)
    q_s = _build.empty((B, np_, 3), torch.float32, dev)
    qid = _build.empty((B, np_), torch.int32, dev)
    q_box = _build.empty((B, np_ // qt, 6), torch.float32, dev)
    run_p = _build.empty((B, M), torch.int64, dev) if M > RUN else None
    run_q = _build.empty((B, N), torch.int64, dev) if N > RUN else None
    err = _build.lib().ogc_pruned_sort(
        points.data_ptr(), query.data_ptr(), B, M, N, mp, np_, cb, qt, pad_id,
        int(repeat_last), np_ if repeat_last else N, p4.data_ptr(),
        p_box.data_ptr(), q_s.data_ptr(), qid.data_ptr(),
        q_box.data_ptr(), run_p.data_ptr() if run_p is not None else None,
        run_q.data_ptr() if run_q is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ogc_pruned_sort")
    sort_clouds.launches += sort_launches(M, N)
    return Sorted(q_s, p4, qid, q_box, p_box)


def select_blocks(srt: Sorted, fd: Optional[torch.Tensor] = None, k: int = 0,
                  inflate: float = 0.0, n_cand: int = 0) -> Selection:
    """Per query tile, ``lb2`` against every point block, then with the #3
    pre-pass's distances ``fd`` (B, np, k) #4's survivors (``lb2 <=
    theta_tile``, theta the tile's largest ``kth * kth * inflate``): every
    block in ascending (survive ? lb2 : inf, block) order and the count;
    else #6's ``n_cand`` blocks of smallest (score, block)."""
    B, nbq = srt.q_box.shape[:2]
    nbp = srt.p_box.shape[1]
    qt = srt.q_s.shape[1] // nbq
    dev = srt.q_s.device
    survive = fd is not None
    lb2 = _build.empty((B, nbq, nbp), torch.float32, dev)
    score = None if survive else _build.empty((B, nbq, nbp), torch.float32,
                                              dev)
    blocks = _build.empty((B, nbq, nbp if survive else n_cand), torch.int32,
                          dev)
    count = _build.empty((B, nbq), torch.int32, dev) if survive else None
    if survive:
        fd = fd.contiguous()
    err = _build.lib().ogc_pruned_select(
        srt.p_box.data_ptr(), srt.q_box.data_ptr(), B, nbq, nbp, int(survive),
        fd.data_ptr() if survive else None, k, qt, inflate, n_cand,
        lb2.data_ptr(), score.data_ptr() if score is not None else None,
        blocks.data_ptr(), count.data_ptr() if count is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ogc_pruned_select")
    select_blocks.launches += 1
    return Selection(lb2, score, blocks, count)


sort_clouds.launches = 0
select_blocks.launches = 0
