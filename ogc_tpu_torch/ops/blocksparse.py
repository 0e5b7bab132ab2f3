"""Block-sparse row gather and its deterministic scatter-add: the CUDA
kernels (csrc/onehot_bs.cu) and their plain PyTorch versions.

Replaces ogc_tpu/ops/pallas_onehot.py::_bs_gather_kernel (#9) and
::_bs_scatter_kernel (#10), the forward and backward of
``group_blocksparse``: the grouping of the smooth-loss edge tables of a
Morton-sorted cloud (losses/seg_unsup.py::_smooth_mxu).  On such a cloud
the edges of a tile of ``QT`` consecutive query rows reach few distinct
blocks of ``CB`` source rows.  ``bs_prologue`` lists them per tile from the
table itself, as the JAX package's ``_bs_prologue`` does.

* ``gather_blocksparse`` (B, N, C) x (B, M, S) -> (B, M, S, C), bit-equal to
  advanced indexing (the plain version).  The JAX package's one-hot matrix
  product turns -0.0 into +0.0 and spreads a NaN over its block; the port
  copies values, so a -0.0 or a NaN stays where it was.  The smooth loss
  gathers finite positive masks and original indices (floats exact below
  2^24), where both give the same bits.  On the card the same launch also
  writes which blocks each ``RQ`` rows of the padded table reach (the
  ``presence`` of ``bs_prologue``), the input of #10.
* ``scatter_add_blocksparse`` (B, M, S) x (B, M, S, C) -> (B, N, C), each
  destination row summed in ascending edge order from 0.0f: the contract of
  ops/scatter.py (#11), whose ``scatter_add_rows_plain`` is its plain
  version.  On the card a first launch partitions each piece of the padded
  table (an RQ-row unit, in ``ppu`` pieces where it has more than
  SCATTER_PIECE edges) stably by destination group (SCATTER_GROUP rows)
  into scratch; a second takes, per (cloud, group), the segments of the pieces
  whose unit the presence names for the group's block, in order,
  partitions them by row and sums each (row, channel) in order.
  ``bs_scatter_plan`` sizes the pieces, the groups and the scratch.
* ``group_blocksparse`` the pair as an autograd function: the forward runs
  ``bs_pad`` (no work when M is a multiple of ``QT``, S is even and the
  table is int32, as on the KITTI-SF smooth tables) and #9, and keeps the
  padded table and its presence for #10.

The TPU stages a tile's blocks because it gathers random rows slowly, and
the JAX package sends a whole call to the plain gather when a tile reaches
more than ``CAP`` blocks.  The H100 keeps a cloud's source in L2, so #9
stages no blocks and has no cap; ``order``, ``count`` and ``overflow`` of
``bs_prologue`` are what the JAX package computes, and no kernel reads them.

Each wrapper routes by the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.  ``.launches`` counts
kernel launches.  float32 only, C <= 16 on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.onehot import _check
from ogc_tpu_torch.ops.scatter import scatter_add_rows_plain

CB = 128    # source rows per candidate block (pallas_onehot.py::_BS_CB)
QT = 256    # query rows per tile (_BS_QT)
CAP = 32    # candidate blocks a tile stages (_BS_CAP)
RQ = 32     # query rows per unit of the presence matrix
MAX_C = 16
# #9's launch (csrc/onehot_bs.cu): a block of GATHER_WARPS warps per RQ-row
# unit stages at most PIECE padded edges' indices at a time, beside a
# 128-word buffer per warp and the unit's presence row, in at most
# SMEM_LIMIT bytes of shared memory (the H100's opt-in maximum).
GATHER_WARPS, PIECE, SMEM_LIMIT = 8, 4096, 232448
# #10's launches (csrc/onehot_bs.cu): partition blocks take pieces of at
# most SCATTER_PIECE padded edges; accumulation blocks take one group of
# SCATTER_GROUP destination rows each (the kernel's kGroup).
SCATTER_PIECE, SCATTER_GROUP = 8192, 16


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def bs_pad(idx: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """pallas_onehot.py::_bs_pad: M padded to QT and S to even with index 0.

    :return: (idx_p (B, m_pad, s_pad) int32, m_pad, s_pad)."""
    B, M, S = idx.shape
    m_pad, s_pad = _pad_to(M, QT), _pad_to(S, 2)
    idx_p = idx.to(torch.int32)
    if m_pad != M or s_pad != S:
        idx_p = torch.nn.functional.pad(idx_p, (0, s_pad - S, 0, m_pad - M))
    return idx_p, m_pad, s_pad


class Table(NamedTuple):
    """What #10 reads: the padded table and its presence."""
    idx: torch.Tensor       # (B, m_pad * s_pad) int32, the padded table
    s_pad: int
    presence: torch.Tensor  # (B, m_pad / RQ, nb) uint8: rows [u RQ, (u+1)
    #                         RQ) of the table reach block j


class GatherPlan(NamedTuple):
    """#9's launch: a grid of (units, B) blocks, each owning the ``RQ``
    padded rows of one unit of one cloud and walking them ``piece`` padded
    edges at a time, with ``smem`` bytes of dynamic shared memory."""
    m_pad: int
    s_pad: int
    units: int
    piece: int
    smem: int


def bs_gather_plan(n: int, M: int, S: int) -> GatherPlan:
    """#9's launch for a source of ``n`` rows and a (M, S) table."""
    m_pad, s_pad = _pad_to(M, QT), _pad_to(S, 2)
    piece = min(RQ * s_pad, PIECE)
    smem = (GATHER_WARPS * 128 + piece) * 4 + -(-n // CB)
    return GatherPlan(m_pad, s_pad, m_pad // RQ, piece, smem)


class ScatterPlan(NamedTuple):
    """#10's launches: each RQ-row unit's ``RQ * s_pad`` padded edges in
    ``ppu`` pieces of ``piece`` (the last one ragged), ``pieces`` a cloud;
    ``ng`` destination groups of SCATTER_GROUP rows; ``words`` int32 of
    scratch a cloud (the pieces' entries, then their ng + 1 group
    offsets)."""
    s_pad: int
    units: int
    piece: int
    ppu: int
    pieces: int
    ng: int
    words: int


@functools.lru_cache(maxsize=None)
def bs_scatter_plan(n: int, M: int, S: int) -> ScatterPlan:
    """#10's launches for a (M, S) table into ``n`` rows."""
    m_pad, s_pad = _pad_to(M, QT), _pad_to(S, 2)
    unit_edges, units = RQ * s_pad, m_pad // RQ
    ng = -(-n // SCATTER_GROUP)
    ppu = -(-unit_edges // SCATTER_PIECE)
    piece = -(-unit_edges // ppu)
    pieces = units * ppu
    words = pieces * piece + pieces * (ng + 1)
    return ScatterPlan(s_pad, units, piece, ppu, pieces, ng, words)


class Prologue(NamedTuple):
    idx: torch.Tensor       # (B, m_pad * s_pad) int32, the padded table
    s_pad: int
    order: torch.Tensor     # (B, nt, CAP) int32 present blocks ascending
    count: torch.Tensor     # (B, nt, 1) int32, clamped to CAP
    overflow: torch.Tensor  # () bool: some tile has more than CAP blocks
    nblk: torch.Tensor      # (B, nt) int32 unclamped block counts
    presence: torch.Tensor  # (B, m_pad / RQ, nb) uint8: rows [u RQ, (u+1)
    #                         RQ) of the table reach block j


def bs_prologue(idx: torch.Tensor, n: int) -> Prologue:
    """Per-tile candidate-block lists of ``idx`` (B, M, S) into a source of
    ``n`` rows (pallas_onehot.py::_bs_pad and ::_bs_prologue): ``order``,
    ``count`` and ``overflow`` as the JAX package computes them (``order``
    lists the present blocks ascending, then the absent ones); ``nblk``, the
    unclamped counts; and ``presence`` per RQ rows, which #9 writes on the
    card and #10 reads (the scatter walks only the units that reach its
    block).  Indices are clamped into [0, n) first, as the kernels clamp
    them."""
    B = idx.shape[0]
    idx_p, m_pad, s_pad = bs_pad(idx)
    nb, nt = -(-n // CB), m_pad // QT
    blk = (idx_p.clamp(0, n - 1) // CB).reshape(B, m_pad // RQ, RQ * s_pad)
    presence = torch.zeros((B, m_pad // RQ, nb), dtype=torch.uint8,
                           device=idx.device)
    # A constant fill: every duplicate writes the same 1, so the result is
    # deterministic without the sorting path of a tensor-source scatter.
    presence.scatter_(2, blk.long(), 1)
    in_tile = presence.reshape(B, nt, QT // RQ, nb).amax(2).bool()
    nblk = in_tile.sum(-1, dtype=torch.int32)
    iota = torch.arange(nb, dtype=torch.int32, device=idx.device)
    key = torch.where(in_tile, iota, nb + iota)
    order = (torch.sort(key, dim=-1).values[..., :CAP] % nb).to(torch.int32)
    if order.shape[-1] < CAP:  # nb < CAP: pad (count caps the loop)
        order = torch.nn.functional.pad(order, (0, CAP - order.shape[-1]))
    flat = idx_p.reshape(B, m_pad * s_pad).contiguous()
    return Prologue(flat, s_pad, order, torch.clamp(nblk, max=CAP)[..., None],
                    (nblk > CAP).any(), nblk, presence)


def gather_blocksparse_plain(points: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Advanced indexing: (B, N, C) x (B, M, S) -> (B, M, S, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx.long()]


def scatter_add_blocksparse_plain(idx: torch.Tensor, cot: torch.Tensor,
                                  n: int) -> torch.Tensor:
    """#11's plain version on the flattened table: (B, M, S) x
    (B, M, S, C) -> (B, n, C) float32."""
    B, M, S = idx.shape
    return scatter_add_rows_plain(idx.reshape(B, M * S),
                                  cot.reshape(B, M * S, cot.shape[-1]), n)


def gather_blocksparse(points: torch.Tensor, idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[Table]]:
    """(B, N, C) float32 x (B, M, S) int in [0, N) -> (B, M, S, C),
    bit-equal to the plain version, and on the card the ``Table`` that #10
    reads (its presence written by the same launch); None on the CPU."""
    if points.is_cpu and idx.is_cpu:
        return gather_blocksparse_plain(points, idx), None
    dev = _check("gather_blocksparse", ("points", points), ("idx", idx))
    if (points.dim() != 3 or idx.dim() != 3 or idx.shape[0] != points.shape[0]
            or points.dtype != torch.float32
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            f"gather_blocksparse: want (B, N, C) float32 points and (B, M, S)"
            f" int idx, got {tuple(points.shape)} {points.dtype}, "
            f"{tuple(idx.shape)} {idx.dtype}")
    B, N, C = points.shape
    M, S = idx.shape[1:]
    plan = bs_gather_plan(N, M, S)
    if not (N >= 1 and 1 <= C <= MAX_C and plan.smem <= SMEM_LIMIT):
        raise ValueError(f"gather_blocksparse: N={N} C={C}; the kernel takes "
                         f"N >= 1, C <= {MAX_C} and at most {SMEM_LIMIT} "
                         f"bytes of shared memory (here {plan.smem})")
    idx_p = bs_pad(idx)[0].reshape(B, plan.m_pad * plan.s_pad)
    if not idx_p.is_contiguous():
        idx_p = idx_p.contiguous()
    out = _build.empty((B, M, S, C), torch.float32, points.device)
    presence = _build.empty((B, plan.units, -(-N // CB)), torch.uint8,
                            points.device)
    table = Table(idx_p, plan.s_pad, presence)
    if B * M * S == 0:
        presence.zero_()
        return out, table
    if not points.is_contiguous():
        points = points.contiguous()
    err = _build.lib().ogc_bs_gather(
        points.data_ptr(), idx_p.data_ptr(), B, N, C, M, S, plan.s_pad,
        plan.units, plan.piece, plan.smem, out.data_ptr(),
        presence.data_ptr(), _build.raw_stream(dev))
    _build.check(err, "ogc_bs_gather")
    gather_blocksparse.launches += 1
    return out, table


def scatter_add_blocksparse(idx: torch.Tensor, cot: torch.Tensor, n: int,
                            table: Optional[Table] = None) -> torch.Tensor:
    """(B, M, S) int in [0, n) x (B, M, S, C) float32 -> (B, n, C) float32,
    each row summed in ascending edge order.  ``table`` is the one #9
    returned for ``idx`` (or a ``bs_prologue(idx, n)``), computed here when
    not given.  On the card the kernels take n <= 65536 (4096 groups of
    16 rows), at most 4096 partition pieces a cloud (M up to about 131072
    rows at S <= 128) and M * S < 2^27 edges a cloud, and raise beyond them
    (the partition's offsets and the accumulation's list of pieces live in
    shared memory); the plain version has no such limits.  The KITTI-SF
    tables (n 8192, 256 pieces) are far inside."""
    if idx.is_cpu and cot.is_cpu:
        return scatter_add_blocksparse_plain(idx, cot, n)
    dev = _check("scatter_add_blocksparse", ("idx", idx), ("cot", cot))
    if (idx.dim() != 3 or cot.dim() != 4 or cot.shape[:3] != idx.shape
            or cot.dtype != torch.float32
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            f"scatter_add_blocksparse: want (B, M, S) int idx and "
            f"(B, M, S, C) float32 cot, got {tuple(idx.shape)} {idx.dtype}, "
            f"{tuple(cot.shape)} {cot.dtype}")
    B, M, S = idx.shape
    C = cot.shape[-1]
    if not (n >= 1 and 1 <= C <= MAX_C):
        raise ValueError(f"scatter_add_blocksparse: n={n} C={C}; the kernel "
                         f"takes n >= 1, C <= {MAX_C}")
    out = _build.empty((B, n, C), torch.float32, cot.device)
    if B == 0:
        return out
    if M * S == 0:
        return out.zero_()
    plan = bs_scatter_plan(n, M, S)
    table = table or bs_prologue(idx, n)
    if not cot.is_contiguous():
        cot = cot.contiguous()
    scratch = _build.empty((B * plan.words,), torch.int32, cot.device)
    err = _build.lib().ogc_bs_scatter(
        table.idx.data_ptr(), cot.data_ptr(), table.presence.data_ptr(), B,
        n, C, M, S, table.s_pad, plan.units, table.presence.shape[2],
        plan.piece, plan.ppu, scratch.data_ptr(), out.data_ptr(),
        _build.raw_stream(dev))
    _build.check(err, f"ogc_bs_scatter (n={n}, M={M}, S={S}: {plan.ng} "
                 f"groups, {plan.pieces} pieces)")
    scatter_add_blocksparse.launches += 1
    return out


gather_blocksparse.launches = 0
scatter_add_blocksparse.launches = 0


class _GroupBlockSparse(torch.autograd.Function):
    """#9 forward, #10 backward; the table and presence #9 writes (CUDA
    only) are kept for the backward, as the JAX package keeps its
    residuals."""

    @staticmethod
    def forward(ctx, points, idx):
        out, ctx.table = gather_blocksparse(points, idx)
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return out

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        d = scatter_add_blocksparse(idx, grad.float(), ctx.n, ctx.table)
        return d.to(grad.dtype), None


def group_blocksparse(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ops.group`` through #9/#10: (B, N, C) x (B, M, S) -> (B, M, S, C),
    the backward a deterministic scatter-add in ascending edge order."""
    return _GroupBlockSparse.apply(points, idx)
