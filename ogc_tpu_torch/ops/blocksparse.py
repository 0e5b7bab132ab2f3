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
  2^24), where both give the same bits.
* ``scatter_add_blocksparse`` (B, M, S) x (B, M, S, C) -> (B, N, C), each
  destination row summed in ascending edge order from 0.0f: the contract of
  ops/scatter.py (#11), whose ``scatter_add_rows_plain`` is its plain
  version.
* ``group_blocksparse`` the pair as an autograd function.

The JAX package sends a whole call to the plain gather and XLA's scatter
when any tile reaches more than ``CAP`` blocks.  The port routes per tile
inside the kernels instead: a tile over the cap reads its rows straight from
device memory, with the same result.  Such tiles are counted on the device
in ``gather_blocksparse.overflow_tiles`` (no host sync).

Each wrapper routes by the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.  ``.launches`` counts
kernel launches.  float32 only, C <= 16 on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.onehot import _check
from ogc_tpu_torch.ops.scatter import scatter_add_rows_plain

CB = 128    # source rows per candidate block (pallas_onehot.py::_BS_CB)
QT = 256    # query rows per tile (_BS_QT)
CAP = 32    # candidate blocks a tile stages (_BS_CAP)
RQ = 32     # query rows per unit of the scatter's presence matrix
MAX_C = 16


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
    lists the present blocks ascending, then the absent ones); ``nblk`` and
    ``presence`` (per RQ rows: the scatter walks only the units that reach
    its block) are what the kernels read.  Indices are clamped into [0, n)
    first, as the kernels clamp them."""
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


def gather_blocksparse(points: torch.Tensor, idx: torch.Tensor,
                       pro: Optional[Prologue] = None) -> torch.Tensor:
    """(B, N, C) float32 x (B, M, S) int in [0, N) -> (B, M, S, C),
    bit-equal to the plain version.  ``pro`` is ``bs_prologue(idx, N)``,
    computed here when not given."""
    if points.device.type == "cpu" and idx.device.type == "cpu":
        return gather_blocksparse_plain(points, idx)
    _check("gather_blocksparse", ("points", points), ("idx", idx))
    if (points.dim() != 3 or idx.dim() != 3 or idx.shape[0] != points.shape[0]
            or points.dtype != torch.float32
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            f"gather_blocksparse: want (B, N, C) float32 points and (B, M, S)"
            f" int idx, got {tuple(points.shape)} {points.dtype}, "
            f"{tuple(idx.shape)} {idx.dtype}")
    B, N, C = points.shape
    M, S = idx.shape[1:]
    if not (N >= 1 and 1 <= C <= MAX_C):
        raise ValueError(f"gather_blocksparse: N={N} C={C}; the kernel takes "
                         f"N >= 1, C <= {MAX_C}")
    out = torch.empty((B, M, S, C), dtype=torch.float32, device=points.device)
    if B * M * S == 0:
        return out
    pro = pro or bs_prologue(idx, N)
    points = points.contiguous()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = _build.lib().ogc_bs_gather(
        points.data_ptr(), pro.idx.data_ptr(), pro.order.data_ptr(),
        pro.nblk.data_ptr(), B, N, C, M, S, pro.s_pad, pro.nblk.shape[1],
        out.data_ptr(), stream)
    _build.check(err, "ogc_bs_gather")
    gather_blocksparse.launches += 1
    gather_blocksparse.overflow_tiles = (gather_blocksparse.overflow_tiles
                                         + (pro.nblk > CAP).sum())
    return out


def scatter_add_blocksparse(idx: torch.Tensor, cot: torch.Tensor, n: int,
                            pro: Optional[Prologue] = None) -> torch.Tensor:
    """(B, M, S) int in [0, n) x (B, M, S, C) float32 -> (B, n, C) float32,
    each row summed in ascending edge order.  ``pro`` is
    ``bs_prologue(idx, n)``, computed here when not given."""
    if idx.device.type == "cpu" and cot.device.type == "cpu":
        return scatter_add_blocksparse_plain(idx, cot, n)
    _check("scatter_add_blocksparse", ("idx", idx), ("cot", cot))
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
    out = torch.empty((B, n, C), dtype=torch.float32, device=cot.device)
    if B == 0:
        return out
    if M * S == 0:
        return out.zero_()
    pro = pro or bs_prologue(idx, n)
    cot = cot.contiguous()
    stream = torch.cuda.current_stream(cot.device).cuda_stream
    err = _build.lib().ogc_bs_scatter(
        pro.idx.data_ptr(), cot.data_ptr(), pro.presence.data_ptr(), B, n, C,
        M, S, pro.s_pad, pro.presence.shape[1], pro.presence.shape[2],
        out.data_ptr(), stream)
    _build.check(err, "ogc_bs_scatter")
    scatter_add_blocksparse.launches += 1
    return out


gather_blocksparse.launches = 0
gather_blocksparse.overflow_tiles = 0
scatter_add_blocksparse.launches = 0


class _GroupBlockSparse(torch.autograd.Function):
    """#9 forward, #10 backward; the prologue is computed once (CUDA only)
    and kept for the backward, as the JAX package keeps its residuals."""

    @staticmethod
    def forward(ctx, points, idx):
        pro = None if points.device.type == "cpu" else bs_prologue(
            idx, points.shape[1])
        ctx.save_for_backward(idx)
        ctx.pro, ctx.n = pro, points.shape[1]
        return gather_blocksparse(points, idx, pro)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        d = scatter_add_blocksparse(idx, grad.float(), ctx.n, ctx.pro)
        return d.to(grad.dtype), None


def group_blocksparse(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ops.group`` through #9/#10: (B, N, C) x (B, M, S) -> (B, M, S, C),
    the backward a deterministic scatter-add in ascending edge order."""
    return _GroupBlockSparse.apply(points, idx)
