"""Deterministic row scatter-add: the CUDA kernels (csrc/scatter_add.cu) and
their plain PyTorch version.

Replaces ogc_tpu/ops/pallas_scatter.py::scatter_add_rows:
``d[b, idx[b, r], :] += g[b, r, :]`` in ascending r, float32, from 0.0.  It
is the backward of every grouping gather in the port (ops/core.py::group).
``scatter_add_rows`` routes by the tensors' device: CPU tensors take
``scatter_add_rows_plain``; CUDA tensors launch the kernels or raise.
``scatter_add_rows.launches`` counts calls that launch them.

On the card three kernels build a stable CSR of the destinations (chunk
histograms, their scan, ranked placement; every counter has one writer,
and no torch sort) and a fourth sums each destination's segment.
``csr_plan`` sizes the chunks,
the scan's destination tiles and the destination window; ``scatter_csr``
and ``scatter_accumulate`` run the two halves alone, as ``chip_smoke.py``
times them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ogc_tpu_torch.ops import _build

# The CTAs one launch should give the card (2 per SM of an H100).
TARGET_CTAS = 2 * 132
# Rows a chunk takes: a multiple of the 256 threads; at most kMaxChunk, so
# a warp's offsets inside its chunk fit 16 bits.
CHUNK_ALIGN, MAX_CHUNK = 256, 65280
# (destination, chunk) entries a scan CTA takes, and destinations a window.
SCAN_ENTRIES, MAX_WINDOW = 8192, 8192
# At most this many chunks a batch, so that a scan tile spans >= 32
# destinations.
MAX_CHUNKS = SCAN_ENTRIES // 32
# The call's limits: rows a batch (MAX_CHUNKS chunks of MAX_CHUNK rows),
# batches (a launch grid's y), and int32 CSR entries.
MAX_ROWS, MAX_BATCH, MAX_ENTRIES = MAX_CHUNKS * MAX_CHUNK, 65535, 2 ** 31 - 1
# Channels from which a warp per destination row sums (accumulate_plan).
WARP_MIN_C = 32


class CsrPlan(NamedTuple):
    chunk: int  # rows a csr_count / csr_place CTA takes
    nc: int  # chunks a batch
    dt: int  # destinations a scan tile
    win: int  # destinations a window
    n_tiles: int  # scan tiles a batch
    words: int  # int32 scratch: order, start, chunk counts, tile counts


@functools.lru_cache(maxsize=None)
def csr_plan(B: int, R: int, n_dest: int) -> CsrPlan:
    """The CSR build's sizes for idx (B, R) over ``n_dest`` destinations:
    enough chunks for ~TARGET_CTAS CTAs, but no more than half a chunk's
    rows a destination (the chunk counts stay below R / 2 entries) or
    MAX_CHUNKS; scan tiles of SCAN_ENTRIES / chunks destinations (a power
    of two); one window of every destination up to MAX_WINDOW."""
    if B < 1 or R < 1 or n_dest < 1:
        raise ValueError(f"csr_plan: B={B} R={R} n_dest={n_dest}")
    if (R > MAX_ROWS or B > MAX_BATCH or B * R >= MAX_ENTRIES
            or B * n_dest >= MAX_ENTRIES):
        raise ValueError(f"csr_plan: B={B} x R={R} rows into n_dest={n_dest} "
                         f"exceed the kernels' limits: R <= {MAX_ROWS}, "
                         f"B <= {MAX_BATCH}, B*R and B*n_dest < "
                         f"{MAX_ENTRIES}")
    nc = max(1, min(-(-TARGET_CTAS // B), R // (2 * n_dest), MAX_CHUNKS))
    chunk = -(-R // nc)
    chunk = min(MAX_CHUNK, max(CHUNK_ALIGN,
                               -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN))
    chunk = max(chunk, -(-R // MAX_CHUNKS // CHUNK_ALIGN) * CHUNK_ALIGN)
    nc = -(-R // chunk)
    dt = 1 << ((SCAN_ENTRIES // nc).bit_length() - 1)
    win = n_dest if n_dest <= MAX_WINDOW else MAX_WINDOW
    n_tiles = -(-n_dest // dt)
    words = B * R + B * n_dest + 1 + B * nc * n_dest + B * nc * n_tiles
    return CsrPlan(chunk, nc, dt, win, n_tiles, words)


def accumulate_plan(C: int) -> str:
    """The accumulation kernel for C channels: ``"warp"`` (a warp per
    destination row, lanes over channels) from WARP_MIN_C channels, else
    ``"thread"`` (a thread per (row, channel))."""
    return "warp" if C >= WARP_MIN_C else "thread"


def segments(idx: torch.Tensor, n_dest: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version's integer prologue (a stable torch sort); the
    card's CSR (``scatter_csr``) gives the same (order, start).

    :param idx: (B, R) destination rows in [0, n_dest).
    :return: (dest, order, start): ``order`` lists the flattened source rows
        b*R + r sorted by destination b*n_dest + idx[b, r], ascending r
        within a destination (a stable sort); ``dest`` is that sorted
        destination; ``start`` (B*n_dest + 1) the offset of each
        destination's segment in ``order``.
    """
    B = idx.shape[0]
    key = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n_dest
           ).reshape(-1)
    dest, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        dest, torch.arange(B * n_dest + 1, device=idx.device))
    return dest, order, start


def scatter_add_rows_plain(idx: torch.Tensor, g: torch.Tensor,
                           n_dest: int) -> torch.Tensor:
    """The per-destination ascending-r sum, vectorised over destinations:
    step s adds every destination's s-th incoming row (one row per
    destination, so the indexed update is exact).

    :param idx: (B, R) int; :param g: (B, R, C).  :return: (B, n_dest, C) f32.
    """
    B, R = idx.shape
    C = g.shape[-1]
    dest, order, start = segments(idx, n_dest)
    out = torch.zeros((B * n_dest, C), dtype=torch.float32, device=g.device)
    if B * R == 0:
        return out.reshape(B, n_dest, C)
    rank = torch.arange(B * R, device=idx.device) - start[dest]
    by_rank = torch.argsort(rank, stable=True)
    bounds = torch.searchsorted(
        rank[by_rank],
        torch.arange(int(rank.max()) + 2, device=idx.device)).tolist()
    rows = g.reshape(B * R, C).float()
    for s in range(len(bounds) - 1):
        sel = by_rank[bounds[s]:bounds[s + 1]]
        d = dest[sel]
        out[d] = out[d] + rows[order[sel]]
    return out.reshape(B, n_dest, C)


def _check(idx: torch.Tensor, g: torch.Tensor = None) -> None:
    for name, t in (("idx", idx), ("g", g)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"scatter_add_rows: {name} on {t.device}")
    if (idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64)
            or (g is not None and (
                g.dim() != 3 or g.shape[:2] != idx.shape
                or g.dtype != torch.float32 or idx.device != g.device))):
        raise ValueError(
            f"scatter_add_rows: want (B, R) int idx and (B, R, C) float32 g "
            f"on one device, got {tuple(idx.shape)} {idx.dtype}, "
            f"{None if g is None else (tuple(g.shape), g.dtype)}")


def scatter_csr(idx: torch.Tensor, n_dest: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The card's CSR of ``idx`` (B, R) CUDA: (order (B*R,), start
    (B*n_dest + 1,)), int32, equal to ``segments``' (order, start)."""
    _check(idx)
    B, R = idx.shape
    plan = csr_plan(B, R, n_dest)
    idx = idx.contiguous()
    scratch = _build.empty((plan.words,), torch.int32, idx.device)
    _build.check(_build.lib().ogc_scatter_csr(
        idx.data_ptr(), int(idx.dtype == torch.int64), B, R, n_dest,
        plan.chunk, plan.nc, plan.dt, plan.win, scratch.data_ptr(),
        _build.raw_stream(idx.device.index)), "ogc_scatter_csr")
    return scratch[:B * R], scratch[B * R:B * R + B * n_dest + 1]


def scatter_accumulate(order: torch.Tensor, start: torch.Tensor,
                       g: torch.Tensor, n_dest: int,
                       variant: Optional[str] = None) -> torch.Tensor:
    """The card's segment sums of ``g`` (B, R, C) CUDA along a CSR from
    ``scatter_csr``: (B, n_dest, C) float32.  ``variant`` (``"thread"`` or
    ``"warp"``) overrides ``accumulate_plan``'s kernel."""
    B, R, C = g.shape
    g = g.contiguous()
    out = _build.empty((B, n_dest, C), torch.float32, g.device)
    warp = (variant or accumulate_plan(C)) == "warp"
    _build.check(_build.lib().ogc_scatter_accumulate(
        g.data_ptr(), order.data_ptr(), start.data_ptr(), B * n_dest, C,
        int(warp), out.data_ptr(), _build.raw_stream(g.device.index)),
        "ogc_scatter_accumulate")
    return out


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor,
                     n_dest: int) -> torch.Tensor:
    """(B, R) int destinations x (B, R, C) float32 rows -> (B, n_dest, C)
    float32 sums, each in ascending r.

    Every idx must lie in [0, n_dest): the card's CSR gives an
    out-of-range row no position.  On the card R <= MAX_ROWS (16,711,680),
    B <= MAX_BATCH (65535) and B*R, B*n_dest < 2**31 (int32 entries);
    larger calls raise ValueError.
    """
    if idx.device.type == "cpu" and g.device.type == "cpu":
        return scatter_add_rows_plain(idx, g, n_dest)
    _check(idx, g)
    B, R = idx.shape
    C = g.shape[-1]
    out = _build.empty((B, n_dest, C), torch.float32, g.device)
    if B * n_dest * C == 0:
        return out
    if R == 0:
        return out.zero_()
    plan = csr_plan(B, R, n_dest)
    idx, g = idx.contiguous(), g.contiguous()
    scratch = _build.empty((plan.words,), torch.int32, g.device)
    err = _build.lib().ogc_scatter_add_rows(
        idx.data_ptr(), int(idx.dtype == torch.int64), g.data_ptr(), B, R,
        n_dest, C, plan.chunk, plan.nc, plan.dt, plan.win,
        int(accumulate_plan(C) == "warp"), scratch.data_ptr(), out.data_ptr(),
        _build.raw_stream(g.device.index))
    _build.check(err, "ogc_scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
