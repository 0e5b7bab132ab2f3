"""Deterministic row scatter-add: the CUDA kernel (csrc/scatter_add.cu) and
its plain PyTorch version.

Replaces ogc_tpu/ops/pallas_scatter.py::scatter_add_rows:
``d[b, idx[b, r], :] += g[b, r, :]`` in ascending r, float32, from 0.0.  It
is the backward of every grouping gather in the port (ops/core.py::group).
``scatter_add_rows`` routes by the tensors' device: CPU tensors take
``scatter_add_rows_plain``; CUDA tensors launch the kernel or raise.
``scatter_add_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ogc_tpu_torch.ops import _build


def segments(idx: torch.Tensor, n_dest: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer prologue shared by both versions.

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


def scatter_add_rows(idx: torch.Tensor, g: torch.Tensor,
                     n_dest: int) -> torch.Tensor:
    """(B, R) int destinations x (B, R, C) float32 rows -> (B, n_dest, C)
    float32 sums, each in ascending r."""
    if idx.device.type == "cpu" and g.device.type == "cpu":
        return scatter_add_rows_plain(idx, g, n_dest)
    for name, t in (("idx", idx), ("g", g)):
        if t.device.type != "cuda":
            raise ValueError(f"scatter_add_rows: {name} on {t.device}")
    if (idx.dim() != 2 or g.dim() != 3 or g.shape[:2] != idx.shape
            or g.dtype != torch.float32 or idx.device != g.device
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            f"scatter_add_rows: want (B, R) int idx and (B, R, C) float32 g "
            f"on one device, got {tuple(idx.shape)} {idx.dtype}, "
            f"{tuple(g.shape)} {g.dtype}")
    B, R = idx.shape
    C = g.shape[-1]
    out = _build.empty((B, n_dest, C), torch.float32, g.device)
    if B * n_dest * C == 0:
        return out
    if R == 0:
        return out.zero_()
    _, order, start = segments(idx, n_dest)
    g = g.contiguous()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = _build.lib().ogc_scatter_add_rows(
        g.data_ptr(), order.data_ptr(), start.data_ptr(), B * n_dest, C,
        out.data_ptr(), stream)
    _build.check(err, "ogc_scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
