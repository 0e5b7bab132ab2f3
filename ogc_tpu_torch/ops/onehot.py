"""Small-source row gather and deterministic scatter-add: the CUDA kernels
(csrc/onehot.cu) and their plain PyTorch versions.

Replaces ogc_tpu/ops/pallas_onehot.py::_gather_kernel (#7) and
::_scatter_kernel (#8), the one-hot grouping the JAX package routes every
``ops.group`` of a cloud of at most 1024 points with at most 16 channels
through.  ``onehot_path_applicable`` is a copy of its shape gate, so the port
launches these kernels at exactly the call sites where the JAX package
launches #7/#8.

* ``gather_rows_onehot`` (B, N, C) x (B, E) -> (B, E, C), bit-equal to
  ``src[b, idx[b]]`` (the plain version, advanced indexing).  Its kernel
  stages no source (the cloud stays in L2) and copies rows with C fixed at
  compile time.  At SAPIEN's smooth-loss calls the device needs a few
  microseconds, so the host path is kept to what the launch needs: no
  conversion of an int32 contiguous ``idx``, the output allocated without
  deterministic mode's fill (the kernel writes it whole), the library taken
  without a lock, the stream as a raw handle.
* ``scatter_add_rows_onehot`` (B, E) x (B, E, C) -> (B, n, C), each
  destination summed in ascending e from 0.0f: the contract of
  ops/scatter.py, whose ``scatter_add_rows_plain`` is its plain version.
  Its kernel partitions each cloud's edges stably by destination in shared
  memory and sums each (row, channel) segment in order, a block per
  (cloud, window of destinations); ``onehot_scatter_plan`` sizes the
  windows.  The indices go to the kernel as the caller holds them (int32 or
  int64).

Each routes by the tensors' device: CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.  ``.launches`` counts kernel launches.
float32 only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.scatter import scatter_add_rows_plain

MAX_N, MAX_C = 1024, 16
# #8's launch (csrc/onehot.cu): a block per (cloud, window of destinations)
# keeps at most SCATTER_MAX_SUMS (row, channel) sums; the plan aims at
# SCATTER_TARGET_CTAS blocks (one per SM of an H100: at SAPIEN's smooth
# groups windows of 128 rows beat 64, 32 and 256 on the card,
# chip_smoke.py's window crossover) with windows of a multiple of
# SCATTER_ROW_ALIGN destinations.
SCATTER_MAX_SUMS, SCATTER_TARGET_CTAS, SCATTER_ROW_ALIGN = 2048, 132, 32


class ScatterPlan(NamedTuple):
    rows: int     # destinations a block sums (its window)
    windows: int  # blocks a cloud


def scatter_window(n: int, C: int, rows: int) -> ScatterPlan:
    """Windows of ``rows`` destinations, cut to what the kernel takes: at
    most ``n`` rows and SCATTER_MAX_SUMS (row, channel) sums a block."""
    rows = max(1, min(rows, n, SCATTER_MAX_SUMS // C))
    return ScatterPlan(rows, -(-n // rows))


@functools.lru_cache(maxsize=None)
def onehot_scatter_plan(B: int, n: int, C: int) -> ScatterPlan:
    """#8's launch for B clouds of ``n`` destinations and C channels:
    windows of a multiple of SCATTER_ROW_ALIGN destinations that give about
    SCATTER_TARGET_CTAS blocks."""
    want = -(-SCATTER_TARGET_CTAS // B)
    return scatter_window(n, C, _pad_to(-(-n // want), SCATTER_ROW_ALIGN))


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def onehot_path_applicable(n_src: int, n_rows: int, c: int) -> bool:
    """The JAX package's gate (ogc_tpu/ops/pallas_onehot.py::
    onehot_path_applicable with OGC_GROUP_ONEHOT=auto on one chip):
    n_pad = ceil128(n_src) <= 1024, c <= 16, n_rows >= 1024 rows per cloud.
    Its VMEM-feasibility line always holds inside these limits.  Shapes
    only."""
    return (n_src >= 1 and _pad_to(n_src, 128) <= MAX_N and c <= MAX_C
            and n_rows >= 1024)


def gather_rows_onehot_plain(src: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Advanced indexing.  :param src: (B, N, C); :param idx: (B, E) int."""
    rows = torch.arange(src.shape[0], device=src.device)[:, None]
    return src[rows, idx.long()]


def _check(name: str, *tensors) -> int:
    """Raise unless every tensor lies on one CUDA device; return its index."""
    dev = tensors[0][1].get_device()
    for label, t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name}: {label} on {t.device}, want the CUDA "
                             f"device of {tensors[0][0]}")
    return dev


def gather_rows_onehot(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32 x (B, E) int in [0, N) -> (B, E, C), bit-equal to
    the plain version; requires N <= 1024 and C <= 16 on the card.  The host
    path does only what the launch needs (the calls are small, and their
    time is mostly the host's): an int32 contiguous ``idx`` and a contiguous
    ``src`` go to the kernel as they are."""
    if src.is_cpu and idx.is_cpu:
        return gather_rows_onehot_plain(src, idx)
    dev = src.get_device()
    if (dev < 0 or idx.get_device() != dev or src.dim() != 3
            or idx.dim() != 2 or src.dtype != torch.float32
            or idx.dtype not in (torch.int32, torch.int64)
            or idx.shape[0] != src.shape[0]):
        raise ValueError(
            f"gather_rows_onehot: want (B, N, C) float32 src and (B, E) int "
            f"idx on one CUDA device, got {tuple(src.shape)} {src.dtype} on "
            f"{src.device}, {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    B, N, C = src.shape
    E = idx.shape[1]
    if not (1 <= N <= MAX_N and 1 <= C <= MAX_C):
        raise ValueError(f"gather_rows_onehot: N={N} C={C} outside the "
                         f"kernel's N <= {MAX_N}, C <= {MAX_C}")
    out = _build.empty((B, E, C), torch.float32, dev)
    if B * E == 0:
        return out
    if not src.is_contiguous():
        src = src.contiguous()
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        idx = idx.to(torch.int32).contiguous()
    err = _build.lib().ogc_gather_rows_onehot(
        src.data_ptr(), idx.data_ptr(), B, N, C, E, out.data_ptr(),
        _build.raw_stream(dev))
    if err:
        _build.check(err, "ogc_gather_rows_onehot")
    gather_rows_onehot.launches += 1
    return out


def _launch_scatter(idx: torch.Tensor, cot: torch.Tensor, n: int,
                    plan: ScatterPlan) -> torch.Tensor:
    """Launches #8 with ``plan``'s window on CUDA tensors that
    ``scatter_add_rows_onehot`` has checked; ``chip_smoke.py`` calls it with
    other windows (``scatter_window``) for its edge cases and crossover."""
    B, E = idx.shape
    C = cot.shape[-1]
    out = _build.empty((B, n, C), torch.float32, cot.device)
    if B == 0:
        return out
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if not cot.is_contiguous():
        cot = cot.contiguous()
    err = _build.lib().ogc_scatter_add_rows_onehot(
        idx.data_ptr(), int(idx.dtype == torch.int64), cot.data_ptr(), B, E,
        C, n, plan.rows, out.data_ptr(), _build.raw_stream(cot.device.index))
    if err:
        _build.check(err, "ogc_scatter_add_rows_onehot")
    scatter_add_rows_onehot.launches += 1
    return out


def scatter_add_rows_onehot(idx: torch.Tensor, cot: torch.Tensor,
                            n: int) -> torch.Tensor:
    """(B, E) int in [0, n) x (B, E, C) float32 -> (B, n, C) float32, each
    row summed in ascending e; requires n <= 1024 and C <= 16 on the card."""
    if idx.is_cpu and cot.is_cpu:
        return scatter_add_rows_plain(idx, cot, n)
    _check("scatter_add_rows_onehot", ("idx", idx), ("cot", cot))
    if (idx.dim() != 2 or cot.dim() != 3 or cot.shape[:2] != idx.shape
            or cot.dtype != torch.float32
            or idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(
            f"scatter_add_rows_onehot: want (B, E) int idx and (B, E, C) "
            f"float32 cot, got {tuple(idx.shape)} {idx.dtype}, "
            f"{tuple(cot.shape)} {cot.dtype}")
    C = cot.shape[-1]
    if not (1 <= n <= MAX_N and 1 <= C <= MAX_C):
        raise ValueError(f"scatter_add_rows_onehot: n={n} C={C} outside the "
                         f"kernel's n <= {MAX_N}, C <= {MAX_C}")
    return _launch_scatter(idx, cot, n,
                           onehot_scatter_plan(idx.shape[0], n, C))


gather_rows_onehot.launches = 0
scatter_add_rows_onehot.launches = 0
