"""Block-min approximate KNN and ball query: the CUDA kernels
(csrc/knn_blockmin.cu; the ball mode in csrc/ball_query.cu) and their plain
PyTorch versions.

Replaces ogc_tpu/ops/pallas_knn.py::_knn_kernel in its thinned modes (entry
points ``knn_blockmin`` and ``ball_query_blockmin``), plus the
``_fill_balls`` padding that ogc_tpu/ops/core.py applies to the ball mode's
output: both versions here return the filled ball.  The candidates are
padded to a multiple of 1024 with points at 1e6 and cut into runs of
``blk``; each run keeps one winner.  KNN keys pack a run's minimum d2 and
its index into one int32 (the d2's low ``idx_bits`` bits give way to the
index, after the minimum over the full d2), so the returned distances are
the truncated ones the JAX package returns, and callers (the radius
clamps, the interpolation weights) use them as they are.

The wrappers route by the tensors' device: CPU tensors take the plain
versions; CUDA tensors launch the kernel or raise.  ``knn_blockmin.launches``
and ``ball_query_blockmin.launches`` count kernel launches.
``blockmin_plan`` picks the KNN kernel: one thread per query with a
register list for k up to ``THREAD_MAX_K`` over at least
``THREAD_MIN_QUERIES`` queries, else one warp per two queries (lanes own
whole runs; the warp selection of csrc/neighbors.cuh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ogc_tpu_torch.ops import _build
from ogc_tpu_torch.ops.ball import fill_balls, launch_ball, radius_sq
from ogc_tpu_torch.ops.knn import check_clouds, pair_d2

MAX_K = 64
TILE = 1024       # candidate padding (pallas_knn.py::_TM)
PAD = 1e6         # pad point coordinate (pallas_knn.py:1443)
BALL_INVALID = 2 ** 30  # a run with no in-radius point (pallas_knn.py:65)
#: The run lengths block_size gives (and the kernels are compiled for).
BLKS = (4, 8, 16, 32)
#: The thread kernel takes k <= THREAD_MAX_K over at least
#: THREAD_MIN_QUERIES queries (B x N); the warp kernel (two queries a warp)
#: takes the rest.  The crossover measured on the H100 (chip_smoke.py's
#: blockmin_crossover) is in PERF.md.
THREAD_MAX_K = 8
THREAD_MIN_QUERIES = 16384
#: List capacities the kernels are compiled for: the thread kernel's
#: register list, and the warp kernel's k <= 32 or k <= 64.
THREAD_KCAP = (4, 8)
WARP_KCAP = (32, 64)


def pick_block(m: int, k: int, recall_target: float = 0.95) -> int:
    """Largest run length keeping the expected recall >= target
    (pallas_knn.py::pick_block): blk <= 2 M (1 - r) / (k - 1)."""
    if k <= 1:
        return 32
    cap = int(2 * m * (1.0 - recall_target) / (k - 1))
    for blk in (32, 16, 8, 4):
        if blk <= cap:
            return blk
    return 4


def block_size(m: int, k: int, recall_target: float) -> int:
    """pick_block, halved while fewer than k runs would hold real points
    (pallas_knn.py:1432-1436)."""
    blk = pick_block(m, k, recall_target)
    while blk > 4 and -(-m // blk) < k:
        blk //= 2
    if -(-m // blk) < k:
        raise ValueError(f"blockmin: {m} points in runs of {blk} give fewer "
                         f"than k={k} winners")
    return blk


def _padded(points: torch.Tensor) -> torch.Tensor:
    B, M, _ = points.shape
    mp = -(-M // TILE) * TILE
    if mp == M:
        return points.float()
    pad = points.new_full((B, mp - M, 3), PAD, dtype=torch.float32)
    return torch.cat([points.float(), pad], 1)


def _run_d2(q: torch.Tensor, p: torch.Tensor, blk: int) -> torch.Tensor:
    """Direct-form d2 of queries (B, n, 3) against padded points (B, Mp, 3),
    as (B, n, Mp / blk, blk)."""
    return pair_d2(q, p).unflatten(-1, (-1, blk))


def knn_blockmin_plain(query: torch.Tensor, points: torch.Tensor, k: int,
                       recall_target: float, chunk: int = 512
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run minima (ties to the lowest index), packed int32 keys, the k
    smallest ascending.  Queries go in chunks so the (B, chunk, Mp) d2 tile
    stays bounded.

    :param query: (B, N, 3); :param points: (B, M, 3).
    :return: (dist (B, N, k) float32, truncated; idx (B, N, k) int32).
    """
    M = points.shape[1]
    blk = block_size(M, k, recall_target)
    p = _padded(points)
    mp = p.shape[1]
    mask_low = (1 << max(1, (mp - 1).bit_length())) - 1
    ids = torch.arange(mp, device=p.device, dtype=torch.int32).reshape(-1, blk)
    dists, idxs = [], []
    for q in query.float().split(chunk, dim=1):
        d3 = _run_d2(q, p, blk)
        vmin = d3.amin(-1)
        amin = torch.where(d3 == vmin[..., None], ids, BALL_INVALID).amin(-1)
        keys = (vmin.view(torch.int32) & ~mask_low) | amin
        top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
        idxs.append(top & mask_low)
        # sqrt in float64, rounded once to float32, is the correctly rounded
        # float32 sqrt (the kernel's sqrtf, jnp.sqrt); torch's float32 sqrt
        # on the CPU is not.
        d2 = torch.clamp((top & ~mask_low).view(torch.float32), min=0.0)
        dists.append(torch.sqrt(d2.double()).float())
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def ball_query_blockmin_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                              radius: float, nsample: int,
                              chunk: int = 512) -> torch.Tensor:
    """Each run's lowest in-radius index (strict d2 < r^2), the nsample
    smallest run keys ascending, then ``fill_balls``.  The run length
    takes the default recall 0.95, as ops/core.py calls it.

    :param xyz: (B, N, 3) points; :param new_xyz: (B, M, 3) centres.
    :return: (B, M, nsample) int32.
    """
    N = xyz.shape[1]
    blk = block_size(N, nsample, 0.95)
    p = _padded(xyz)
    ids = torch.arange(p.shape[1], device=p.device,
                       dtype=torch.int32).reshape(-1, blk)
    r2 = radius_sq(radius)
    cands = []
    for c in new_xyz.float().split(chunk, dim=1):
        keys = torch.where(_run_d2(c, p, blk) < r2, ids, BALL_INVALID).amin(-1)
        cands.append(torch.topk(keys, nsample, dim=-1, largest=False,
                                sorted=True).values)
    return fill_balls(torch.cat(cands, 1), nsample, BALL_INVALID)


def blockmin_plan(k: int, queries: int, blk: int,
                  variant: Optional[str] = None) -> Tuple[str, int]:
    """(kernel, list capacity) for k over ``queries`` (B x N) queries in
    runs of ``blk``: ``"thread"`` for k <= THREAD_MAX_K over >=
    THREAD_MIN_QUERIES queries, else ``"warp"``, unless ``variant`` names
    one."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"blockmin_plan: k={k} outside 1..{MAX_K}")
    if blk not in BLKS:
        raise ValueError(f"blockmin_plan: blk={blk} not in {BLKS}")
    variant = variant or (
        "thread" if k <= THREAD_MAX_K and queries >= THREAD_MIN_QUERIES
        else "warp")
    caps = {"thread": THREAD_KCAP, "warp": WARP_KCAP}[variant]
    if k > caps[-1]:
        raise ValueError(f"blockmin_plan: the {variant} kernel takes k <= "
                         f"{caps[-1]}, not {k}")
    return variant, next(c for c in caps if k <= c)


def knn_blockmin(query: torch.Tensor, points: torch.Tensor, k: int,
                 recall_target: float, variant: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-min approximate KNN of ``query`` (B, N, 3) in ``points``
    (B, M, 3): (dist, idx), each (B, N, k), ascending by key.  ``variant``
    (``"thread"`` or ``"warp"``) overrides ``blockmin_plan``'s kernel on the
    card."""
    if query.device.type == "cpu" and points.device.type == "cpu":
        return knn_blockmin_plain(query, points, k, recall_target)
    check_clouds("knn_blockmin", query, points, "query", "points")
    B, N, _ = query.shape
    M = points.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_blockmin: k={k} must be in 1..{MAX_K}")
    blk = block_size(M, k, recall_target)
    kernel, cap = blockmin_plan(k, B * N, blk, variant)
    mp = -(-M // TILE) * TILE
    query = query.contiguous()
    points = points.contiguous()
    dist = _build.empty((B, N, k), torch.float32, query.device)
    idx = _build.empty((B, N, k), torch.int32, query.device)
    if B * N == 0:
        return dist, idx
    stream = torch.cuda.current_stream(query.device).cuda_stream
    err = _build.lib().ogc_knn_blockmin(
        query.data_ptr(), points.data_ptr(), B, N, M, mp, k, blk,
        max(1, (mp - 1).bit_length()), int(kernel == "warp"), cap,
        dist.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "ogc_knn_blockmin")
    knn_blockmin.launches += 1
    return dist, idx


def ball_query_blockmin(xyz: torch.Tensor, new_xyz: torch.Tensor,
                        radius: float, nsample: int) -> torch.Tensor:
    """Block-min approximate ball query of the centres ``new_xyz``
    (B, M, 3) among ``xyz`` (B, N, 3): the filled balls, (B, M, nsample)
    int32."""
    if xyz.device.type == "cpu" and new_xyz.device.type == "cpu":
        return ball_query_blockmin_plain(xyz, new_xyz, radius, nsample)
    check_clouds("ball_query_blockmin", xyz, new_xyz, "xyz", "new_xyz")
    N = xyz.shape[1]
    if nsample < 1:
        raise ValueError(f"ball_query_blockmin: nsample={nsample} must be "
                         f">= 1")
    idx = launch_ball(xyz, new_xyz, radius, nsample,
                      block_size(N, nsample, 0.95), -(-N // TILE) * TILE)
    if idx.numel():
        ball_query_blockmin.launches += 1
    return idx


knn_blockmin.launches = 0
ball_query_blockmin.launches = 0
