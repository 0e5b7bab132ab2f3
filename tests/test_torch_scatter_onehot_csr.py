"""The small-source scatter-add's walk (ogc_tpu_torch/csrc/onehot.cu, kernel
#8) on the CPU: a numpy model of its kernel held against the stable sort,
the plain version's bits and, on a hub, the Pallas kernel in interpret mode.

* The model runs the card's kernel step by step under the plan that
  ops/onehot.py::onehot_scatter_plan gives the case: per (cloud, window of
  ``rows`` destinations), per tile of 8192 edges, the indices become window
  offsets (-1 outside), and csr.cuh::stable_partition orders them: 16 warps
  each walk a contiguous slice of whole 32-edge steps, the lowest lane of a
  group of equal destinations adds the group's size to its warp's 16-bit
  histogram, the counts become positions (destinations, then warps, in
  order), and a second walk places each edge at its warp's position plus
  its rank among the earlier lanes of its group.  Every position is written
  once, within 16 bits, and the order is the stable sort of the window's
  edges.  csr.cuh::sum_segments then adds each (row, channel) segment in
  list order from +0.0 in float32, carried from tile to tile: the plain
  version's bits (int32 and int64 idx).
* The cases: SAPIEN's smooth KNN and ball rows, a hub of in-degree >= 1000,
  empty destinations, every edge to one destination, E not a multiple of
  the tile (two tiles and 37 edges), n = 1 and n = 1024, and C from 1 to
  16.  On the hub (integer-valued cotangents, which every order sums
  exactly) the sums also equal pallas_onehot.scatter_add_rows_onehot's.
* onehot_scatter_plan at every site chip_smoke.py drives, and
  scatter_window at the windows its edge cases force, stay inside the
  kernel's limits: at most 2048 (row, channel) sums a block, windows that
  cover n.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu.ops import pallas_onehot
from tests.torch_port_helper import pack, run_torch

WARPS, TILE, MAX_PAIRS, THREADS = 16, 8192, 4, 512


def _knn_rows(rng, b, n, k):
    """(b, n * k): k distinct destinations a query."""
    return np.stack([np.concatenate([rng.choice(n, k, replace=False)
                                     for _ in range(n)])
                     for _ in range(b)]).astype(np.int32)


def _ball_rows(rng, b, n, ns):
    """(b, n * ns) ball rows: under-full balls filled with their first."""
    idx = np.zeros((b, n, ns), np.int32)
    for bb in range(b):
        for q in range(n):
            k = rng.randint(1, ns + 1)
            idx[bb, q, :k] = np.sort(rng.choice(n, k, replace=False))
            idx[bb, q, k:] = idx[bb, q, 0]
    return idx.reshape(b, n * ns)


def _cases():
    """name -> (idx (B, E) int32, C, n, integer-valued cotangents)."""
    rng = np.random.RandomState(5)
    hub = rng.randint(0, 512, (2, 4096)).astype(np.int32)
    hub[:, 100:1300] = 7
    cases = {
        "sapien_knn": (_knn_rows(rng, 4, 512, 8), 8, 512, False),
        "sapien_ball": (_ball_rows(rng, 2, 512, 16), 8, 512, False),
        "hub": (hub, 8, 512, True),
        "empty_dests": (4 * rng.randint(0, 128, (2, 4096)).astype(np.int32),
                        8, 512, False),
        "one_dest": (np.full((2, 3000), 3, np.int32), 3, 512, False),
        "ragged_e": (rng.randint(0, 300, (1, 2 * TILE + 37)).astype(np.int32),
                     5, 300, False),
        "n1": (np.zeros((2, 2 * TILE + 3), np.int32), 2, 1, False),
        "n1024": (rng.randint(0, 1024, (2, 4099)).astype(np.int32), 16, 1024,
                  False),
    }
    for C in range(1, 17):
        cases[f"c{C}"] = (rng.randint(0, 100, (1, 1500)).astype(np.int32), C,
                          100, False)
    return cases


CASES = _cases()
# (B, n, C, rows or None) of every #8 call chip_smoke.py makes: SAPIEN's
# smooth groups, the window crossover, the edge cases at the plan's window
# (None) and at 32, 64 and 256 rows (through scatter_window).
PLAN_SITES = ([(32, 512, 8, r) for r in (None, 32, 64, 128, 256)]
              + [(b, n, c, r) for b, n, c in
                 [(4, 512, 8), (3, 512, 8), (2, 700, 8), (2, 1, 5),
                  (2, 1024, 16), (1, 300, 8)]
                 + [(2, 512, c) for c in range(1, 17)]
                 for r in (None, 32, 64, 256)])


def partition_model(keys, n, warps):
    """csr.cuh::stable_partition on keys (len,) in [0, n) or -1, step by
    step: (start (n + 1,), order: the kept items at their positions)."""
    ln = len(keys)
    sub = -(-ln // (32 * warps)) * 32
    slices = [(min(ln, w * sub), min(ln, min(ln, w * sub) + sub))
              for w in range(warps)]
    hist = np.zeros((warps, max(n, 1)), np.int64)
    for w, (r0, r1) in enumerate(slices):  # the count walk
        for rb in range(r0, r1, 32):
            d = keys[rb:min(rb + 32, r1)]
            groups, sizes = np.unique(d[d >= 0], return_counts=True)
            hist[w, groups] += sizes  # one leader a group
    assert hist.max(initial=0) <= 0xffff  # 16-bit counters
    start = np.concatenate([[0], np.cumsum(hist.sum(0))])[:n + 1]
    base = start[:n][None] + np.cumsum(hist[:, :n], 0) - hist[:, :n]
    assert base.max(initial=0) <= 0xffff  # 16-bit positions
    order = np.full(int(start[-1]), -1, np.int64)
    for w, (r0, r1) in enumerate(slices):  # the place walk
        h = base[w].copy()
        for rb in range(r0, r1, 32):
            d = keys[rb:min(rb + 32, r1)]
            lanes = np.arange(len(d))
            rank = ((d[:, None] == d[None, :])
                    & (lanes[None, :] < lanes[:, None])).sum(1)
            kept = np.flatnonzero(d >= 0)
            pos = h[d[kept]] + rank[kept]
            assert (order[pos] == -1).all() and len(set(pos)) == len(pos)
            order[pos] = rb + kept
            groups, sizes = np.unique(d[kept], return_counts=True)
            h[groups] += sizes
    assert (order >= 0).all()  # every position written once
    kept = np.flatnonzero(keys >= 0)
    np.testing.assert_array_equal(
        order, kept[np.argsort(keys[kept], kind="stable")])
    return start, order


def sum_segments_model(acc, start, rows_of, g):
    """csr.cuh::sum_segments: acc (rows, C) float32 += g[rows_of[s]] for s
    in each row's segment, in order (float32 adds, as __fadd_rn)."""
    deg = np.diff(start)
    for s in range(int(deg.max(initial=0))):
        r = np.flatnonzero(deg > s)
        acc[r] = acc[r] + g[rows_of[start[r] + s]]


def onehot_model(idx, g, n, rows):
    """(B, n, C) float32 as csrc/onehot.cu's scatter_rows_kernel sums
    idx (B, E) x g (B, E, C) with windows of ``rows``."""
    B, E = idx.shape
    out = np.zeros((B, n, g.shape[-1]), np.float32)
    for b in range(B):
        for w0 in range(0, n, rows):
            wn = min(rows, n - w0)
            acc = np.zeros((wn, g.shape[-1]), np.float32)
            for e0 in range(0, E, TILE):
                v = idx[b, e0:e0 + TILE].astype(np.int64)
                keys = np.where((v >= w0) & (v < w0 + wn), v - w0, -1)
                start, order = partition_model(keys, wn, WARPS)
                sum_segments_model(acc, start, e0 + order, g[b])
            out[b, w0:w0 + wn] = acc
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_scatter_onehot_csr")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"cases": {}, "plan_sites": PLAN_SITES}
    for name, (idx, C, n, integer) in CASES.items():
        x[name + "/idx"] = idx
        g = (rng.randint(-8, 9, idx.shape + (C,)) if integer
             else rng.randn(*idx.shape, C))
        x[name + "/g"] = g.astype(np.float32)
        cfg["cases"][name] = n
    inp = pack(str(tmp / "in.npz"), x, cfg)
    out, = run_torch([("scatter_onehot_csr", inp, str(tmp / "out.npz"))])
    return x, out


@pytest.mark.parametrize("name", list(CASES))
def test_model_sums_to_the_plain_bits(port, name):
    x, out = port
    idx, _, n, _ = CASES[name]
    rows = int(out[name + "/plan"][0])
    got = onehot_model(idx, x[name + "/g"], n, rows)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  out[name + "/sum"].view(np.uint32))
    np.testing.assert_array_equal(out[name + "/sum64"].view(np.uint32),
                                  out[name + "/sum"].view(np.uint32))
    deg = np.stack([np.bincount(i, minlength=n) for i in idx])
    if name == "hub":
        assert deg.max() >= 1000
    if name == "empty_dests":
        assert (deg == 0).any()


def test_hub_sums_match_pallas(port):
    x, out = port
    idx, _, n, _ = CASES["hub"]
    want = np.asarray(pallas_onehot.scatter_add_rows_onehot(
        jnp.asarray(idx), jnp.asarray(x["hub/g"]), n))
    np.testing.assert_array_equal(want.view(np.uint32),
                                  out["hub/sum"].view(np.uint32))


@pytest.mark.parametrize("k", range(len(PLAN_SITES)))
def test_plans_stay_inside_the_kernel_limits(port, k):
    _, out = port
    B, n, C, want_rows = PLAN_SITES[k]
    rows, windows = (int(v) for v in out["site_plans"][k])
    assert 1 <= rows <= n and rows * C <= MAX_PAIRS * THREADS
    assert windows * rows >= n > (windows - 1) * rows
    if want_rows is not None:
        assert rows == min(want_rows, n, MAX_PAIRS * THREADS // C)
    if (B, n, C, want_rows) == (32, 512, 8, None):
        assert (rows, windows) == (128, 4)  # 128 blocks at SAPIEN


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches_onehot"], [0, 0])
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
