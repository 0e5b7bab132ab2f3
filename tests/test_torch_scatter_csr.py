"""The scatter-add's CSR build (ogc_tpu_torch/csrc/scatter_add.cu, kernel
#11) on the CPU: a numpy model of its three kernels held against the plain
version's prologue, and the model's accumulation order against the plain
version's bits.

* The model runs the card's build step by step under the plan that
  ops/scatter.py::csr_plan gives the case: csr_count (per chunk, 8 warps
  each walking a contiguous eighth 32 rows at a time, the lowest lane of a
  group of equal destinations adding the group's size to its warp's
  histogram; the chunk's counts and its rows below each destination tile),
  csr_scan (per destination tile, from the rows below it, in (destination,
  chunk) order) and csr_place (per-warp offsets, a row's rank among the
  earlier lanes of its group).  Its (order, start) equal ``segments``'
  stable sort, and every position is written once.
* Summing each segment in order from +0.0 in float32 gives the plain
  version's bits, with int32 and int64 idx; on a hub case also the Pallas
  scatter_add_rows in interpret mode.
* The cases: uniform KNN rows, smooth-ball rows with hub destinations of
  in-degree >= 1000, every row to one destination, empty destinations, R
  not a multiple of the chunk, B = 1 and B = 16, odd n_dest, and n_dest
  over one window (8192) of the build.
* csr_plan at every site chip_smoke.py drives stays inside the kernels'
  limits (16-bit chunk offsets, a scan tile of <= 8192 entries).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

WARPS = 8
MAX_CHUNK, SCAN_ENTRIES, MAX_WINDOW = 65280, 8192, 8192


def _knn_rows(rng, b, m, s, n):
    """(b, m * s): s distinct destinations a query."""
    return np.stack([np.concatenate([rng.choice(n, s, replace=False)
                                     for _ in range(m)])
                     for _ in range(b)]).astype(np.int32)


def _ball_rows(rng, b, m, s, n, hubs):
    """(b, m * s) ball-query rows: under-full groups padded with their
    first index; the first ``hubs`` groups list destination 7 only."""
    idx = np.zeros((b, m, s), np.int32)
    for bb in range(b):
        for q in range(m):
            k = rng.randint(1, s + 1)
            idx[bb, q, :k] = rng.choice(n, k, replace=False)
            idx[bb, q, k:] = idx[bb, q, 0]
        idx[bb, :hubs] = 7
    return idx.reshape(b, m * s)


def _cases(rng):
    """name -> (idx (B, R) int32, C, n_dest)."""
    return {
        "knn_uniform": (_knn_rows(rng, 2, 250, 16, 250), 10, 250),
        "ball_hubs": (_ball_rows(rng, 2, 128, 32, 512, 36), 10, 512),
        "one_dest": (np.full((2, 700), 2, np.int32), 3, 5),
        "empty_dests": (3 * rng.randint(0, 100, (2, 900)).astype(np.int32),
                        33, 300),
        "ragged_r_b1": (rng.randint(0, 77, (1, 1000)).astype(np.int32), 1, 77),
        "b16": (rng.randint(0, 64, (16, 384)).astype(np.int32), 131, 64),
        "odd_n": (_knn_rows(rng, 3, 100, 20, 333), 99, 333),
        "windows": (rng.randint(0, 20001, (1, 40000)).astype(np.int32), 3,
                    20001),
    }


# (B, R, n_dest) of every #11 call chip_smoke.py makes on the paths: the
# KITTI-SF parity sites, the mxu general route, SAPIEN's smooth groups.
PLAN_SITES = [(4, 262144, 8192), (4, 524288, 8192), (16, 65536, 2048),
              (16, 32768, 1024), (16, 3072, 512), (16, 6144, 1024),
              (16, 24576, 2048), (4, 786432, 8192), (32, 4096, 512),
              (32, 8192, 512), (1, 16000000, 20000)]


def _walk(ib, r0, r1, w0, wn):
    """A warp's steps over rows [r0, r1): (rows, window offsets, in)."""
    for rb in range(r0, r1, 32):
        r = np.arange(rb, min(rb + 32, r1))
        v = ib[r].astype(np.int64)
        inw = (v >= w0) & (v < w0 + wn)
        yield r, v - w0, inw


def _warp_rows(R, chunk, c, w):
    sub = chunk // WARPS
    r0 = min(R, c * chunk + w * sub)
    return r0, min(R, r0 + sub)


def _count(ib, R, chunk, c, w0, wn):
    """The warps' histograms of one window (csr_count / csr_place)."""
    hist = np.zeros((WARPS, wn), np.int64)
    for w in range(WARPS):
        for _, d, inw in _walk(ib, *_warp_rows(R, chunk, c, w), w0, wn):
            groups, sizes = np.unique(d[inw], return_counts=True)
            hist[w, groups] += sizes  # one leader a group
    assert hist.sum(0).max(initial=0) <= MAX_CHUNK  # 16-bit offsets
    return hist


def csr_model(idx, n_dest, plan):
    """(order, start) as csrc/scatter_add.cu's three kernels build them."""
    chunk, nc, dt, win, n_tiles, _ = (int(v) for v in plan)
    B, R = idx.shape
    H = np.zeros((B, nc, n_dest), np.int64)
    cum = np.zeros((B, nc, n_tiles), np.int64)
    windows = range(0, n_dest, win)
    for b in range(B):  # csr_count
        for c in range(nc):
            carry = 0
            for w0 in windows:
                wn = min(win, n_dest - w0)
                tot = _count(idx[b], R, chunk, c, w0, wn).sum(0)
                H[b, c, w0:w0 + wn] = tot
                tsum = np.add.reduceat(tot, np.arange(0, wn, dt))
                cum[b, c, w0 // dt:w0 // dt + len(tsum)] = (
                    carry + np.cumsum(tsum) - tsum)
                carry += tsum.sum()
    start = np.zeros(B * n_dest + 1, np.int64)
    for b in range(B):  # csr_scan
        for t in range(n_tiles):
            d0 = t * dt
            dn = min(dt, n_dest - d0)
            base = b * R + cum[b, :, t].sum()
            block = H[b, :, d0:d0 + dn].T.ravel()  # (destination, chunk)
            H[b, :, d0:d0 + dn] = (base + np.cumsum(block) - block).reshape(
                dn, nc).T
            start[b * n_dest + d0:b * n_dest + d0 + dn] = H[b, 0, d0:d0 + dn]
    start[B * n_dest] = B * R
    order = np.full(B * R, -1, np.int64)
    for b in range(B):  # csr_place
        for c in range(nc):
            for w0 in windows:
                wn = min(win, n_dest - w0)
                hist = _count(idx[b], R, chunk, c, w0, wn)
                off = np.cumsum(hist, 0) - hist
                for w in range(WARPS):
                    for r, d, inw in _walk(idx[b], *_warp_rows(R, chunk, c, w),
                                           w0, wn):
                        step = {}
                        for lane in np.flatnonzero(inw):
                            rank = step.get(d[lane], 0)
                            pos = H[b, c, w0 + d[lane]] + off[w, d[lane]] + rank
                            assert order[pos] == -1
                            order[pos] = b * R + r[lane]
                            step[d[lane]] = rank + 1
                        for dd, size in step.items():
                            off[w, dd] += size
    return order, start


def segment_sums(order, start, g, n_dest):
    """Each destination's rows summed in CSR order from +0.0, float32."""
    B, R, C = g.shape
    rows = g.reshape(B * R, C)
    out = np.zeros((B * n_dest, C), np.float32)
    deg = np.diff(start)
    for s in range(int(deg.max(initial=0))):
        d = np.flatnonzero(deg > s)
        out[d] = out[d] + rows[order[start[d] + s]]
    return out.reshape(B, n_dest, C)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_scatter_csr")
    rng = np.random.RandomState(0)
    cases = _cases(rng)
    x, cfg = {}, {"cases": {}, "plan_sites": PLAN_SITES}
    for name, (idx, C, n_dest) in cases.items():
        x[name + "/idx"] = idx
        x[name + "/g"] = rng.randn(*idx.shape, C).astype(np.float32)
        cfg["cases"][name] = n_dest
    inp = pack(str(tmp / "in.npz"), x, cfg)
    out, = run_torch([("scatter_csr", inp, str(tmp / "out.npz"))])
    return cases, x, out


@pytest.mark.parametrize("name", list(_cases(np.random.RandomState(0))))
def test_model_csr_is_the_stable_sort(port, name):
    cases, x, out = port
    idx, _, n_dest = cases[name]
    order, start = csr_model(idx, n_dest, out[name + "/plan"])
    np.testing.assert_array_equal(order, out[name + "/order"])
    np.testing.assert_array_equal(start, out[name + "/start"])
    deg = np.diff(start)
    if name == "ball_hubs":
        assert deg.max() >= 1000
    if name == "empty_dests":
        assert (deg == 0).any()
    if name == "windows":
        assert int(out[name + "/plan"][3]) < n_dest  # several windows


@pytest.mark.parametrize("name", list(_cases(np.random.RandomState(0))))
def test_model_order_sums_to_the_plain_bits(port, name):
    cases, x, out = port
    _, _, n_dest = cases[name]
    got = segment_sums(out[name + "/order"], out[name + "/start"],
                       x[name + "/g"], n_dest)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  out[name + "/sum"].view(np.uint32))
    np.testing.assert_array_equal(out[name + "/sum64"].view(np.uint32),
                                  out[name + "/sum"].view(np.uint32))


def test_hub_sums_match_pallas(port):
    from ogc_tpu.ops.pallas_scatter import scatter_add_rows

    cases, x, out = port
    idx, _, n_dest = cases["ball_hubs"]
    want = np.asarray(scatter_add_rows(jnp.asarray(idx),
                                       jnp.asarray(x["ball_hubs/g"]), n_dest))
    np.testing.assert_array_equal(want.view(np.uint32),
                                  out["ball_hubs/sum"].view(np.uint32))


def test_plans_stay_inside_the_kernel_limits(port):
    _, _, out = port
    for B, R, n_dest, chunk, nc, dt, win, n_tiles, words in out["site_plans"]:
        assert chunk % 256 == 0 and 256 <= chunk <= MAX_CHUNK
        assert nc * chunk >= R > (nc - 1) * chunk
        assert dt >= 32 and dt & (dt - 1) == 0 and nc * dt <= SCAN_ENTRIES
        assert win == min(n_dest, MAX_WINDOW) and (win == n_dest
                                                   or win % dt == 0)
        assert n_tiles * dt >= n_dest > (n_tiles - 1) * dt
        assert nc == 1 or nc * n_dest <= R // 2  # chunk counts <= R / 2
        assert words == B * R + B * n_dest + 1 + B * nc * (n_dest + n_tiles)
