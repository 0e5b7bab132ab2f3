"""The exact KNN's selection (ogc_tpu_torch/csrc/knn_exact.cu, kernel #2) on
the CPU: its packed key, a numpy model of the warp kernel's walk, and the
host-side dispatch of #2 and #12.

* The kernels' key (d2's float bits above the index, packed in an int64):
  sorting by it gives knn_exact_plain's stable sort and the Pallas
  knn_exact in interpret mode (indices bit-equal, distances within 1e-6:
  sqrt of equal d2), on grid clouds with tied rows, d2 = 0 (every point the
  same), M < 32, k = M and k = 64.
* The warp kernel's walk, step by step in numpy (32 lanes, a survivor
  buffer of 64 merged when it may not take another 32, ranks from a binary
  search of the list and a count over the buffer, tiles of 1024 points):
  the list it ends with is the stable sort's first k on the same clouds.
* The dispatch: ops/pool.py::pool_plan picks a compiled instance (S
  template or the runtime one, 16-byte chunks) at every pool the flow path
  sends to #12, and ops/knn.py::knn_plan a compiled kernel at every exact k
  chip_smoke.py drives.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

# (name, B, N, M, k, extent, step): a 1/8 and a 1/64 grid, a crowded 1/8
# grid where whole rows of d2 tie (a unit cube holds 512 sites), every point
# the same (d2 = 0), M < 32 with k = M, M = 33, a ragged M over two tiles.
CASES = [("grid8_k64", 2, 40, 1100, 64, 8.0, 1 / 8),
         ("grid64_k17", 2, 40, 700, 17, 8.0, 1 / 64),
         ("crowded_k32", 2, 40, 2048, 32, 1.0, 1 / 8),
         ("same_k64", 1, 20, 300, 64, 0.0, 1 / 8),
         ("m20_k20", 3, 25, 20, 20, 2.0, 1 / 8),
         ("m33_k33", 2, 25, 33, 33, 2.0, 1 / 8),
         ("m33_k1", 2, 25, 33, 1, 2.0, 1 / 8),
         ("ragged_k9", 1, 30, 1500, 9, 4.0, 1 / 8)]
COMPILED_S = (0, 4, 8, 16, 32)
THREAD_KCAP, WARP_KCAP = (4, 8), (32, 64)


def _cloud(rng, shape, extent, step):
    return (np.round(rng.rand(*shape) * extent / step) * step).astype(
        np.float32)


def _d2(q, p):
    """Direct-form d2 in float32, points minus query, ((dx*dx + dy*dy) +
    dz*dz): numpy rounds every operation (no FMA), as the kernel does."""
    d = p[:, None, :, :] - q[:, :, None, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def warp_select(d2_row, k, buf=64, tile=1024):
    """knn_warp_kernel's walk for one query, lane by lane: (keys, indices)
    of its final list."""
    keys = d2_row.astype(np.float32).view(np.uint32).astype(np.int64)
    lk, li = [], []
    thr = 0xFFFFFFFF
    bk, bi = [], []

    def merge():
        nonlocal lk, li, thr
        u, nv = len(bk), len(lk)
        new_k, new_i = [None] * k, [None] * k
        for pos in range(u):
            rank = int(np.searchsorted(np.array(lk, np.int64), bk[pos],
                                       "right"))
            rank += sum(bk[i] < bk[pos] or (bk[i] == bk[pos] and i < pos)
                        for i in range(u))
            if rank < k:
                assert new_k[rank] is None
                new_k[rank], new_i[rank] = bk[pos], bi[pos]
        for j in range(nv):
            rank = j + sum(v < lk[j] for v in bk)
            if rank < k:
                assert new_k[rank] is None
                new_k[rank], new_i[rank] = lk[j], li[j]
        n = min(nv + u, k)
        assert all(v is not None for v in new_k[:n])
        lk, li = new_k[:n], new_i[:n]
        if n == k:
            thr = lk[k - 1]
        bk.clear()
        bi.clear()

    m = len(keys)
    for t0 in range(0, m, tile):
        tn = min(tile, m - t0)
        for j0 in range(0, tn, 32):
            for lane in range(32):
                j = j0 + lane
                key = keys[t0 + j] if j < tn else 0xFFFFFFFF
                if key < thr:
                    bk.append(key)
                    bi.append(t0 + j)
            if len(bk) > buf - 32:
                merge()
    if bk:
        merge()
    return np.array(lk, np.int64), np.array(li, np.int64)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_knn_select")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"cases": {}}
    for name, b, n, m, k, extent, step in CASES:
        x[name + "/q"] = _cloud(rng, (b, n, 3), extent, step)
        x[name + "/p"] = _cloud(rng, (b, m, 3), extent, step)
        cfg["cases"][name] = k
    inp = pack(str(tmp / "in.npz"), x, cfg)
    out, plans = run_torch([("knn_select", inp, str(tmp / "out.npz")),
                            ("plans", inp, str(tmp / "plans.npz"))])
    out.update(plans)
    return x, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_packed_key_sort_matches_plain_and_pallas(port, case):
    from ogc_tpu.ops.pallas_knn import knn_exact

    x, out = port
    name, k = case[0], case[4]
    q, p = x[name + "/q"], x[name + "/p"]
    d, i = knn_exact(k, jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_array_equal(out[name + "/key_idx"], out[name + "/idx"])
    np.testing.assert_array_equal(out[name + "/key_idx"], np.asarray(i))
    np.testing.assert_allclose(out[name + "/dist"], np.asarray(d), rtol=0,
                               atol=1e-6)
    d2 = _d2(q, p)
    order = np.argsort(d2, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(out[name + "/key_idx"], order)
    np.testing.assert_array_equal(out[name + "/key_d2"],
                                  np.take_along_axis(d2, order, -1))
    if name.startswith("same"):
        assert (out[name + "/dist"] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_warp_walk_matches_stable_sort(port, case):
    x, out = port
    name, k = case[0], case[4]
    d2 = _d2(x[name + "/q"], x[name + "/p"])
    for b in range(d2.shape[0]):
        for n in range(0, d2.shape[1], 7):
            keys, idx = warp_select(d2[b, n], k)
            np.testing.assert_array_equal(idx, out[name + "/key_idx"][b, n])
            np.testing.assert_array_equal(
                keys, d2[b, n][idx].view(np.uint32).astype(np.int64))


def test_pool_plans_pick_compiled_instances(port):
    _, out = port
    plans = out["pool_plans"]
    assert len(plans) >= 40
    for s, c, size, s_t, vec in plans:
        assert s_t in COMPILED_S and s_t in (0, s)
        assert s_t == s  # every flow-path S (4, 8, 16, 32) is compiled
        assert vec and (c * size) % 16 == 0


def test_knn_plans_pick_compiled_kernels(port):
    """A compiled kernel and list for every search; the thread kernel only
    for k <= 8 over >= 65536 queries (the FP three_nn of 8192 queries at B
    8 and 16), the warp kernel for every k = 64 search."""
    _, out = port
    plans = out["knn_plans"]
    assert {1, 3, 8, 16, 32, 64} <= set(plans[:, 1].tolist())
    for n, k, warp, kcap in plans:
        assert k <= kcap and kcap in (WARP_KCAP if warp else THREAD_KCAP)
        assert warp == (k > 8 or n < 65536)
    assert not plans[(plans[:, 0] == 16 * 8192) & (plans[:, 1] == 3), 2].any()
    assert plans[plans[:, 1] == 64, 2].all()
