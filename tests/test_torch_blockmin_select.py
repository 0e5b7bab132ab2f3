"""The block-min KNN's selection (ogc_tpu_torch/csrc/knn_blockmin.cu, kernel
#3) on the CPU: numpy models of its warp kernel's walk, held against the
plain version (the torch side on CPU tensors) and the Pallas kernel in
interpret mode, and the host-side choice of the kernel.

* A run's winner as a lane takes it: the run's candidates in index order,
  replaced only by a strictly smaller FULL d2 (ties keep the lower index),
  and only then truncated into the packed key (d2 bits above idx_bits, the
  index below).  On the low-bit case (two candidates of one run whose d2
  agree above idx_bits, the lower index the farther) the other order,
  truncate and then take the smallest key, keeps the lower index; the
  model, the plain version and Pallas keep the nearer candidate.
* The tile as the warp kernel stages it: entry c at slot c ^ ((c / blk) &
  7), a permutation of the tile; lane l reads candidate t of its runs l,
  l + 32, ... at slot c ^ (l & 7); a quarter-warp's reads and 8
  consecutive staging writes each hit 8 distinct 16-byte bank groups.
* The warp selection over run keys, step by step: lane l offers run 32 s +
  l of each tile's step s, up to four steps a vote, the keys below the
  k-th key appended in lane order to a buffer of 64 that is merged into a
  list of k when it may not take another 32, by the kernel's bitonic
  network (the buffer sorted, min(list[i], buffer[63 - i]), six more
  stages).  The network keeps the smallest keys of any list and buffer;
  the list the walk ends with is the k smallest run keys, as idx and
  truncated dist bit-equal to the plain version's and the Pallas
  kernel's.
* blockmin_plan gives a compiled kernel at every #3 KNN site chip_smoke.py
  drives: the thread kernel only for k <= 8 over >= 16384 queries (every
  k = 3 site), the warp kernel (k <= 32 or 64) for the rest.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

TILE, PAD = 1024, np.float32(1e6)
BLKS = (4, 8, 16, 32)
# (name, B, N, M, k, recall, kind): grid clouds (ties), continuous clouds,
# the low-bit case; M 1100, 1500 and 2047 are ragged over two tiles; the
# recalls give runs of 4 (k 64; k 16 at 0.99), 8 (k 16 at 0.95), 16 (k 16
# at 0.9) and 32 (k 3 at 0.8, k 1).
CASES = [("grid_k64_blk4", 2, 24, 1100, 64, 0.95, "grid"),
         ("grid_k16_blk8", 2, 24, 2048, 16, 0.95, "grid"),
         ("scene_k16_blk16", 2, 24, 2047, 16, 0.9, "scene"),
         ("scene_k3_blk32", 2, 24, 1500, 3, 0.8, "scene"),
         ("grid_k1_blk32", 1, 16, 1024, 1, 0.95, "grid"),
         ("lowbits_blk4", 1, 8, 2048, 16, 0.99, "lowbits"),
         ("lowbits_blk16", 1, 8, 2048, 16, 0.9, "lowbits")]
THREAD_MAX_K, THREAD_MIN_QUERIES = 8, 16384


def _cloud(rng, b, n, kind):
    if kind == "grid":
        return (np.round(rng.rand(b, n, 3) * 64) / 8).astype(np.float32)
    if kind == "scene":
        return (rng.rand(b, n, 3) * 8).astype(np.float32)
    # The low-bit case: every point far away but 8 at (1 + 2^-23, 0, 0),
    # d2 1 + 2^-22, and 9 at (1, 0, 0), d2 1, against queries at the
    # origin: one run (of 4 to 32) holds both.
    p = (100 + 30 * rng.rand(b, n, 3)).astype(np.float32)
    p[:, 8] = [np.nextafter(np.float32(1), np.float32(2)), 0, 0]
    p[:, 9] = [1, 0, 0]
    return p


def _d2(q, p):
    """Direct-form d2 in float32, points minus query, ((dx*dx + dy*dy) +
    dz*dz): numpy rounds every operation (no FMA), as the kernel does."""
    d = p[:, None, :, :] - q[:, :, None, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def pick_block(m, k, recall):
    if k <= 1:
        return 32
    cap = int(2 * m * (1.0 - recall) / (k - 1))
    return next((b for b in (32, 16, 8, 4) if b <= cap), 4)


def block_size(m, k, recall):
    blk = pick_block(m, k, recall)
    while blk > 4 and -(-m // blk) < k:
        blk //= 2
    return blk


def padded_d2(q, p):
    """d2 against the points padded to a multiple of 1024 with (1e6, 1e6,
    1e6), and idx_bits."""
    b, m, _ = p.shape
    mp = -(-m // TILE) * TILE
    pp = np.concatenate([p, np.full((b, mp - m, 3), PAD, np.float32)], 1)
    return _d2(q, pp), max(1, (mp - 1).bit_length())


def lane_run_keys(d2_row, blk, idx_bits):
    """Each run's key as its lane takes it: a strict-< walk over the full
    d2 in index order, then the truncation.  uint32 keys, one per run."""
    runs = d2_row.reshape(-1, blk)
    vmin, amin = runs[:, 0].copy(), np.zeros(len(runs), np.int64)
    for t in range(1, blk):
        better = runs[:, t] < vmin
        vmin = np.where(better, runs[:, t], vmin)
        amin = np.where(better, t, amin)
    mask = np.uint32((1 << idx_bits) - 1)
    idx = np.arange(len(runs)) * blk + amin
    return (vmin.view(np.uint32) & ~mask) | idx.astype(np.uint32)


def truncated_run_keys(d2_row, blk, idx_bits):
    """The other order: truncate every candidate's key, then the run's
    smallest key."""
    mask = np.uint32((1 << idx_bits) - 1)
    keys = (d2_row.view(np.uint32) & ~mask) | np.arange(
        len(d2_row), dtype=np.uint32)
    return keys.reshape(-1, blk).min(-1)


def staged_slot(c, blk):
    return c ^ ((c // blk) & 7)


def bitonic_stage(x, size, stride):
    """One stage of the kernel's network over 64 keys: element e meets
    e ^ stride and keeps the smaller key when ((e & stride) == 0) equals
    ((e & size) == 0)."""
    e = np.arange(64)
    p = x[e ^ stride]
    keep_min = ((e & stride) == 0) == ((e & size) == 0)
    return np.where(keep_min, np.minimum(x, p), np.maximum(x, p))


def bitonic_sort64(x):
    for size in (2, 4, 8, 16, 32, 64):
        stride = size // 2
        while stride:
            x = bitonic_stage(x, size, stride)
            stride //= 2
    return x


def bitonic_merge(lk, bk, k, lpl):
    """neighbors.cuh's merge of unique keys: the buffer padded to 64 with
    0xffffffff and sorted; min(list[i], buffer[63 - i]) (the list padded to
    64); six stages; the first 32 * lpl kept."""
    pad = 0xFFFFFFFF
    b = np.full(64, pad, np.int64)
    b[:len(bk)] = bk
    lst = np.full(64, pad, np.int64)
    lst[:min(len(lk), 32 * lpl)] = lk[:32 * lpl]
    x = np.minimum(lst, bitonic_sort64(b)[::-1])
    for stride in (32, 16, 8, 4, 2, 1):
        x = bitonic_stage(x, 64, stride)
    return x[:32 * lpl]


def warp_walk(run_keys, k, blk, buf=64):
    """blockmin_warp_kernel's selection for one query, lane by lane: the
    sorted list of k uint32 keys it ends with."""
    steps = TILE // (32 * blk)
    per_vote = min(steps, 4)
    lpl = 1 if k <= 32 else 2
    lk, bk = np.zeros(0, np.int64), []
    nv, thr = 0, 0xFFFFFFFF

    def merge():
        nonlocal lk, nv, thr
        lk = bitonic_merge(lk[:nv], bk, k, lpl)
        nv = min(nv + len(bk), k)
        assert (lk[:nv] < 0xFFFFFFFF).all()
        if nv == k:
            thr = int(lk[k - 1])
        bk.clear()

    tiles = run_keys.reshape(-1, TILE // blk)
    for tile in tiles:
        for s0 in range(0, steps, per_vote):
            group = tile[32 * s0:32 * (s0 + per_vote)].astype(np.int64)
            if not (group < thr).any():
                continue
            for v in range(per_vote):
                for lane in range(32):
                    key = int(tile[32 * (s0 + v) + lane])
                    if key < thr:
                        bk.append(key)
                if len(bk) > buf - 32:
                    merge()
    if bk:
        merge()
    return lk[:k]


def keys_to_output(keys, idx_bits):
    """(dist, idx) of packed keys: the truncated d2's correctly rounded
    float32 square root, and the low bits."""
    mask = (1 << idx_bits) - 1
    d2 = (keys & ~mask).astype(np.uint32).view(np.float32)
    return (np.sqrt(np.maximum(d2, 0).astype(np.float64)).astype(np.float32),
            (keys & mask).astype(np.int32))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_blockmin_select")
    rng = np.random.RandomState(4)
    x, cfg = {}, {"cases": {}}
    for name, b, n, m, k, recall, kind in CASES:
        if kind == "lowbits":
            x[name + "/q"] = np.zeros((b, n, 3), np.float32)
        else:
            x[name + "/q"] = _cloud(rng, b, n, kind)
        x[name + "/p"] = _cloud(rng, b, m, kind)
        cfg["cases"][name] = [k, recall]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("blockmin_select", inp, str(tmp / "out.npz"))],
                       exact=False)
    return x, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_lane_run_minimum_matches_plain_and_pallas(port, case):
    """The model's k smallest lane-taken run keys, as (dist, idx), equal
    the plain version's and the Pallas kernel's bit for bit."""
    from ogc_tpu.ops.pallas_knn import knn_blockmin

    x, out = port
    name, _, _, m, k, recall, _ = case
    q, p = x[name + "/q"], x[name + "/p"]
    blk = block_size(m, k, recall)
    d2, idx_bits = padded_d2(q, p)
    keys = np.stack([[np.sort(lane_run_keys(row, blk, idx_bits))[:k]
                      for row in cloud] for cloud in d2]).astype(np.int64)
    dist, idx = keys_to_output(keys, idx_bits)
    np.testing.assert_array_equal(idx, out[name + "/idx"])
    np.testing.assert_array_equal(dist, out[name + "/dist"])
    pd, pi = knn_blockmin(k, jnp.asarray(q), jnp.asarray(p),
                          recall_target=recall, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(pi))
    np.testing.assert_array_equal(dist, np.asarray(pd))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_warp_walk_selects_smallest_run_keys(port, case):
    x, out = port
    name, _, _, m, k, recall, _ = case
    blk = block_size(m, k, recall)
    d2, idx_bits = padded_d2(x[name + "/q"], x[name + "/p"])
    for b in range(d2.shape[0]):
        for n in range(0, d2.shape[1], 3):
            run_keys = lane_run_keys(d2[b, n], blk, idx_bits)
            got = warp_walk(run_keys, k, blk)
            np.testing.assert_array_equal(
                got, np.sort(run_keys.astype(np.int64))[:k])
            dist, idx = keys_to_output(got, idx_bits)
            np.testing.assert_array_equal(idx, out[name + "/idx"][b, n])
            np.testing.assert_array_equal(dist, out[name + "/dist"][b, n])


@pytest.mark.parametrize("case", [c for c in CASES if c[6] == "lowbits"],
                         ids=lambda c: c[0])
def test_low_bits_take_the_full_minimum(port, case):
    """Candidates 8 and 9 share a run and agree above idx_bits; 9 is the
    nearer.  The full minimum keeps 9 (so does every output); truncating
    first would keep 8."""
    x, out = port
    name, _, _, m, k, recall, _ = case
    blk = block_size(m, k, recall)
    d2, idx_bits = padded_d2(x[name + "/q"], x[name + "/p"])
    row = d2[0, 0]
    assert row[8] > row[9]
    mask = np.uint32((1 << idx_bits) - 1)
    assert row[8].view(np.uint32) & ~mask == row[9].view(np.uint32) & ~mask
    run = 8 // blk
    assert lane_run_keys(row, blk, idx_bits)[run] & mask == 9
    assert truncated_run_keys(row, blk, idx_bits)[run] & mask == 8
    assert (out[name + "/idx"][..., 0] == 9).all()
    assert (out[name + "/dist"][..., 0] == 1.0).all()


@pytest.mark.parametrize("blk", BLKS)
def test_staged_tile_is_a_conflict_free_permutation(blk):
    slots = np.array([staged_slot(c, blk) for c in range(TILE)])
    assert sorted(slots) == list(range(TILE))
    # 8 consecutive staging writes: 8 distinct 16-byte bank groups.
    assert all(len(set(slots[c:c + 8] % 8)) == 8 for c in range(0, TILE, 8))
    for s in range(TILE // (32 * blk)):
        for t in range(blk):
            cand = np.array([(32 * s + lane) * blk + t for lane in range(32)])
            read = cand ^ (np.arange(32) & 7)
            np.testing.assert_array_equal(read, slots[cand])
            for quarter in range(4):
                assert len(set(read[8 * quarter:8 * quarter + 8] % 8)) == 8


@pytest.mark.parametrize("lpl", (1, 2))
def test_bitonic_merge_keeps_the_smallest_keys(lpl):
    """The merge network on unique keys: any sorted list (0 to 32 * lpl
    keys) and any buffer (1 to 64 keys) give the 32 * lpl smallest of both,
    ascending, padded with 0xffffffff."""
    rng = np.random.RandomState(lpl)
    for _ in range(300):
        keys = rng.permutation(np.unique(rng.randint(0, 2 ** 31, 400)))
        nl = int(rng.randint(0, 32 * lpl + 1))
        nb = int(rng.randint(1, 65))
        lk = np.sort(keys[:nl])
        bk = list(keys[nl:nl + nb])
        got = bitonic_merge(lk, bk, 32 * lpl, lpl)
        want = np.sort(np.r_[lk, bk])[:32 * lpl]
        np.testing.assert_array_equal(got[:len(want)], want)
        assert (got[len(want):] == 0xFFFFFFFF).all()


def test_blockmin_plans_pick_compiled_kernels(port):
    _, out = port
    plans = out["plans"]
    assert len(plans) >= 25
    assert set(plans[:, 2].tolist()) <= set(BLKS)
    for k, queries, blk, warp, cap in plans:
        assert k <= cap
        if warp:
            assert cap in (32, 64)
        else:
            assert cap in (4, 8)
            assert k <= THREAD_MAX_K and queries >= THREAD_MIN_QUERIES
        if k > THREAD_MAX_K:
            assert warp
    # Both kernels take path sites: every k = 3 path site (16384 queries or
    # more) takes the thread kernel.
    assert set(plans[:, 3].tolist()) == {0, 1}
    path_k3 = (plans[:, 0] == 3) & (plans[:, 1] >= THREAD_MIN_QUERIES)
    assert path_k3.sum() >= 6 and not plans[path_k3, 3].any()


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches_blockmin"], [0, 0])
