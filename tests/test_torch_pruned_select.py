"""The fused prologue (ogc_tpu_torch/csrc/pruned_prologue.cu) and the warp
walks of the pruned KNNs #4 (csrc/knn_exact_pruned.cu) and #6
(csrc/knn_cand_pruned.cu) on the CPU: numpy models of what the kernels
compute, held against the port's torch prologues and plain versions (the
torch side on CPU tensors) and the JAX package's prologues and Pallas
kernels in interpret mode.

* The sort kernel: each cloud's 30-bit Morton codes in float32 with every
  step rounded ((x - lo) / max(hi - lo, 1e-6) * 1023, clamped, truncated),
  an LSD radix sort by four 8-bit digits, each pass a stable partition (a
  stable sort by code, tied codes in index order), a cloud of more than
  one CTA's run sorted in runs and each key code << 32 | index placed at
  its rank among all runs; the pads (points at 1e6 with #4's id 2^30 or
  #6's mask_low; queries a copy of the last sorted query for #4, at 1e6
  for #6) and the boxes with pads left out as each module leaves them out.
* The select kernel: lb2 ((gx^2 + gy^2) + gz^2), #6's score rounded once
  from float64, #4's theta_tile (the tile's largest kth * kth * inflate),
  and every list as the ranks of the unique (value bits, block) pairs.
* #4's walk, one warp per query: the survivors 64 at a time, nearest first
  by the query's own lower bound to each block's box (ties to the lower
  listed place), stopping at the first bound strictly above the k-th d2;
  a block's four steps of 32 lanes, 64-bit keys (bits(d2) << 32) | id
  voted against the k-th key, a ballot into a buffer of 64 and the
  bitonic merge.  Tied pairs arrive higher id first on the grid clouds;
  the keys order them by id.
* #6's walk, one query: the candidate chunks in order; each chunk's
  minimum (d2, id) over its blk blocks at each position, the truncated
  32-bit key voted against the k-th key, pad winners remembered and
  offered once after the walk (merged by value), rows with fewer distinct
  keys filled with INT32_MAX.

Cases: grid clouds with ties, ragged N and M, k 1, 16, 32 and 64, blocks of
32 points, every point at one place (no block pruned), a pad block among
#6's candidates.  Clouds are on a grid, so every d2 and bound is exact:
everything must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

F32 = np.float32
PAD, BIG = F32(1e6), F32(1e9)
PAD_ID = 2 ** 30
RUN = 16384          # points one CTA sorts
MAX64 = np.uint64(2 ** 64 - 1)
MAX32 = np.uint64(2 ** 32 - 1)
INT32_MAX = 2 ** 31 - 1

# #4: (name, B, N, M, k, cb, qt, layout, against the Pallas kernel): ragged
# N and M with ties, k 1, k 64 over 32-point blocks, every point at one
# place.  The plain version meets the Pallas kernel at more shapes in
# tests/test_torch_pruned.py.
EXACT = [("ties_k32", 1, 300, 1100, 32, 128, 128, "ties", True),
         ("k1", 1, 130, 1024, 1, 128, 128, "grid", True),
         ("k64_cb32", 1, 160, 600, 64, 32, 128, "grid", False),
         ("one_place", 1, 128, 700, 16, 128, 128, "one_place", False)]
# #6: (name, B, N, M, k, n_cand_blocks, blk, cb, against the Pallas kernel):
# a pad block among the candidates at blk 1 (M 1000: 104 real rows in the
# last block), k 32 at blk 2, k 64 over 32-point blocks at blk 4, k 1.
CAND = [("pad_block_blk1", 1, 300, 1000, 16, 7, 1, 128, True),
        ("k32_blk2", 1, 130, 2000, 32, 10, 2, 128, True),
        ("k64_cb32", 1, 160, 2500, 64, 40, 4, 32, False),
        ("k1", 1, 130, 2048, 1, 6, 2, 128, True)]


def _cloud(rng, b, n, layout):
    if layout == "ties":  # a coarse grid: many equal distances
        return (np.round(rng.rand(b, n, 3) * 8) / 2).astype(F32)
    if layout == "one_place":
        return np.full((b, n, 3), 1.5, F32)
    return (np.round(rng.rand(b, n, 3) * 64) / 8).astype(F32)


# --- the sort kernel -------------------------------------------------------

def spread10(v):
    v = v.astype(np.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton(x):
    """(n, 3) float32 -> 30-bit codes, every float32 step rounded."""
    lo, hi = x.min(0), x.max(0)
    ext = np.maximum(hi - lo, F32(1e-6))
    u = np.clip((x - lo) / ext * F32(1023), F32(0), F32(1023)).astype(np.int32)
    return (spread10(u[:, 0]) << 2) | (spread10(u[:, 1]) << 1) | spread10(
        u[:, 2])


def radix_order(codes):
    """A CTA's sort of its run: four stable passes by 8-bit digits, low
    first."""
    order = np.arange(len(codes))
    for shift in (0, 8, 16, 24):
        digit = (codes[order] >> shift) & 255
        order = order[np.argsort(digit, kind="stable")]
    return order


def sort_order(codes, run=RUN):
    """The sort kernel's order: runs of ``run`` rows (one CTA each) sorted
    by radix_order, then (more than one run) each key code << 32 | index
    at its rank: its place in its run plus the keys below it in every
    other run."""
    n = len(codes)
    runs = []
    for r in range(0, n, run):
        part = r + radix_order(codes[r:r + run])
        runs.append((codes[part].astype(np.uint64) << np.uint64(32))
                    | part.astype(np.uint64))
    out = np.empty(n, np.uint64)
    for i, mine in enumerate(runs):
        rank = np.arange(len(mine))
        for j, other in enumerate(runs):
            if j != i:
                rank = rank + np.searchsorted(other, mine, side="left")
        out[rank] = mine
    return (out & np.uint64(0xFFFFFFFF)).astype(np.int64)


def sort_cloud(x, size, cb, pad_id, repeat_last, boxed, run=RUN):
    """One cloud as sort_kernel leaves it: sorted rows and pads, ids, and
    the (size / cb, 6) boxes of rows < boxed."""
    order = sort_order(morton(x), run)
    xs, ids = x[order], order.astype(np.int32)
    pad = np.broadcast_to(xs[-1] if repeat_last else PAD, (size - len(x), 3))
    xs = np.concatenate([xs, pad]).astype(F32)
    ids = np.concatenate([ids, np.full(size - len(x), pad_id, np.int32)])
    rows = xs.reshape(-1, cb, 3)
    valid = (np.arange(size) < boxed).reshape(-1, cb, 1)
    box = np.concatenate([np.where(valid, rows, BIG).min(1),
                          np.where(valid, rows, -BIG).max(1)], -1)
    return xs, ids, order, box


# --- the select kernel -----------------------------------------------------

def lb2_of(qbox, pbox):
    gap = np.maximum(np.maximum(qbox[:, None, :3] - pbox[None, :, 3:],
                                pbox[None, :, :3] - qbox[:, None, 3:]), F32(0))
    g2 = gap * gap
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def score_of(qbox, pbox, lb2):
    dc = ((qbox[:, None, :3] + qbox[:, None, 3:])
          - (pbox[None, :, :3] + pbox[None, :, 3:]))
    d2 = dc * dc
    c2c = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
    return (lb2.astype(np.float64)
            + c2c.astype(np.float64) * np.float64(F32(1e-3))).astype(F32)


def by_rank(v):
    """Each row's blocks by the rank of the unique (value bits, block)
    pair, as the select kernel places them (values >= +0.0 or +inf)."""
    bits = v.view(np.uint32).astype(np.int64)
    j = np.arange(v.shape[-1])
    below = (bits[:, None, :] < bits[:, :, None]) | (
        (bits[:, None, :] == bits[:, :, None]) & (j[None, :] < j[:, None]))
    rank = below.sum(-1)
    out = np.empty_like(rank)
    np.put_along_axis(out, rank, np.broadcast_to(j, rank.shape), axis=1)
    return out.astype(np.int32)


def theta_inflate(m):
    mp = -(-m // 1024) * 1024
    idx_bits = max(1, (mp - 1).bit_length())
    return 1.0 + max(2.0 ** -8, 2.0 ** (idx_bits - 22))


def survivors(lb2, kth, qt, inflate):
    theta = (kth * kth * F32(inflate)).reshape(-1, qt).max(-1)
    survive = lb2 <= theta[:, None]
    return by_rank(np.where(survive, lb2, F32(np.inf))), survive.sum(-1)


def exact_prologue(q, p, k, cb, qt, kth):
    """#4's fused prologue for one item: sorted clouds, ids, boxes, lb2,
    order and count (kth: the #3 pre-pass's last column)."""
    n, m = len(q), len(p)
    np_, mp = -(-n // qt) * qt, -(-m // cb) * cb
    p_s, pid, _, p_box = sort_cloud(p, mp, cb, PAD_ID, False, m)
    q_s, _, qid, q_box = sort_cloud(q, np_, qt, -1, True, np_)
    lb2 = lb2_of(q_box, p_box)
    order, count = survivors(lb2, kth, qt, theta_inflate(m))
    return dict(q_s=q_s, p_s=p_s, pid=pid, qid=qid, q_box=q_box,
                p_box=p_box, lb2=lb2, order=order, count=count)


def cand_prologue(q, p, n_cand, cb, qt=128):
    n, m = len(q), len(p)
    np_, mp = -(-n // qt) * qt, -(-m // cb) * cb
    idx_bits = max(1, (mp - 1).bit_length())
    p_s, pid, _, p_box = sort_cloud(p, mp, cb, (1 << idx_bits) - 1, False, m)
    q_s, _, qid, q_box = sort_cloud(q, np_, qt, -1, False, n)
    lb2 = lb2_of(q_box, p_box)
    score = score_of(q_box, p_box, lb2)
    return dict(q_s=q_s, p_s=p_s, pid=pid, qid=qid, q_box=q_box,
                p_box=p_box, lb2=lb2, score=score,
                cand=by_rank(score)[:, :n_cand], idx_bits=idx_bits)


# --- the warp selection ----------------------------------------------------

def bitonic_stage(x, size, stride):
    e = np.arange(64)
    p = x[e ^ stride]
    keep_min = ((e & stride) == 0) == ((e & size) == 0)
    return np.where(keep_min, np.minimum(x, p), np.maximum(x, p))


def bitonic_merge(lk, bk, lpl, last):
    """neighbors.cuh::merge_unique: the buffer padded to 64 with the
    largest key and sorted, min(list[i], buffer[63 - i]), six stages; the
    first 32 * lpl kept."""
    b = np.full(64, last, np.uint64)
    b[:len(bk)] = bk
    for size in (2, 4, 8, 16, 32, 64):
        stride = size // 2
        while stride:
            b = bitonic_stage(b, size, stride)
            stride //= 2
    x = np.full(64, last, np.uint64)
    x[:min(len(lk), 32 * lpl)] = lk[:32 * lpl]
    x = np.minimum(x, b[::-1])
    for stride in (32, 16, 8, 4, 2, 1):
        x = bitonic_stage(x, 64, stride)
    return x[:32 * lpl]


class Selection:
    """One query's list, buffer and threshold in the warp selection."""

    def __init__(self, k, last):
        self.k, self.last, self.lpl = k, last, 1 if k <= 32 else 2
        self.lk, self.bk = np.zeros(0, np.uint64), []
        self.nv, self.thr = 0, last

    def merge(self):
        self.lk = bitonic_merge(self.lk[:self.nv], self.bk, self.lpl,
                                self.last)
        self.nv = min(self.nv + len(self.bk), self.k)
        if self.nv == self.k:
            self.thr = self.lk[self.k - 1]
        self.bk = []

    def offer(self, keys):
        """One step: the lanes' keys below the threshold, in lane order."""
        self.bk.extend(keys[keys < self.thr])
        if len(self.bk) > 32:
            self.merge()

    def done(self):
        if self.bk:
            self.merge()
        return self.lk[:self.nv]


def d2_direct(q, p):
    d = p - q
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def point_lb2(q, box):
    """The query's lower bound to each box (n, 6), as lb2_of for one
    query."""
    return lb2_of(np.concatenate([q, q])[None], box)[0]


def nearest_first(bounds):
    """A warp's walk order over up to 64 items: by (bound bits, place)."""
    return np.lexsort((np.arange(len(bounds)), bounds.view(np.uint32)))


def walk_exact(q, surv, p_box, p_s, pid, m, cb, k, seen=None):
    """pruned_knn_kernel's walk for one query: its list of k keys
    (bits(d2) << 32) | id.  ``seen`` collects whether a tied pair arrived
    higher id first."""
    sel, arrived = Selection(k, MAX64), {}
    r = np.arange(128).reshape(4, 32)
    for g0 in range(0, len(surv), 64):
        blocks = surv[g0:g0 + 64]
        bounds = point_lb2(q, p_box[blocks])
        for e in nearest_first(bounds):
            kth = np.uint32(int(sel.thr) >> 32).view(F32)
            if sel.nv == k and bounds[e] > kth:
                break
            rows = blocks[e] * cb + np.minimum(r, cb - 1)
            real = (r < cb) & (rows < m)
            d2 = d2_direct(q, p_s[rows])
            keys = np.where(real, (d2.view(np.uint32).astype(np.uint64)
                                   << np.uint64(32)) | pid[rows].astype(
                                       np.uint64), MAX64)
            if seen is not None:
                for d, i in zip(d2[real], pid[rows][real]):
                    if any(o > i for o in arrived.get(float(d), ())):
                        seen.append(True)
                    arrived.setdefault(float(d), []).append(int(i))
            if not (keys < sel.thr).any():
                continue
            for v in range(4):
                sel.offer(keys[v])
    return sel.done()


def walk_cand(q, cand, blk, p_s, pid, m, cb, k, idx_bits):
    """cand_knn_kernel's walk for one query: its k output keys."""
    mask = np.uint64((1 << idx_bits) - 1)
    sel, pad_key = Selection(k, MAX32), None
    r = np.arange(128).reshape(4, 32)
    rr = np.minimum(r, cb - 1)
    for c in range(0, len(cand), blk):
        rows = cand[c:c + blk, None, None] * cb + rr          # (blk, 4, 32)
        d2 = d2_direct(q, p_s[rows])
        ids = pid[rows]
        win = np.lexsort((ids, d2), axis=0)[0]                # (d2, id) min
        pick = np.take_along_axis(rows, win[None], 0)[0]
        d2w = np.take_along_axis(d2, win[None], 0)[0]
        keys = ((d2w.view(np.uint32).astype(np.uint64) & ~mask)
                | pid[pick].astype(np.uint64))
        keys = np.where(r < cb, keys, MAX32)
        pads = (r < cb) & (pick >= m)
        if pads.any():
            pad_key = keys[pads][0]
            keys = np.where(pads, MAX32, keys)
        if not (keys < sel.thr).any():
            continue
        for v in range(4):
            sel.offer(keys[v])
    if pad_key is not None:
        sel.offer(np.array([pad_key], np.uint64))
    out = list(sel.done())
    return np.array(out + [INT32_MAX] * (k - len(out)), np.uint64)


def to_output(keys, mask_low=None):
    """(dist, idx): #4's 64-bit keys (mask_low None) or #6's 32-bit keys,
    the distance the correctly rounded float32 square root."""
    keys = keys.astype(np.uint64)
    if mask_low is None:
        d2 = (keys >> np.uint64(32)).astype(np.uint32).view(F32)
        idx = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    else:
        d2 = (keys & ~np.uint64(mask_low)).astype(np.uint32).view(F32)
        idx = (keys & np.uint64(mask_low)).astype(np.int64)
    return (np.sqrt(np.maximum(d2, F32(0)).astype(np.float64)).astype(F32),
            idx.astype(np.int32))


# --- the cases -------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pruned_select")
    rng = np.random.RandomState(12)
    x, cfg = {}, {"exact": {}, "cand": {}}
    for name, b, n, m, k, cb, qt, layout, _ in EXACT:
        x[f"e_{name}/q"] = _cloud(rng, b, n, "grid" if layout == "one_place"
                                  else layout)
        x[f"e_{name}/p"] = _cloud(rng, b, m, layout)
        cfg["exact"][f"e_{name}"] = [k, cb, qt]
    for name, b, n, m, k, n_cand, blk, cb, _ in CAND:
        x[f"c_{name}/q"] = _cloud(rng, b, n, "grid")
        x[f"c_{name}/p"] = _cloud(rng, b, m, "grid")
        cfg["cand"][f"c_{name}"] = [k, n_cand, blk, cb]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("pruned_select", inp, str(tmp / "out.npz"))])
    return x, out


_JAX = {}


def jax_exact(x, out, case):
    """The JAX package's #4 on a case, once: _pruned_prologue,
    _survivor_order on the #3 pre-pass's distances (the torch side's; the
    two pre-passes agree in tests/test_torch_pruned.py) and, where the case
    asks, the Pallas kernel on them (interpret mode), its rows back in query
    order."""
    from ogc_tpu.ops.pallas_knn import (_exact_pruned_pallas,
                                        _pruned_prologue, _survivor_order,
                                        _theta_inflate)

    name, b, n, m, k, cb, qt, _, pallas = case
    key = f"e_{name}"
    if key not in _JAX:
        q, p = (jnp.asarray(x[f"{key}/{c}"]) for c in "qp")
        q_t, p_s, pid, q_s, lb2, inv = _pruned_prologue(q, p, cb, qt)
        kth = jnp.asarray(out[key + "/fd"][..., -1])
        theta = (kth ** 2) * _theta_inflate(m)
        order, count = _survivor_order(lb2, theta.reshape(b, -1, qt).max(-1))
        r = dict(p_s=p_s, pid=pid[..., 0], q_s=q_s, lb2=lb2, inv=inv,
                 order=order, count=count)
        if pallas:
            d, i = _exact_pruned_pallas(q_t, p_s, pid, order, count, k, cb,
                                        qt, interpret=True)
            back = inv[..., None]
            r["dist"] = jnp.take_along_axis(jnp.swapaxes(d, 1, 2)[:, :n],
                                            back, axis=1)
            r["idx"] = jnp.take_along_axis(jnp.swapaxes(i, 1, 2)[:, :n],
                                           back, axis=1)
        _JAX[key] = {f: np.asarray(v) for f, v in r.items()}
    return _JAX[key]


def jax_cand(x, case):
    """The JAX package's knn_pruned on a case, once (interpret mode), with
    the candidates it hands its Pallas kernel."""
    from ogc_tpu.ops import pallas_knn

    name, b, n, m, k, n_cand, blk, cb, _ = case
    key = f"c_{name}"
    if key not in _JAX:
        seen = {}
        inner = pallas_knn._knn_pruned_pallas

        def spy(q_t, p_s, perm, cand, *a):
            seen["cand"] = np.asarray(cand)
            return inner(q_t, p_s, perm, cand, *a)

        pallas_knn._knn_pruned_pallas = spy
        try:
            d, i = pallas_knn.knn_pruned(
                k, jnp.asarray(x[key + "/q"]), jnp.asarray(x[key + "/p"]),
                n_cand_blocks=n_cand, blk=blk, cb=cb, interpret=True)
        finally:
            pallas_knn._knn_pruned_pallas = inner
        _JAX[key] = dict(dist=np.asarray(d), idx=np.asarray(i),
                         cand=seen["cand"])
    return _JAX[key]


@pytest.mark.parametrize("run", [RUN, 64, 37])
def test_sort_in_runs_is_the_stable_sort(run):
    """Runs sorted by radix and keys placed by rank give the stable sort by
    code, tied codes in index order (one run or many)."""
    rng = np.random.RandomState(run)
    x = (np.round(rng.rand(1000, 3) * 4) / 2).astype(F32)  # many tied codes
    codes = morton(x)
    assert len(np.unique(codes)) < 200
    np.testing.assert_array_equal(sort_order(codes, run),
                                  np.argsort(codes, kind="stable"))


@pytest.mark.parametrize("case", EXACT, ids=lambda c: c[0])
def test_exact_prologue_model(port, case):
    """#4's fused prologue (model) against the torch prologue and the JAX
    package's _pruned_prologue and _survivor_order (theta from the same
    pre-pass distances)."""
    x, out = port
    name, b, n, m, k, cb, qt, layout, _ = case
    key = f"e_{name}"
    q, p = x[key + "/q"], x[key + "/p"]
    jx = jax_exact(x, out, case)
    for i in range(b):
        mod = exact_prologue(q[i], p[i], k, cb, qt, out[key + "/fd"][i, :, -1])
        for f in ("q_s", "p_s", "pid", "q_box", "p_box", "lb2", "order",
                  "count", "qid"):
            np.testing.assert_array_equal(mod[f], out[f"{key}/{f}"][i], f)
        for f in ("q_s", "p_s", "pid", "lb2", "order", "count"):
            np.testing.assert_array_equal(mod[f], jx[f][i], f)
        np.testing.assert_array_equal(jx["inv"][i][mod["qid"]], np.arange(n))
        if layout == "one_place":  # every block survives every tile
            assert (mod["count"] == mod["p_box"].shape[0]).all()


@pytest.mark.parametrize("case", CAND, ids=lambda c: c[0])
def test_cand_prologue_model(port, case):
    """#6's fused prologue (model) against the torch prologue and the
    candidates the JAX package's knn_pruned hands its Pallas kernel."""
    x, out = port
    name, b, n, m, k, n_cand, blk, cb, pallas = case
    key = f"c_{name}"
    q, p = x[key + "/q"], x[key + "/p"]
    n_res = out[key + "/cand"].shape[-1]
    for j in range(b):
        mod = cand_prologue(q[j], p[j], n_res, cb)
        for f in ("q_s", "p_s", "pid", "q_box", "p_box", "lb2", "score",
                  "cand", "qid"):
            np.testing.assert_array_equal(mod[f], out[f"{key}/{f}"][j], f)
        if pallas:
            np.testing.assert_array_equal(mod["cand"],
                                          jax_cand(x, case)["cand"][j])
    if name == "pad_block_blk1":
        assert m % cb and (out[key + "/cand"] == -(-m // cb) - 1).any()


@pytest.mark.parametrize("case", EXACT, ids=lambda c: c[0])
def test_exact_walk_model(port, case):
    """#4's warp walk (model, a warp per query) gives the plain version's
    rows bit for bit, and the Pallas kernel's where the case asks; on the
    tied grid a tied pair arrives higher id first."""
    x, out = port
    name, b, n, m, k, cb, qt, layout, pallas = case
    key = f"e_{name}"
    if pallas:
        jx = jax_exact(x, out, case)
        np.testing.assert_array_equal(out[key + "/dist"], jx["dist"])
        np.testing.assert_array_equal(out[key + "/idx"], jx["idx"])
    seen = [] if layout == "ties" else None
    for i in range(b):
        g = {f: out[f"{key}/{f}"][i] for f in ("q_s", "p_s", "pid", "qid",
                                                "p_box", "order", "count")}
        for s in range(0, n, 3):
            tile = s // qt
            keys = walk_exact(g["q_s"][s], g["order"][tile][:g["count"][tile]],
                              g["p_box"], g["p_s"], g["pid"], m, cb, k, seen)
            dist, idx = to_output(keys)
            row = g["qid"][s]
            np.testing.assert_array_equal(idx, out[key + "/idx"][i, row])
            np.testing.assert_array_equal(dist, out[key + "/dist"][i, row])
    if layout == "ties":
        assert seen, "no tied pair arrived higher id first"


@pytest.mark.parametrize("case", CAND, ids=lambda c: c[0])
def test_cand_walk_model(port, case):
    """#6's warp walk (model) gives the plain version's rows bit for bit,
    and the Pallas kernel's where the case asks."""
    x, out = port
    name, b, n, m, k, n_cand, blk, cb, pallas = case
    key = f"c_{name}"
    if pallas:
        jx = jax_cand(x, case)
        np.testing.assert_array_equal(out[key + "/dist"], jx["dist"])
        np.testing.assert_array_equal(out[key + "/idx"], jx["idx"])
    blk = int(out[key + "/blk"])
    for i in range(b):
        g = {f: out[f"{key}/{f}"][i] for f in ("q_s", "p_s", "pid", "qid",
                                                "cand")}
        mp = g["p_s"].shape[0]
        idx_bits = max(1, (mp - 1).bit_length())
        for s in range(0, n, 3):
            keys = walk_cand(g["q_s"][s], g["cand"][s // 128], blk,
                             g["p_s"], g["pid"], m, cb, k, idx_bits)
            dist, idx = to_output(keys, (1 << idx_bits) - 1)
            row = g["qid"][s]
            np.testing.assert_array_equal(idx, out[key + "/idx"][i, row])
            np.testing.assert_array_equal(dist, out[key + "/dist"][i, row])


def test_cand_walk_appends_one_pad_key():
    """A walk with fewer real keys than k: the pads, all one key, enter
    once, here after every real key; the rest is INT32_MAX (the plain
    version's k smallest distinct keys)."""
    cb, m, k = 4, 5, 8          # block 1: one real row, three pads
    p = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0], [4, 0, 0]] +
                 [[PAD] * 3] * 3, F32)
    pid = np.array([0, 1, 2, 3, 4, 7, 7, 7], np.int32)
    q = np.zeros(3, F32)
    keys = walk_cand(q, np.array([0, 1]), 1, p, pid, m, cb, k, 3)
    d2 = d2_direct(q, p)
    want = np.unique((d2.view(np.uint32).astype(np.uint64) & ~np.uint64(7))
                     | pid.astype(np.uint64))
    np.testing.assert_array_equal(keys[:len(want)], want)
    assert len(want) == 6 and (keys[6:] == INT32_MAX).all()


@pytest.mark.parametrize("k", [4, 8])
def test_cand_walk_places_the_pad_key_by_value(k):
    """Real points farther than the pad point (1e6 on every axis): the one
    pad key enters by value, before them, as the plain version's k smallest
    distinct keys have it, whether or not the list is full."""
    cb, m = 4, 6                # block 1: two real rows, two pads
    p = np.array([[0, 0, 0], [1, 0, 0], [-2e6, 0, 0], [-3e6, 0, 0],
                  [2, 0, 0], [-4e6, 0, 0]] + [[PAD] * 3] * 2, F32)
    pid = np.array([0, 1, 2, 3, 4, 5, 7, 7], np.int32)
    q = np.zeros(3, F32)
    keys = walk_cand(q, np.array([0, 1]), 1, p, pid, m, cb, k, 3)
    d2 = d2_direct(q, p)
    want = np.unique((d2.view(np.uint32).astype(np.uint64) & ~np.uint64(7))
                     | pid.astype(np.uint64))[:k]
    np.testing.assert_array_equal(keys[:len(want)], want)
    assert (keys[len(want):] == INT32_MAX).all()
    pad = (np.uint64(d2[6].view(np.uint32)) & ~np.uint64(7)) | np.uint64(7)
    assert list(keys).index(pad) == 3     # after the 3 near real keys


@pytest.mark.parametrize("last", [MAX32, MAX64])
def test_bitonic_merge_keeps_the_smallest_keys(last):
    """The merge network on unique 32- or 64-bit keys: any sorted list and
    buffer give the 32 * lpl smallest of both, ascending."""
    rng = np.random.RandomState(int(last % 1000))
    top = 2 ** 62 if last == MAX64 else 2 ** 31
    for lpl in (1, 2):
        for _ in range(100):
            keys = rng.permutation(np.unique(
                rng.randint(0, top, 300, dtype=np.int64))).astype(np.uint64)
            nl, nb = rng.randint(0, 32 * lpl + 1), rng.randint(1, 65)
            lk = np.sort(keys[:nl])
            bk = list(keys[nl:nl + nb])
            got = bitonic_merge(lk, bk, lpl, last)
            want = np.sort(np.r_[lk, bk])[:32 * lpl]
            np.testing.assert_array_equal(got[:len(want)], want)
            assert (got[len(want):] == last).all()


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches_flow"], [0, 0])
    np.testing.assert_array_equal(out["launches_cand"], [0, 0, 0])
