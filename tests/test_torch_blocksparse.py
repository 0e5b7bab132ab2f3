"""The port's block-sparse grouping (ogc_tpu_torch/ops/blocksparse.py,
kernels #9/#10) against the JAX package's group_blocksparse, whose Pallas
kernels run in interpret mode here.

On CPU tensors the port takes the plain versions (advanced indexing
forward, #11's plain scatter-add backward), so this holds those and the
prologue to the Pallas contract; chip_smoke.py holds the CUDA kernels to
them on the card.  The first four cases are tests/test_onehot_group.py's:
a Morton-coherent-like table with an odd S, a uniform table at N = 8192
whose every tile reaches more blocks than the cap, the vjp case, and
integer data (C 10, 4, 6, 5); the "c*" cases add C 1, 3, 8, 11 and 16,
and "wide" has rows of more padded edges than #9 stages at once.  The forward is a copy and must be bit-equal; the backward sums
each row in ascending edge order where XLA's scatter takes its own order,
so it holds rtol 1e-5 / atol 1e-4 (the JAX test's tolerance) on float data
and bit-equality on integer data, where every order gives the same sums.

#9's presence (which blocks each 32 rows of the padded table reach, the
input of #10) is held to JAX's per-tile lists; #9's launch plan
(``bs_gather_plan``) to the kernel's needs by a numpy model of the walk
csrc/onehot_bs.cu makes: every padded edge loaded once, every output edge
written once, the rows and the presence equal to indexing and to
``bs_prologue``'s.

#10 is held by a numpy model of its two kernels under ``bs_scatter_plan``:
bs_partition splits each piece's real edges stably by destination group
(csr.cuh::stable_partition, tests/test_torch_scatter_onehot_csr.py's
model) into packed entries and group offsets; bs_accumulate lists, per
group, the segments of the pieces whose unit the presence names, in order
(every piece with entries for the group is named), partitions each 2048-
entry tile stably by row and sums each (row, channel) in order.  Its sums
must be the plain version's bits on every case above and on SCATTER_CASES:
a hub of in-degree >= 1000 (integer data, also against JAX's
group_blocksparse VJP with its Pallas kernel in interpret mode), every
edge to one destination, empty destinations, n = 1, rows of 300 padded
edges (two pieces a unit), and C from 1 to 16.  ``bs_scatter_plan`` at
every site chip_smoke.py drives stays inside the kernels' limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu.ops import core
from ogc_tpu.ops.pallas_onehot import (_BS_CAP, _bs_pad, _bs_prologue,
                                       _pad_to, group_blocksparse)
from tests.test_torch_scatter_onehot_csr import partition_model
from tests.torch_port_helper import pack, run_torch

# name: (seed, B, N, C, M, S, table width (None: uniform), integer data)
CASES = {"coherent": (5, 2, 1024, 10, 700, 7, 300, False),
         "overflow": (6, 1, 8192, 4, 512, 16, None, False),
         "vjp": (7, 2, 512, 6, 512, 8, 150, False),
         "integer": (8, 1, 640, 5, 512, 6, 100, True),
         "c1": (9, 1, 512, 1, 256, 6, 60, False),
         "c3": (10, 2, 640, 3, 300, 9, 80, False),
         "c8": (11, 1, 1024, 8, 512, 12, 200, False),
         "c11": (12, 1, 1500, 11, 600, 17, 150, False),
         "c16": (13, 1, 768, 16, 256, 10, None, True),
         "wide": (14, 1, 700, 11, 300, 201, 100, False)}
# #10's own cases, (seed, B, N, C, M, S, table kind, integer data): a hub
# (1200 edges to row 7 of a coherent table), every edge to one destination,
# empty destinations (every fourth row only), n = 1, rows of 300 padded
# edges (two partition pieces a unit), and every C from 1 to 16.
SCATTER_CASES = {"hub": (20, 2, 1024, 8, 512, 16, "hub", True),
                 "one_dest": (21, 2, 512, 11, 300, 17, "one", False),
                 "empty_dests": (22, 1, 1024, 11, 512, 16, "fourth", False),
                 "n1": (23, 2, 1, 4, 100, 7, "zero", False),
                 "two_pieces": (24, 1, 700, 11, 300, 300, "uniform", False)}
SCATTER_CASES.update({f"s_c{C}": (30 + C, 1, 300, C, 256, 7, "coherent",
                                  False) for C in range(1, 17)})
# (n, M, S) #10 launch plans at chip_smoke.py's sites: the KITTI-SF smooth
# table, SAPIEN's, the ragged table (also its C 1..16 cases) and the
# uniform one, the edge cases (one destination, n 1, two pieces a unit).
SCATTER_PLANS = [(8192, 8192, 96), (512, 512, 24), (1500, 1500, 17),
                 (8192, 1024, 16), (512, 300, 17), (1, 100, 7),
                 (700, 300, 300)]
# (n, M, S) launch plans beside the cases': the KITTI-SF, SAPIEN, ragged
# and uniform tables of chip_smoke.py, tiny ones, and rows of more padded
# edges than one piece (S 200: two pieces per unit; S 129: a 64-edge rest).
PLANS = [(8192, 8192, 96), (512, 512, 24), (1500, 1500, 17),
         (8192, 1024, 16), (1, 1, 1), (100, 3, 2), (300, 33, 200),
         (1000, 300, 129), (2 ** 20, 64, 8)]


def _coherent_idx(rng, B, M, S, N, width):
    """tests/test_onehot_group.py::_coherent_idx: targets near the row."""
    i = np.arange(M)[None, :, None]
    off = rng.randint(-width, width + 1, (B, M, S))
    return np.clip(i + off, 0, N - 1).astype(np.int32)


def _scatter_inputs(case):
    seed, B, N, C, M, S, kind, integer = SCATTER_CASES[case]
    rng = np.random.RandomState(seed)
    if kind in ("hub", "coherent", "fourth"):
        idx = _coherent_idx(rng, B, M, S, N, 60)
        if kind == "hub":
            idx.reshape(B, -1)[:, 1000:2200] = 7
        if kind == "fourth":
            idx = idx // 4 * 4
    elif kind == "uniform":
        idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
    else:
        idx = np.full((B, M, S), 3 if kind == "one" else 0, np.int32)
    src = rng.randn(B, N, C).astype(np.float32)
    cot = (rng.randint(-4, 5, (B, M, S, C)) if integer
           else rng.randn(B, M, S, C)).astype(np.float32)
    return {"src": src, "idx": idx, "cot": cot}


def _inputs(case):
    if case in SCATTER_CASES:
        return _scatter_inputs(case)
    seed, B, N, C, M, S, width, integer = CASES[case]
    rng = np.random.RandomState(seed)
    if integer:
        src = rng.randint(-4, 5, (B, N, C)).astype(np.float32)
    else:
        src = rng.randn(B, N, C).astype(np.float32)
    idx = (rng.randint(0, N, (B, M, S)).astype(np.int32) if width is None
           else _coherent_idx(rng, B, M, S, N, width))
    cot = (rng.randint(-4, 5, (B, M, S, C)) if integer
           else rng.randn(B, M, S, C)).astype(np.float32)
    return {"src": src, "idx": idx, "cot": cot}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_blocksparse")
    x = {f"{case}/{k}": v for case in (*CASES, *SCATTER_CASES)
         for k, v in _inputs(case).items()}
    inp = pack(str(tmp / "in.npz"), x,
               {"cases": [*CASES, *SCATTER_CASES], "plans": PLANS,
                "scatter_plans": SCATTER_PLANS})
    (out,) = run_torch([("blocksparse", inp, str(tmp / "out.npz"))])
    return x, out


def _jax(x, case):
    src, idx = jnp.asarray(x[case + "/src"]), jnp.asarray(x[case + "/idx"])
    n = src.shape[1]
    out, pull = jax.vjp(lambda s: group_blocksparse(s, idx, n), src)
    (grad,) = pull(jnp.asarray(x[case + "/cot"]))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("case", list(CASES))
def test_prologue_matches_jax(port, case):
    x, out = port
    idx = jnp.asarray(x[case + "/idx"])
    idx_p, _, _ = _bs_pad(idx)
    order, count, overflow = _bs_prologue(
        idx_p, _pad_to(x[case + "/src"].shape[1], 128))
    np.testing.assert_array_equal(out[case + "/order"], np.asarray(order))
    np.testing.assert_array_equal(out[case + "/count"], np.asarray(count))
    assert bool(out[case + "/overflow"]) == bool(overflow)
    assert bool(overflow) == (case == "overflow")
    if case == "overflow":
        assert x[case + "/src"].shape[1] // 128 > _BS_CAP


@pytest.mark.parametrize("case", list(CASES))
def test_forward_bit_equal_to_jax(port, case):
    x, out = port
    want, _ = _jax(x, case)
    np.testing.assert_array_equal(out[case + "/out"], want)
    ref = core.group(jnp.asarray(x[case + "/src"]),
                     jnp.asarray(x[case + "/idx"]))
    np.testing.assert_array_equal(out[case + "/out"], np.asarray(ref))
    np.testing.assert_array_equal(out["launches_cand"], [0, 0, 0])


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(port, case):
    x, out = port
    _, want = _jax(x, case)
    if CASES[case][-1]:
        np.testing.assert_array_equal(out[case + "/grad"], want)
        B, M, S, C = x[case + "/cot"].shape
        ref = jnp.zeros((B, x[case + "/src"].shape[1], C)).at[
            jnp.arange(B)[:, None], x[case + "/idx"].reshape(B, M * S)].add(
                x[case + "/cot"].reshape(B, M * S, C))
        np.testing.assert_array_equal(out[case + "/grad"], np.asarray(ref))
    else:
        np.testing.assert_allclose(out[case + "/grad"], want, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_bit_equal_to_scatter_add_rows_plain(port, case):
    """#10's contract is #11's: the same bits as scatter_add_rows_plain on
    the flattened table."""
    _, out = port
    np.testing.assert_array_equal(out[case + "/grad"],
                                  out[case + "/scatter11"])


def _out_edge(e, s_pad, S):
    """csrc/onehot_bs.cu::out_edge: real edges before padded edge e."""
    m = e // s_pad
    return m * S + np.minimum(e - m * s_pad, S)


def _walk(plan, consts, n, M, S, padded=None):
    """A numpy model of the walk bs_gather_kernel makes under ``plan``, for
    one cloud: per unit, per piece, the padded edges loaded and the output
    edges written, each counted; with ``padded`` (m_pad * s_pad,) also the
    rows written per output edge and the presence rows."""
    m_pad, s_pad, units, piece, smem = (int(v) for v in plan)
    rq, cb, warps, limit = (int(v) for v in consts)
    nb = -(-n // cb)
    assert smem >= (warps * 128 + piece) * 4 + nb and smem <= limit
    assert piece % 4 == 0 and units * rq == m_pad and s_pad % 2 == 0
    loads = np.zeros(m_pad * s_pad, np.int64)
    writes = np.zeros(M * S, np.int64)
    rows = np.full(M * S, -1, np.int64)
    presence = np.zeros((units, nb), np.uint8)
    unit_edges = rq * s_pad
    for u in range(units):
        for p0 in range(0, unit_edges, piece):
            e0 = u * unit_edges + p0
            ln = min(piece, unit_edges - p0)
            assert ln % 4 == 0 and ln <= piece
            q0 = min(_out_edge(e0, s_pad, S), M * S)
            q1 = min(_out_edge(e0 + ln, s_pad, S), M * S)
            e = np.arange(e0, e0 + ln)
            loads[e] += 1
            m, s = e // s_pad, e % s_pad
            real = (s < S) & (m < M)
            pos = (m * S + s - q0)[real]
            # The piece's real edges fill s_row[0, q1 - q0) exactly.
            np.testing.assert_array_equal(np.sort(pos), np.arange(q1 - q0))
            writes[q0:q1] += 1
            if padded is not None:
                i = np.clip(padded[e], 0, n - 1)
                presence[u, i // cb] = 1
                rows[q0 + pos] = i[real]
    np.testing.assert_array_equal(loads, 1)
    np.testing.assert_array_equal(writes, 1)
    return rows, presence


@pytest.mark.parametrize("k", range(len(PLANS)))
def test_gather_plan_covers_every_edge_once(port, k):
    _, out = port
    n, M, S = PLANS[k]
    _walk(out["plans"][k], out["plan_consts"], n, M, S)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_walk_matches_indexing_and_prologue(port, case):
    """The modelled walk, run on the case's padded table, writes indexing's
    rows and bs_prologue's presence."""
    x, out = port
    src, idx = x[case + "/src"], x[case + "/idx"]
    B, M, S = idx.shape
    n = src.shape[1]
    for b in range(B):
        rows, presence = _walk(out[case + "/plan"], out["plan_consts"], n, M,
                               S, out[case + "/padded"][b])
        np.testing.assert_array_equal(rows, idx[b].reshape(-1))
        np.testing.assert_array_equal(presence, out[case + "/presence"][b])


@pytest.mark.parametrize("case", list(CASES))
def test_presence_matches_jax_tile_lists(port, case):
    """bs_prologue's presence, per 32 rows, reduced over each 256-row tile
    lists the blocks JAX's _bs_prologue lists for it (the first CAP of them
    where the tile passes the cap), and counts them as it does."""
    x, out = port
    n = x[case + "/src"].shape[1]
    idx_p, m_pad, _ = _bs_pad(jnp.asarray(x[case + "/idx"]))
    order, count, _ = _bs_prologue(idx_p, _pad_to(n, 128))
    order, count = np.asarray(order), np.asarray(count)[..., 0]
    presence = out[case + "/presence"]
    B, units, nb = presence.shape
    assert (units, nb) == (m_pad // 32, -(-n // 128))
    tiles = presence.reshape(B, m_pad // 256, 8, nb).any(2)
    for b in range(B):
        for t in range(tiles.shape[1]):
            blocks = np.flatnonzero(tiles[b, t])[:_BS_CAP]
            assert count[b, t] == len(blocks)
            np.testing.assert_array_equal(order[b, t, :count[b, t]], blocks)


# #10's kernels (csrc/onehot_bs.cu): partition and accumulation warps, list
# entries an accumulation tile sorts, cotangent values staged at a time,
# groups and pieces a cloud, rows a group, the largest piece.
PART_WARPS, ACC_WARPS, TILE, STAGE_FLOATS = 8, 8, 2048, 8192
MAX_GROUPS, MAX_PIECES, GROUP, MAX_PIECE = 4096, 4096, 16, 8192
RQ_ = 32  # table rows a unit of the presence


def _bs_scatter_model(padded, presence, g, n, M, S, splan):
    """(n, C) float32 as bs_partition and bs_accumulate sum one cloud:
    padded (m_pad * s_pad,) table, presence (units, nb), g (M * S, C)."""
    s_pad, units, piece, ppu, pieces, ng = (int(v) for v in splan[:6])
    group, unit_edges, C = GROUP, RQ_ * s_pad, g.shape[-1]
    lg = group.bit_length() - 1
    ents, offs = [], np.zeros((pieces, ng + 1), np.int64)
    for p in range(pieces):  # bs_partition
        u, part = divmod(p, ppu)
        e0 = u * unit_edges + part * piece
        e = e0 + np.arange(min(piece, unit_edges - part * piece))
        m, s = e // s_pad, e % s_pad
        v = np.clip(padded[e], 0, n - 1).astype(np.int64)
        real = (m < M) & (s < S)
        start, order = partition_model(np.where(real, v >> lg, -1), ng,
                                       PART_WARPS)
        packed = ((m * S + s) << lg) | (v & (group - 1))
        assert (packed[real] < 2 ** 31).all()
        ents.append(packed[order])
        offs[p] = start
    out = np.zeros((n, C), np.float32)
    for gi in range(ng):  # bs_accumulate
        rows, blk = min(group, n - gi * group), gi * group // 128
        named = presence[np.arange(pieces) // ppu, blk].astype(bool)
        lens = offs[:, gi + 1] - offs[:, gi]
        assert not lens[~named].any()  # the presence names every segment
        pos = np.concatenate([[0], np.cumsum(np.where(named, lens, 0))])
        acc = np.zeros((rows, C), np.float32)
        for t0 in range(0, int(pos[-1]), TILE):
            q = np.arange(t0, min(int(pos[-1]), t0 + TILE))
            lo = np.searchsorted(pos, q, side="right") - 1  # binary search
            v = np.array([ents[p][offs[p, gi] + qq - pos[p]]
                          for p, qq in zip(lo, q)], np.int64)
            start, order = partition_model(v & (group - 1), rows, ACC_WARPS)
            crow = v[order] >> lg
            chunk = STAGE_FLOATS // C  # entries staged at a time
            for c0 in range(0, len(q), chunk):
                deg = (np.minimum(start[1:], c0 + chunk)
                       - np.maximum(start[:-1], c0)).clip(0)
                first = np.maximum(start[:-1], c0)
                for k in range(int(deg.max(initial=0))):
                    r = np.flatnonzero(deg > k)
                    acc[r] = acc[r] + g[crow[first[r] + k]]
        out[gi * group:gi * group + rows] = acc
    return out


@pytest.mark.parametrize("case", [*CASES, *SCATTER_CASES])
def test_scatter_model_sums_to_the_plain_bits(port, case):
    """The modelled kernels' sums on each cloud equal the plain version's
    bits (the grouping's backward)."""
    x, out = port
    src, idx, cot = (x[f"{case}/{k}"] for k in ("src", "idx", "cot"))
    B, M, S, C = cot.shape
    n = src.shape[1]
    for b in range(B):
        got = _bs_scatter_model(out[case + "/padded"][b],
                                out[case + "/presence"][b],
                                cot[b].reshape(M * S, C), n, M, S,
                                out[case + "/splan"])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      out[case + "/grad"][b].view(np.uint32))
    if case == "hub":
        assert np.bincount(idx.reshape(-1), minlength=n).max() >= 1000


def test_hub_scatter_matches_pallas(port):
    """On integer data every order sums exactly: the plain version's bits
    are JAX group_blocksparse's VJP (Pallas #10 in interpret mode)."""
    x, out = port
    _, want = _jax(x, "hub")
    np.testing.assert_array_equal(out["hub/grad"].view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("k", range(len(SCATTER_PLANS)))
def test_scatter_plan_stays_inside_the_kernel_limits(port, k):
    _, out = port
    n, M, S = SCATTER_PLANS[k]
    s_pad, units, piece, ppu, pieces, ng, words = (
        int(v) for v in out["scatter_plans"][k])
    m_pad, unit_edges = _pad_to(M, 256), RQ_ * s_pad
    assert s_pad == _pad_to(S, 2) and units * RQ_ == m_pad
    assert 1 <= piece <= MAX_PIECE and ppu * piece >= unit_edges
    assert (ppu - 1) * piece < unit_edges and pieces == units * ppu
    assert pieces <= MAX_PIECES and ng == -(-n // GROUP) <= MAX_GROUPS
    assert M * S * GROUP < 2 ** 31
    assert words == pieces * piece + pieces * (ng + 1)
