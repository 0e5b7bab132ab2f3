"""The ball kernel's walk (ogc_tpu_torch/csrc/ball_query.cu: kernel #5 at
blk = 1, kernel #3's ball mode at blk 4 to 32) on the CPU: a numpy model
of its ballots held against the plain versions (the torch side on CPU
tensors) and the Pallas kernels in interpret mode.

* The group-lowest hit: from a warp's ballot of in-radius lanes, a lane
  keeps its hit only when no lower lane of its aligned group of blk lanes
  hit (blk divides 32 and steps start at multiples of 32, so a group is a
  run); that is the lowest hit of every run, for blk 1, 4, 8, 16 and 32.
* The slots: a __popc of the winners below a lane, after the count so
  far, gives consecutive slots in lane order, so the ball comes out in
  index order with no selection.
* The walk: steps of 32 candidates in index order, four to a vote, the
  winners written to their slots until ns are filled (the points padded to
  a multiple of 1024 with points at 1e6 in the block-min mode), then the
  reference's filling.  Its balls equal ball_query_plain's and the Pallas
  ball_query_exact's and ball_query_exact_pruned's (blk 1), and
  ball_query_blockmin_plain's and the Pallas ball_query_blockmin's (the
  run length block_size gives), on balls that fill within the first 32
  candidates, empty balls (centres far away), under-full and full ones,
  grid and continuous clouds, ragged N.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

TILE, PAD, STEPS = 1024, np.float32(1e6), 4
BLKS = (1, 4, 8, 16, 32)
# (name, N, centres, radius, ns, extent, kind); block_size(N, ns, 0.95)
# gives runs of 32, 16, 8, 4, 4 and 4.
CASES = [("tight_ns2", 1500, 24, 2.0, 2, 0.5, "tight"),
         ("tight_ns8", 1500, 24, 2.0, 8, 0.5, "tight"),
         ("mixed_ns16", 1500, 48, 0.5, 16, 4.0, "mixed"),
         ("mixed_ns40", 1500, 48, 1.0, 40, 4.0, "mixed"),
         ("scene_ns16", 1111, 48, 0.7, 16, 4.0, "scene"),
         ("grid_ns64", 2048, 48, 2.0, 64, 8.0, "mixed")]


def _grid(rng, shape, extent, step=1 / 8):
    return (np.round(rng.rand(*shape) * extent / step) * step).astype(
        np.float32)


def _clouds(rng, n, centres, extent, kind):
    """(points, centres): a tight cloud (every point within 0.87 of every
    other) with its own first points as centres; or points with centres on
    the cloud (never empty), far away (always empty) and free; or a
    continuous cloud with such centres."""
    if kind == "tight":
        x = _grid(rng, (2, n, 3), extent, 1 / 64)
        return x, x[:, :centres].copy()
    x = (_grid(rng, (2, n, 3), extent) if kind == "mixed"
         else (rng.rand(2, n, 3) * extent).astype(np.float32))
    q = centres // 4
    own = x[:, rng.randint(0, n, 2 * q)]
    far = _grid(rng, (2, q, 3), extent) + 100
    free = (rng.rand(2, centres - 3 * q, 3) * extent).astype(np.float32)
    return x, np.concatenate([own, far, free], 1)


def _d2(q, p):
    d = p[:, None, :, :] - q[:, :, None, :]
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def r2_of(radius):
    return np.float32(float(radius) * float(radius))


def pick_block(m, k):
    if k <= 1:
        return 32
    cap = int(2 * m * 0.05 / (k - 1))
    return next((b for b in (32, 16, 8, 4) if b <= cap), 4)


def block_size(m, k):
    blk = pick_block(m, k)
    while blk > 4 and -(-m // blk) < k:
        blk //= 2
    return blk


def group_below(lane, blk):
    """The lanes below ``lane`` in its aligned group of blk lanes."""
    group = 0xFFFFFFFF if blk == 32 else ((1 << blk) - 1) << (lane & ~(blk - 1))
    return ((1 << lane) - 1) & group


def group_winners(hits, blk):
    """The second ballot: lanes whose hit has no lower hit in its group."""
    return sum(1 << lane for lane in range(32)
               if hits >> lane & 1 and not hits & group_below(lane, blk))


def ball_walk(d2_row, r2, ns, blk):
    """ball_kernel's walk for one centre over the candidates of ``d2_row``
    (padded in the block-min mode): (filled ball, steps walked)."""
    n = len(d2_row)
    out = [0] * ns
    cnt, first, walked = 0, 0, 0
    for t0 in range(0, n, TILE):
        length = min(TILE, n - t0)
        for j0 in range(0, length, 32 * STEPS):
            if cnt >= ns:
                break
            for u in range(STEPS):
                base = t0 + j0 + 32 * u
                if j0 + 32 * u >= length or cnt >= ns:
                    break
                walked += 1
                hits = sum(1 << lane for lane in range(32)
                           if j0 + 32 * u + lane < length
                           and d2_row[base + lane] < r2)
                wins = group_winners(hits, blk) if blk > 1 else hits
                if not wins:
                    continue
                if cnt == 0:
                    first = base + (wins & -wins).bit_length() - 1
                for lane in range(32):
                    if wins >> lane & 1:
                        slot = cnt + bin(wins & ((1 << lane) - 1)).count("1")
                        if slot < ns:
                            out[slot] = base + lane
                cnt += bin(wins).count("1")
    for s in range(min(cnt, ns), ns):
        out[s] = first
    return np.array(out, np.int32), walked


def model_balls(x, c, radius, ns, blk):
    p = x
    if blk > 1:
        b, n, _ = x.shape
        np_ = -(-n // TILE) * TILE
        p = np.concatenate([x, np.full((b, np_ - n, 3), PAD, np.float32)], 1)
    d2 = _d2(c, p)
    return np.stack([[ball_walk(row, r2_of(radius), ns, blk)[0]
                      for row in cloud] for cloud in d2])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ball_select")
    rng = np.random.RandomState(5)
    x, cfg = {}, {"cases": {}}
    for name, n, centres, radius, ns, extent, kind in CASES:
        x[name + "/xyz"], x[name + "/centres"] = _clouds(rng, n, centres,
                                                         extent, kind)
        cfg["cases"][name] = [radius, ns]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("ball_select", inp, str(tmp / "out.npz"))],
                       exact=False)
    return x, out


@pytest.mark.parametrize("blk", BLKS)
def test_group_winners_are_each_runs_lowest_hit(blk):
    rng = np.random.RandomState(blk)
    masks = [0, 0xFFFFFFFF, 1 << 31, 0x80000001] + [
        int(m) for m in rng.randint(0, 2 ** 32, 300, dtype=np.uint64)]
    masks += [int(m) & int(n) for m, n in zip(masks[4:], masks[5:])]
    for hits in masks:
        want = 0
        for g in range(0, 32, blk):
            run = (hits >> g) & ((1 << blk) - 1)
            if run:
                want |= (run & -run) << g
        got = group_winners(hits, blk) if blk > 1 else hits
        assert got == want


@pytest.mark.parametrize("blk", BLKS)
def test_popc_slots_are_consecutive_in_lane_order(blk):
    rng = np.random.RandomState(10 + blk)
    for _ in range(200):
        hits = int(rng.randint(0, 2 ** 32, dtype=np.uint64))
        wins = group_winners(hits, blk) if blk > 1 else hits
        cnt = int(rng.randint(0, 40))
        lanes = [lane for lane in range(32) if wins >> lane & 1]
        slots = [cnt + bin(wins & ((1 << lane) - 1)).count("1")
                 for lane in lanes]
        assert slots == list(range(cnt, cnt + len(lanes)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_exact_walk_matches_plain_and_pallas(port, case):
    from ogc_tpu.ops.core import _fill_balls
    from ogc_tpu.ops.pallas_knn import (ball_query_exact,
                                        ball_query_exact_pruned)

    x, out = port
    name, _, _, radius, ns, _, _ = case
    xyz, c = x[name + "/xyz"], x[name + "/centres"]
    got = model_balls(xyz, c, radius, ns, 1)
    np.testing.assert_array_equal(got, out[name + "/exact"])
    for fn in (ball_query_exact, ball_query_exact_pruned):
        cand = fn(radius, ns, jnp.asarray(xyz), jnp.asarray(c),
                  interpret=True)
        np.testing.assert_array_equal(got, np.asarray(_fill_balls(cand, ns)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_blockmin_walk_matches_plain_and_pallas(port, case):
    from ogc_tpu.ops.core import _fill_balls
    from ogc_tpu.ops.pallas_knn import ball_query_blockmin

    x, out = port
    name, n, _, radius, ns, _, _ = case
    blk = block_size(n, ns)
    assert int(out[name + "/blk"]) == blk
    xyz, c = x[name + "/xyz"], x[name + "/centres"]
    got = model_balls(xyz, c, radius, ns, blk)
    np.testing.assert_array_equal(got, out[name + "/blockmin"])
    cand = ball_query_blockmin(radius, ns, jnp.asarray(xyz), jnp.asarray(c),
                               interpret=True)
    np.testing.assert_array_equal(got, np.asarray(_fill_balls(cand, ns)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_balls_cover_full_empty_and_early_stops(port, case):
    """Each case holds what it was made for: tight clouds fill every ball
    from the first candidate of each run and stop as soon as ns runs are
    walked (the exact ball after one step of 32); mixed ones hold empty
    balls (all zeros), under-full and full ones."""
    x, out = port
    name, n, _, radius, ns, _, kind = case
    xyz, c = x[name + "/xyz"], x[name + "/centres"]
    for mode, blk in (("exact", 1), ("blockmin", block_size(n, ns))):
        balls = out[name + "/" + mode]
        if kind == "tight":
            np.testing.assert_array_equal(
                balls, np.broadcast_to(np.arange(ns) * blk, balls.shape))
            # Full within the first ns * blk candidates: the exact balls
            # within the first step of 32.
            steps = -(-ns * blk // 32)
            assert blk > 1 or steps == 1
            d2 = _d2(c, xyz)
            assert all(ball_walk(row, r2_of(radius), ns, blk)[1] == steps
                       for cloud in d2 for row in cloud)
        else:
            full = balls[..., -1] != balls[..., 0]
            empty = (balls == 0).all(-1)
            assert empty.any() and full.any() and (~full & ~empty).any()


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
    np.testing.assert_array_equal(out["launches_blockmin"], [0, 0])
