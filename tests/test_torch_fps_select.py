"""The FPS kernel's selection (ogc_tpu_torch/csrc/fps.cu, kernel #1) on the
CPU: a numpy model of its reduction held against the plain version and the
Pallas kernel, and the host-side choice of the compiled instance.

* The model walks the kernel's layout step by step: thread t owns points
  t + k*T (k < PPT) and keeps the first of its largest min_d2; a warp
  takes the largest float bits, then the lowest index among the lanes
  that hold them; the warps' winners are reduced the same way.  Padding points (j >= N) hold min_d2 =
  +0.  Its indices equal fps_plain's (the torch side on CPU tensors) and
  the Pallas kernel's in interpret mode, bit for bit, for the instance
  fps_plan picks and for the other compiled instances (1, 4, 8 and 32
  points a thread in registers, 16 from shared memory) at other thread
  counts.
* The clouds: every point the same (every d2 = 0), duplicated points, a
  1/8 grid, N = 33, 1000 and 1500 (no multiple of 32 or of the thread
  count), N < 32, and npoint = N.
* fps_plan gives a compiled instance at every path shape: KITTI-SF seg
  (8192 -> 2048, 2048 -> 1024, 1024 -> 512), the KITTI-SF flow forward's
  five stages (8192 .. 512 points), SAPIEN's 512 and 256, and the largest
  cloud the kernel takes; its table's rows end at 512, 2048, 4095 and
  8192 points.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

MAX_N = 14464
# The compiled instances: (points a thread, x, y, z in registers).
COMPILED = {(1, 1), (4, 1), (8, 1), (32, 1), (16, 0)}
# The last N of each row of fps_plan's table; fps_plan gives each
# instance its most threads there.
TABLE_N = (512, 2048, 4095, 8192, MAX_N)
# (name, B, N, npoint, kind)
CLOUDS = [("same", 2, 100, 50, "same"),
          ("dup", 2, 300, 120, "dup"),
          ("grid8", 2, 1000, 300, "grid"),
          ("n33", 2, 33, 33, "rand"),
          ("n1000", 1, 1000, 200, "rand"),
          ("n1500", 1, 1500, 400, "grid"),
          ("n20", 3, 20, 20, "grid"),
          ("n1", 2, 1, 1, "rand")]
# Shapes the paths give fps: KITTI-SF seg, the flow forward's five stages,
# SAPIEN's SA0 and SA1, and the largest cloud.
PATH_N = (8192, 2048, 1024, 4096, 512, 256, MAX_N)
# Other instances the model must agree with: (ppt, threads, reg_xyz).
OTHER_PLANS = [(1, 512, 1), (4, 256, 1), (4, 512, 1), (8, 256, 1),
               (16, 96, 0), (32, 256, 1), (8, 32, 1), (32, 64, 1)]


def _cloud(rng, b, n, kind):
    if kind == "same":
        return np.tile(rng.rand(1, 1, 3).astype(np.float32), (b, n, 1))
    if kind == "dup":
        base = np.round(rng.rand(b, n // 3, 3) * 64) / 8
        return np.repeat(base, 3, axis=1)[:, rng.permutation(n)].astype(
            np.float32)
    if kind == "grid":
        return (np.round(rng.rand(b, n, 3) * 80) / 8).astype(np.float32)
    return rng.rand(b, n, 3).astype(np.float32) * 10


def fps_model(xyz, npoint, plan):
    """csrc/fps.cu's walk for one (N, 3) cloud under ``plan``."""
    ppt, T, _ = plan
    n = len(xyz)
    assert T * ppt >= n and T % 32 == 0
    x = np.zeros((T * ppt, 3), np.float32)
    x[:n] = xyz
    m = np.full(T * ppt, 1e10, np.float32)
    m[n:] = 0.0
    t = np.arange(T)
    out, last = [0], 0
    for _ in range(1, npoint):
        d = x - x[last]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        m = np.minimum(m, d2)
        per = m.reshape(ppt, T)  # thread t holds points t + k * T
        bk = np.argmax(per, axis=0)  # the first of the largest
        bits = per[bk, t].view(np.uint32)
        idx = (t + bk * T).astype(np.uint32)
        wb, wi = bits.reshape(T // 32, 32), idx.reshape(T // 32, 32)
        top = wb.max(-1)  # redux max, then redux min over the holders
        win = np.where(wb == top[:, None], wi, 0xFFFFFFFF).min(-1)
        last = int(np.where(top == top.max(), win, 0xFFFFFFFF).min())
        assert last < n
        out.append(last)
    return np.array(out, np.int32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fps_select")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"clouds": {}, "plan_n": sorted({c[2] for c in CLOUDS}
                                                 | set(PATH_N)
                                                 | set(TABLE_N))}
    for name, b, n, npoint, kind in CLOUDS:
        x[name] = _cloud(rng, b, n, kind)
        cfg["clouds"][name] = npoint
    inp = pack(str(tmp / "in.npz"), x, cfg)
    out, = run_torch([("fps_select", inp, str(tmp / "out.npz"))])
    plans = {int(r[0]): tuple(int(v) for v in r[1:]) for r in out["plans"]}
    return x, out, plans


@pytest.mark.parametrize("case", CLOUDS, ids=lambda c: c[0])
def test_model_matches_plain_and_pallas(port, case):
    from ogc_tpu.ops.pallas_kernels import furthest_point_sample_pallas

    x, out, plans = port
    name, _, n, npoint, kind = case
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(x[name]),
                                                   npoint, True))
    np.testing.assert_array_equal(out[name], want)
    for b in range(x[name].shape[0]):
        np.testing.assert_array_equal(
            fps_model(x[name][b], npoint, plans[n]), out[name][b])
    if kind == "same":
        assert (out[name] == 0).all()  # every d2 ties at 0: index 0 wins
    if npoint == n:
        assert all(len(set(r)) == n for r in out[name].tolist())


@pytest.mark.parametrize("plan", OTHER_PLANS, ids=str)
def test_model_is_the_same_under_every_instance(port, plan):
    x, out, plans = port
    ppt, T, reg = plan
    most = {p[:1] + p[2:]: p[1] for p in map(plans.get, TABLE_N)}
    assert T <= most[(ppt, reg)]  # a compiled instance, as many threads
    for name, _, n, npoint, _ in CLOUDS:
        if T * ppt < n:
            continue
        np.testing.assert_array_equal(
            fps_model(x[name][0], npoint, plan), out[name][0])


def test_plans_pick_compiled_instances(port):
    _, _, plans = port
    for n in sorted(set(PATH_N) | set(TABLE_N)):
        ppt, T, reg = plans[n]
        assert (ppt, reg) in COMPILED and T % 32 == 0
        assert 32 <= T <= (1024 if not reg else 256 if ppt == 32 else 512)
        assert T * ppt >= n > (T - 32) * ppt  # no more warps than needed
        # x, y, z in registers wherever a register instance holds the cloud
        assert reg == (n <= 8192)
        assert (ppt == 32) == (4096 <= n <= 8192)
    assert plans[8192] == (32, 256, 1) and plans[4096] == (32, 128, 1)
    assert plans[4095] == (8, 512, 1) and plans[2048] == (4, 512, 1)
    assert plans[1024] == (4, 256, 1) and plans[512] == (1, 512, 1)
    assert plans[256] == (1, 256, 1) and plans[MAX_N] == (16, 928, 0)
