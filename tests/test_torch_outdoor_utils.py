"""The outdoor path's utilities in the port against the JAX package: FPS on
full-resolution clouds (kernel #1 above its single-CTA limit), ICP, GPF
and the KITTI benchmark's sampling (ogc_tpu_torch/ops/fps.py,
utils/{icp,gpf}.py, test_flow_kittisf_benchmark.py).  The torch side runs
in one subprocess (tests/torch_port_helper.py, case ``outdoor_utils``).

* FPS at N = 16384 and 20480 (above ops/fps.py::MAX_N = 14464), npoint
  1024, B = 2, on 1/8-grid clouds (every d2 exact), one of them with the
  batched CLIs' padding (duplicates of row 0, ``_pad_rows``): the plain
  version bit-equal to JAX ``furthest_point_sample``, no padding row
  picked, and a numpy model of the cluster instance (CTA r holds points
  [r S, r S + S), each CTA reduces its slice as the single-CTA kernel,
  then the cluster reduces the CTAs' winners by (largest bits, lowest
  index)) equal to both under fps_plan's instance and a cluster of 7;
  fps_plan's instances at and above MAX_N (4-16 CTAs of 32 points a
  thread, no CTA empty, up to 131072 points).
* ICP: icp_batched against JAX ``icp_xla`` (exact neighbours on both
  sides) and the port's numpy ``icp`` against JAX's, on four seeded
  scene-like cloud pairs of 256-1024 points (a rotation of 2-5 degrees
  and a shift of up to 1 m).  Tolerances: rotation entries within 2e-5
  and translation within 5e-4 m of icp_xla (measured 7.4e-6 and 2.0e-4 m:
  two float32 runs with other SVDs and d2 forms, the largest where both
  stop in the same local minimum, 0.67 m from the true transform); the
  numpy oracles equal to 1e-12.
* GPF: ground_plane_fitting_batched's marks equal to
  ``ground_plane_fitting_xla``'s on 4 padded street clouds (1/32 grid)
  without masks,
  with ``valid`` and with ``valid`` + an FPS ``fit_valid``, and on a
  cloud whose every attempt fails; the numpy oracles' marks equal.
* The benchmark's ``preproc`` keeps the JAX CLI's points: the same numpy
  draws from seed 18.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from ogc_tpu.utils.gpf import ground_plane_fitting, ground_plane_fitting_xla
from ogc_tpu.utils.icp import icp, icp_xla
from ogc_tpu_torch.tools.synth import make_waymo_root
from tests.torch_port_helper import pack, run_torch

MAX_N = 14464
FPS_CLOUDS = {"n16384": (16384, False), "n20480": (20480, False),
              "pad20480": (20480, True)}
FPS_NPOINT = 1024
# fps_plan rows: (ppt, x/y/z in registers) instances compiled in fps.cu.
COMPILED = {(1, 1), (4, 1), (8, 1), (32, 1), (16, 0)}
PLAN_N = (MAX_N, MAX_N + 1, 16384, 20480, 65536, 100000, 120000, 131072)
ICP_ITERS = 50
ICP_POINTS = (256, 512, 700, 1024)
GPF_KW = {"n_iter": 5, "n_lpr": 50, "thresh_seed": 0.4, "thresh_dist": 0.4}
GPF_NP_KW = {"n_sample_point": 2048, **GPF_KW}
BENCH_N = 512


def _grid(rng, b, n, extent=80.0):
    return (np.round(rng.rand(b, n, 3) * extent * 8) / 8).astype(np.float32)


def _pad_rows(a, n):
    from test_flow_kittisf import _pad_rows

    return _pad_rows(a, n)


def _rot(deg):
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("zyx", deg, degrees=True).as_matrix()


def _icp_pairs(rng):
    """Scene-like pairs (ground and clusters over 40 m), B = R A + t."""
    A, B, T = [], [], []
    for n in ICP_POINTS:
        a = np.r_[np.c_[40 * rng.rand(n // 2, 1) - 20,
                        0.1 * rng.randn(n // 2, 1),
                        40 * rng.rand(n // 2, 1)],
                  (rng.randn(n - n // 2, 3) * [2.0, 1.0, 2.0]
                   + np.repeat(rng.rand(8, 3) * [40, 2, 40] - [20, 0, 0],
                               -(-(n - n // 2) // 8), 0)[:n - n // 2])]
        R = _rot(rng.uniform(2, 5, 3) * rng.choice([-1, 1], 3))
        t = rng.uniform(-1, 1, 3)
        A.append(a)
        B.append(a @ R.T + t)
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        T.append(M)
    m = max(ICP_POINTS)
    # One batch: every pair padded to the largest cloud by its row 0.
    pad = lambda c: _pad_rows(c.astype(np.float32), m)  # noqa: E731
    return (np.stack([pad(a) for a in A]), np.stack([pad(b) for b in B]),
            np.stack(T), A, B)


def _gpf_clouds(tmp):
    """Street frames of the synthetic Waymo root (tilted ground), padded
    to one 4096 bucket, with their valid masks."""
    root = make_waymo_root(str(tmp / "waymo_gpf"), ["s"], 4, (2500, 3800),
                           seed=3)
    # On a 1/32 grid every d2 of these 70 m clouds is exact, so the two
    # packages' FPS pick the same fit subcloud.
    clouds = [np.round(np.load(f"{root}/data/s/pc_{t:04d}.npy") * 32) / 32
              for t in range(4)]
    P = np.stack([_pad_rows(c, 4096) for c in clouds])
    V = np.zeros(P.shape[:2], bool)
    for i, c in enumerate(clouds):
        V[i, :len(c)] = True
    return clouds, P, V


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_outdoor_utils")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"fps": {}, "plan_n": list(PLAN_N), "icp_iters": ICP_ITERS,
                  "gpf_kw": GPF_KW, "gpf_np_kw": GPF_NP_KW,
                  "bench_n": BENCH_N}
    for name, (n, pad) in FPS_CLOUDS.items():
        c = _grid(rng, 2, n)
        if pad:
            c = np.stack([_pad_rows(a[:n - 3000 - 500 * b], n)
                          for b, a in enumerate(c)])
        x["fps/" + name] = c
        cfg["fps"][name] = FPS_NPOINT
    x["icp/A"], x["icp/B"], T, A, B = _icp_pairs(rng)
    clouds, P, V = _gpf_clouds(tmp)
    # A cloud on which every attempt fails (with its valid mask): 12
    # points scattered over a 100 m cube, fewer than 3 near any plane.
    fail = np.zeros((4096, 3), np.float32)
    fail[:12] = rng.rand(12, 3) * 100 - 50
    P = np.concatenate([P, fail[None]])
    V = np.concatenate([V, np.arange(4096)[None] < 12])
    FV = np.zeros_like(V)
    idx = np.asarray(ops.furthest_point_sample(jnp.asarray(P), 2048))
    np.put_along_axis(FV, idx, True, axis=1)
    x.update({"gpf/P": P, "gpf/V": V, "gpf/FV": FV})
    cfg["gpf"] = {"none": (None, None), "valid": ("gpf/V", None),
                  "fit": ("gpf/V", "gpf/FV")}
    for i, c in enumerate(clouds):
        x[f"gpf_np/{i}"] = c
    cfg["n_gpf_np"] = len(clouds)
    for i in range(3):
        n = 300 + 400 * i  # fewer and more points than BENCH_N
        pc1 = (rng.rand(n, 3) * [40, 4, 40] - [20, 2.5, 0]).astype(np.float32)
        x[f"bench/{i}/pc1"] = pc1
        x[f"bench/{i}/pc2"] = pc1 + 0.1
        x[f"bench/{i}/flow"] = np.full_like(pc1, 0.1)
    cfg["n_bench"] = 3
    out, = run_torch([("outdoor_utils", pack(str(tmp / "in.npz"), x, cfg),
                       str(tmp / "out.npz"))])
    return x, cfg, out, {"T": T, "A": A, "B": B, "clouds": clouds}


def cluster_model(xyz, npoint, plan):
    """csrc/fps.cu's cluster instance for one (N, 3) cloud: ``cluster``
    CTAs of ``threads`` threads with ``ppt`` points each over slices of
    S = ceil(N / cluster) consecutive points."""
    ppt, T, _, C = plan
    n = len(xyz)
    S = -(-n // C)
    assert T * ppt >= S and (C - 1) * S < n
    x = np.zeros((C, T * ppt, 3), np.float32)
    m = np.zeros((C, T * ppt), np.float32)
    gid = np.full((C, T * ppt), 0xFFFFFFFF, np.uint64)
    for r in range(C):
        cnt = min(S, n - r * S)
        x[r, :cnt] = xyz[r * S:r * S + cnt]
        m[r, :cnt] = 1e10
        gid[r, :cnt] = r * S + np.arange(cnt)
    out, last = [0], xyz[0]
    t = np.arange(T)
    for _ in range(1, npoint):
        d = x - last
        m = np.minimum(m, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                       + d[..., 2] * d[..., 2])
        wins = []
        for r in range(C):
            per = m[r].reshape(ppt, T)
            bk = np.argmax(per, axis=0)  # a thread's first largest
            bits = per[bk, t].view(np.uint32).astype(np.uint64)
            idx = gid[r].reshape(ppt, T)[bk, t]
            wb, wi = bits.reshape(T // 32, 32), idx.reshape(T // 32, 32)
            top = wb.max(-1)
            win = np.where(wb == top[:, None], wi, 0xFFFFFFFF).min(-1)
            best = top.max()
            wins.append((best, np.where(top == best, win, 0xFFFFFFFF).min()))
        best = max(b for b, _ in wins)
        g = int(min(i for b, i in wins if b == best))
        out.append(g)
        last = xyz[g]
    return np.array(out, np.int32)


@pytest.mark.parametrize("name", sorted(FPS_CLOUDS))
def test_fps_above_max_n_matches_jax(port, name):
    x, cfg, out, _ = port
    want = np.asarray(ops.furthest_point_sample(jnp.asarray(x["fps/" + name]),
                                                FPS_NPOINT))
    np.testing.assert_array_equal(out["fps/" + name], want)
    n = x["fps/" + name].shape[1]
    if FPS_CLOUDS[name][1]:
        for b in range(2):
            assert (want[b] < n - 3000 - 500 * b).all()  # no padding row
    plans = {int(r[0]): tuple(int(v) for v in r[1:]) for r in out["plans"]}
    other = (32, 96, 1, 7)  # another cluster size
    for plan in (plans[n], other):
        np.testing.assert_array_equal(
            cluster_model(x["fps/" + name][0], 256, plan), want[0, :256])


def test_fps_plan_above_max_n(port):
    _, _, out, _ = port
    for row in out["plans"]:
        n, ppt, T, reg, C = (int(v) for v in row)
        assert (ppt, reg) in COMPILED and T % 32 == 0
        assert T <= (1024 if not reg else 256 if ppt == 32 else 512)
        if n <= MAX_N:
            assert C == 1 and T * ppt >= n
            continue
        S = -(-n // C)
        assert (ppt, reg) == (32, 1) and T * ppt >= S > (T - 32) * ppt
        assert 4 <= C <= 16 and (C - 1) * S < n  # no empty CTA
        assert C == max(4, -(-n // 8192))  # as few CTAs as hold the cloud
    assert dict((int(r[0]), int(r[4])) for r in out["plans"])[131072] == 16


def test_icp_matches_jax_icp_xla_and_numpy(port):
    x, _, out, ref = port
    prev = ops.exact_neighbors()
    ops.set_exact_neighbors(True)
    try:
        want = np.asarray(icp_xla(jnp.asarray(x["icp/A"]),
                                  jnp.asarray(x["icp/B"]),
                                  max_iterations=ICP_ITERS))
    finally:
        ops.set_exact_neighbors(prev)
    got = out["icp/T"]
    rot_gap = np.abs(got[:, :3, :3] - want[:, :3, :3]).max()
    t_gap = np.abs(got[:, :3, 3] - want[:, :3, 3]).max()
    print(f"icp_batched vs icp_xla: rotation {rot_gap:.3e}, translation "
          f"{t_gap:.3e}")
    assert rot_gap <= 2e-5 and t_gap <= 5e-4
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    # Both reach the same transform, the true one or the same local
    # minimum.
    np.testing.assert_allclose(np.abs(got - ref["T"]).max((1, 2)),
                               np.abs(want - ref["T"]).max((1, 2)), atol=1e-3)
    for i, (a, b) in enumerate(zip(x["icp/A"], x["icp/B"])):
        T_np = icp(a, b, max_iterations=ICP_ITERS)[0]
        np.testing.assert_allclose(out["icp/T_np"][i], T_np, atol=1e-12)


@pytest.mark.parametrize("setting", ["none", "valid", "fit"])
def test_gpf_masks_match_jax(port, setting):
    x, cfg, out, _ = port
    v, fv = cfg["gpf"][setting]
    want = np.asarray(ground_plane_fitting_xla(
        jnp.asarray(x["gpf/P"]),
        valid=None if v is None else jnp.asarray(x[v]),
        fit_valid=None if fv is None else jnp.asarray(x[fv]), **GPF_KW))
    got = out["gpf/" + setting]
    np.testing.assert_array_equal(got, want)
    assert want[:4].sum(1).min() > 100  # the street clouds have ground
    if v is not None:
        assert not want[4].any()  # every attempt fails on the last cloud


def test_gpf_numpy_oracle_matches_jax(port):
    x, cfg, out, ref = port
    for i, c in enumerate(ref["clouds"]):
        want = ground_plane_fitting(c, **GPF_NP_KW)
        np.testing.assert_array_equal(out[f"gpf_np/{i}"], want)
        # The far side of the tilted ground rises above the CLIs' height
        # cut (y < 0.3): only the plane finds it.
        assert (want.astype(bool) & (c[:, 1] >= 0.3)).any()


def test_benchmark_preproc_keeps_the_jax_points(port):
    from test_flow_kittisf_benchmark import preproc

    x, cfg, out, _ = port
    np.random.seed(18)
    for i in range(cfg["n_bench"]):
        want = preproc(*(x[f"bench/{i}/{k}"] for k in ("pc1", "pc2", "flow")),
                       remove_ground=True, n_sample_point=BENCH_N)
        for k, w in zip(("pc1", "pc2", "flow"), want):
            np.testing.assert_array_equal(out[f"bench/{i}/{k}"], w)
