"""The port's exact neighbour search against the JAX package's below 1024
points, on continuous clouds (ogc_tpu_torch/ops/core.py's documented
deviation).

Below its Pallas gates (M, N >= 1024) the JAX package searches on the
expanded-form d2 |a|^2 - 2ab + |b|^2 (ogc_tpu/ops/core.py::square_distance,
XLA ``top_k``); the port searches on the direct form
((dx*dx + dy*dy) + dz*dz) at every size, as the Pallas kernels and the
reference CUDA do.  On the grid-quantized clouds of the other tests both
forms are exact; here the clouds are continuous SAPIEN-shaped scenes
(tests/synth.py::make_sapien_root_coherent, 512 points), searched at every
SAPIEN site of the main path: SA0 (256 FPS centres, k 64, radius clamps 0.1
and 0.2), SA1 (128 centres of SA0's 256, k 64, clamp 0.4), the two FP
three_nn (256 <- 128, 512 <- 256), the smooth KNN (k 8, clamp 0.1), the
smooth ball (ns 16, r 0.2) and OA-ICP's k = 1 mask interpolation (the view
1 cloud against view 0 warped by a noisy flow).  JAX runs ``ops.knn`` /
``ops.ball_query`` with ``exact=True`` (on the CPU: XLA, expanded form);
the port its exact routes on CPU tensors (the plain versions, which the
kernels equal bit for bit).

Each site counts the (query) lists that differ, and every differing
position must be a near-tie.  The bound: the expanded form's f32 rounding
of a pair's d2 is at most EPS_FACTOR * 2^-24 * (|q| + |p|)^2 (the norms'
three products and two sums, the inner product's, and the two final sums,
each at most a few units of rounding of a term no larger than
(|q| + |p|)^2; the direct form's own rounding, ~3 units of d2, is inside
it), taken per query over its candidates as eps_q.  A KNN position j whose
entries differ (a from JAX, b from the port) must have
|D(a) - D(b)| <= 2 eps_q, D the direct-form d2 (the j-th order statistic of
a list moves by at most the sup of the perturbation, so the entries the two
forms put at j differ in true d2 by at most twice it); where the radius
clamp decides differently, the raw entry's D must lie within 2 eps_q of
r^2.  A ball's smallest index in one list but not the other must have its
D within eps_q of r^2 (and, for under-full balls, every such index).
"""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from tests.synth import make_sapien_root_coherent
from tests.torch_port_helper import pack, run_torch

N_SCENES, N_VIEWS, N_POINT = 8, 4, 512
U = 2.0 ** -24
EPS_FACTOR = 16.0
# (site, kind, k or nsample, radius or None)
SITES = [("SA0 r0.1", "knn", 64, 0.1), ("SA0 r0.2", "knn", 64, 0.2),
         ("SA1 r0.4", "knn", 64, 0.4), ("FP 256<-128", "knn", 3, None),
         ("FP 512<-256", "knn", 3, None), ("smooth knn", "knn", 8, 0.1),
         ("smooth ball", "ball", 16, 0.2), ("OA-ICP k1", "knn", 1, None)]


def _direct_d2(q, p):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) float32, the port's pair_d2."""
    dx = p[:, None, :, 0] - q[:, :, None, 0]
    dy = p[:, None, :, 1] - q[:, :, None, 1]
    dz = p[:, None, :, 2] - q[:, :, None, 2]
    return (dx * dx + dy * dy) + dz * dz


def _eps(q, p):
    """(B, N): the expanded form's rounding bound per query."""
    qn = np.linalg.norm(q.astype(np.float64), axis=-1)
    pn = np.linalg.norm(p.astype(np.float64), axis=-1).max(-1)
    return EPS_FACTOR * U * (qn + pn[:, None]) ** 2


def _inputs(tmp):
    """The searched clouds of every site (numpy, float32)."""
    make_sapien_root_coherent(str(tmp), n_scenes=N_SCENES, n_views=N_VIEWS,
                              n_points=N_POINT, seed=3)
    pcs = np.stack([np.load(osp.join(str(tmp), "data", "%06d.npz" % i))["pc"]
                    for i in range(N_SCENES)])  # (S, V, N, 3)
    pc = pcs.reshape(-1, N_POINT, 3).astype(np.float32)
    rows = np.arange(pc.shape[0])[:, None]
    c0 = pc[rows, np.asarray(ops.furthest_point_sample(jnp.asarray(pc),
                                                       256))]
    c1 = c0[rows, np.asarray(ops.furthest_point_sample(jnp.asarray(c0),
                                                       128))]
    rng = np.random.RandomState(0)
    pc1, pc2 = pcs[:, 0], pcs[:, 1]
    flow = (pc2 - pc1 + 0.01 * rng.randn(*pc1.shape)).astype(np.float32)
    warped = (pc1 + flow).astype(np.float32)
    return {"SA0 r0.1": (c0, pc), "SA0 r0.2": (c0, pc), "SA1 r0.4": (c1, c0),
            "FP 256<-128": (c0, c1), "FP 512<-256": (pc, c0),
            "smooth knn": (pc, pc), "smooth ball": (pc, pc),
            "OA-ICP k1": (pc2.astype(np.float32), warped)}


def _clamp(dist, idx, radius):
    if radius is None:
        return idx
    return np.where(dist > np.float32(radius), idx[..., :1], idx)


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search_form")
    clouds = _inputs(tmp / "sapien")
    x, cfg = {}, {"sites": {}}
    for name, kind, k, radius in SITES:
        q, p = clouds[name]
        x[name + "/q"], x[name + "/p"] = q, p
        cfg["sites"][name] = [kind, k, radius]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    out, = run_torch([("search_form", inp, str(tmp / "out.npz"))])
    return clouds, out


def _knn_site(clouds, out, name, k, radius):
    q, p = clouds[name]
    jd, ji = (np.asarray(v)
              for v in ops.knn(k, jnp.asarray(q), jnp.asarray(p), exact=True))
    td, ti = out[name + "/dist"], out[name + "/idx"]
    want, got = _clamp(jd, ji, radius), _clamp(td, ti, radius)
    D, eps = _direct_d2(q, p), _eps(q, p)
    bad = []
    for b, n, j in zip(*np.nonzero(want != got)):
        d, e = D[b, n], 2 * eps[b, n]
        a, c = want[b, n, j], got[b, n, j]
        ok = abs(float(d[a]) - float(d[c])) <= e
        if radius is not None and (jd[b, n, j] > radius) != (
                td[b, n, j] > radius):
            r2 = float(np.float32(radius * radius))
            ok = ok or min(abs(float(d[ji[b, n, j]]) - r2),
                           abs(float(d[ti[b, n, j]]) - r2)) <= e
        if not ok:
            bad.append((b, n, j, a, c, float(d[a]), float(d[c]), e))
    raw = int((ji != ti).any(-1).sum())
    return (int((want != got).any(-1).sum()), raw,
            want.shape[0] * want.shape[1], bad)


def _ball_site(clouds, out, name, ns, radius):
    q, p = clouds[name]
    want = np.asarray(ops.ball_query(radius, ns, jnp.asarray(p),
                                     jnp.asarray(q), exact=True))
    got = out[name + "/idx"]
    D, eps = _direct_d2(q, p), _eps(q, p)
    r2 = float(np.float32(radius * radius))
    bad = []
    differ = np.nonzero((want != got).any(-1))
    for b, n in zip(*differ):
        sets = []
        for lst in (want[b, n], got[b, n]):
            count = 1
            while count < ns and lst[count] > lst[count - 1]:
                count += 1
            sets.append(set(lst[:count].tolist()))
        diff = sorted(sets[0] ^ sets[1])
        full = len(sets[0]) == ns or len(sets[1]) == ns
        for i in (diff[:1] if full else diff):
            if abs(float(D[b, n, i]) - r2) > eps[b, n]:
                bad.append((b, n, i, float(D[b, n, i]), r2, eps[b, n]))
    n_differ = len(differ[0])
    return n_differ, n_differ, want.shape[0] * want.shape[1], bad


@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_differences_are_near_ties(searched, site):
    clouds, out = searched
    name, kind, k, radius = site
    if kind == "knn":
        differ, raw, lists, bad = _knn_site(clouds, out, name, k, radius)
    else:
        differ, raw, lists, bad = _ball_site(clouds, out, name, k, radius)
    print(f"{name}: {differ} of {lists} lists differ ({raw} before the "
          f"radius clamp)")
    assert not bad, f"{name}: {len(bad)} differences beyond the bound: " \
                    f"{bad[:5]}"
    assert (out["launches"] == 0).all()
