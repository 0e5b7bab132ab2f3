"""The port's ball query, scatter-add and grouping backward
(ogc_tpu_torch/ops/{ball,scatter,core}.py) against the JAX package.

On CPU tensors the port's wrappers take their plain PyTorch versions, so
this holds those to the Pallas kernels they replace, run in interpret mode;
chip_smoke.py holds the CUDA kernels to the plain versions on the card.

* Ball query: bit-equal to ``ball_query_exact_pruned`` (kernel #5) and
  ``ball_query_exact`` (kernel #3 in exact-ball mode), each completed by
  ``ops.core._fill_balls``, and to ``ops.ball_query(exact=True)``.  Clouds
  are on a 1/8 grid, so every d2 is exact and d2 == r^2 ties occur; the
  cases hold crowded, under-full and empty balls and nsample > N.
* Scatter-add: bit-equal to ``pallas_scatter.scatter_add_rows`` (kernel
  #11); values are continuous, so the summation order is what is tested.
* ``group`` backward: equal to ``jax.grad`` of ``ops.group`` within 1e-6
  (XLA's scatter-add sums in its own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from ogc_tpu.ops.core import _fill_balls
from tests.torch_port_helper import pack, run_torch

# name: (n_points, n_centres, radius, nsample, extent)
BALL_CASES = {
    "crowded": (700, 160, 2.0, 16, 6.0),
    "underfull": (700, 160, 1.0, 64, 12.0),
    "small_n": (40, 96, 2.0, 64, 4.0),
}
# name: (B, R, n_dest, C)
SCATTER_CASES = {"wide": (2, 3000, 300, 10), "hub": (2, 2500, 40, 3)}


def _grid(rng, shape, extent):
    return (np.round(rng.rand(*shape) * extent * 8) / 8).astype(np.float32)


def _ball_inputs(rng, n, m, extent):
    xyz = _grid(rng, (2, n, 3), extent)
    # Centres: a third are points of the cloud, a third elsewhere in the
    # box, a third far outside it (empty balls).
    k = m // 3
    centres = np.concatenate([
        xyz[:, :k], _grid(rng, (2, k, 3), extent),
        _grid(rng, (2, m - 2 * k, 3), extent) + 4 * extent], 1)
    return xyz, centres


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ball_scatter")
    rng = np.random.RandomState(5)
    x, cfg = {}, {"ball": {}, "scatter": {}}
    for name, (n, m, radius, ns, extent) in BALL_CASES.items():
        x[name + "/xyz"], x[name + "/centres"] = _ball_inputs(rng, n, m,
                                                              extent)
        cfg["ball"][name] = (radius, ns)
    for name, (B, R, n_dest, C) in SCATTER_CASES.items():
        hi = n_dest if name == "wide" else 4  # "hub": a few long segments
        idx = rng.randint(0, hi, (B, R)).astype(np.int32)
        if name == "hub":
            idx[:, ::7] = rng.randint(0, n_dest, (B, len(idx[0, ::7])))
        x[name + "/idx"] = idx
        x[name + "/g"] = rng.randn(B, R, C).astype(np.float32)
        cfg["scatter"][name] = n_dest
    x["group/points"] = rng.randn(2, 90, 5).astype(np.float32)
    x["group/idx"] = rng.randint(0, 90, (2, 60, 12)).astype(np.int32)
    x["group/idx"][:, :, 6:] = x["group/idx"][:, :, :1]  # repeated rows
    x["group/w"] = rng.randn(2, 60, 12, 5).astype(np.float32)
    (out,) = run_torch([("ball_scatter", pack(str(tmp / "in.npz"), x, cfg),
                         str(tmp / "out.npz"))])
    return x, out


@pytest.mark.parametrize("name", list(BALL_CASES))
def test_ball_query_plain_matches_jax(port, name):
    from ogc_tpu.ops import pallas_knn

    x, out = port
    n, m, radius, ns, _ = BALL_CASES[name]
    xyz, centres = jnp.asarray(x[name + "/xyz"]), jnp.asarray(
        x[name + "/centres"])
    got = out[name]
    assert got.shape == (2, m, ns) and got.dtype == np.int32
    want = ops.ball_query(radius, ns, xyz, centres, exact=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    if ns <= n:  # the Pallas kernels require nsample <= N
        for fn in (pallas_knn.ball_query_exact,
                   pallas_knn.ball_query_exact_pruned):
            cand = fn(radius, ns, xyz, centres, interpret=True)
            np.testing.assert_array_equal(
                got, np.asarray(_fill_balls(cand, ns)), err_msg=fn.__name__)
    # The cases hold what they are named for.
    distinct = (got != got[..., :1]).sum(-1) + 1
    assert (got == 0).all(-1).any(), "no empty ball"
    if name == "crowded":
        assert (distinct == ns).mean() > 0.3
    else:
        assert ((distinct > 1) & (distinct < ns)).mean() > 0.3


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_add_plain_matches_pallas(port, name):
    from ogc_tpu.ops.pallas_scatter import scatter_add_rows

    x, out = port
    n_dest = SCATTER_CASES[name][2]
    want = scatter_add_rows(jnp.asarray(x[name + "/idx"]),
                            jnp.asarray(x[name + "/g"]), n_dest)
    np.testing.assert_array_equal(out[name], np.asarray(want))


def test_group_backward_matches_jax_grad(port):
    x, out = port
    w = jnp.asarray(x["group/w"])
    want = jax.grad(lambda p: jnp.sum(ops.group(p, jnp.asarray(
        x["group/idx"])) * w))(jnp.asarray(x["group/points"]))
    np.testing.assert_allclose(out["group/grad"], np.asarray(want), rtol=0,
                               atol=1e-6)


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
