"""The port's ops/core.py against ogc_tpu.ops in exact-neighbour mode on
grid-quantized clouds: indices bit-equal, features within 1e-6 (the same
f32 arithmetic in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ogc_tpu import ops
from tests.torch_port_helper import pack, run_torch

RADIUS, NSAMPLE, BIG_K = 0.2, 16, 40


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ops")
    rng = np.random.RandomState(1)

    def grid(*shape):
        return (np.round(rng.rand(*shape) * 16) / 16).astype(np.float32)

    x = {
        "xyz": grid(2, 200, 3),
        "new_xyz": grid(2, 50, 3),
        "feats": rng.randn(2, 200, 5).astype(np.float32),
        "known_feats": rng.randn(2, 50, 7).astype(np.float32),
        "small": grid(2, 24, 3),  # BIG_K > M exercises the k > M padding
    }
    cfg = {"radius": RADIUS, "nsample": NSAMPLE, "big_k": BIG_K}
    (out,) = run_torch([("core", pack(str(tmp / "in.npz"), x, cfg),
                         str(tmp / "out.npz"))])
    prev = ops.exact_neighbors()
    ops.set_exact_neighbors(True)
    try:
        j = {k: jnp.asarray(v) for k, v in x.items()}
        feats, gxyz = ops.query_and_group(RADIUS, NSAMPLE, j["xyz"],
                                          j["new_xyz"], j["feats"])
        idx, w = ops.interpolate_weights(j["xyz"], j["new_xyz"])
        interp = ops.three_interpolate(j["known_feats"], idx, w)
        d, i = ops.knn(BIG_K, j["xyz"], j["small"])
        want = {"qg_feats": feats, "qg_xyz": gxyz, "iw_idx": idx, "iw_w": w,
                "interp": interp, "knn_dist": d, "knn_idx": i}
    finally:
        ops.set_exact_neighbors(prev)
    return out, {k: np.asarray(v) for k, v in want.items()}


def test_query_and_group_radius_clamp(case):
    got, want = case
    np.testing.assert_allclose(got["qg_xyz"], want["qg_xyz"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["qg_feats"], want["qg_feats"], rtol=0,
                               atol=1e-6)


def test_interpolate_weights_and_three_interpolate(case):
    got, want = case
    np.testing.assert_array_equal(got["iw_idx"], want["iw_idx"])
    np.testing.assert_allclose(got["iw_w"], want["iw_w"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["interp"], want["interp"], rtol=0, atol=1e-6)


def test_knn_pads_k_above_m(case):
    got, want = case
    np.testing.assert_array_equal(got["knn_idx"], want["knn_idx"])
    np.testing.assert_allclose(got["knn_dist"], want["knn_dist"], rtol=0,
                               atol=1e-6)
