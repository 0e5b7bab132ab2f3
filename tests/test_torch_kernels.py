"""The port's FPS and exact-KNN kernels (ogc_tpu_torch/ops/{fps,knn}.py)
against the Pallas kernels they replace, run in interpret mode.

On CPU tensors the port's wrappers take their plain PyTorch versions, so
this holds those to the Pallas contract; chip_smoke.py holds the CUDA
kernels to the plain versions on the card.  Clouds are grid-quantized (1/8
grid), so direct- and expanded-form d2 agree exactly and ties are common.
Indices must be bit-equal; distances agree to 1e-6 (sqrt of equal d2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.torch_port_helper import pack, run_torch

FPS_CASES = [(256, 64), (512, 128)]
KNN_CASES = [(m, k) for m in (700, 1024) for k in (3, 16, 64)]
N_QUERY = 96


def _grid(rng, shape, extent=8.0):
    return (np.round(rng.rand(*shape) * extent * 8) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_kernels")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"fps": {}, "knn": {}}
    for n, npoint in FPS_CASES:
        x[f"fps{n}"] = _grid(rng, (2, n, 3))
        cfg["fps"][f"fps{n}"] = npoint
    for m, k in KNN_CASES:
        name = f"knn{m}_{k}"
        x[name + "/q"] = _grid(rng, (2, N_QUERY, 3))
        x[name + "/p"] = _grid(rng, (2, m, 3))
        cfg["knn"][name] = k
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("kernels", inp, str(tmp / "out.npz"))])
    return x, out


@pytest.mark.parametrize("n,npoint", FPS_CASES)
def test_fps_plain_matches_pallas(port, n, npoint):
    from ogc_tpu.ops.pallas_kernels import furthest_point_sample_pallas

    x, out = port
    want = furthest_point_sample_pallas(jnp.asarray(x[f"fps{n}"]), npoint,
                                        True)
    np.testing.assert_array_equal(out[f"fps{n}"], np.asarray(want))


@pytest.mark.parametrize("m,k", KNN_CASES)
def test_knn_exact_plain_matches_pallas(port, m, k):
    from ogc_tpu.ops.pallas_knn import knn_exact

    x, out = port
    name = f"knn{m}_{k}"
    d, i = knn_exact(k, jnp.asarray(x[name + "/q"]), jnp.asarray(x[name + "/p"]),
                     interpret=True)
    np.testing.assert_array_equal(out[name + "/idx"], np.asarray(i))
    np.testing.assert_allclose(out[name + "/dist"], np.asarray(d), rtol=0,
                               atol=1e-6)


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
