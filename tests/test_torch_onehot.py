"""The port's small-source gather/scatter (ogc_tpu_torch/ops/onehot.py) and
its routing in ``ops.group`` against the JAX package's one-hot grouping
(ogc_tpu/ops/pallas_onehot.py, kernels #7/#8 run in interpret mode).

On CPU tensors the port's wrappers take their plain versions, so this holds
those to the Pallas kernels; chip_smoke.py holds the CUDA kernels to the
plain versions on the card.

* Gate: ``onehot_path_applicable`` equal to the JAX gate on a grid of
  (n, rows, c), the JAX side with ``pallas_available`` patched to True (its
  gate is off away from a TPU) for the test only.
* #7: bit-equal to ``gather_rows_onehot`` at (N, C) = (512, 6), (512, 8),
  (130, 3), (1, 1), (300, 11), (1024, 16): every channel count near the
  paths' that the CUDA kernel is compiled for, and N at both ends.
* #8: bit-equal to ``scatter_add_rows_onehot`` on integer-valued
  cotangents (any order sums them exactly), and within rtol 1e-6 / atol
  1e-6 on normal ones (the one-hot product sums in its own order; the
  tolerance of tests/test_onehot_group.py).
* ``ops.group`` at a gated shape (N 512, C 8, 4096 rows per cloud): forward
  bit-equal to ``group_onehot``, VJP within rtol 1e-6 / atol 1e-6.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu.ops import core as jcore
from ogc_tpu.ops import pallas_onehot
from tests.torch_port_helper import pack, run_torch

GATE_GRID = list(itertools.product(
    (1, 100, 128, 129, 500, 512, 896, 1000, 1024, 1025, 2048, 8192),
    (1, 512, 1023, 1024, 4096, 16384),
    (1, 3, 6, 8, 16, 17, 64, 300)))
GATHER_CASES = {"g512x6": (512, 6), "g512x8": (512, 8), "g130x3": (130, 3),
                "g1x1": (1, 1), "g300x11": (300, 11), "g1024x16": (1024, 16)}
# name: (N, C, E, integer-valued)
SCATTER_CASES = {"s_int": (300, 7, 4097, True), "s_normal": (512, 8, 4096,
                                                             False),
                 "s_ball": (512, 8, 8192, False)}
B = 2
GROUP = (512, 8, 512, 8)  # N, C, M, S


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_onehot")
    rng = np.random.RandomState(11)
    x = {}
    for name, (n, c) in GATHER_CASES.items():
        x[name + "/src"] = rng.randn(B, n, c).astype(np.float32)
        x[name + "/idx"] = rng.randint(0, n, (B, 1337)).astype(np.int32)
    for name, (n, c, e, integer) in SCATTER_CASES.items():
        x[name + "/idx"] = rng.randint(0, n, (B, e)).astype(np.int32)
        cot = (rng.randint(-8, 9, (B, e, c)) if integer
               else rng.randn(B, e, c))
        x[name + "/cot"] = cot.astype(np.float32)
    n, c, m, s = GROUP
    x["group/points"] = rng.randn(B, n, c).astype(np.float32)
    x["group/idx"] = rng.randint(0, n, (B, m, s)).astype(np.int32)
    x["group/w"] = rng.randn(B, m, s, c).astype(np.float32)
    cfg = {"gate": GATE_GRID, "gather": list(GATHER_CASES),
           "scatter": {k: v[0] for k, v in SCATTER_CASES.items()}}
    (out,) = run_torch([("onehot", pack(str(tmp / "in.npz"), x, cfg),
                         str(tmp / "out.npz"))])
    return x, out


def test_gate_matches_jax(port, monkeypatch):
    _, out = port
    monkeypatch.setattr(jcore, "pallas_available", lambda: True)
    monkeypatch.delenv("OGC_GROUP_ONEHOT", raising=False)
    want = [pallas_onehot.onehot_path_applicable(*s) for s in GATE_GRID]
    assert out["gate"].tolist() == want
    # The SAPIEN call sites are on the gated side, KITTI-SF's are not.
    sites = {(512, 256 * 64, 6): True, (512, 512 * 8, 8): True,
             (512, 512 * 16, 8): True, (256, 128 * 64, 195): False,
             (8192, 8192 * 32, 10): False}
    for shape, gated in sites.items():
        assert pallas_onehot.onehot_path_applicable(*shape) is gated, shape


@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gather_plain_bit_equal_to_pallas(port, name):
    x, out = port
    want = pallas_onehot.gather_rows_onehot(jnp.asarray(x[name + "/src"]),
                                            jnp.asarray(x[name + "/idx"]))
    np.testing.assert_array_equal(out[name], np.asarray(want))


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_plain_matches_pallas(port, name):
    x, out = port
    n, _, _, integer = SCATTER_CASES[name]
    want = np.asarray(pallas_onehot.scatter_add_rows_onehot(
        jnp.asarray(x[name + "/idx"]), jnp.asarray(x[name + "/cot"]), n))
    if integer:
        np.testing.assert_array_equal(out[name], want)
    else:
        np.testing.assert_allclose(out[name], want, rtol=1e-6, atol=1e-6)


def test_group_routes_and_matches_group_onehot(port):
    x, out = port
    n = GROUP[0]
    pts = jnp.asarray(x["group/points"])
    idx = jnp.asarray(x["group/idx"])
    w = jnp.asarray(x["group/w"])
    fwd, vjp = jax.vjp(lambda p: pallas_onehot.group_onehot(p, idx, n), pts)
    np.testing.assert_array_equal(out["group/out"], np.asarray(fwd))
    np.testing.assert_allclose(out["group/grad"], np.asarray(vjp(w)[0]),
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
    np.testing.assert_array_equal(out["launches_onehot"], [0, 0])
