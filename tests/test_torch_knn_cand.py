"""The port's candidate-pruned KNN (ogc_tpu_torch/ops/knn_cand.py, kernel
#6) against the Pallas kernel it replaces, run in interpret mode through
the JAX package's ``knn_pruned``.

On CPU tensors ``knn_cand`` takes its plain version (the wrapper's steps,
the kernel body in torch), so this holds that version, the prologue's
candidate blocks and the size rounding to the Pallas contract;
chip_smoke.py holds the CUDA kernel to the plain version on the card.  The
cases are tests/test_flash_knn.py's (recall and consistency, ragged shapes,
the route to #3 at a small M), grid clouds with ties, and sizes where the
rounding grows the candidate pool or halves ``blk``.  Every cloud is on a
1/8 grid, so every d2 and every bound is exact: indices and distances must
be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu.ops.pallas_knn import knn_pruned
from tests.synth import scene_like_cloud
from tests.torch_port_helper import pack, run_torch

# name: (B, N, M, k, n_cand_blocks, blk, layout)
CASES = {"recall": (2, 1024, 2048, 16, 10, 4, "scene"),
         "ragged": (1, 333, 999, 8, 4, None, "scene"),
         "small_m": (1, 200, 256, 8, None, None, "unit"),
         "grid": (2, 512, 4096, 32, 12, 2, "grid"),
         "grid_default": (1, 700, 3000, 16, None, None, "grid"),
         "blk_halved": (1, 300, 1408, 8, 9, 4, "grid"),
         "to_blockmin": (1, 300, 1280, 8, 9, 4, "grid")}
# (M, k, n_cand_blocks, blk) -> the JAX wrapper's (n_cand, blk, #3?).
RESOLVE = [((2048, 16, 10, 4), (12, 4, False)),
           ((999, 8, 4, None), (4, 2, False)),
           ((256, 8, None, None), (2, 2, True)),
           ((8192, 32, None, None), (22, 2, False)),
           ((1408, 8, 9, 4), (10, 2, False)),
           ((1280, 8, 9, 4), (10, 2, True)),
           ((4096, 64, 3, None), (3, 1, False))]


def _cloud(rng, n, layout):
    if layout == "scene":
        x = scene_like_cloud(rng, n)
    elif layout == "unit":
        x = rng.rand(n, 3)
    else:
        x = rng.rand(n, 3) * 8
    return (np.round(x * 8) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_knn_cand")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"cases": {}, "resolve": [list(a) for a, _ in RESOLVE]}
    for name, (b, n, m, k, n_cand, blk, layout) in CASES.items():
        x[name + "/q"] = np.stack([_cloud(rng, n, layout) for _ in range(b)])
        x[name + "/p"] = np.stack([_cloud(rng, m, layout) for _ in range(b)])
        cfg["cases"][name] = [k, n_cand, blk]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("knn_cand", inp, str(tmp / "out.npz"))])
    return x, out


@pytest.mark.parametrize("name", list(CASES))
def test_knn_cand_bit_equal_to_pallas(port, name):
    x, out = port
    _, _, m, k, n_cand, blk, _ = CASES[name]
    d, i = knn_pruned(k, jnp.asarray(x[name + "/q"]),
                      jnp.asarray(x[name + "/p"]), n_cand_blocks=n_cand,
                      blk=blk, interpret=True)
    np.testing.assert_array_equal(out[name + "/idx"], np.asarray(i))
    np.testing.assert_array_equal(out[name + "/dist"], np.asarray(d))
    assert int(out[name + "/idx"].max()) < m
    np.testing.assert_array_equal(out["launches_cand"], [0, 0, 0])


def test_route_to_blockmin(port):
    """The pool covering every block is #3's call, as in the JAX wrapper."""
    _, out = port
    routed = {name for name in CASES if bool(out[name + "/blockmin"])}
    assert routed == {"small_m", "to_blockmin"}


@pytest.mark.parametrize("case", range(len(RESOLVE)))
def test_resolve_matches_jax_wrapper(port, case):
    """The pool rounded up to a multiple of blk, blk halved while the
    round-up passes the block count, the defaults from M and k."""
    _, out = port
    np.testing.assert_array_equal(out["resolve"][case], RESOLVE[case][1])
