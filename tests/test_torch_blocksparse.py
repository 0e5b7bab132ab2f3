"""The port's block-sparse grouping (ogc_tpu_torch/ops/blocksparse.py,
kernels #9/#10) against the JAX package's group_blocksparse, whose Pallas
kernels run in interpret mode here.

On CPU tensors the port takes the plain versions (advanced indexing
forward, #11's plain scatter-add backward), so this holds those and the
prologue to the Pallas contract; chip_smoke.py holds the CUDA kernels to
them on the card.  The four cases are tests/test_onehot_group.py's: a
Morton-coherent-like table with an odd S, a uniform table at N = 8192
whose every tile reaches more blocks than the cap, the vjp case, and
integer data.  The forward is a copy and must be bit-equal; the backward
sums each row in ascending edge order where XLA's scatter takes its own
order, so it holds rtol 1e-5 / atol 1e-4 (the JAX test's tolerance) on
float data and bit-equality on integer data, where every order gives the
same sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu.ops import core
from ogc_tpu.ops.pallas_onehot import (_BS_CAP, _bs_pad, _bs_prologue,
                                       _pad_to, group_blocksparse)
from tests.torch_port_helper import pack, run_torch

# name: (seed, B, N, C, M, S, table width (None: uniform), integer data)
CASES = {"coherent": (5, 2, 1024, 10, 700, 7, 300, False),
         "overflow": (6, 1, 8192, 4, 512, 16, None, False),
         "vjp": (7, 2, 512, 6, 512, 8, 150, False),
         "integer": (8, 1, 640, 5, 512, 6, 100, True)}


def _coherent_idx(rng, B, M, S, N, width):
    """tests/test_onehot_group.py::_coherent_idx: targets near the row."""
    i = np.arange(M)[None, :, None]
    off = rng.randint(-width, width + 1, (B, M, S))
    return np.clip(i + off, 0, N - 1).astype(np.int32)


def _inputs(case):
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
    x = {f"{case}/{k}": v for case in CASES
         for k, v in _inputs(case).items()}
    inp = pack(str(tmp / "in.npz"), x, {"cases": list(CASES)})
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
