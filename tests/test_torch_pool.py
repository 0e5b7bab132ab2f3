"""The port's row-group pool (ogc_tpu_torch/ops/pool.py, kernel #12) against
the Pallas kernel it replaces, run in interpret mode, and the port's
pool_neighbors gate against the JAX package's.

On CPU tensors ``rowgroup_pool`` takes its plain version, so this holds that
version to the Pallas kernel; chip_smoke.py holds the CUDA kernel to the
plain version on the card.  Max pooling is a selection, so it must be
bit-equal.  Mean pooling sums S values in float32, the plain version in
ascending s and XLA's reduction in an order of its own: within 1e-6
relative (a few float32 roundings of values of order 1) in float32, and
within one bf16 unit in the last place (2^-8 relative) where the sum is then
rounded to bf16.  The cases are those of tests/test_pallas_pool.py, in both
dtypes.

The kernel rounds ``x * scale`` and then ``+ add`` (two roundings, pinned
against FMA contraction), and so does its plain version; XLA on the CPU
contracts the pair into one FMA (one rounding), in interpret mode as in its
plain chain, and then differs in about a quarter of the elements by one
float32 rounding.  So the scales against JAX are powers of two, where the
product is exact and both forms give the same bits; with general scales
the plain version is held bit-equal to a numpy oracle of the two-rounding
arithmetic and to JAX within one float32 rounding of the product (|x *
scale| < 8 here, so 1e-6 absolute).

NaN and -0.0 rows go through the kernel's route of pool_neighbors in both
packages with the scale and the add absent or given: NaN at the same
places (ReLU and the max keep it), every zero with the same sign (an
absent add is +0.0 added, so a -0.0 group pools to +0.0).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

SC_CASES = [(4, 128), (8, 64), (16, 32), (32, 128), (32, 16), (16, 256),
            (64, 64)]
MODES = [(True, False), (False, False), (True, True)]
N_GROUPS = 512
ROWGROUP = ([(s, c, relu, mean, False) for s, c in SC_CASES
             for relu, mean in MODES]
            + [(s, c, relu, mean, True) for s, c in ((32, 32), (8, 128))
               for relu, mean in MODES]
            + [(8, 128, True, False, "bcast"), (8, 128, False, True, "bcast")]
            + [(16, 32, True, False, "general"), (8, 64, False, False,
                                                  "general")])
# (B, M, S, C, scale, add, mean, relu): the affine fold of a BatchNorm
# stack's last layer, the per-group add of a single-layer stack, a bare max.
NEIGHBORS = [(2, 64, 8, 32, True, "c", False, True),
             (2, 64, 8, 32, True, "c", True, True),
             (2, 32, 4, 16, False, "g", False, False),
             (2, 32, 4, 16, False, "g", True, False),
             (2, 64, 16, 32, False, None, False, False)]
GRID = [(n, s, c) for n in (8, 24, 96, 512, 1000, 16384)
        for s in (1, 2, 4, 16, 24, 64, 2048) for c in (3, 8, 16, 128, 1024)]


# pool_neighbors on NaN and -0.0 rows: (mean, relu, scale, add), the scale
# and the add absent (the kernel's null pointers) or given.
SPECIAL = [(mean, relu, scale, add) for mean in (False, True)
           for relu in (True, False) for scale, add in ((False, None),
                                                        (True, "c"),
                                                        (False, "g"))]


def _name(case):
    return "rg_" + "_".join(map(str, case))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pool")
    rng = np.random.RandomState(0)
    x, cfg = {}, {"rowgroup": {}, "neighbors": {}, "grid": GRID}
    for case in ROWGROUP:
        s, c, relu, mean, kind = case
        name = _name(case)
        x[name + "/x"] = rng.randn(N_GROUPS * s, c).astype(np.float32)
        x[name + "/scale"] = (
            rng.rand(c) + 0.5 if kind == "general"
            else 2.0 ** rng.randint(-2, 3, c)).astype(np.float32)
        rows = 1 if kind == "bcast" else N_GROUPS
        x[name + "/add"] = rng.randn(rows, c).astype(np.float32)
        cfg["rowgroup"][name] = [s, relu, mean, kind is True]
    for i, (b, m, s, c, scale, add, mean, relu) in enumerate(NEIGHBORS):
        name = f"nb{i}"
        x[name + "/x"] = rng.randn(b, m, s, c).astype(np.float32)
        if scale:
            x[name + "/scale"] = (2.0 ** rng.randint(-2, 3, c)).astype(
                np.float32)
        if add == "c":
            x[name + "/add"] = rng.randn(c).astype(np.float32)
        elif add == "g":
            x[name + "/add"] = rng.randn(b, m, c).astype(np.float32)
        cfg["neighbors"][name] = [mean, relu]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    sx, scfg = {}, {"cases": {}}
    for i, (mean, relu, scale, add) in enumerate(SPECIAL):
        name = f"sp{i}"
        v = rng.randn(2, 64, 8, 16).astype(np.float32)
        v.reshape(-1, 16)[rng.choice(2 * 64 * 8, 40, replace=False)] = np.nan
        v[0, :6] = -0.0  # whole groups of -0.0 rows
        v.reshape(-1, 16)[rng.choice(2 * 64 * 8, 200, replace=False)] = -0.0
        sx[name + "/x"] = v
        if scale:
            sx[name + "/scale"] = (2.0 ** rng.randint(-2, 3, 16)).astype(
                np.float32)
        if add == "c":
            sx[name + "/add"] = rng.randn(16).astype(np.float32)
        elif add == "g":
            sx[name + "/add"] = rng.randn(2, 64, 16).astype(np.float32)
        scfg["cases"][name] = [mean, relu]
    sinp = pack(str(tmp / "sp_in.npz"), sx, scfg)
    out, sout = run_torch([("pool", inp, str(tmp / "out.npz")),
                           ("pool_special", sinp, str(tmp / "sp_out.npz"))])
    out.update(sout)
    x.update(sx)
    return x, out


@pytest.mark.parametrize("case", ROWGROUP, ids=_name)
def test_rowgroup_plain_matches_pallas(port, case):
    from ogc_tpu.ops.pallas_pool import rowgroup_pool, supported

    x, out = port
    s, c, relu, mean, kind = case
    name = _name(case)
    assert supported(N_GROUPS, s, c)
    xx, add = jnp.asarray(x[name + "/x"]), jnp.asarray(x[name + "/add"])
    if kind is True:
        xx, add = xx.astype(jnp.bfloat16), add.astype(jnp.bfloat16)
    want = np.asarray(rowgroup_pool(
        xx, jnp.asarray(x[name + "/scale"]), add, s, relu=relu, mean=mean,
        interpret=True).astype(jnp.float32))
    got = out[name]
    assert got.shape == (N_GROUPS, c)
    if kind == "general":
        y = (x[name + "/x"].reshape(N_GROUPS, s, c) * x[name + "/scale"]
             + x[name + "/add"][:, None])
        oracle = (np.maximum(y, 0) if relu else y).max(1)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got != want).any()  # XLA contracted to an FMA
    elif not mean:
        np.testing.assert_array_equal(got, want)
    elif kind is True:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", range(len(NEIGHBORS)))
def test_pool_neighbors_matches_jax(port, monkeypatch, i):
    """pool_neighbors at OGC_PALLAS_POOL=interpret (the kernel's route, on
    the CPU its plain version) against the JAX package's interpret route,
    and with the gate off against its plain chain (pallas_pool.py:97-109)."""
    from ogc_tpu.ops.pallas_pool import pool_neighbors

    x, out = port
    name = f"nb{i}"
    mean, relu = NEIGHBORS[i][6], NEIGHBORS[i][7]
    kw = {k: jnp.asarray(x[f"{name}/{k}"]) for k in ("scale", "add")
          if f"{name}/{k}" in x}
    tol = dict(rtol=1e-6, atol=1e-6)
    for mode in ("interpret", "off"):
        monkeypatch.setenv("OGC_PALLAS_POOL", mode)
        want = np.asarray(pool_neighbors(jnp.asarray(x[name + "/x"]),
                                         mean=mean, differentiable=False,
                                         relu=relu, **kw))
        got = out[f"{name}/{mode}"]
        if mean:
            np.testing.assert_allclose(got, want, **tol)
        else:
            np.testing.assert_array_equal(got, want)
    # The kernel's route and the chain agree too (float32: the same
    # roundings; a mean in another order).
    np.testing.assert_allclose(out[f"{name}/interpret"], out[f"{name}/off"],
                               **tol)


def test_supported_matches_jax(port):
    from ogc_tpu.ops.pallas_pool import supported

    _, out = port
    want = np.array([supported(*g) for g in GRID])
    assert want.any() and not want.all()
    np.testing.assert_array_equal(out["supported"], want)


def test_pool_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches_flow"], [0, 0])


@pytest.mark.parametrize("i", range(len(SPECIAL)))
def test_pool_neighbors_nan_and_negative_zero_match_jax(port, monkeypatch,
                                                         i):
    """NaN and -0.0 rows through the kernel's route (interpret) in both
    packages: a NaN pools to NaN (ReLU and max keep it, the mean sums it),
    and an absent add is +0.0 added, so a group of -0.0 rows pools to +0.0,
    with the sign of every zero the same."""
    from ogc_tpu.ops.pallas_pool import pool_neighbors

    x, out = port
    name = f"sp{i}"
    mean, relu = SPECIAL[i][:2]
    kw = {k: jnp.asarray(x[f"{name}/{k}"]) for k in ("scale", "add")
          if f"{name}/{k}" in x}
    monkeypatch.setenv("OGC_PALLAS_POOL", "interpret")
    want = np.asarray(pool_neighbors(jnp.asarray(x[name + "/x"]), mean=mean,
                                     differentiable=False, relu=relu, **kw))
    got = out[name]
    assert np.isnan(want).any()
    if relu or "add" not in kw:
        assert (want == 0).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    zero = want == 0
    np.testing.assert_array_equal(got == 0, zero)
    np.testing.assert_array_equal(np.signbit(got[zero]),
                                  np.signbit(want[zero]))
    if "add" not in kw:
        assert not np.signbit(got[zero]).any()
    if mean:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
