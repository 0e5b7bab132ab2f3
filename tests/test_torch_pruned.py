"""The port's bound-pruned exact KNN (ogc_tpu_torch/ops/knn_pruned.py, kernel
#4) against the Pallas kernel it replaces, run in interpret mode, and
against the exact KNN (#2) whose contract it keeps; its survivor blocks
against the JAX package's prologue; and the ops.knn route against the JAX
package's gate.

On CPU tensors ``knn_exact_pruned`` takes its plain version (the prologue,
then #2's arithmetic over each query's surviving candidates only), so this
holds that version, and the pruning it relies on, to the Pallas contract;
chip_smoke.py holds the CUDA kernel to the plain version and to #2 on the
card.  Clouds are on a 1/8 grid, so every d2 is exact and ties are common:
indices and distances must be bit-equal, and the survivor lists equal
(same query tile and block sizes on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

# (N queries, M points, k, cb, qt, layout): ragged M (1500, 5000: pads in
# the last block), ragged N (300: repeated last query in the last tile),
# k = 64 over blocks of 32 points (a k-list spans several blocks), and a
# clustered cloud where tiles prune blocks.
CASES = [(256, 1500, 16, 128, 128, "grid"), (300, 2048, 32, 128, 128, "grid"),
         (256, 5000, 32, 128, 128, "grid"), (256, 2048, 64, 32, 128, "grid"),
         (384, 4096, 32, 128, 128, "clusters")]
# (N, M, k) for the route: the JAX gate is exact mode, 1024 <= M <= 16384,
# M >= k, M >= 4096 and N >= 1024, with OGC_PALLAS_EXACT_PRUNE=knn.
GATE = [(n, m, k) for n in (512, 1023, 1024, 2048)
        for m in (1024, 4095, 4096, 8192, 16384, 16385) for k in (3, 32, 64)]


def _name(case):
    return "_".join(map(str, case))


def _cloud(rng, b, n, layout):
    x = rng.rand(b, n, 3) * 8
    if layout == "clusters":
        x = x / 4 + 20.0 * rng.randint(0, 3, (b, n, 3))
    return (np.round(x * 8) / 8).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pruned")
    rng = np.random.RandomState(4)
    x, cfg = {}, {"cases": {}, "gate": GATE}
    for case in CASES:
        n, m, k, cb, qt, layout = case
        name = _name(case)
        x[name + "/q"] = _cloud(rng, 2, n, layout)
        x[name + "/p"] = _cloud(rng, 2, m, layout)
        cfg["cases"][name] = [k, cb, qt]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("pruned", inp, str(tmp / "out.npz"))])
    return x, out


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_pruned_plain_matches_pallas_and_exact(port, case):
    from ogc_tpu.ops.pallas_knn import knn_exact, knn_exact_pruned

    x, out = port
    n, m, k, cb, qt, _ = case
    name = _name(case)
    q, p = jnp.asarray(x[name + "/q"]), jnp.asarray(x[name + "/p"])
    d, i = knn_exact_pruned(k, q, p, cb=cb, qt=qt, interpret=True)
    np.testing.assert_array_equal(out[name + "/idx"], np.asarray(i))
    np.testing.assert_array_equal(out[name + "/dist"], np.asarray(d))
    d2, i2 = knn_exact(k, q, p, interpret=True)
    np.testing.assert_array_equal(out[name + "/idx"], np.asarray(i2))
    np.testing.assert_array_equal(out[name + "/dist"], np.asarray(d2))


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_survivors_match_jax(port, case):
    """order and count of the surviving blocks per query tile equal the
    JAX package's (pallas_knn.py:1066-1084) for the same cb and qt."""
    from ogc_tpu.ops.pallas_knn import (_pruned_prologue, _survivor_order,
                                        _theta_inflate, knn_blockmin)

    x, out = port
    n, m, k, cb, qt, layout = case
    name = _name(case)
    q, p = jnp.asarray(x[name + "/q"]), jnp.asarray(x[name + "/p"])
    _, _, _, q_s, lb2, _ = _pruned_prologue(q, p, cb, qt)
    fd, _ = knn_blockmin(k, q_s, p, recall_target=0.98, interpret=True)
    theta = (fd[..., k - 1] ** 2) * _theta_inflate(m)
    theta_tile = jnp.max(theta.reshape(2, -1, qt), axis=-1)
    order, count = _survivor_order(lb2, theta_tile)
    np.testing.assert_array_equal(out[name + "/count"], np.asarray(count))
    np.testing.assert_array_equal(out[name + "/order"], np.asarray(order))
    if layout == "clusters":
        assert out[name + "/count"].min() < lb2.shape[-1]


def test_pruned_route_matches_jax_gate(port, monkeypatch):
    """ops.knn in exact mode takes #4 exactly where the JAX package's
    _knn_jit takes knn_exact_pruned: with the gate at "knn" only (its
    default "on" prunes the ball query alone)."""
    from ogc_tpu.ops import core, pallas_knn

    used = []

    def fake(tag):
        def fn(k, q, p, **kw):
            used.append(tag)
            shape = q.shape[:2] + (k,)
            return jnp.zeros(shape), jnp.zeros(shape, jnp.int32)
        return fn

    monkeypatch.setattr(core, "pallas_available", lambda: True)
    monkeypatch.setattr(pallas_knn, "knn_exact", fake("exact"))
    monkeypatch.setattr(pallas_knn, "knn_exact_pruned", fake("pruned"))
    want = []
    for mode in ("on", "knn"):
        monkeypatch.setattr(core, "_PALLAS_EXACT_PRUNE_ENV", mode)
        for n, m, k in GATE:
            used.clear()
            core._knn_jit.__wrapped__(k, jnp.zeros((1, n, 3)),
                                      jnp.zeros((1, m, 3)), 4096, True, 0.95)
            want.append(used == ["pruned"])
    _, out = port
    assert any(want) and not all(want)
    np.testing.assert_array_equal(out["routes"], np.array(want))


def test_pruned_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches_flow"], [0, 0])
    np.testing.assert_array_equal(out["launches_blockmin"], [0, 0])
