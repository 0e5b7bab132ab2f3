"""The port's block-min approximate KNN and ball query
(ogc_tpu_torch/ops/knn_blockmin.py, kernel #3) against the Pallas kernel it
replaces, run in interpret mode, and the port's approximate-mode routing
against the JAX package's gates.

On CPU tensors the port's wrappers take their plain PyTorch versions, so
this holds those to the Pallas contract; chip_smoke.py holds the CUDA
kernel to the plain versions on the card.  Clouds are on a 1/8 grid, so
every d2 is exact and ties (within a run and across runs) are common.
The contract is a deterministic function: indices, truncated distances and
filled balls must be bit-equal.  The torch side runs in approximate mode
(no ``OGC_EXACT_NEIGHBORS``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port_helper import pack, run_torch

N_QUERY = 256
# (M, k, recall): the recall the port's ops.knn passes (0.95 for k >= 8,
# else 0.99); M = 1500 puts pad points in the last tile; the last case
# (recall 0.3) makes pick_block's 32 leave fewer than k runs, so the
# halving loop fires (32 -> 16).
KNN_CASES = [(m, k, 0.95 if k >= 8 else 0.99) for m in (1024, 1500, 2048)
             for k in (3, 16, 64)] + [(1024, 40, 0.3)]
# (N points, radius, nsample, extent): sparse, under-full and crowded balls;
# r = 0.1 and 0.5 against a radius binary cannot hold (0.1) and one it can.
BALL_CASES = [(1500, 0.1, 8, 8.0), (1500, 0.5, 16, 8.0), (2048, 2.0, 64, 8.0),
              (1024, 3.0, 32, 4.0)]
GATE_KNN = [(m, k) for m in (512, 1023, 1024, 1500, 4096)
            for k in (1, 3, 64, 256, 257, 375, 376)]
GATE_BALL = GATE_KNN


def _grid(rng, shape, extent=8.0):
    return (np.round(rng.rand(*shape) * extent * 8) / 8).astype(np.float32)


def _ball_centres(rng, xyz, extent):
    """Cloud points (never empty), far points (always empty), free points."""
    B, n = xyz.shape[0], N_QUERY // 4
    own = xyz[:, rng.randint(0, xyz.shape[1], 2 * n)]
    far = _grid(rng, (B, n, 3), extent) + 100.0
    return np.concatenate([own, far, _grid(rng, (B, n, 3), extent)], 1)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_blockmin")
    rng = np.random.RandomState(3)
    x, cfg = {}, {"knn": {}, "ball": {}, "gate_knn": GATE_KNN,
                  "gate_ball": GATE_BALL}
    for m, k, recall in KNN_CASES:
        name = f"knn{m}_{k}_{recall}"
        x[name + "/q"] = _grid(rng, (2, N_QUERY, 3))
        x[name + "/p"] = _grid(rng, (2, m, 3))
        cfg["knn"][name] = [k, recall]
    for n, radius, ns, extent in BALL_CASES:
        name = f"ball{n}_{radius}_{ns}"
        x[name + "/xyz"] = _grid(rng, (2, n, 3), extent)
        x[name + "/centres"] = _ball_centres(rng, x[name + "/xyz"], extent)
        cfg["ball"][name] = [radius, ns]
    inp = pack(str(tmp / "in.npz"), x, cfg)
    (out,) = run_torch([("blockmin", inp, str(tmp / "out.npz"))], exact=False)
    return x, out


@pytest.mark.parametrize("m,k,recall", KNN_CASES)
def test_knn_blockmin_plain_matches_pallas(port, m, k, recall):
    from ogc_tpu.ops.pallas_knn import knn_blockmin, pick_block

    x, out = port
    name = f"knn{m}_{k}_{recall}"
    if recall == 0.3:
        assert pick_block(m, k, recall) == 32 and -(-m // 32) < k
    d, i = knn_blockmin(k, jnp.asarray(x[name + "/q"]),
                        jnp.asarray(x[name + "/p"]), recall_target=recall,
                        interpret=True)
    np.testing.assert_array_equal(out[name + "/idx"], np.asarray(i))
    np.testing.assert_array_equal(out[name + "/dist"], np.asarray(d))
    assert (out[name + "/idx"] < m).all()


@pytest.mark.parametrize("n,radius,ns,extent", BALL_CASES)
def test_ball_blockmin_plain_matches_pallas(port, n, radius, ns, extent):
    from ogc_tpu.ops.core import _fill_balls
    from ogc_tpu.ops.pallas_knn import ball_query_blockmin

    x, out = port
    name = f"ball{n}_{radius}_{ns}"
    cand = ball_query_blockmin(radius, ns, jnp.asarray(x[name + "/xyz"]),
                               jnp.asarray(x[name + "/centres"]),
                               interpret=True)
    want = np.asarray(_fill_balls(cand, ns))
    got = out[name]
    np.testing.assert_array_equal(got, want)
    # The centres hold empty (the far quarter), under-full and full balls.
    count = np.asarray((cand < 2 ** 30).sum(-1))
    assert (count == 0).any() and (count > 0).any()
    assert (got[count == 0] == 0).all()
    if radius >= 2.0:
        assert (count == ns).any()


def test_approximate_gates_match_jax(port, monkeypatch):
    """ops.knn / ops.ball_query take #3 exactly where the JAX package's
    _knn_jit / _ball_query_jit take the Pallas block-min kernel (on a TPU,
    in approximate mode): M >= 1024 and ceil(M / 4) >= k."""
    from ogc_tpu.ops import core, pallas_knn

    used = []

    def fake_knn(k, q, p, **kw):
        used.append(1)
        shape = q.shape[:2] + (k,)
        return jnp.zeros(shape), jnp.zeros(shape, jnp.int32)

    def fake_ball(radius, ns, xyz, new_xyz, **kw):
        used.append(1)
        return jnp.zeros(new_xyz.shape[:2] + (ns,), jnp.int32)

    monkeypatch.setattr(core, "pallas_available", lambda: True)
    monkeypatch.setattr(pallas_knn, "knn_blockmin", fake_knn)
    monkeypatch.setattr(pallas_knn, "ball_query_blockmin", fake_ball)
    want = []
    for m, k in GATE_KNN:
        used.clear()
        core._knn_jit.__wrapped__(k, jnp.zeros((1, 1, 3)),
                                  jnp.zeros((1, m, 3)), 4096, False, 0.95)
        want.append(bool(used))
    for n, ns in GATE_BALL:
        used.clear()
        core._ball_query_jit.__wrapped__(0.5, ns, jnp.zeros((1, n, 3)),
                                         jnp.zeros((1, 1, 3)), False, 2048)
        want.append(bool(used))
    _, out = port
    assert not bool(out["exact_mode"])
    assert any(want) and not all(want)
    np.testing.assert_array_equal(out["gates"], np.array(want))


def test_cpu_tensors_launch_no_kernel(port):
    _, out = port
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
    np.testing.assert_array_equal(out["launches_blockmin"], [0, 0])
