"""The OGC loss options of ``smooth_loss_params`` and the loss block on the
port (ogc_tpu_torch/losses/seg_unsup.py) against the JAX package's, on the
CPU.

Clouds lie on a 1/8 grid (every d2 exact in both packages' forms, so the
exact tables, and the scalar test's d2, agree bit for bit); masks are
softmaxes of seeded logits.  Held:

* ``graph: mutual``: the keep masks of the exact clamped-KNN and ball
  tables bit-equal to JAX's ``mutual_keep_mask``; on exact tables the
  scalar membership test (the default there) bit-equal to the gather test
  (``mutual_gather``) in loss and gradient; against JAX, each graph's loss
  within rtol 1e-4 and its mask gradient within 0.3% relative Frobenius
  norm, on exact tables and on approximate ones (1024 points: #3's plain
  version against the Pallas block-min kernel in interpret mode, the
  gather test);
* ``ref_bwd: lean`` and ``remat``: loss bit-equal and gradient within 1e-6
  relative Frobenius of the port's autodiff; against JAX as above;
* ``scatter_kernel: true``: the same bits as false;
* ``monitor_terms: false`` in ``ogc_loss`` (invariance weight 0): the
  gradient bit-equal to ``true``, entropy, rank and invariance 0, the other
  terms equal; against JAX's ``ogc_loss``, terms rtol 1e-4;
* ``from_dict`` refuses a typo in ``graph`` / ``ref_bwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from ogc_tpu.losses import seg_unsup as L
from tests.test_torch_fast import _grid
from tests.test_torch_smooth_mxu import _JaxApprox
from tests.torch_port_helper import pack, run_torch

# data: (seed, B, N, K, extent)
DATA = {"n256": (1, 2, 256, 5, 4.0), "n1024": (2, 2, 1024, 5, 8.0)}
SMOOTH = dict(knn_k=8, knn_radius=0.6, ball_q_k=16, ball_q_radius=1.0)
# name: (data, OGCLossConfig fields shared by both packages)
RUNS = {
    "mutual": ("n256", dict(SMOOTH, smooth_exact=True,
                            smooth_graph="mutual")),
    "mutual_l2": ("n256", dict(SMOOTH, smooth_exact=True,
                               smooth_graph="mutual", knn_loss_norm=2,
                               ball_q_loss_norm=2)),
    "mutual_approx": ("n1024", dict(SMOOTH, knn_k=16, ball_q_k=32,
                                    smooth_exact=False,
                                    smooth_graph="mutual")),
    "autodiff": ("n256", dict(SMOOTH, smooth_exact=True)),
    "lean": ("n256", dict(SMOOTH, smooth_exact=True, smooth_ref_bwd="lean")),
    "remat": ("n256", dict(SMOOTH, smooth_exact=True,
                           smooth_ref_bwd="remat")),
    "scatter_kernel": ("n256", dict(SMOOTH, smooth_exact=True,
                                    smooth_scatter_kernel=True)),
}
# The port only: the gather test (the oracle) on the exact tables.
PORT_RUNS = {"mutual_gather": ("n256", dict(SMOOTH, smooth_exact=True,
                                            smooth_graph="mutual_gather"))}
FROM_DICT = [({"graph": "mutual"}, "gather"),
             ({"graph": "typo"}, "ValueError"),
             ({"ref_bwd": "typo"}, "ValueError")]
T = 4


def _data(name):
    seed, B, N, K, extent = DATA[name]
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, N, K) * 2
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {name + "/pc": _grid(rng, (B, N, 3), extent),
            name + "/mask": mask.astype(np.float32)}


def _loss_blocks():
    smooth = {"w_knn": 3.0, "w_ball_q": 1.0,
              "knn_loss_params": {"k": 8, "radius": 0.6, "loss_norm": 1},
              "ball_q_loss_params": {"k": 16, "radius": 1.0,
                                     "loss_norm": 1}}
    base = {"weights": [10.0, 0.1, 0.0],
            "dynamic_loss_params": {"loss_norm": 2},
            "smooth_loss_params": smooth,
            "invariance_loss_params": {"loss_norm": 2}}
    return {"monitor": base, "no_monitor": {**base, "monitor_terms": False}}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_loss_options")
    x = {k: v for name in DATA for k, v in _data(name).items()}
    rng = np.random.RandomState(4)
    logits = rng.randn(2, T, 256, 5)
    terms = {"pcs": _grid(rng, (2, T, 256, 3), 4.0),
             "flows": (np.round(rng.randn(2, T, 256, 3) * 0.3 * 8) / 8
                       ).astype(np.float32),
             "masks": (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                       ).astype(np.float32)}
    cases = [
        ("smooth_mxu", pack(str(tmp / "smooth.in.npz"), x,
                            {"runs": {**RUNS, **PORT_RUNS},
                             "from_dict": [b for b, _ in FROM_DICT]}),
         str(tmp / "smooth.out.npz")),
        ("mutual_keep", pack(str(tmp / "keep.in.npz"),
                             {"pc": x["n256/pc"]},
                             {"knn_k": 8, "knn_radius": 0.6, "ball_k": 16,
                              "ball_radius": 1.0}),
         str(tmp / "keep.out.npz")),
        ("ogc_terms", pack(str(tmp / "terms.in.npz"), terms,
                           {"losses": _loss_blocks(), "aug": True}),
         str(tmp / "terms.out.npz"))]
    smooth, keep, terms_out = run_torch(cases, timeout=600)
    return {"x": x, "smooth": smooth, "keep": keep, "terms_in": terms,
            "terms": terms_out}


def _jax_smooth(x, run):
    data, fields = RUNS[run]
    cfg = L.OGCLossConfig(**fields)
    pc = jnp.asarray(x[data + "/pc"])
    with _JaxApprox():
        loss, grad = jax.value_and_grad(
            lambda m: L.smooth_loss(pc, m, cfg))(
                jnp.asarray(x[data + "/mask"]))
    return float(loss), np.asarray(grad)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_mutual_keep_mask_matches_jax(port):
    k = port["keep"]
    pc = jnp.asarray(port["x"]["n256/pc"])
    dist, idx = ops.knn(8, pc, pc, exact=True)
    knn = jnp.where(dist > 0.6, idx[..., :1], idx)
    ball = ops.ball_query(1.0, 16, pc, pc, exact=True)
    np.testing.assert_array_equal(k["knn"], np.asarray(knn))
    np.testing.assert_array_equal(k["ball"], np.asarray(ball))
    for name, table in (("knn", knn), ("ball", ball)):
        want = np.asarray(L.mutual_keep_mask(table))
        np.testing.assert_array_equal(k[name + "_keep"], want)
        assert 0 < want.mean() < 1, name


def test_scalar_mutual_test_is_bit_equal_to_gather_test(port):
    out = port["smooth"]
    for key in ("loss", "grad"):
        np.testing.assert_array_equal(out[f"mutual/{key}"],
                                      out[f"mutual_gather/{key}"])


@pytest.mark.parametrize("run", ["mutual", "mutual_l2", "mutual_approx",
                                 "lean", "remat", "scatter_kernel"])
def test_smooth_option_matches_jax(port, run):
    out = port["smooth"]
    loss, grad = _jax_smooth(port["x"], run)
    np.testing.assert_allclose(out[run + "/loss"], loss, rtol=1e-4)
    got = out[run + "/grad"]
    assert np.isfinite(got).all()
    assert _rel(got, grad) <= 3e-3, _rel(got, grad)
    assert not bool(out[run + "/mxu"])
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])


@pytest.mark.parametrize("run", ["lean", "remat"])
def test_lean_and_remat_backwards_equal_autodiff(port, run):
    out = port["smooth"]
    np.testing.assert_array_equal(out[run + "/loss"], out["autodiff/loss"])
    rel = _rel(out[run + "/grad"], out["autodiff/grad"])
    assert rel <= 1e-6, rel


def test_scatter_kernel_flag_changes_no_bit(port):
    out = port["smooth"]
    for key in ("loss", "grad"):
        np.testing.assert_array_equal(out[f"scatter_kernel/{key}"],
                                      out[f"autodiff/{key}"])


def test_monitor_terms_off_keeps_the_gradient(port):
    out = port["terms"]
    np.testing.assert_array_equal(out["no_monitor/grad"],
                                  out["monitor/grad"])
    for k in ("entropy", "rank", "invariance"):
        assert float(out[f"no_monitor/ld/{k}"]) == 0.0, k
    assert float(out["monitor/ld/entropy"]) > 0
    for k in ("dynamic", "smooth", "sum"):
        np.testing.assert_array_equal(out[f"no_monitor/ld/{k}"],
                                      out[f"monitor/ld/{k}"])
    x = port["terms_in"]
    for name, block in _loss_blocks().items():
        ops.set_exact_neighbors(True)
        _, ld = L.ogc_loss([jnp.asarray(x["pcs"][:, t]) for t in range(T)],
                           [jnp.asarray(x["masks"][:, t]) for t in range(T)],
                           [jnp.asarray(x["flows"][:, t]) for t in range(T)],
                           L.OGCLossConfig.from_dict(block),
                           aug_transform=True)
        for k, v in ld.items():
            np.testing.assert_allclose(out[f"{name}/ld/{k}"], float(v),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", range(len(FROM_DICT)))
def test_from_dict_graph_and_ref_bwd(port, case):
    assert str(port["smooth"]["from_dict"][case]) == FROM_DICT[case][1]
