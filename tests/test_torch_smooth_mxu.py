"""The port's mxu smooth edge engine (ogc_tpu_torch/losses/seg_unsup.py::
_smooth_mxu: the Morton-sorted cloud, both edge tables through one
block-sparse grouping, #9/#10) against the JAX package's, on the CPU.

``smooth_loss`` value and mask gradient in exact mode (N = 256) and in
approximate mode (N = 1024: the shuffled tables reach the block-min search,
#3, whose JAX side runs the Pallas kernel in interpret mode on the JAX gates,
as tests/test_torch_fast.py patches them); the routing gates; the YAML keys
``from_dict`` accepts and refuses; and 3 SegTrainer steps of the ``kitti``
arch (n_point 1024) on the KITTI-SF loss block with ``edge_engine: mxu``,
both sides in exact mode.  Clouds are on a 1/8 grid, so both sides build
the same tables.

Tolerances: the loss rtol 1e-4 and the mask gradient within 0.3% relative
Frobenius norm (float32 sums in another order); trainer losses rtol 1e-4 on
the sum and 1e-3 on each term (tests/test_torch_losses.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu.losses import seg_unsup as L
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.train.seg import SegTrainer, make_optimizer
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.test_torch_losses import (LR, SEGNET, _flows, _grid,
                                     _random_params, _ReferenceChain)
from tests.torch_port_helper import REPO, pack, run_torch

# data: (seed, B, N, K, extent)
DATA = {"n256": (1, 2, 256, 5, 4.0), "n1024": (2, 2, 1024, 5, 8.0)}
SMOOTH = dict(knn_k=8, knn_radius=0.6, ball_q_k=16, ball_q_radius=1.0,
              smooth_edge_engine="mxu")
# name: (data, OGCLossConfig fields shared by both packages).  exact_l2
# takes the ball term's L2 branch; an L2 KNN term has no JAX gradient to
# compare (jnp.linalg.norm's is NaN at the self edge's zero difference).
RUNS = {"exact": ("n256", dict(SMOOTH, smooth_exact=True)),
        "exact_l2": ("n256", dict(SMOOTH, smooth_exact=True,
                                  ball_q_loss_norm=2)),
        "approx": ("n1024", dict(SMOOTH, knn_k=16, ball_q_k=32,
                                 smooth_exact=False)),
        "symgrad": ("n256", dict(SMOOTH, smooth_exact=True,
                                 symmetric_smooth_grad=True)),
        "gather": ("n256", dict(SMOOTH, smooth_exact=True,
                                smooth_edge_engine="gather")),
        "mutual": ("n256", dict(SMOOTH, smooth_exact=True,
                                smooth_graph="mutual"))}
# smooth_loss_params blocks -> what from_dict makes of them (the engine
# it records; the keys the port once refused are accepted now, and
# smooth_loss takes mxu only on the reference graph, the "mutual" run).
FROM_DICT = [({"edge_engine": "mxu"}, "mxu"), ({}, "gather"),
             ({"edge_engine": "gather", "symmetric_grad": True}, "gather"),
             ({"graph": "mutual"}, "gather"),
             ({"ref_bwd": "lean"}, "gather"),
             ({"scatter_kernel": True}, "gather"),
             ({"edge_engine": "mxu", "graph": "mutual"}, "mxu"),
             ({"edge_engine": "typo"}, "ValueError")]
TRAIN_STEPS = 3
N_TRAIN = SEGNET["n_point"]


def _data(name):
    seed, B, N, K, extent = DATA[name]
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, N, K) * 2
    mask = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {name + "/pc": _grid(rng, (B, N, 3), extent),
            name + "/mask": mask.astype(np.float32)}


def _mxu_loss_block():
    with open(f"{REPO}/config/seg/kittisf/kittisf_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["start_steps"] = [0, 1, 2]
    loss["smooth_loss_params"]["edge_engine"] = "mxu"
    return loss


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_smooth_mxu")
    x = {k: v for name in DATA for k, v in _data(name).items()}
    cfg = {"runs": RUNS, "from_dict": [blk for blk, _ in FROM_DICT]}
    rng = np.random.RandomState(3)
    model = MaskFormer3D(**SEGNET)
    params = _random_params(model, 23)
    train = {"pcs": _grid(rng, (TRAIN_STEPS, 1, 4, N_TRAIN, 3), 8.0),
             "flows": _flows(rng, (TRAIN_STEPS, 1, 4, N_TRAIN, 3)),
             "segms": np.zeros((TRAIN_STEPS, 1, 4, N_TRAIN), np.int32)}
    tcfg = {"segnet": SEGNET, "loss": _mxu_loss_block(),
            "lr": {**LR, "batch_size": 1}, "exp_base": str(tmp / "exp")}
    out = run_torch([
        ("smooth_mxu", pack(str(tmp / "mxu.in.npz"), x, cfg),
         str(tmp / "mxu.out.npz")),
        ("train_steps", pack(str(tmp / "train.in.npz"), train, tcfg,
                             segnet_state_dict_from_jax(params)),
         str(tmp / "train.out.npz"))], timeout=900)
    return {"x": x, "out": out[0], "train_out": out[1], "train": train,
            "model": model, "params": params, "tmp": tmp}


class _JaxApprox:
    """The JAX gates with the Pallas block-min kernel in interpret mode for
    approximate searches (off the TPU the JAX route is approx_max_k)."""

    def __enter__(self):
        from ogc_tpu.ops import core, pallas_knn

        knn_jit, ball_jit = core._knn_jit, core._ball_query_jit

        def knn(k, query, points, chunk, exact, recall):
            M = points.shape[-2]
            if not exact and M >= 1024 and -(-M // 4) >= k:
                return pallas_knn.knn_blockmin(k, query, points,
                                               recall_target=recall,
                                               interpret=True)
            return knn_jit(k, query, points, chunk, exact, recall)

        def ball(radius, nsample, xyz, new_xyz, exact, chunk):
            n = xyz.shape[1]
            if not exact and n >= 1024 and -(-n // 4) >= nsample:
                return core._fill_balls(pallas_knn.ball_query_blockmin(
                    radius, nsample, xyz, new_xyz, interpret=True), nsample)
            return ball_jit(radius, nsample, xyz, new_xyz, exact, chunk)

        self.mp = pytest.MonkeyPatch()
        self.mp.setattr(core, "_knn_jit", knn)
        self.mp.setattr(core, "_ball_query_jit", ball)

    def __exit__(self, *exc):
        self.mp.undo()


def _jax_smooth(x, run):
    data, fields = RUNS[run]
    cfg = L.OGCLossConfig(**fields)
    pc = jnp.asarray(x[data + "/pc"])
    with _JaxApprox():
        loss, grad = jax.value_and_grad(
            lambda m: L.smooth_loss(pc, m, cfg))(
                jnp.asarray(x[data + "/mask"]))
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("run", ["exact", "exact_l2", "approx"])
def test_smooth_mxu_matches_jax(port, run):
    out = port["out"]
    loss, grad = _jax_smooth(port["x"], run)
    np.testing.assert_allclose(out[run + "/loss"], loss, rtol=1e-4)
    got = out[run + "/grad"]
    assert np.linalg.norm(got - grad) <= 3e-3 * np.linalg.norm(grad)
    assert bool(out[run + "/mxu"])
    np.testing.assert_array_equal(out["launches_cand"], [0, 0, 0])


@pytest.mark.parametrize("run", ["symgrad", "gather", "mutual"])
def test_smooth_mxu_engine_routing_gates(port, run):
    """mxu routes only on the reference graph without symmetric_grad (the
    JAX gate without cross-entropy, which the port does not have); the
    other combinations keep the gather engine, in both packages."""
    out = port["out"]
    assert not bool(out[run + "/mxu"])
    loss, grad = _jax_smooth(port["x"], run)
    assert np.isfinite(loss)
    np.testing.assert_allclose(out[run + "/loss"], loss, rtol=1e-4)
    got = out[run + "/grad"]
    assert np.linalg.norm(got - grad) <= 3e-3 * np.linalg.norm(grad)


@pytest.mark.parametrize("case", range(len(FROM_DICT)))
def test_from_dict_accepts_mxu_and_refuses_a13_keys(port, case):
    assert str(port["out"]["from_dict"][case]) == FROM_DICT[case][1]


def test_trainer_steps_match_jax(port):
    tr = port["train"]
    cfg = L.OGCLossConfig.from_dict(_mxu_loss_block())
    assert cfg.smooth_edge_engine == "mxu"
    opt = make_optimizer(batch_size=1, **LR)
    with _ReferenceChain():
        trainer = SegTrainer(port["model"], port["params"], cfg, opt,
                             aug_transform_epoch=0, ignore_npoint_thresh=0,
                             exp_base=str(port["tmp"] / "jax_exp"))
        params, opt_state, want = trainer.params, trainer.opt_state, []
        for it in range(TRAIN_STEPS):
            params, opt_state, ld, _ = trainer._train_step(
                params, opt_state, jnp.asarray(tr["pcs"][it]),
                jnp.asarray(tr["flows"][it]), jnp.int32(it), aug=True)
            want.append([float(ld[k]) for k in ("sum", "dynamic", "smooth",
                                                "invariance")])
    got, want = port["train_out"]["ld"], np.array(want)
    assert got.shape == (TRAIN_STEPS, 4)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert (want[:, 2] > 0).all()

