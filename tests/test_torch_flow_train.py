"""The port's flow training (FlowStep3D train mode, the unsupervised flow
loss, make_bn_schedule, FlowTrainer) against the JAX package's on the same
weights and inputs.

Weights are random flax variables with BatchNorm affines and statistics
perturbed (tests/test_torch_flownet.py::random_flow_variables), carried to
the port by utils/params.py::flownet_state_dict_from_jax; the ``sapien``
arch at 64 points, B=2, 2 iterations (the recurrence is chaotic beyond,
PARITY.md:238-241), the loss block of config/flow/sapien/sapien_unsup.yaml
with iters_w cut to 2.  Clouds and flows are on a 1/128 grid in a 0.4 m
cube (dense enough that the smooth KNN's 0.05 m and the ball's 0.1 m radii
hold neighbours besides the point itself; the grid keeps every d2 of the
clouds exact in both packages' forms).  Both sides run exact neighbours.

Both packages also run the train step in float64: JAX with x64 enabled and
its explicit float32 casts widened (``_jax_float64``), the port on its
float64 model, whose plain kernels then compute in float64.  That pair is
the independent witness of the semantics: flows, loss terms, every running
statistic and every gradient leaf agree to rtol 1e-9 of the leaf's largest
entry, and 3 FlowTrainer steps of 2 iterations to rtol 1e-7.

Float32, at the tolerances stated for the slice where the computation is
well conditioned: each loss term rtol 1e-4 and the loss's gradient in given
flows (reference and symmetric smooth gradient) within 1e-4 of its largest
entry; iteration 0's flows within 2e-5 of their scale (max |flow|, at
least 1) and its terms rtol 1e-4; the gradient through iteration 0 alone
at a global cosine above 0.9999; make_bn_schedule equal; the first
FlowTrainer step's terms rtol 1e-3.  In train mode BatchNorm normalises
with batch statistics, and random weights give near-constant flow
features: a channel's spread is then tiny against its mean, and float32
rounding is amplified (JAX's own float32 flows lie 8.7e-4 from its
float64 run at iteration 1, on a flow scale of 2.4, and its full
gradient's leaves up to a quarter of their largest entry; ``-s`` prints
each distance).  There (iteration 1's flows,
the running statistics, every gradient leaf) the port's float32 distance
to JAX's float64 run must be at most twice JAX's float32 distance plus the
stated tolerance.  Later FlowTrainer steps in float32 are not compared:
Adam's first, sign-like update amplifies a gradient's rounding by 1/eps
where it is near zero, and JAX's float32 run differs from its float64 run
by tens of percent by step 3.
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu import ops
from ogc_tpu.losses.flow_unsup import FlowLossConfig, flowstep3d_loss
from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.train.flow import FlowTrainer, make_bn_schedule
from ogc_tpu.train.seg import make_optimizer
from ogc_tpu_torch.utils.params import flownet_state_dict_from_jax
from tests.test_torch_flownet import random_flow_variables
from tests.torch_port_helper import REPO, pack, run_torch

B, N, ITERS, EXTENT, GRID = 2, 64, 2, 0.4, 1 / 128
MODEL = {"npoint": N, "loc_flow_nn": 8, "loc_flow_rad": 0.1,
         "k_decay_fact": 1.0}
BN_MOMENTUM = 0.9
LR = {"lr": 1e-3, "lr_decay": 0.5, "lr_clip": 1e-5, "decay_step": 400000,
      "batch_size": B}
BN = {"bn_momentum": 0.9, "bn_decay": 0.5, "decay_step": 64,
      "batch_size": B}
BN_CASES = [BN, {**BN, "decay_step": -1},
            {"bn_momentum": 0.5, "bn_decay": 0.1, "decay_step": 8,
             "batch_size": 4}]
BN_ITS = [0, 1, 31, 32, 33, 95, 96, 200, 10 ** 5]
TRAIN_STEPS, TRAIN_ITERS = 3, 2
STEP_KEYS = ["chamfer_loss_#0", "smooth_loss_#0", "chamfer_loss_#1",
             "smooth_loss_#1", "sum", "epe3d_#0", "epe3d_#1"]
# The float64 pair's tolerances (observed: 1e-12 on flows and terms, 1e-9
# on the trainer's third step, where Adam's eps amplifies rounding).
F64_RTOL, F64_STEP_RTOL = 1e-9, 1e-7


class _Float64Names:
    """``jax.numpy`` with ``float32`` meaning float64: installed as ``jnp``
    in the JAX package's modules, it widens their explicit float32 casts
    (BatchNorm statistics, neighbour searches, the loss's accumulator)."""

    def __getattr__(self, name):
        return getattr(jnp, "float64" if name == "float32" else name)


@contextlib.contextmanager
def _jax_float64():
    """The JAX package traced in float64 within the block."""
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("ogc_tpu.") and getattr(m, "jnp", None) is jnp]
    with jax.enable_x64(True):
        for m in mods:
            m.jnp = _Float64Names()
        try:
            yield
        finally:
            for m in mods:
                m.jnp = jnp


def _loss_block():
    with open(f"{REPO}/config/flow/sapien/sapien_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["iters_w"] = loss["iters_w"][:ITERS]
    return loss


def _grid(a):
    return (np.round(a / GRID) * GRID).astype(np.float32)


def _pair(rng):
    """(pc1, pc2, flow): pc2 = pc1 + flow, a per-cloud shift plus a small
    per-point motion, every coordinate on the grid."""
    pc1 = _grid(rng.rand(B, N, 3) * EXTENT)
    flow = _grid(0.05 * rng.randn(B, 1, 3) + 0.01 * rng.randn(B, N, 3))
    return pc1, _grid(pc1 + flow), flow


def _loss_blocks():
    """The config's block ("full") and the same with iteration 1's weight
    0 ("it0": the gradient through iteration 0 only)."""
    full = _loss_block()
    return {"full": full, "it0": {**full,
                                  "iters_w": full["iters_w"][:1] + [0.0]}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flow_train")
    rng = np.random.RandomState(3)
    model = FlowStep3D(arch="sapien", **MODEL)
    variables = random_flow_variables(model, N, 4)
    pc1, pc2, gt = _pair(rng)
    # Loss inputs: flows of the model's scale, off the grid.
    flows = (gt[None] + 0.02 * rng.randn(ITERS, B, N, 3)).astype(np.float32)
    train = [_pair(rng) for _ in range(TRAIN_STEPS)]
    tr_pcs = np.stack([np.stack([p1, p2], 1) for p1, p2, _ in train])
    tr_flows = np.stack([np.stack([f, -f], 1) for _, _, f in train])
    state = flownet_state_dict_from_jax(variables)
    cfg = {"arch": "sapien", "model": MODEL, "iters": ITERS,
           "losses": _loss_blocks(), "bn_momentum": BN_MOMENTUM, "lr": LR,
           "bn": BN, "bn_cases": BN_CASES, "bn_its": BN_ITS,
           "step_keys": STEP_KEYS, "train_iters": TRAIN_ITERS,
           "exp_base": str(tmp / "port_exp")}
    cases = [("flow_loss", pack(str(tmp / "loss.in.npz"),
                                {"pc1": pc1, "pc2": pc2, "flows": flows},
                                {"loss": _loss_block()}),
              str(tmp / "loss.out.npz")),
             ("flow_train", pack(str(tmp / "train.in.npz"),
                                 {"pc1": pc1, "pc2": pc2, "tr_pcs": tr_pcs,
                                  "tr_flows": tr_flows}, cfg, state),
              str(tmp / "train.out.npz"))]
    loss_out, train_out = run_torch(cases, timeout=600)
    return {"model": model, "variables": variables, "pc1": pc1, "pc2": pc2,
            "flows": flows, "tr_pcs": tr_pcs, "tr_flows": tr_flows,
            "loss": loss_out, "train": train_out, "tmp": tmp}


@pytest.fixture(scope="module")
def jax_step(setup):
    """One train-mode forward and backward of each loss block in the JAX
    package, in float32 and in float64: flows, terms, gradients and the
    updated batch_stats, under ``out[dtype][block]``."""
    model, variables = setup["model"], setup["variables"]

    def loss_fn(params, stats, pc1, pc2, iters_w):
        flows, new_vars = model.apply(
            {"params": params, "batch_stats": stats},
            pc1, pc2, pc1, pc2, ITERS, train=True, bn_momentum=BN_MOMENTUM,
            mutable=["batch_stats"])
        cfg = FlowLossConfig.from_dict({**_loss_block(),
                                        "iters_w": tuple(iters_w)})
        loss, ld = flowstep3d_loss(pc1, pc2, flows, cfg)
        return loss, (ld, flows, new_vars["batch_stats"])

    def run(dt):
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables)
        out = {}
        for name, block in _loss_blocks().items():
            (_, (ld, flows, stats)), grads = step(
                v["params"], v["batch_stats"], jnp.asarray(setup["pc1"], dt),
                jnp.asarray(setup["pc2"], dt), jnp.asarray(block["iters_w"],
                                                           dt))
            tree = jax.tree_util.tree_map(np.asarray, {"params": grads,
                                                       "batch_stats": stats})
            out[name] = {"ld": {k: float(v) for k, v in ld.items()},
                         "flows": np.stack([np.asarray(f) for f in flows]),
                         "state": flownet_state_dict_from_jax(tree)}
        return out

    ops.set_exact_neighbors(True)
    out = {"f32": run(jnp.float32)}
    with _jax_float64():
        out["f64"] = run(jnp.float64)
    assert out["f64"]["full"]["flows"].dtype == np.float64
    return out


def _port(setup, dt, name="full"):
    """The port's outputs of one dtype and loss block: flows, terms,
    gradients, running statistics."""
    p = f"{dt}/{name}/"
    out = {k[len(p):]: v for k, v in setup["train"].items()
           if k.startswith(p)}
    return {"flows": out["flows"],
            "ld": {k[3:]: float(v) for k, v in out.items()
                   if k.startswith("ld/")},
            "g": {k[2:]: v for k, v in out.items() if k.startswith("g/")},
            "s": {k[2:]: v for k, v in out.items() if k.startswith("s/")}}


def _leaf_err(got, want) -> float:
    """max |got - want| over the largest |want| (at least 1e-30)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _within_rounding(got, want, ref, floor, what):
    """The port's float32 value ``got`` against JAX's float32 ``want``
    where float32 rounding is amplified: both are held to JAX's float64
    run ``ref``, and the port's distance to it (max norm) must be at most
    twice JAX's plus ``floor``."""
    e_port = float(np.abs(np.asarray(got, np.float64) - ref).max())
    e_jax = float(np.abs(np.asarray(want, np.float64) - ref).max())
    print(f"{what}: from JAX's float64 run port {e_port:.3e}, JAX "
          f"{e_jax:.3e}")
    assert e_port <= 2 * e_jax + floor, (what, e_port, e_jax, floor)


@pytest.mark.parametrize("tag", ["ref", "sym"])
def test_flow_loss_terms_and_grads_match_jax(setup, tag):
    cfg = _loss_block()
    cfg["smooth_loss_params"] = dict(cfg["smooth_loss_params"],
                                     symmetric_grad=tag == "sym")
    cfg = FlowLossConfig.from_dict(cfg)
    pc1, pc2 = jnp.asarray(setup["pc1"]), jnp.asarray(setup["pc2"])

    def loss_fn(flows, pc1, pc2):
        return flowstep3d_loss(pc1, pc2, list(flows), cfg)

    ops.set_exact_neighbors(True)
    (_, ld), grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jnp.asarray(setup["flows"]), pc1, pc2)
    out = setup["loss"]
    for k, v in ld.items():
        np.testing.assert_allclose(out[f"{tag}/ld/{k}"], float(v), rtol=1e-4,
                                   err_msg=k)
        assert float(v) > 0, k
    grad = np.asarray(grad)
    got = out[f"{tag}/grad"]
    assert np.isfinite(got).all()
    assert np.abs(got - grad).max() <= 1e-4 * np.abs(grad).max()
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
    np.testing.assert_array_equal(out["launches_onehot"], [0, 0])


def test_iteration0_flows_terms_and_grads_match_jax(setup, jax_step):
    """Iteration 0's flows and terms at the stated tolerances; the gradient
    through iteration 0 alone: global cosine above 0.9999, and each leaf
    within float32 rounding of JAX's (BatchNorm's backward over 64-row
    batches amplifies rounding in the global encoder's leaves past the
    3e-3 per-leaf tolerance)."""
    got, want = _port(setup, "f32", "it0"), jax_step["f32"]["it0"]
    ref = jax_step["f64"]["it0"]
    assert got["flows"].shape == want["flows"].shape == (ITERS, B, N, 3)
    scale = max(1.0, float(np.abs(want["flows"][0]).max()))
    diff = float(np.abs(got["flows"][0] - want["flows"][0]).max())
    assert diff <= 2e-5 * scale, (diff, scale)
    for k in ("chamfer_loss_#0", "smooth_loss_#0"):
        np.testing.assert_allclose(got["ld"][k], want["ld"][k], rtol=1e-4,
                                   err_msg=k)
    keys = sorted(got["g"])
    g = np.concatenate([got["g"][k].ravel() for k in keys])
    w = np.concatenate([want["state"][k].ravel() for k in keys])
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    assert cos > 0.9999, cos
    for k in keys:
        w = want["state"][k]
        _within_rounding(got["g"][k], w, ref["state"][k],
                         3e-3 * np.abs(w).max(), k)
    np.testing.assert_array_equal(setup["train"]["launches"], [0, 0, 0, 0])


def test_float64_step_matches_jax_float64(setup, jax_step):
    """The semantics, free of float32 rounding: the port's float64 train
    step against the JAX package's, for both loss blocks, at rtol 1e-9 of
    each quantity's largest entry: both iterations' flows, every loss
    term, every running statistic after the step (each one moved) and
    every gradient leaf (the refinement's GRU and regressor leaves
    included)."""
    before = flownet_state_dict_from_jax(setup["variables"])
    for name in ("full", "it0"):
        got, want = _port(setup, "f64", name), jax_step["f64"][name]
        assert got["flows"].dtype == np.float64
        assert _leaf_err(got["flows"], want["flows"]) <= F64_RTOL, name
        assert sorted(got["ld"]) == sorted(want["ld"])
        for k, v in want["ld"].items():
            np.testing.assert_allclose(got["ld"][k], v, rtol=F64_RTOL,
                                       err_msg=(name, k))
        stats = sorted(k for k in want["state"] if "running_" in k)
        assert stats and sorted(got["s"]) == stats
        grads = sorted(got["g"])
        assert sorted(set(want["state"]) - set(stats)) == sorted(
            grads + [k for k in before if "num_batches" in k])
        for k in stats:
            assert not np.array_equal(want["state"][k], before[k]), k
            assert _leaf_err(got["s"][k], want["state"][k]) <= F64_RTOL, k
        errs = {k: _leaf_err(got["g"][k], want["state"][k]) for k in grads}
        e_stats = max(_leaf_err(got["s"][k], want["state"][k])
                      for k in stats)
        print(f"float64 {name}: flows "
              f"{_leaf_err(got['flows'], want['flows']):.3e}, statistics "
              f"{e_stats:.3e}, gradient leaves {max(errs.values()):.3e}")
        for k in grads:
            if name == "full":
                assert np.abs(want["state"][k]).max() > 0, k
            assert errs[k] <= F64_RTOL, (name, k, errs[k])


def test_iteration1_within_float32_rounding_of_jax(setup, jax_step):
    """Iteration 1's flows, the running statistics after the step and the
    full loss's gradients in float32: where BatchNorm's batch statistics
    amplify float32 rounding (near-constant flow features, 64-row
    batches), the port's distance to JAX's float64 run is at most twice
    JAX's float32 distance (floors: the stated tolerances); the full
    loss's sum at rtol 1e-3 and its gradient at a global cosine above
    0.999 directly."""
    got, want = _port(setup, "f32"), jax_step["f32"]["full"]
    ref = jax_step["f64"]["full"]
    scale = max(1.0, float(np.abs(want["flows"]).max()))
    _within_rounding(got["flows"][1], want["flows"][1], ref["flows"][1],
                     2e-5 * scale, "flows #1")
    assert np.abs(got["flows"][1] - got["flows"][0]).max() > 1e-4
    keys = sorted(k for k in want["state"] if "running_" in k)
    assert keys and sorted(got["s"]) == keys
    for k in keys:
        w = want["state"][k]
        _within_rounding(got["s"][k], w, ref["state"][k],
                         1e-5 * np.abs(w).max(), k)
    keys = sorted(got["g"])
    flat = [np.concatenate([t[k].ravel() for k in keys]).astype(np.float64)
            for t in (got["g"], want["state"], ref["state"])]
    cos = [a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
           for a, b in ((flat[0], flat[1]), (flat[1], flat[2]),
                        (flat[0], flat[2]))]
    print(f"full gradient cosines: port-JAX {cos[0]:.6f}, JAX-float64 "
          f"{cos[1]:.6f}, port-float64 {cos[2]:.6f}")
    assert cos[0] > 0.999, cos
    for k in keys:
        w = want["state"][k]
        _within_rounding(got["g"][k], w, ref["state"][k],
                         3e-3 * np.abs(w).max(), k)
    np.testing.assert_allclose(got["ld"]["sum"], want["ld"]["sum"],
                               rtol=1e-3)


def test_bn_schedule_matches_jax(setup):
    want = np.array([[make_bn_schedule(**kw)(it) for it in BN_ITS]
                     for kw in BN_CASES])
    np.testing.assert_array_equal(setup["train"]["bn_schedule"], want)
    assert len(np.unique(want[0])) > 2


def test_trainer_steps_match_jax(setup):
    """3 FlowTrainer steps of 2 iterations from the same weights: in
    float64 every term and EPE of every step at rtol 1e-7 of JAX's float64
    trainer; in float32 the first step's at rtol 1e-3 of JAX's."""
    model, variables = setup["model"], setup["variables"]
    ops.set_exact_neighbors(True)
    loss = {**_loss_block(), "iters_w": _loss_block()["iters_w"][:TRAIN_ITERS]}

    def run(dt):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), variables)
        trainer = FlowTrainer(
            model, v, TRAIN_ITERS, FlowLossConfig.from_dict(loss),
            make_optimizer(**LR), str(setup["tmp"] / f"jax_exp_{dt.__name__}"),
            bn_schedule=make_bn_schedule(**BN))
        steps = []
        for it in range(TRAIN_STEPS):
            ld = trainer.train_it(it, (setup["tr_pcs"][it].astype(dt), None,
                                       setup["tr_flows"][it].astype(dt),
                                       None))
            steps.append([ld[k] for k in STEP_KEYS])
        return np.array(steps)

    want32 = run(np.float32)
    with _jax_float64():
        want64 = run(np.float64)
    got32, got64 = setup["train"]["f32/steps"], setup["train"]["f64/steps"]
    assert got64.shape == want64.shape == (TRAIN_STEPS, len(STEP_KEYS))
    print("float64 step terms, rtol to JAX:",
          np.abs(got64 / want64 - 1).max(axis=1))
    print("float32 step terms, rtol to JAX's float64 run: port",
          np.abs(got32 / want64 - 1).max(axis=1), "JAX",
          np.abs(want32 / want64 - 1).max(axis=1))
    np.testing.assert_allclose(got64, want64, rtol=F64_STEP_RTOL)
    assert (np.abs(np.diff(want64, axis=0)) > 1e-3).any(axis=0).all()
    np.testing.assert_allclose(got32[0], want32[0], rtol=1e-3)
    assert np.isfinite(got32).all()
