"""The port's FlowStep3D in the bf16 compute mode against the JAX
package's on the same weights, on the CPU.

Weights are random flax variables (tests/test_torch_flownet.py::
random_flow_variables), carried by utils/params.py::
flownet_state_dict_from_jax; the ``sapien`` arch at 128 points, B=2, 2
iterations, exact neighbours on both sides.  Each side runs the eval
forward and one train-mode forward and backward of sum_i w_i mean(flow_i^2)
(w = 1, 0.5).

bf16 against JAX's bf16: the port's relative RMS gap to JAX's bf16 (eval
flows of both iterations; the train step's gradients over all leaves) may
not exceed a share of JAX's own bf16-vs-float32 gap on the same inputs,
the test of tests/test_torch_fast.py (BF16_SHARE there).  The port's
float32 outputs are the control: they sit at ~1.0 of the gap and must fail
the same limits.  Both dtypes load one state dict, and the JAX parameter
tree is the same in both.  The JAX side runs under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.nn.layers import set_compute_dtype
from ogc_tpu_torch.utils.params import flownet_state_dict_from_jax
from tests.test_torch_flownet import random_flow_variables
from tests.torch_port_helper import pack, start_torch

B, N, ITERS, EXTENT = 2, 128, 2, 1.0
ITERS_W = [1.0, 0.5]
MODEL = {"npoint": N, "loc_flow_nn": 8, "loc_flow_rad": 0.1,
         "k_decay_fact": 0.5}
BN_MOMENTUM = 0.1
FLOW_TOL = 2e-5
# The shares of JAX's bf16-vs-float32 gap the port's bf16 may reach, as
# tests/test_torch_fast.py holds the seg net (the port reads ~6e-5 on the
# eval flows and ~0.5 on the gradients; its float32, the control, ~1.0).
BF16_SHARE = {"eval": 0.6, "grads": 0.9}
DTYPES = ("f32", "bf16")


def _clouds(rng):
    pc1 = (rng.rand(B, N, 3) * EXTENT).astype(np.float32)
    flow = 0.02 * rng.randn(B, 1, 3) + 0.005 * rng.randn(B, N, 3)
    return pc1, (pc1 + flow).astype(np.float32)


def _model(inorm=False):
    return FlowStep3D(arch="sapien", use_instance_norm=inorm, **MODEL)


def jax_flow_run(model, variables, pc1, pc2, train=True):
    """The JAX package's eval flows and, with ``train``, its train step of
    sum_i ITERS_W[i] mean(flow_i^2) (flows; gradients and updated
    statistics as a port state dict), under jax.jit, exact neighbours."""

    def loss_fn(params, stats, pc1, pc2):
        flows, new = model.apply(
            {"params": params, "batch_stats": stats}, pc1, pc2, pc1, pc2,
            ITERS, train=True, bn_momentum=BN_MOMENTUM,
            mutable=["batch_stats"])
        loss = sum(w * jnp.mean(f * f) for w, f in zip(ITERS_W, flows))
        return loss, (flows, new.get("batch_stats", {}))

    ops.set_exact_neighbors(True)
    flows = jax.jit(lambda v, a, b: model.apply(v, a, b, a, b, ITERS,
                                                train=False))(
        variables, pc1, pc2)
    out = {"eval": np.stack([np.asarray(f) for f in flows])}
    if train:
        (_, (tflows, stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"],
                                    variables.get("batch_stats", {}),
                                    pc1, pc2)
        tree = jax.tree_util.tree_map(np.asarray, {"params": grads,
                                                   "batch_stats": stats})
        out["train"] = np.stack([np.asarray(f) for f in tflows])
        out["state"] = flownet_state_dict_from_jax(tree)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flow_bf16")
    rng = np.random.RandomState(5)
    pc1, pc2 = _clouds(rng)
    variables = random_flow_variables(_model(), N, 2)
    state = flownet_state_dict_from_jax(variables)
    cases = [("flow_modes", pack(
        str(tmp / f"{dt}.in.npz"), {"pc1": pc1, "pc2": pc2},
        {"arch": "sapien", "model": MODEL, "iters": ITERS,
         "iters_w": ITERS_W, "bn_momentum": BN_MOMENTUM,
         "compute_dtype": dt}, state), str(tmp / f"{dt}.out.npz"))
        for dt in DTYPES]
    finish = start_torch(cases, timeout=600)
    jax_out = {}
    for dt in DTYPES:
        set_compute_dtype(jnp.bfloat16 if dt == "bf16" else None)
        try:
            jax_out[dt] = jax_flow_run(_model(), variables, pc1, pc2)
        finally:
            set_compute_dtype(None)
    return dict(zip(DTYPES, finish())), jax_out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grads(out, prefix="train/"):
    keys = sorted(k for k in out if k.startswith(prefix + "g/"))
    return np.concatenate([out[k].ravel() for k in keys])


def _jax_grads(state, port_out, prefix="train/"):
    keys = sorted(k[len(prefix) + 2:] for k in port_out
                  if k.startswith(prefix + "g/"))
    return np.concatenate([state[k].ravel() for k in keys])


def test_bf16_flows_and_grads_match_jax_bf16(runs):
    """bf16 rounds where the JAX package rounds: the port's bf16 flows and
    gradients lie closer to JAX's bf16 than JAX's bf16 lies to its own
    float32, by BF16_SHARE; the port's float32 (the control) does not."""
    port, jax_out = runs
    j16, j32 = jax_out["bf16"], jax_out["f32"]
    g16 = _jax_grads(j16["state"], port["bf16"])
    g32 = _jax_grads(j32["state"], port["f32"])

    def shares(name):
        out = port[name]
        return {"eval": _rel(out["eval"], j16["eval"])
                / _rel(j32["eval"], j16["eval"]),
                "grads": _rel(_grads(out), g16) / _rel(g32, g16)}

    got, control = shares("bf16"), shares("f32")
    print(f"shares of JAX's bf16-vs-f32 gap: port bf16 {got}, port f32 "
          f"{control}; JAX's gaps: eval {_rel(j32['eval'], j16['eval']):.3e}"
          f", grads {_rel(g32, g16):.3e}")
    assert np.isfinite(port["bf16"]["eval"]).all()
    assert np.isfinite(_grads(port["bf16"])).all()
    for k, limit in BF16_SHARE.items():
        assert got[k] <= limit, (k, got[k])
        assert control[k] > limit, (k, control[k])
    # bf16 really ran: its flows are not the float32 ones.
    assert np.abs(port["bf16"]["eval"] - port["f32"]["eval"]).max() > 0
    np.testing.assert_array_equal(port["bf16"]["launches"], [0, 0, 0, 0])


def test_parameter_tree_is_the_same_in_both_dtypes():
    """One parameter tree in float32 and bf16 on the JAX side; on the
    port's, both dtypes load the same state dict (the runs above)."""
    pc = np.zeros((1, N, 3), np.float32)
    trees = []
    for dt in (None, jnp.bfloat16):
        set_compute_dtype(dt)
        try:
            trees.append(jax.eval_shape(
                lambda k, x: _model().init(k, x, x, x, x, 2),
                jax.random.PRNGKey(0), pc))
        finally:
            set_compute_dtype(None)
    assert jax.tree_util.tree_structure(trees[0]) == \
        jax.tree_util.tree_structure(trees[1])


def test_float32_eval_flows_match_jax(runs):
    """The float32 control itself: JAX's default eval (the fold) within
    2e-5 of the flow's scale at each iteration."""
    port, jax_out = runs
    got, want = port["f32"]["eval"], jax_out["f32"]["eval"]
    assert got.shape == want.shape == (ITERS, B, N, 3)
    scale = max(1.0, float(np.abs(want).max()))
    for it in range(ITERS):
        assert np.abs(got[it] - want[it]).max() <= FLOW_TOL * scale, it
