"""The port's FlowStep3D with InstanceNorm and with ``OGC_EVAL_FOLD=off``
against the JAX package's on the same weights, on the CPU (the ``sapien``
arch at 128 points, B=2, 2 iterations, exact neighbours; the inputs and
the train step of tests/test_torch_flow_bf16.py).

InstanceNorm (``flownet.use_instance_norm``): statistics over the spatial
axes, no eval fold and no pool folds; its parameters carried by
``flownet_state_dict_from_jax`` from ``InstanceNorm_{j}``.  Random weights
give near-constant features, which the per-sample normalisation amplifies
through the recurrence as train-mode BatchNorm does (ROADMAP §C): JAX's own
float32 flows lie ~1 from its float64 run at iteration 1.  So the
semantics are held in float64 on both sides (JAX traced in float64 by
tests/test_torch_flow_train.py::_jax_float64, the port's float64 model):
each iteration's flows within 2e-5 of their scale (max |flow|, at least
1) and the train step's gradients within 0.3% relative Frobenius norm
over all leaves; in float32, iteration 0 within 2e-5 and iteration 1 no
farther from JAX's float64 run than twice JAX's own float32.

``OGC_EVAL_FOLD=off`` (both packages' reference-shaped eval chain), float32:
flows within 2e-5 per iteration.
"""

import jax
import numpy as np
import pytest

from ogc_tpu_torch.utils.params import flownet_state_dict_from_jax
from tests.test_torch_flow_bf16 import (B, BN_MOMENTUM, ITERS, ITERS_W, MODEL,
                                        N, _clouds, _model, jax_flow_run)
from tests.test_torch_flow_train import _jax_float64
from tests.test_torch_flownet import random_flow_variables
from tests.torch_port_helper import pack, start_torch

FLOW_TOL = 2e-5
# name: (use_instance_norm, OGC_EVAL_FOLD, float64, train)
RUNS = {"inorm32": (True, "on", False, False),
        "inorm64": (True, "on", True, True),
        "fold_off": (False, "off", False, False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_flow_inorm")
    pc1, pc2 = _clouds(np.random.RandomState(5))
    variables = {inorm: random_flow_variables(_model(inorm), N, 2)
                 for inorm in (False, True)}
    cases = []
    for name, (inorm, fold, f64, train) in RUNS.items():
        cfg = {"arch": "sapien", "model": {**MODEL,
                                           "use_instance_norm": inorm},
               "iters": ITERS, "iters_w": ITERS_W,
               "bn_momentum": BN_MOMENTUM, "eval_fold": fold,
               "float64": f64, "train": train}
        cases.append(("flow_modes", pack(
            str(tmp / f"{name}.in.npz"), {"pc1": pc1, "pc2": pc2}, cfg,
            flownet_state_dict_from_jax(variables[inorm])),
            str(tmp / f"{name}.out.npz")))
    finish = start_torch(cases, timeout=600)
    jax_out = {"inorm32": jax_flow_run(_model(True), variables[True], pc1,
                                       pc2, train=False)}
    with _jax_float64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables[True])
        jax_out["inorm64"] = jax_flow_run(
            _model(True), v64, pc1.astype(np.float64),
            pc2.astype(np.float64))
    mp = pytest.MonkeyPatch()
    mp.setenv("OGC_EVAL_FOLD", "off")
    try:
        jax_out["fold_off"] = jax_flow_run(_model(), variables[False], pc1,
                                           pc2, train=False)
    finally:
        mp.undo()
    return dict(zip(RUNS, finish())), jax_out


def _check_flows(got, want, iters=ITERS):
    assert got.shape == want.shape == (ITERS, B, N, 3)
    scale = max(1.0, float(np.abs(want).max()))
    for it in range(iters):
        diff = float(np.abs(got[it] - want[it]).max())
        assert diff <= FLOW_TOL * scale, (it, diff, scale)
    assert np.abs(got[1] - got[0]).max() > 1e-4 * scale


def test_instance_norm_flows_match_jax_float64(runs):
    port, jax_out = runs
    assert port["inorm64"]["eval"].dtype == np.float64
    _check_flows(port["inorm64"]["eval"], jax_out["inorm64"]["eval"])
    _check_flows(port["inorm64"]["train/flows"], jax_out["inorm64"]["train"])


def test_instance_norm_float32_within_jax_rounding(runs):
    port, jax_out = runs
    got, want = port["inorm32"]["eval"], jax_out["inorm32"]["eval"]
    ref = jax_out["inorm64"]["eval"]
    _check_flows(got, want, iters=1)
    e_port = float(np.abs(got[1] - ref[1]).max())
    e_jax = float(np.abs(want[1] - ref[1]).max())
    print(f"iteration 1 from JAX's float64 run: port {e_port:.3e}, JAX "
          f"{e_jax:.3e}")
    assert e_port <= 2 * e_jax + FLOW_TOL, (e_port, e_jax)


def test_instance_norm_grads_match_jax_float64(runs):
    port, jax_out = runs
    out, state = port["inorm64"], jax_out["inorm64"]["state"]
    keys = sorted(k[len("train/g/"):] for k in out
                  if k.startswith("train/g/"))
    assert set(keys) == set(state), set(keys) ^ set(state)
    assert any(".mlp_bns." in k for k in keys)
    assert not any(k.startswith("train/s/") for k in out)
    got = np.concatenate([out["train/g/" + k].ravel() for k in keys])
    want = np.concatenate([state[k].ravel() for k in keys])
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"InstanceNorm gradient relative Frobenius error {rel:.3e}")
    assert rel <= 3e-3, rel


def test_eval_fold_off_matches_jax(runs):
    port, jax_out = runs
    _check_flows(port["fold_off"]["eval"], jax_out["fold_off"]["eval"])
