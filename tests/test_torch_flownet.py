"""The port's FlowStep3D (ogc_tpu_torch/models/flownet.py) against the JAX
package's on the same weights, in eval mode, and the weight converter.

Weights are random flax variables (BatchNorm statistics and affines
perturbed, so the folded eval affines are not identities), carried to the
port by utils/params.py::flownet_state_dict_from_jax.  Two archs: SAPIEN's
at 64 points, and a narrow KITTI-shaped one (three global levels, two
correlation stages, S = 12 at the second global level, loc_flow_nn 16,
loc_flow_rad 1.5) at 256 points on a 20 m scene.  The recurrence is chaotic
past ~2 iterations (PARITY.md:238-241), so iterations 0-1 are compared:
within 2e-5 of the flow's scale (max |flow|, at least 1), in the exact mode
and in the approximate mode (nested FPS, frozen self-KNN tables; at these
sizes both packages search exactly).
"""

import jax
import numpy as np
import pytest

from ogc_tpu.models.flownet import FlowNetArch, FlowStep3D, SASpec
from ogc_tpu_torch.utils.params import flownet_state_dict_from_jax
from tests.torch_port_helper import pack, run_torch

ITERS = 2
FLOW_TOL = 2e-5
KITTI_NARROW = {
    "enc_loc": [[2, 16, [16, 16, 16]], [4, 16, [32, 32, 32]]],
    "enc_glob": [[8, 16, [32, 32, 32]], [16, 12, [32, 32, 32]],
                 [32, 8, [64, 64, 64]]],
    "corr_sa": [[16, 8, [16, 16, 32]], [8, 8, [32, 32, 32]]],
    "corr_dim": 32, "reg_nsample": 16, "reg_mlp": [32, 32, 32],
    "hidden_dim": 32, "local_corr_mlp": [32, 32, 32],
    "flow_conv1": [4, 8, [16, 16, 16]], "flow_conv2": [4, 4, [8, 8, 8]],
    "h0_mlp1": [32, 32, 32],
}
# name: (arch, model kwargs, B, extent)
MODELS = {
    "sapien": ("sapien", dict(npoint=64, loc_flow_nn=8, loc_flow_rad=0.1,
                              k_decay_fact=0.5), 2, 1.0),
    "kitti_narrow": (KITTI_NARROW, dict(npoint=256, loc_flow_nn=16,
                                        loc_flow_rad=1.5, k_decay_fact=0.5),
                     2, 20.0),
}


def _jax_arch(a):
    if isinstance(a, str):
        return a
    spec = {k: (tuple(SASpec(s[0], s[1], tuple(s[2])) for s in v)
                if k in ("enc_loc", "enc_glob", "corr_sa")
                else SASpec(v[0], v[1], tuple(v[2]))
                if k in ("flow_conv1", "flow_conv2")
                else tuple(v) if isinstance(v, list) else v)
            for k, v in a.items()}
    return FlowNetArch(**spec)


def random_flow_variables(model, npoint, seed):
    """Random FlowStep3D variables of the model's shapes: kernels scaled by
    1/sqrt(fan_in), BatchNorm affines and statistics away from identity."""
    pc = np.zeros((1, npoint, 3), np.float32)
    shapes = jax.eval_shape(lambda key, x: model.init(key, x, x, x, x, 2),
                            jax.random.PRNGKey(0), pc)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        z = rng.randn(*s.shape).astype(np.float32)
        key = path[-1].key
        if key == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if key in ("scale", "var"):
            return 1 + 0.2 * np.abs(z) if key == "var" else 1 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _clouds(rng, b, n, extent):
    pc1 = (rng.rand(b, n, 3) * extent).astype(np.float32)
    flow = 0.02 * extent * rng.randn(b, 1, 3) + 0.005 * extent * rng.randn(
        b, n, 3)
    return pc1, (pc1 + flow).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ogc_tpu import ops

    tmp = tmp_path_factory.mktemp("torch_flownet")
    rng = np.random.RandomState(7)
    cases, jax_out = [], {}
    for i, (name, (arch, kw, b, extent)) in enumerate(MODELS.items()):
        model = FlowStep3D(arch=_jax_arch(arch), **kw)
        variables = random_flow_variables(model, kw["npoint"], i)
        pc1, pc2 = _clouds(rng, b, kw["npoint"], extent)
        for mode in ("exact", "approx"):
            ops.set_exact_neighbors(mode == "exact")
            flows = model.apply(variables, pc1, pc2, pc1, pc2, ITERS,
                                train=False)
            jax_out[f"{name}/{mode}"] = np.stack([np.asarray(f)
                                                  for f in flows])
        ops.set_exact_neighbors(True)
        inp = pack(str(tmp / f"{name}.in.npz"), {"pc1": pc1, "pc2": pc2},
                   {"arch": arch, "model": kw, "iters": ITERS,
                    "modes": ["exact", "approx"]},
                   flownet_state_dict_from_jax(variables))
        cases.append(("flownet", inp, str(tmp / f"{name}.out.npz")))
    outs = run_torch(cases)
    return jax_out, dict(zip(MODELS, outs))


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("name", list(MODELS))
def test_flownet_matches_jax(runs, name, mode):
    jax_out, port = runs
    want, got = jax_out[f"{name}/{mode}"], port[name][mode]
    assert got.shape == want.shape == (ITERS, MODELS[name][2],
                                       MODELS[name][1]["npoint"], 3)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    for it in range(ITERS):
        diff = float(np.abs(got[it] - want[it]).max())
        assert diff <= FLOW_TOL * scale, (it, diff, scale)
    # The iterations moved the flow (the refinement ran).
    assert np.abs(got[1] - got[0]).max() > 1e-3 * scale


@pytest.mark.parametrize("name", list(MODELS))
def test_pool_gate_route_is_bit_equal(runs, name):
    """OGC_PALLAS_POOL=interpret sends every supported pool through
    rowgroup_pool (on the CPU its plain version): the same float32
    roundings as the plain chain, so the flows are bit-equal; no kernel
    launches on CPU tensors."""
    _, port = runs
    np.testing.assert_array_equal(port[name]["exact/interpret"],
                                  port[name]["exact"])
    np.testing.assert_array_equal(port[name]["launches_flow"], [0, 0])


@pytest.mark.parametrize("name", list(MODELS))
def test_flownet_converter_round_trip(name):
    """flax variables -> the port's state_dict -> the JAX package's
    flownet_variables_from_torch -> the same variables."""
    from ogc_tpu.utils.torch_interop import flownet_variables_from_torch

    arch, kw, _, _ = MODELS[name]
    model = FlowStep3D(arch=_jax_arch(arch), **kw)
    variables = random_flow_variables(model, kw["npoint"], 11)
    state = flownet_state_dict_from_jax(variables)
    assert not any(k.startswith(("h0_net.sa2.mlp_bns", "gru.conv"))
                   and ".mlp_bns." in k for k in state)
    blank = jax.tree_util.tree_map(np.zeros_like, variables)
    back = flownet_variables_from_torch(state, blank)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    n_bn = sum(k.endswith("running_var") for k in state)
    assert n_bn == len(jax.tree_util.tree_leaves(variables["batch_stats"])) // 2
