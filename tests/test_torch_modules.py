"""The port's nn modules and MaskFormer3D against the JAX package with the
same weights, carried by ogc_tpu_torch.utils.params.

Weights are seeded random draws in the flax trees' shapes (so every norm
affine and bias is non-trivial); clouds are grid-quantized so that neighbour selection is
exact on both sides.  Tolerances: modules 1e-5 (float32 sums in another
order, GroupNorm two-pass vs. flax's E[x^2] - E[x]^2); whole-model masks
2e-4 (the PARITY.md segnet tolerance) with 100% argmax agreement.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogc_tpu import ops
from ogc_tpu.models.segnet import ARCHS, MaskFormer3D
from ogc_tpu.nn.pointnet2 import FPModule, SAModuleMSG
from ogc_tpu.nn.transformer import MaskFormerHead
from ogc_tpu.utils.torch_interop import segnet_params_from_torch
from ogc_tpu_torch.utils import params as P
from tests.torch_port_helper import pack, run_torch

GN = {"class": "GroupNorm", "num_groups": 4}
SA_CFG = {"npoint": 64, "radii": [0.15, 0.3], "nsamples": [16, 16],
          "mlps": [[16, 16, 16], [16, 16, 32]]}
FP_MLP = [16, 16]
FP_ARGS = ("unknown", "known", "unknown_feats", "known_feats")
MF_CFG = {"n_slot": 4, "input_dim": 24, "n_transformer_layer": 2,
          "transformer_embed_dim": 32, "transformer_n_head": 8,
          "transformer_hidden_dim": 32, "input_pos_enc": True}
SEG_ARCHS = ("sapien", "kitti")
SEG_N = 1024


def _seg_cfg(arch):
    return {"n_slot": 4, "n_point": SEG_N, "arch": arch,
            "n_transformer_layer": 1, "transformer_embed_dim": 32}


def _random_params(module, seed, *args):
    """Seeded weights in the shape of ``module.init(key, *args)``, traced
    abstractly (no flax init run): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.01), biases N(0, 0.01), embeddings N(0, 1)."""
    with _Exact():
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        z = rng.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1 + 0.1 * z
        return z if name == "embedding" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(module, params, *args):
    with _Exact():
        return jax.tree_util.tree_map(
            np.asarray, jax.jit(module.apply)(params, *map(jnp.asarray, args)))


def _grid(rng, shape, extent, step):
    return (np.round(rng.rand(*shape) * extent / step) * step).astype(np.float32)


class _Exact:
    def __enter__(self):
        self.prev = ops.exact_neighbors()
        ops.set_exact_neighbors(True)

    def __exit__(self, *exc):
        ops.set_exact_neighbors(self.prev)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """All torch-side cases in one subprocess; returns (inputs, params, outs)."""
    tmp = tmp_path_factory.mktemp("torch_modules")
    rng = np.random.RandomState(2)
    inputs, params, cases, names = {}, {}, [], []

    def add(case, name, x, cfg, state):
        inputs[name] = x
        names.append(name)
        cases.append((case, pack(str(tmp / f"{name}.in.npz"), x, cfg, state),
                      str(tmp / f"{name}.out.npz")))

    x = {"xyz": _grid(rng, (2, 256, 3), 1.0, 1 / 16),
         "feats": rng.randn(2, 256, 6).astype(np.float32)}
    params["sa"] = _random_params(SAModuleMSG(**SA_CFG, norm=GN), 10,
                                  x["xyz"], x["feats"])
    add("sa", "sa", x, SA_CFG, P.sa_module_state(params["sa"]["params"]))

    x = {"unknown": _grid(rng, (2, 128, 3), 1.0, 1 / 16),
         "known": _grid(rng, (2, 32, 3), 1.0, 1 / 16),
         "unknown_feats": rng.randn(2, 128, 6).astype(np.float32),
         "known_feats": rng.randn(2, 32, 10).astype(np.float32)}
    params["fp"] = _random_params(FPModule(tuple(FP_MLP), norm=GN), 11,
                                  *(x[k] for k in FP_ARGS))
    add("fp", "fp", x, {"mlp": FP_MLP},
        P.fp_module_state(params["fp"]["params"]))

    x = {"feats": rng.randn(2, 40, MF_CFG["input_dim"]).astype(np.float32),
         "pos": rng.randn(2, 40, 3).astype(np.float32)}
    params["mf"] = _random_params(MaskFormerHead(**MF_CFG), 12, x["feats"],
                                  x["pos"])
    add("mf_head", "mf", x, MF_CFG, P.mf_head_state(params["mf"]["params"]))

    for arch in SEG_ARCHS:
        extent, step = (1.0, 1 / 64) if arch == "sapien" else (16.0, 1 / 8)
        x = {"pc": _grid(rng, (2, SEG_N, 3), extent, step)}
        params[arch] = _random_params(MaskFormer3D(**_seg_cfg(arch)), 13,
                                      x["pc"], x["pc"])
        add("segnet", arch, x, _seg_cfg(arch),
            P.segnet_state_dict_from_jax(params[arch]))

    return inputs, params, dict(zip(names, run_torch(cases)))


def test_sa_module_msg(port):
    """Against the JAX eval path as test_seg.py runs it (the source-projected
    fold).  The JAX reference-shaped chain (OGC_EVAL_FOLD=off) is held out:
    on this input its flax GroupNorm (E[x^2] - E[x]^2 in float32) lands
    1.9e-5 from a float64 evaluation of the same chain, against 1.2e-6 for
    the port and 4.2e-6 for the fold."""
    inputs, params, outs = port
    x = inputs["sa"]
    new_xyz, new_feats = _apply(SAModuleMSG(**SA_CFG, norm=GN), params["sa"],
                                x["xyz"], x["feats"])
    np.testing.assert_array_equal(outs["sa"]["new_xyz"], new_xyz)
    np.testing.assert_allclose(outs["sa"]["new_feats"], new_feats, rtol=0,
                               atol=1e-5)


def test_fp_module(port):
    inputs, params, outs = port
    x = inputs["fp"]
    want = _apply(FPModule(tuple(FP_MLP), norm=GN), params["fp"],
                  *(x[k] for k in FP_ARGS))
    np.testing.assert_allclose(outs["fp"]["out"], want, rtol=0, atol=1e-5)


def test_maskformer_head(port):
    inputs, params, outs = port
    x = inputs["mf"]
    want = _apply(MaskFormerHead(**MF_CFG), params["mf"], x["feats"], x["pos"])
    np.testing.assert_allclose(outs["mf"]["out"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", SEG_ARCHS)
def test_maskformer3d_slice(port, arch):
    inputs, params, outs = port
    pc = inputs[arch]["pc"]
    want = _apply(MaskFormer3D(**_seg_cfg(arch)), params[arch], pc, pc)
    got = outs[arch]["mask"]
    assert got.shape == want.shape == (2, SEG_N, 4)
    assert np.abs(got - want).max() <= 2e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(outs[arch]["launches"], [0, 0, 0, 0])


def test_archs_match_jax(port):
    _, _, outs = port
    want = {k: dataclasses.asdict(v) for k, v in ARCHS.items()}
    assert json.loads(str(outs["sapien"]["archs"])) == json.loads(
        json.dumps(want))


def test_weights_round_trip():
    """flax params -> segnet_state_dict_from_jax -> segnet_params_from_torch
    gives back the same tree bit-exactly (numpy only, no torch)."""
    model = MaskFormer3D(n_slot=4, n_point=64, arch="kitti",
                         n_transformer_layer=2, transformer_embed_dim=32,
                         transformer_input_pos_enc=True)
    pc = np.zeros((1, 64, 3), np.float32)
    params = _random_params(model, 14, pc, pc)
    state = P.segnet_state_dict_from_jax(params)
    back = segnet_params_from_torch(state, params, n_transformer_layer=2)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))
