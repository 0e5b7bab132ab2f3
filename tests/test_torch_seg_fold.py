"""The float32 forms of the port's segmentation net (ogc_tpu_torch/nn/
pointnet2.py) against the JAX package's defaults, on the CPU: the
source-projected eval fold and the raw-gather train split, and the
reference-shaped chain that ``OGC_EVAL_FOLD=off`` / ``OGC_TRAIN_SPLIT=off``
restore in both packages (the torch subprocess inherits the variables).

SAPIEN's MaskFormer3D (multi-scale SA stages, radius clamps) at 512 points,
one transformer layer, B=2, random seeded weights, exact neighbours; clouds
on a 1/64 grid.  Held: masks within 2e-4 of JAX's (each form); the port's
fold within 5e-5 of its reference-shaped chain (PARITY.md:96); one
``ogc_loss`` step (two frames) in each train form: loss rtol 1e-4 and the
parameter gradients within 0.3% relative Frobenius norm of JAX's (the JAX
split and the port's product of the centred rows, nn/pointnet2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu import ops
from ogc_tpu.losses.seg_unsup import OGCLossConfig, ogc_loss
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.torch_port_helper import REPO, pack, start_torch

SEGNET = {"n_slot": 8, "n_point": 512, "arch": "sapien",
          "n_transformer_layer": 1, "transformer_embed_dim": 32}
B, T, N = 2, 2, 512
# name: (the environment variable, its value)
FORMS = {"default": (None, None), "fold_off": ("OGC_EVAL_FOLD", "off"),
         "split_off": ("OGC_TRAIN_SPLIT", "off")}


def _loss_block():
    with open(f"{REPO}/config/seg/sapien/sapien_unsup.yaml") as f:
        return yaml.safe_load(f)["loss"]


def _random_params(model, seed):
    pc = np.zeros((1, N, 3), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), pc, pc)
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


def _jax(model, params, data, form):
    var, value = FORMS[form]
    mp = pytest.MonkeyPatch()
    if var:
        mp.setenv(var, value)
    cfg = OGCLossConfig.from_dict(_loss_block())

    def loss_fn(p, pcs, flows):
        flat = pcs.reshape(B * T, N, 3)
        masks = model.apply(p, flat, flat, train=True).reshape(B, T, N, -1)
        return ogc_loss([pcs[:, t] for t in range(T)],
                        [masks[:, t] for t in range(T)],
                        [flows[:, t] for t in range(T)], cfg)

    ops.set_exact_neighbors(True)
    try:
        mask = jax.jit(model.apply)(params, data["pc"], data["pc"])
        (loss, _), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(data["pcs"]),
                                    jnp.asarray(data["flows"]))
    finally:
        mp.undo()
    return {"mask": np.asarray(mask), "loss": float(loss),
            "grads": segnet_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_seg_fold")
    rng = np.random.RandomState(12)
    model = MaskFormer3D(**SEGNET)
    params = _random_params(model, 41)
    state = segnet_state_dict_from_jax(params)
    data = {"pc": (np.round(rng.rand(B, N, 3) * 64) / 64).astype(np.float32),
            "pcs": (np.round(rng.rand(B, T, N, 3) * 64) / 64).astype(
                np.float32),
            "flows": (np.round(rng.randn(B, T, N, 3) * 0.02 * 64) / 64
                      ).astype(np.float32)}
    finishes = {}
    for form, (var, value) in FORMS.items():
        mp = pytest.MonkeyPatch()
        if var:
            mp.setenv(var, value)
        try:
            finishes[form] = start_torch([
                ("segnet", pack(str(tmp / f"fwd_{form}.in.npz"),
                                {"pc": data["pc"]}, SEGNET, state),
                 str(tmp / f"fwd_{form}.out.npz")),
                ("ogc_loss", pack(str(tmp / f"loss_{form}.in.npz"),
                                  {"pcs": data["pcs"],
                                   "flows": data["flows"]},
                                  {"segnet": SEGNET, "loss": _loss_block(),
                                   "aug": False}, state),
                 str(tmp / f"loss_{form}.out.npz"))], timeout=600)
        finally:
            mp.undo()
    jax_out = {form: _jax(model, params, data, form) for form in FORMS}
    port = {form: finish() for form, finish in finishes.items()}
    return port, jax_out


@pytest.mark.parametrize("form", ["default", "fold_off"])
def test_eval_masks_match_jax(runs, form):
    port, jax_out = runs
    got = port[form][0]["mask"]
    np.testing.assert_allclose(got, jax_out[form]["mask"], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(port[form][0]["launches"], [0, 0, 0, 0])


def test_fold_is_within_5e_5_of_the_reference_chain(runs):
    port, _ = runs
    fold, chain = port["default"][0]["mask"], port["fold_off"][0]["mask"]
    diff = float(np.abs(fold - chain).max())
    print(f"fold vs reference-shaped chain: {diff:.3e}")
    assert 0 < diff <= 5e-5, diff


@pytest.mark.parametrize("form", ["default", "split_off"])
def test_train_split_loss_and_grads_match_jax(runs, form):
    port, jax_out = runs
    out, want = port[form][1], jax_out[form]
    np.testing.assert_allclose(out["ld/sum"], want["loss"], rtol=1e-4)
    keys = sorted(want["grads"])
    assert sorted(k[2:] for k in out if k.startswith("g/")) == keys
    got = np.concatenate([out["g/" + k].ravel() for k in keys])
    ref = np.concatenate([want["grads"][k].ravel() for k in keys])
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    print(f"{form}: gradient relative Frobenius error {rel:.3e}")
    assert rel <= 3e-3, rel


def test_float32_train_forms_are_one_computation(runs):
    """In float32 the port's split is the product of the centred rows
    (nn/pointnet2.py says why), so OGC_TRAIN_SPLIT=off changes no bit."""
    port, _ = runs
    a, b = port["default"][1], port["split_off"][1]
    assert float(a["ld/sum"]) != 0
    for k in a:
        if k.startswith(("ld/", "g/")) or k == "masks":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
