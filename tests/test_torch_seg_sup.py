"""The port's supervised segmentation training (losses/seg_sup.py,
train/seg_sup.py, train_seg_sup.py) against the JAX package's.

Same inputs made with numpy from a seed.  The loss: random soft masks
(B=4 x 200 points x 8 slots, softmax of N(0, 2) logits) against one-hot
ground truth using 1-8 of the slots (so empty slots tie in the matching
cost) with a valid mask, in CE and focal mode: the terms rtol 1e-5, the
(B, K, K) matching costs rtol 1e-5, the port's LAP on JAX's costs
returning the JAX solver's very ``col_ind`` (on its own costs, an
assignment of the same total), d(sum)/d(mask) within 1e-5 of its largest
entry, and the three unmatched losses without a valid mask rtol 1e-5.
The trainer: the ``sapien`` MaskFormer3D at the config's 512 points (8
slots, one transformer layer of width 32) on seeded weights carried by
ogc_tpu_torch.utils.params.segnet_state_dict_from_jax, 3 SupSegTrainer
steps of B=2 on 1/64-grid clouds (exact neighbours on both sides): the
loss terms rtol 1e-3 at every step, and both packages' float64 runs
(tests/test_torch_flow_train.py::_jax_float64) at rtol 1e-9.  At 64
points the same: the float64 pair at rtol 1e-9, and the port's float32
steps at rtol 1e-3 of JAX's float64 run; JAX's own float32 run is not the
reference there, as its rounding moves it 3.2e-3 from its float64 run by
the third step on these inputs (``-s`` prints every distance).  And
``python -m ogc_tpu_torch.train_seg_sup --device cpu`` on a tiny synthetic
SAPIEN root: one epoch, its checkpoint read by the port's ``test_seg``, a
resumed second epoch, and ``--remat full`` refused.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu.losses.seg_sup import (SupLossConfig, ce_loss, ce_match_cost,
                                    dice_loss, dice_match_cost, focal_loss,
                                    focal_match_cost, supervised_mask_loss)
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.train.seg import make_optimizer
from ogc_tpu.train.seg_sup import SupSegTrainer
from ogc_tpu.utils.lap import linear_sum_assignment
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.synth import make_sapien_root
from tests.test_torch_flow_train import _jax_float64
from tests.test_torch_losses import _ReferenceChain
from tests.torch_port_helper import REPO, pack, run_torch

K = 8
LOSS_B, LOSS_N = 4, 200
WEIGHTS = (2.0, 0.1)
SEGNET = {"n_slot": K, "n_point": 512, "arch": "sapien",
          "n_transformer_layer": 1, "transformer_embed_dim": 32}
TRAIN_B, TRAIN_STEPS = 2, 3
TRAIN_SIZES = (512, 64)
STEP_KEYS = ("sum", "cross_entropy", "dice")
F64_RTOL = 1e-9
LR = {"lr": 1e-3, "lr_decay": 0.7, "lr_clip": 1e-5, "decay_step": 200000,
      "batch_size": TRAIN_B}


def _onehot(rng, shape):
    """One-hot ground truth using 1..K of the slots, and a valid mask with
    ~10% of the points invalid (their rows zeroed, as the datasets do)."""
    b, n = shape
    gt = np.zeros((b, n, K), np.float32)
    valid = (rng.rand(b, n) > 0.1).astype(np.float32)
    for i in range(b):
        n_obj = rng.randint(1, K + 1)
        gt[i, np.arange(n), rng.randint(0, n_obj, n)] = 1
    return gt * valid[..., None], valid


def _random_params(model, seed):
    """Seeded weights in the shape of ``model.init``: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.01), biases N(0, 0.01), embeddings N(0, 1)."""
    pc = np.zeros((1, SEGNET["n_point"], 3), np.float32)
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


def _jax_cost(mask, gt, valid, focal):
    match = (focal_match_cost(mask, gt, valid) if focal
             else ce_match_cost(mask, gt, valid))
    return WEIGHTS[0] * match + WEIGHTS[1] * dice_match_cost(mask, gt, valid)


def _loss_inputs(rng):
    """(mask, gt, valid): soft masks and one-hot ground truth."""
    logits = 2 * rng.randn(LOSS_B, LOSS_N, K)
    mask = np.exp(logits - logits.max(-1, keepdims=True))
    mask = (mask / mask.sum(-1, keepdims=True)).astype(np.float32)
    return (mask, *_onehot(rng, (LOSS_B, LOSS_N)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_seg_sup")
    mask, gt, valid = _loss_inputs(np.random.RandomState(11))
    jax_cost = {f"jax_cost/{tag}": np.asarray(_jax_cost(mask, gt, valid,
                                                         tag == "focal"))
                for tag in ("ce", "focal")}
    x = {"mask": mask, "gt": gt, "valid": valid, **jax_cost}
    cases = [("seg_sup", pack(str(tmp / "in.npz"), x,
                              {"weights": list(WEIGHTS)}),
              str(tmp / "out.npz"))]
    train = {}
    for n in TRAIN_SIZES:
        # Each size's batches follow the loss inputs of the same seed.
        rng = np.random.RandomState(11)
        _loss_inputs(rng)
        tr_pcs = (np.round(rng.rand(TRAIN_STEPS, TRAIN_B, 2, n, 3) * 64)
                  / 64).astype(np.float32)
        segs = [_onehot(rng, (TRAIN_B * 2, n)) for _ in range(TRAIN_STEPS)]
        segnet = {**SEGNET, "n_point": n}
        model = MaskFormer3D(**segnet)
        params = _random_params(model, 5)
        tr = {"tr_pcs": tr_pcs,
              "tr_segms": np.stack([s.reshape(TRAIN_B, 2, n, K)
                                    for s, _ in segs]),
              "tr_valids": np.stack([v.reshape(TRAIN_B, 2, n)
                                     for _, v in segs])}
        cfg = {"weights": list(WEIGHTS), "segnet": segnet, "lr": LR,
               "exp_base": str(tmp / f"port_exp_{n}")}
        cases.append(("seg_sup_train",
                      pack(str(tmp / f"train{n}.in.npz"), tr, cfg,
                           segnet_state_dict_from_jax(params)),
                      str(tmp / f"train{n}.out.npz")))
        train[n] = {**tr, "model": model, "params": params}
    out, *train_out = run_torch(cases)
    for n, o in zip(TRAIN_SIZES, train_out):
        train[n]["out"] = o
    return {**x, "out": out, "train": train, "tmp": tmp}


@pytest.mark.parametrize("focal", [False, True], ids=["ce", "focal"])
def test_supervised_loss_matches_jax(setup, focal):
    tag = "focal" if focal else "ce"
    cfg = SupLossConfig(weights=WEIGHTS, use_focal=focal)
    mask, gt, valid = (jnp.asarray(setup[k]) for k in ("mask", "gt",
                                                       "valid"))
    (_, ld), grad = jax.value_and_grad(
        lambda m: supervised_mask_loss(m, gt, valid, cfg), has_aux=True)(mask)
    out = setup["out"]
    for k, v in ld.items():
        np.testing.assert_allclose(out[f"{tag}/ld/{k}"], float(v), rtol=1e-5,
                                   err_msg=k)
    grad = np.asarray(grad)
    assert np.abs(out[f"{tag}/grad"] - grad).max() <= 1e-5 * np.abs(grad).max()
    cost = np.asarray(_jax_cost(mask, gt, valid, focal))
    np.testing.assert_allclose(out[f"{tag}/cost"], cost, rtol=1e-5)
    # The port's LAP on JAX's cost returns the JAX solver's very col_ind;
    # on its own cost (equal within rounding) an assignment of the same
    # total: empty ground-truth slots tie, and rounding may pick another
    # of the tied assignments, with the same loss (checked above).
    col_ind = np.asarray(linear_sum_assignment(jnp.asarray(cost), False))
    np.testing.assert_array_equal(out[f"{tag}/col_ind_jax_cost"], col_ind)
    total = lambda ci: np.take_along_axis(cost, ci[:, :, None], 2).sum()
    np.testing.assert_allclose(total(out[f"{tag}/col_ind"]), total(col_ind),
                               rtol=1e-6)
    # The matching permutes the slots (not the identity everywhere).
    assert (col_ind != np.arange(K)).any()


def test_unmatched_losses_without_valid_match_jax(setup):
    mask, gt = jnp.asarray(setup["mask"]), jnp.asarray(setup["gt"])
    out = setup["out"]
    for name, fn in (("ce", ce_loss), ("dice", dice_loss),
                     ("focal", focal_loss)):
        np.testing.assert_allclose(out[f"{name}_novalid"],
                                   float(fn(mask, gt)), rtol=1e-5,
                                   err_msg=name)


def _jax_steps(setup, n, dt):
    """3 steps of the JAX package's SupSegTrainer at ``n`` points in the
    numpy dtype ``dt``: (sum, cross_entropy, dice) a step."""
    tr, want = setup["train"][n], []
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                    tr["params"])
    with _ReferenceChain():
        trainer = SupSegTrainer(
            tr["model"], params, SupLossConfig(weights=WEIGHTS),
            make_optimizer(**LR), ignore_npoint_thresh=0,
            exp_base=str(setup["tmp"] / f"jax_exp_{n}_{dt.__name__}"))
        for it in range(TRAIN_STEPS):
            batch = (tr["tr_pcs"][it].astype(dt),
                     tr["tr_segms"][it].astype(dt), None,
                     tr["tr_valids"][it].astype(dt))
            ld, _, _ = trainer.train_it(it, batch)
            want.append([ld[k] for k in STEP_KEYS])
    return np.array(want)


def _jax_steps_f64(setup, n):
    with _jax_float64():
        return _jax_steps(setup, n, np.float64)


def test_trainer_steps_match_jax(setup):
    """512 points: the float32 steps at rtol 1e-3 of JAX's, the float64
    pair at rtol 1e-9."""
    out = setup["train"][512]["out"]
    want, want64 = _jax_steps(setup, 512, np.float32), _jax_steps_f64(
        setup, 512)
    got, got64 = out["f32/steps"], out["f64/steps"]
    assert got.shape == got64.shape == (TRAIN_STEPS, 3)
    print("512 points, float64 pair:", np.abs(got64 / want64 - 1).max(1))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(got64, want64, rtol=F64_RTOL)
    assert not np.allclose(got[0], got[-1])
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])


def test_trainer_steps_at_64_points_match_jax_float64(setup):
    """64 points, where JAX's float32 trainer leaves rtol 1e-3 of its own
    float64 run by the third step (3.2e-3 on these inputs): the float64
    pair at rtol 1e-9 (the port's semantics are JAX's), and the port's
    float32 steps at rtol 1e-3 of JAX's float64 run.  The distances are
    printed with ``-s``."""
    out = setup["train"][64]["out"]
    want, want64 = _jax_steps(setup, 64, np.float32), _jax_steps_f64(
        setup, 64)
    got, got64 = out["f32/steps"], out["f64/steps"]
    for what, a in (("float64 pair", got64), ("port float32", got),
                    ("JAX float32", want)):
        print(f"64 points, {what} to JAX's float64 run:",
              np.abs(a / want64 - 1).max(1))
    np.testing.assert_allclose(got64, want64, rtol=F64_RTOL)
    np.testing.assert_allclose(got, want64, rtol=1e-3)
    assert not np.allclose(got64[0], got64[-1])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_SEGNET = {"n_slot": 4, "n_point": 64, "use_xyz": True,
              "n_transformer_layer": 1, "transformer_embed_dim": 32,
              "transformer_input_pos_enc": False}


def _port(module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"ogc_tpu_torch.{module}", *args,
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "2"})


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_seg_sup_cli")
    for part in ("mbs-shapepart", "mbs-sapien"):
        make_sapien_root(str(tmp / "MBS_SAPIEN" / part), n_scenes=4,
                         n_points=64)
    with open(osp.join(REPO, "config/seg/sapien/sapien_sup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update({"save_path": str(tmp / "ckpt" / "sapien_sup"), "epochs": 1,
                "batch_size": 2, "segnet": CLI_SEGNET})
    cfg["data"]["root"] = str(tmp / "MBS_SAPIEN")
    path = str(tmp / "sapien_sup.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    train = _port("train_seg_sup", path)
    assert train.returncode == 0, train.stderr[-3000:]
    return tmp, cfg, path, train.stdout


def test_train_seg_sup_cli_trains_and_checkpoints(cli):
    tmp, cfg, path, out = cli
    assert re.search(r"\[epoch +1\] train: cross_entropy=", out), out
    m = re.search(r"\[epoch +1\] +val: loss=([0-9.]+)", out)
    assert m and np.isfinite(float(m.group(1))), out
    for name in ("current", "best"):
        assert osp.exists(osp.join(cfg["save_path"], name + ".pth.tar"))
    # test_seg reads the checkpoint's model_state (round 0: <save_path>).
    test = _port("test_seg", path, "--split", "test", "--test_batch_size",
                 "4")
    assert test.returncode == 0, test.stderr[-3000:]
    assert "Evaluation on sapien-test" in test.stdout, test.stdout


def test_train_seg_sup_cli_resumes(cli):
    tmp, cfg, path, _ = cli
    cfg2 = dict(cfg, epochs=2)
    path2 = str(tmp / "sapien_sup_2.yaml")
    with open(path2, "w") as f:
        yaml.safe_dump(cfg2, f)
    r = _port("train_seg_sup", path2, "--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Resumed from epoch 1" in r.stdout
    assert re.search(r"\[epoch +2\] train:", r.stdout)
    assert not re.search(r"\[epoch +1\] train:", r.stdout)


def test_train_seg_sup_cli_refuses_remat(cli):
    """--remat, refused when this test was named, now trains (dots here;
    its steps are bit-equal to off's, tests/test_torch_remat.py)."""
    tmp, cfg, _, _ = cli
    cfg2 = dict(cfg, save_path=str(tmp / "ckpt_dots"))
    path2 = str(tmp / "sapien_sup_dots.yaml")
    with open(path2, "w") as f:
        yaml.safe_dump(cfg2, f)
    r = _port("train_seg_sup", path2, "--remat", "dots")
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"\[epoch +1\] train: cross_entropy=", r.stdout)
