"""The port's data-parallel training (ogc_tpu_torch/parallel/mesh.py, the
sharded DataLoader, the trainers' averaged collectives, global BatchNorm,
rank-0 checkpoints) against the JAX package's trainers on a 2-device mesh.

The torch side runs 2 gloo ranks on the CPU (tests/torch_port_helper.py's
``dp`` case spawns them with the launcher's environment set by hand); each
rank loads its row block of every global batch through the port's
``DataLoader``.  The JAX side runs in-process on 2 of the conftest's
virtual CPU devices (manual SPMD: local losses, pmean'd gradients and
scalars).  Same seeded weights (carried by ogc_tpu_torch/utils/params.py),
same inputs (clouds on a 1/64 grid, so every d2 is exact on both sides),
exact neighbours on both sides, B = 4 global (2 a rank), 2 steps:

* SegTrainer (the ``sapien`` MaskFormer3D at 64 points, 4 slots, one
  transformer layer of width 32; 4 frames, the augmented views a quarter
  turn of the first two, every loss term on), SupSegTrainer (one-hot
  ground truth with a valid mask) and FlowTrainer (the ``sapien``
  FlowStep3D at 64 points, 2 iterations) with ``bn_sync`` ``local`` and
  ``global``;
* in float64 (both packages: the port's float64 model; JAX through
  tests/test_torch_flow_train.py::_jax_float64, its IoU matching of the
  invariance term left in float32 as both packages compute it: in float64
  the LAP parts near-ties of the IoU sums another way) every step's terms,
  every parameter and every BatchNorm running statistic after the 2 steps
  at rtol 1e-9 of the quantity's largest entry, FlowTrainer's parameters
  at 1e-7 (Adam's eps amplifies the rounding of a near-zero gradient
  element: 1.9e-9 measured on one BatchNorm bias under local sync, the
  rest below 5e-10); in float32 the first step's terms at rtol 1e-4 (the
  flow trainer's at 1e-3, the single-device tolerance of
  tests/test_torch_flow_train.py) from the JAX float64 run;
* every rank starting from rank 0's weights and Adam moments
  (``sync_replicas``, after rank 1 moved its own);
* the validation loss of a 3-item batch padded to 4 over the 2 ranks (the
  padded duplicate counts in the mean, the weight is the true count) and
  its terms at rtol 1e-9 in float64;
* in float64, the checkpoint: written by rank 0 alone, found by rank 1
  when ``save`` returns, and a trainer resumed from it on both ranks takes
  step 3 bit-equal to the continuing one (terms and parameters).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from ogc_tpu.losses import seg_unsup
from ogc_tpu.losses.flow_unsup import FlowLossConfig
from ogc_tpu.losses.seg_sup import SupLossConfig
from ogc_tpu.losses.seg_unsup import OGCLossConfig
from ogc_tpu.models.flownet import FlowStep3D
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.parallel import mesh as pmesh
from ogc_tpu.train.flow import FlowTrainer, make_bn_schedule
from ogc_tpu.train.seg import SegTrainer, make_optimizer
from ogc_tpu.train.seg_sup import SupSegTrainer
from ogc_tpu.utils import lap
from ogc_tpu_torch.utils.params import (flownet_state_dict_from_jax,
                                        segnet_state_dict_from_jax)
from tests.test_torch_flow_train import _jax_float64
from tests.test_torch_flownet import random_flow_variables
from tests.test_torch_losses import _ReferenceChain
from tests.test_torch_seg_sup import _random_params
from tests.torch_port_helper import REPO, pack, start_torch

WORLD, B, STEPS, N, K, ITERS = 2, 4, 2, 64, 4, 2
SEGNET = {"n_slot": K, "n_point": N, "arch": "sapien",
          "n_transformer_layer": 1, "transformer_embed_dim": 32}
FLOW_MODEL = {"npoint": N, "loc_flow_nn": 8, "loc_flow_rad": 0.1,
              "k_decay_fact": 1.0}
LR = {"lr": 1e-3, "lr_decay": 0.7, "lr_clip": 1e-5, "decay_step": 200000,
      "batch_size": B}
BN = {"bn_momentum": 0.9, "bn_decay": 0.5, "decay_step": 4,
      "batch_size": B}
SUP_WEIGHTS = (2.0, 0.1)
F64_RTOL = 1e-9
# FlowTrainer's parameters after 2 Adam steps: Adam divides by |g| + eps,
# which amplifies the float64 rounding of a near-zero gradient element (the
# bound tests/test_torch_flow_train.py holds its float64 trainer steps to).
FLOW_PARAM_RTOL = 1e-7
KINDS = ["seg", "sup", "flow_local", "flow_global"]


def _seg_loss():
    with open(f"{REPO}/config/seg/sapien/sapien_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["start_steps"] = [0, 0, 0]
    return loss


def _flow_loss():
    with open(f"{REPO}/config/flow/sapien/sapien_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    loss["iters_w"] = loss["iters_w"][:ITERS]
    return loss


@contextlib.contextmanager
def _float32_matching():
    """The JAX package's IoU matching (one-hot masks, IoU, the LAP) in
    float32 inside ``_jax_float64``, as it and the port compute it."""
    names = (seg_unsup, lap)
    real = seg_unsup.match_mask_by_iou

    def match(m1, m2):
        wide = [m.jnp for m in names]
        for m in names:
            m.jnp = jnp
        try:
            return real(m1, m2).astype(m1.dtype)
        finally:
            for m, w in zip(names, wide):
                m.jnp = w

    seg_unsup.match_mask_by_iou = match
    try:
        yield
    finally:
        seg_unsup.match_mask_by_iou = real


def _grid(a):
    return (np.round(a * 64) / 64).astype(np.float32)


def _data(kind, n_items, rng):
    """(pcs, segms, flows, valids) of ``n_items`` items for ``kind``."""
    T = 4 if kind == "seg" else 2
    pcs = _grid(0.4 * rng.rand(n_items, 2, N, 3))
    flows = _grid(0.1 * rng.randn(n_items, 2, N, 3))
    if kind == "seg":
        # The augmented views: a quarter turn about y, exact on the grid.
        turn = (lambda a: np.stack([a[..., 2], a[..., 1], -a[..., 0]], -1))
        pcs = np.concatenate([pcs, turn(pcs)], 1)
        flows = np.concatenate([flows, turn(flows)], 1)
    if kind == "sup":
        segms = np.eye(K, dtype=np.float32)[rng.randint(0, K, (n_items, T,
                                                               N))]
        valids = (rng.rand(n_items, T, N) > 0.1).astype(np.float32)
        segms *= valids[..., None]
    else:
        segms = rng.randint(0, K, (n_items, T, N)).astype(np.int32)
        valids = np.ones((n_items, T, N), np.float32)
    return pcs, segms, flows, valids


def _model(kind):
    if kind.startswith("flow"):
        model = FlowStep3D(arch="sapien", **FLOW_MODEL)
        return model, random_flow_variables(model, N, 4)
    model = MaskFormer3D(**SEGNET)
    return model, _random_params(model, 5)


def _state(kind, tree):
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if kind.startswith("flow"):
        return flownet_state_dict_from_jax(tree)
    return segnet_state_dict_from_jax(tree)


EVAL_KINDS = ("seg", "flow_global")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every trainer's 2-rank run of the port (one torch process, its
    ranks spawned once) and the JAX trainers' runs, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("torch_dp_train")
    runs, x, state = {}, {}, {}
    cfg = {"run": "trainers", "world": WORLD, "trainers": KINDS,
           "steps": STEPS, "batch": B, "lr": LR}
    for i, kind in enumerate(KINDS):
        rng = np.random.RandomState(20 + i)
        model, params = _model(kind)
        train, ev = _data(kind, B * (STEPS + 1), rng), _data(kind, 3, rng)
        for name, arrays in (("", train), ("ev_", ev)):
            x.update({f"{kind}/{name}{k}": v for k, v in zip(
                ("pcs", "segms", "flows", "valids"), arrays)})
        state.update({f"{kind}.{k}": v
                      for k, v in _state(kind, params).items()})
        sub = {"exp_base": str(tmp / f"port_{kind}_"),
               "eval": kind in EVAL_KINDS}
        if kind.startswith("flow"):
            sub.update(arch="sapien", model=FLOW_MODEL, iters=ITERS,
                       loss=_flow_loss(), bn=BN)
        else:
            sub.update(segnet=SEGNET, loss=_seg_loss(),
                       weights=list(SUP_WEIGHTS))
        cfg[kind] = sub
        runs[kind] = {"model": model, "params": params, "train": train,
                      "ev": ev}
    finish = start_torch([("dp", pack(str(tmp / "dp.in.npz"), x, cfg, state),
                           str(tmp / "dp.out.npz"))], timeout=600)
    try:
        with _ReferenceChain():
            for kind, run in runs.items():
                with _jax_float64(), _float32_matching():
                    run["f64"] = _jax_run(kind, run, np.float64, STEPS,
                                          str(tmp / f"jax_{kind}_f64"))
    finally:
        (out,) = finish()
    for kind, run in runs.items():
        p = f"{kind}/"
        run["out"] = {k[:3] + k[3 + len(p):]: v for k, v in out.items()
                      if k[3:].startswith(p)}
        run["out"].update({k: v for k, v in out.items()
                           if k.endswith("launches")})
    return runs


def _jax_run(kind, run, dt, steps, exp_base):
    """The JAX trainer on a 2-device mesh: {"steps": terms a step (keys
    sorted), "keys", "state" after the steps, and for EVAL_KINDS in
    float64 "ev_loss", "ev_ld"}."""
    model, params = run["model"], run["params"]
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
    mesh = pmesh.make_mesh(jax.devices()[:WORLD])
    common = dict(exp_base=exp_base, mesh=mesh)
    if kind.startswith("flow"):
        trainer = FlowTrainer(
            model, params, ITERS, FlowLossConfig.from_dict(_flow_loss()),
            make_optimizer(**LR), bn_schedule=make_bn_schedule(**BN),
            bn_sync=kind[len("flow_"):], **common)
    elif kind == "sup":
        trainer = SupSegTrainer(model, params,
                                SupLossConfig(weights=SUP_WEIGHTS),
                                make_optimizer(**LR),
                                ignore_npoint_thresh=0, **common)
    else:
        trainer = SegTrainer(model, params,
                             OGCLossConfig.from_dict(_seg_loss()),
                             make_optimizer(**LR), aug_transform_epoch=0,
                             ignore_npoint_thresh=0, **common)
    cast = (lambda a: a.astype(dt) if a.dtype.kind == "f" else a)
    out = {"steps": []}
    for it in range(steps):
        batch = tuple(cast(a[it * B:(it + 1) * B]) for a in run["train"])
        ld = (trainer.train_it(it, batch, aug_transform=True)
              if kind == "seg" else trainer.train_it(it, batch))
        ld = ld if isinstance(ld, dict) else ld[0]
        out["keys"] = sorted(ld)
        out["steps"].append([ld[k] for k in out["keys"]])
    out["steps"] = np.array(out["steps"])
    out["state"] = _state(kind, trainer.variables if kind.startswith("flow")
                          else trainer.params)
    if kind in EVAL_KINDS and dt == np.float64:
        loss, ld = trainer.eval_epoch([tuple(cast(a) for a in run["ev"])])[:2]
        out["ev_loss"], out["ev_ld"] = loss, [ld[k] for k in sorted(ld)]
    return out


def _leaf_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _port(out, rank, dt):
    p = f"r{rank}/{dt}/"
    return {k[len(p):]: v for k, v in out.items() if k.startswith(p)}


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_mesh_float64(runs, kind):
    """Both ranks' steps, parameters and running statistics (and, where
    run, the padded eval batch's loss and terms) against the JAX trainer on
    2 devices, in float64 at rtol 1e-9."""
    run = runs[kind]
    want = run["f64"]
    for rank in range(WORLD):
        got = _port(run["out"], rank, "f64")
        assert list(got["keys"]) == want["keys"]
        np.testing.assert_allclose(got["steps"], want["steps"],
                                   rtol=F64_RTOL)
        state = want["state"]
        names = sorted(k[2:] for k in got if k.startswith("s/"))
        assert names == sorted(k for k in state if "num_batches" not in k)
        errs = {k: _leaf_err(got["s/" + k], state[k]) for k in names}
        worst = max(errs, key=errs.get)
        print(f"{kind} rank {rank}: steps "
              f"{np.abs(got['steps'] / want['steps'] - 1).max():.3e}, "
              f"worst leaf {worst} {errs[worst]:.3e}")
        for k, e in errs.items():
            flow_param = kind.startswith("flow") and "running_" not in k
            assert e <= (FLOW_PARAM_RTOL if flow_param else F64_RTOL), (k, e)
        if kind in EVAL_KINDS:
            np.testing.assert_allclose(got["ev_loss"], want["ev_loss"],
                                       rtol=F64_RTOL)
            np.testing.assert_allclose(got["ev_ld"], want["ev_ld"],
                                       rtol=F64_RTOL)
    assert not np.allclose(want["steps"][0], want["steps"][-1])
    if kind.startswith("flow"):
        stats = [k for k in state if "running_" in k]
        before = _state(kind, run["params"])
        assert stats and all(not np.allclose(state[k], before[k])
                             for k in stats)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_mesh_float32(runs, kind):
    """The first step's terms in float32 against the JAX trainer on 2
    devices (rtol 1e-4; the flow trainer's 1e-3, as its single-device
    test), the same on both ranks.  The JAX side is its float64 run, which
    the float64 test holds the port to at 1e-9: a JAX float32 run would
    only add its own rounding to the reference."""
    run = runs[kind]
    r0, r1 = _port(run["out"], 0, "f32"), _port(run["out"], 1, "f32")
    assert list(r0["keys"]) == run["f64"]["keys"]
    np.testing.assert_array_equal(r0["steps"], r1["steps"])
    rtol = 1e-3 if kind.startswith("flow") else 1e-4
    np.testing.assert_allclose(r0["steps"][0], run["f64"]["steps"][0],
                               rtol=rtol)
    assert np.isfinite(r0["steps"]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_start_from_rank0_state(runs, kind):
    """Rank 1 moved its weights and Adam moments away before training;
    ``sync_replicas`` gives every rank rank 0's state, the carried
    weights."""
    out, run = runs[kind]["out"], runs[kind]
    start = [_port(out, r, "f64") for r in range(WORLD)]
    weights = _state(kind, run["params"])
    names = [k[len("start/s/"):] for k in start[0]
             if k.startswith("start/s/")]
    assert names
    for k in names:
        np.testing.assert_array_equal(start[1]["start/s/" + k],
                                      start[0]["start/s/" + k])
        np.testing.assert_allclose(start[0]["start/s/" + k], weights[k],
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(start[1]["start/mu"], start[0]["start/mu"])
    assert not start[0]["start/mu"].any()


@pytest.mark.parametrize("kind", EVAL_KINDS)
def test_padded_eval_batch_counts_true_rows(runs, kind):
    """The 3-item eval batch over 2 ranks: rank 0 holds 2 true rows, rank
    1 one true row and a copy of it; the global true count is 3."""
    out = runs[kind]["out"]
    np.testing.assert_array_equal(out["r0/f64/ev_true_b"], [2, 3])
    np.testing.assert_array_equal(out["r1/f64/ev_true_b"], [1, 3])


@pytest.mark.parametrize("kind", KINDS)
def test_rank0_checkpoint_and_resume(runs, kind):
    """Rank 0 alone writes; rank 1 finds the file once ``save`` returns;
    the resumed trainer's step 3 is bit-equal to the continuing one's on
    both ranks; the ranks' parameters are equal."""
    out = runs[kind]["out"]
    for rank in range(WORLD):
        p = f"r{rank}/f64/"
        assert int(out[p + "writes"]) == (1 if rank == 0 else 0)
        assert bool(out[p + "found"]) and int(out[p + "epoch"]) == 1
        np.testing.assert_array_equal(out[p + "resumed/ld"],
                                      out[p + "cont/ld"])
        for k in [k for k in out if k.startswith(p + "cont/s/")]:
            np.testing.assert_array_equal(
                out[k.replace("/cont/", "/resumed/")], out[k])
            np.testing.assert_array_equal(out[k], out["r0/" + k[3:]])
    np.testing.assert_array_equal(out["r1/launches"], [0, 0, 0, 0])
