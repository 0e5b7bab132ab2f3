"""The port's OGC loss, its LAP, its Adam and its trainer step against the
JAX package (ogc_tpu_torch/{losses/seg_unsup,utils/lap,train/seg}.py).

Same inputs made with numpy from a seed, same weights (seeded draws in the
flax tree's shapes, carried by ogc_tpu_torch.utils.params), the KITTI-SF
loss block of config/seg/kittisf/kittisf_unsup.yaml, on the ``kitti`` arch
at n_point 1024 with one transformer layer.  Clouds and flows are on a 1/8
grid, so neighbour tables are exact on both sides; the 4-frame case feeds
grid clouds as the two augmented views.  The JAX side runs exact neighbours
and its reference-shaped SA chain (OGC_EVAL_FOLD=off), as the port does.

Tolerances: loss rtol 1e-4 and each term rtol 1e-3 (float32 sums in another
order); parameter gradients leaf by leaf within rtol 3e-3 of the leaf's
norm plus a floor of 2e-5 of the global gradient scale, and a global cosine
above 0.9999 (tests/test_grad_parity.py::_compare_grad_trees); trainer
losses within rtol 1e-3 at each of 3 steps.  The LAP must return the JAX
solver's very ``col_ind`` on tied IoU matrices at every slot count the
configs use (8-22) and at the card kernel's most (32), so the invariance
targets agree without injecting the JAX permutations; the card kernel
(csrc/iou_match.cu) is held to the host solver on the card
(chip_smoke.py), and here a numpy model of its walk is held to the JAX
solver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import yaml

from ogc_tpu import ops
from ogc_tpu.losses.seg_unsup import OGCLossConfig, ogc_loss
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.train.seg import SegTrainer, make_optimizer
from ogc_tpu.utils.lap import linear_sum_assignment
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.torch_port_helper import REPO, pack, run_torch

SEGNET = {"n_slot": 10, "n_point": 1024, "arch": "kitti",
          "n_transformer_layer": 1, "transformer_embed_dim": 32}
B, N, EXTENT = 2, 1024, 8.0
LR = {"lr": 1e-3, "lr_decay": 0.7, "lr_clip": 1e-5, "decay_step": 200000}
TRAIN_STEPS = 3
# Adam against optax: the LR decays every 2 counted steps, and step 2's
# gradient is not finite.
ADAM = {"lr": {"lr": 1e-2, "lr_decay": 0.5, "lr_clip": 1e-3, "decay_step": 2,
               "batch_size": 1}, "weight_decay": 1e-3, "steps": 6}
ADAM_NAN_STEP = 2
# Slot counts of the LAP tests: the configs' 8-22 and the card kernel's
# most.  K = 10's matrices come from the module's draws, the others from
# LAP_SEED.
LAP_KS = (8, 10, 15, 18, 22, 32)
LAP_SEED = 11


def _loss_block(start_steps=None):
    with open(f"{REPO}/config/seg/kittisf/kittisf_unsup.yaml") as f:
        loss = yaml.safe_load(f)["loss"]
    if start_steps is not None:
        loss["start_steps"] = list(start_steps)
    return loss


def _grid(rng, shape, extent, step=1 / 8):
    return (np.round(rng.rand(*shape) * extent / step) * step).astype(
        np.float32)


def _flows(rng, shape):
    return (np.round(rng.randn(*shape) * 0.3 * 8) / 8).astype(np.float32)


def _random_params(model, seed):
    """Seeded weights in the shape of ``model.init``: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.01), biases N(0, 0.01), embeddings N(0, 1)."""
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


def _tied_labels(rng, K, n):
    """Random argmax segmentations using few of the K slots."""
    return (rng.randint(0, rng.randint(1, K + 1), n),
            rng.randint(0, rng.randint(1, K + 1), n))


def _iou(s1, s2, K):
    eye = np.eye(K, dtype=np.float32)
    oh1, oh2 = eye[s1], eye[s2]
    inter = oh1.T @ oh2
    union = oh1.sum(0)[:, None] + oh2.sum(0)[None] - inter
    return inter / np.maximum(union, np.float32(1e-10))


def _tied_iou(rng, n_mats, K=10, n=200):
    """IoU matrices of random argmax segmentations using few of the K slots,
    so many assignments tie at the optimum."""
    return np.stack([_iou(*_tied_labels(rng, K, n), K)
                     for _ in range(n_mats)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_losses")
    rng = np.random.RandomState(7)
    model = MaskFormer3D(**SEGNET)
    params = _random_params(model, 21)
    state = segnet_state_dict_from_jax(params)
    data = {"pcs": _grid(rng, (B, 4, N, 3), EXTENT),
            "flows": _flows(rng, (B, 4, N, 3))}
    train = {"pcs": _grid(rng, (TRAIN_STEPS, 1, 4, N, 3), EXTENT),
             "flows": _flows(rng, (TRAIN_STEPS, 1, 4, N, 3)),
             "segms": np.zeros((TRAIN_STEPS, 1, 4, N), np.int32)}
    iou = _tied_iou(rng, 120)
    lap_rng = np.random.RandomState(LAP_SEED)
    ious = {K: iou if K == 10 else _tied_iou(lap_rng, 120, K)
            for K in LAP_KS}
    match_in = {}
    for K in (10, 22):
        s1, s2 = _tied_labels(lap_rng, K, B * N)
        for tag, seg in (("mask1", s1), ("mask2", s2)):
            # softmax-like masks whose argmax is seg
            m = lap_rng.rand(B, N, K).astype(np.float32)
            m[np.arange(B)[:, None], np.arange(N), seg.reshape(B, N)] += 1
            match_in[f"{tag}_{K}"] = m / m.sum(-1, keepdims=True)
    cases = []
    for T in (2, 4):
        x = {k: v[:, :T] for k, v in data.items()}
        cfg = {"segnet": SEGNET, "loss": _loss_block(), "aug": T == 4}
        cases.append(("ogc_loss", pack(str(tmp / f"loss{T}.in.npz"), x, cfg,
                                       state), str(tmp / f"loss{T}.out.npz")))
    cfg = {"segnet": SEGNET, "loss": _loss_block((0, 1, 2)),
           "lr": {**LR, "batch_size": 1}, "exp_base": str(tmp / "exp")}
    cases.append(("train_steps", pack(str(tmp / "train.in.npz"), train, cfg,
                                      state), str(tmp / "train.out.npz")))
    cases.append(("lap", pack(str(tmp / "lap.in.npz"),
                              {_lap_key("iou", K): v
                               for K, v in ious.items()}),
                  str(tmp / "lap.out.npz")))
    adam_p = {"w": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(3).astype(np.float32)}
    adam_g = {f"g{s}/{k}": rng.randn(*v.shape).astype(np.float32)
              for s in range(ADAM["steps"]) for k, v in adam_p.items()}
    adam_g[f"g{ADAM_NAN_STEP}/b"][1] = np.nan
    cases.append(("adam", pack(str(tmp / "adam.in.npz"), adam_g, ADAM,
                               adam_p), str(tmp / "adam.out.npz")))
    cases.append(("match", pack(str(tmp / "match.in.npz"), match_in),
                  str(tmp / "match.out.npz")))
    out = run_torch(cases)
    return {"model": model, "params": params, "data": data, "train": train,
            "iou": ious, "loss2": out[0], "loss4": out[1], "train_out": out[2],
            "lap": out[3], "adam_in": (adam_p, adam_g), "adam": out[4],
            "match_in": match_in, "match": out[5], "tmp": tmp}


def _lap_key(name, K):
    """K = 10 keeps the unsuffixed name it had before the other K."""
    return name if K == 10 else f"{name}_{K}"


class _ReferenceChain:
    """Exact neighbours and the reference-shaped SA chain on the JAX side."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("OGC_EVAL_FOLD", "off")
        self.prev = ops.exact_neighbors()
        ops.set_exact_neighbors(True)

    def __exit__(self, *exc):
        ops.set_exact_neighbors(self.prev)
        self.mp.undo()


def _compare_grads(got, want, rtol=3e-3, atol_frac=2e-5):
    keys = sorted(want)
    assert sorted(got) == keys
    g_all = np.concatenate([got[k].ravel() for k in keys])
    w_all = np.concatenate([want[k].ravel() for k in keys])
    gscale = np.sqrt((w_all ** 2).mean()) + 1e-12
    cos = g_all @ w_all / (np.linalg.norm(g_all) * np.linalg.norm(w_all)
                           + 1e-30)
    assert cos > 0.9999, f"global grad cosine {cos}"
    bad = [(k, float(np.linalg.norm(got[k] - want[k])),
            float(np.linalg.norm(want[k]))) for k in keys
           if np.linalg.norm(got[k] - want[k])
           > rtol * np.linalg.norm(want[k])
           + atol_frac * gscale * np.sqrt(want[k].size)]
    assert not bad, f"{len(bad)} leaves off: {bad[:6]}"


@pytest.mark.parametrize("K", LAP_KS)
def test_lap_col_ind_matches_jax_on_tied_matrices(setup, K):
    iou = setup["iou"][K]
    want = np.asarray(linear_sum_assignment(jnp.asarray(iou), True))
    assert len(iou) >= 100 and iou.shape[-1] == K
    np.testing.assert_array_equal(setup["lap"][_lap_key("col_ind", K)], want)


@pytest.mark.parametrize("K", [10, 22])
def test_match_mask_by_iou_cpu_returns_int64_jax_columns(setup, K):
    """The port's matching on CPU masks: an int64 CPU tensor, the JAX
    package's columns (its permutation matrices' argmax), no launch."""
    from ogc_tpu.losses.seg_unsup import match_mask_by_iou

    m1, m2 = (setup["match_in"][f"{t}_{K}"] for t in ("mask1", "mask2"))
    perm = np.asarray(match_mask_by_iou(jnp.asarray(m1), jnp.asarray(m2)))
    out = setup["match"]
    assert out["meta_" + str(K)].tolist() == ["torch.int64", "cpu"]
    np.testing.assert_array_equal(out["col_ind_" + str(K)],
                                  perm.argmax(-1))
    np.testing.assert_array_equal(out["launches_match"], [0])


def _argmin_first(vals):
    """csrc/iou_match.cu's warp argmin: a butterfly of shuffles over
    (value, lane), a NaN first, then the smaller value, then the lower
    lane; every lane ends with the same pair."""
    def first(a, ia, b, ib):
        if np.isnan(a) or np.isnan(b):
            return np.isnan(a) and (not np.isnan(b) or ia < ib)
        return a < b or (a == b and ia < ib)

    best, lane = list(vals), list(range(32))
    for off in (16, 8, 4, 2, 1):
        pair = [(best[x ^ off], lane[x ^ off]) for x in range(32)]
        for x, (b, i) in enumerate(pair):
            if first(b, i, best[x], lane[x]):
                best[x], lane[x] = b, i
    assert len(set(lane)) == 1
    return best[0], lane[0]


def _kernel_model(s1, s2, K):
    """A numpy model of csrc/iou_match.cu on one cloud pair: the integer
    histogram, its counts and the float32 IoU, then the one-warp solver
    with lane j owning column j (32 lanes, those past K padded with +inf).
    Returns (cost, col_ind)."""
    f32 = np.float32
    hist = np.bincount(s1 * K + s2, minlength=K * K).reshape(K, K)
    inter = hist.astype(f32)
    union = (hist.sum(1)[:, None].astype(f32)
             + hist.sum(0)[None].astype(f32)) - inter
    cost = -(inter / np.maximum(union, f32(1e-10)))
    inf = f32(1e30)
    u, v = np.zeros(K, f32), np.zeros(32, f32)
    col4row, row4col = np.full(K, -1), np.full(K, -1)
    for cur in range(K):
        shortest, pred = np.full(32, inf, f32), np.zeros(32, int)
        done, reached = np.zeros(32, bool), np.zeros(K, bool)
        min_val, sink, i = f32(0), -1, cur
        while sink < 0:
            reached[i] = True
            for j in range(K):
                if not done[j]:
                    d = f32(f32(f32(min_val + cost[i, j]) - u[i]) - v[j])
                    if d < shortest[j]:
                        pred[j], shortest[j] = i, d
            min_val, j = _argmin_first(
                [(inf if done[x] else shortest[x]) if x < K else f32(np.inf)
                 for x in range(32)])
            done[j] = True
            sink, i = (j, i) if row4col[j] < 0 else (-1, row4col[j])
        u[cur] = f32(u[cur] + min_val)
        short_c = shortest[np.clip(col4row, 0, K - 1)]
        for r in range(K):
            other = reached[r] and r != cur
            u[r] = f32(u[r] + (f32(min_val - short_c[r]) if other
                               else f32(0)))
        for j in range(32):
            v[j] = f32(v[j] - (f32(min_val - shortest[j]) if done[j]
                               else f32(0)))
        j = sink
        while True:
            row = pred[j]
            row4col[j], nxt, col4row[row] = row, col4row[row], j
            j = nxt
            if row == cur:
                break
    return cost, col4row


@pytest.mark.parametrize("K", LAP_KS)
def test_iou_match_kernel_model_matches_jax(K):
    """The card kernel's walk, modelled in numpy, on tied label maps (and
    one all in one slot): its IoU bit-equal to the one-hot IoU, its columns
    the JAX solver's."""
    rng = np.random.RandomState(LAP_SEED + K)
    pairs = [_tied_labels(rng, K, 512) for _ in range(12)]
    pairs.append((np.zeros(512, int), rng.randint(0, K, 512)))
    iou = np.stack([_iou(s1, s2, K) for s1, s2 in pairs])
    want = np.asarray(linear_sum_assignment(jnp.asarray(iou), True))
    for (s1, s2), w, m in zip(pairs, want, iou):
        cost, col = _kernel_model(s1, s2, K)
        np.testing.assert_array_equal(cost.view(np.int32),
                                      (-m).view(np.int32))
        np.testing.assert_array_equal(col, w)


@pytest.mark.parametrize("T", [2, 4], ids=["2frame", "4frame_aug"])
def test_ogc_loss_and_grads_match_jax(setup, T):
    model, params = setup["model"], setup["params"]
    pcs = jnp.asarray(setup["data"]["pcs"][:, :T])
    flows = jnp.asarray(setup["data"]["flows"][:, :T])
    cfg = OGCLossConfig.from_dict(_loss_block())

    def loss_fn(p, pcs, flows):
        flat = pcs.reshape(B * T, N, 3)
        masks = model.apply(p, flat, flat).reshape(B, T, N, -1)
        loss, ld = ogc_loss([pcs[:, t] for t in range(T)],
                            [masks[:, t] for t in range(T)],
                            [flows[:, t] for t in range(T)], cfg,
                            aug_transform=T == 4)
        return loss, (ld, masks)

    # Inputs as arguments, not closure constants: XLA would fold the whole
    # neighbour search of constant clouds at compile time.
    with _ReferenceChain():
        (loss, (ld, masks)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, pcs, flows)
    out = setup[f"loss{T}"]
    np.testing.assert_array_equal(out["masks"].argmax(-1),
                                  np.asarray(masks).argmax(-1))
    np.testing.assert_allclose(out["ld/sum"], float(loss), rtol=1e-4)
    terms = ("dynamic", "smooth", "invariance", "entropy", "rank")
    for term in terms:
        np.testing.assert_allclose(out["ld/" + term], float(ld[term]),
                                   rtol=1e-3, err_msg=term)
    if T == 4:
        assert float(ld["invariance"]) > 0
    want = segnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             grads))
    got = {k[2:]: v for k, v in out.items() if k.startswith("g/")}
    _compare_grads(got, want)
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])


def test_trainer_steps_match_jax(setup):
    tr = setup["train"]
    cfg = OGCLossConfig.from_dict(_loss_block((0, 1, 2)))
    opt = make_optimizer(batch_size=1, **LR)
    with _ReferenceChain():
        trainer = SegTrainer(setup["model"], setup["params"], cfg, opt,
                             aug_transform_epoch=0, ignore_npoint_thresh=0,
                             exp_base=str(setup["tmp"] / "jax_exp"))
        params, opt_state, want = trainer.params, trainer.opt_state, []
        for it in range(TRAIN_STEPS):
            params, opt_state, ld, _ = trainer._train_step(
                params, opt_state, jnp.asarray(tr["pcs"][it]),
                jnp.asarray(tr["flows"][it]), jnp.int32(it), aug=True)
            want.append([float(ld[k]) for k in ("sum", "dynamic", "smooth",
                                                "invariance")])
    got = setup["train_out"]["ld"]
    assert got.shape == (TRAIN_STEPS, 4)
    np.testing.assert_allclose(got, np.array(want), rtol=1e-3)


def test_adam_and_finite_guard_match_optax(setup):
    """The port's Adam against ogc_tpu.train.seg.make_optimizer (optax's
    Adam, L2 decay, LR staircase, apply_if_finite): the same parameters
    after every step, and a non-finite gradient moves nothing, not even the
    step the LR schedule reads."""
    p0, grads = setup["adam_in"]
    out = setup["adam"]
    opt = make_optimizer(weight_decay=ADAM["weight_decay"], **ADAM["lr"])
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(params)
    for s in range(ADAM["steps"]):
        g = {k: jnp.asarray(grads[f"g{s}/{k}"]) for k in p0}
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        for k in p0:
            np.testing.assert_allclose(out[f"p{s}/{k}"], np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {s} {k}")
    for k in p0:
        np.testing.assert_array_equal(out[f"p{ADAM_NAN_STEP}/{k}"],
                                      out[f"p{ADAM_NAN_STEP - 1}/{k}"])
    assert int(out["count"]) == ADAM["steps"] - 1
