"""The port's OA-ICP, voting and flow metrics (ogc_tpu_torch/refine/*,
metrics/flow.py, losses/seg_unsup.py::interpolate_mask_by_flow), a SAPIEN
train step at full width, and the ``oa_icp`` / ``vote`` CLIs against the
JAX package on the same seeded inputs and weights.

Tolerances: ``weighted_kabsch`` and ``object_aware_icp`` (the port's
streaming form in one tile against the JAX dense path, and at tile 64
against the JAX blockwise path) rtol 1e-4 / atol 1e-5
(tests/test_refine.py:102);
``warp_mask_chain``, the dense ``collect_correspondences`` products and
``mask_voting`` rtol 2e-4 / atol 2e-5
(tests/test_refine.py:122): float32 sums in another order, amplified by the
1/T = 100 of the softmax.  ``match_mask_by_cost`` must pick the same columns
(the port's LAP is the JAX solver step for step); the k = 1 mask
interpolation is a row copy and must be exact; ``eval_flow`` is a numpy copy
and must be exact.

The train step is the SAPIEN config at full width (512 points, 8 slots,
2 transformer layers, embed 128) at B = 2, 2 frames and 4 augmented frames,
clouds and flows on a 1/64 grid (every d2 exact, so neighbour tables agree):
loss rtol 1e-4, gradients within 0.3% relative Frobenius norm.

The CLIs run on a tiny synthetic SAPIEN root with one converted checkpoint:
flow reports and voted metrics within 1e-3, the flows ``oa_icp --save``
writes within 1e-4 of the JAX CLI's, read back through the JAX package's
``SapienDataset``.
"""

import ast
import json
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
from scipy.spatial.transform import Rotation

from ogc_tpu import ops
from ogc_tpu.data.sapien import SapienDataset
from ogc_tpu.losses.seg_unsup import (OGCLossConfig, interpolate_mask_by_flow,
                                      ogc_loss)
from ogc_tpu.metrics.flow import eval_flow
from ogc_tpu.models.segnet import MaskFormer3D
from ogc_tpu.refine.oa_icp import object_aware_icp, weighted_kabsch
from ogc_tpu.refine.vote import (collect_correspondences, mask_voting,
                                 match_mask_by_cost, warp_mask_chain)
from ogc_tpu.utils.checkpoint import save_checkpoint
from ogc_tpu_torch.utils.params import segnet_state_dict_from_jax
from tests.synth import make_sapien_root
from tests.test_torch_cli import SEGNET as CLI_SEGNET
from tests.test_torch_cli import _random_flax_params
from tests.torch_port_helper import REPO, pack, run_torch

ICP_ITER = 5
CHAINS = [(0, 1), (1, 0), (0, 2), (3, 1), (0, 3)]
SAPIEN = {"n_slot": 8, "n_point": 512, "arch": "sapien",
          "n_transformer_layer": 2, "transformer_embed_dim": 128}
B, N = 2, 512
VIEW_SELS = [[0, 1], [1, 0], [1, 2], [2, 1], [2, 3], [3, 2]]


def _two_object_scene(rng, n):
    pc1 = rng.rand(n, 3).astype(np.float32)
    segm = (rng.rand(n) > 0.5).astype(np.int32)
    flow = np.zeros_like(pc1)
    for k in range(2):
        R = Rotation.from_euler("zyx", rng.uniform(-20, 20, 3),
                                degrees=True).as_matrix().astype(np.float32)
        t = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        sel = segm == k
        flow[sel] = pc1[sel] @ R.T + t - pc1[sel]
    return pc1, pc1 + flow, segm, flow


def _soft(rng, segm, K, noise):
    logits = 4 * np.eye(K, dtype=np.float32)[segm] + noise * rng.randn(
        len(segm), K).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _refine_inputs(rng):
    scenes = [_two_object_scene(rng, 200) for _ in range(2)]
    x = {"pc1": np.stack([s[0] for s in scenes]),
         "pc2": np.stack([s[1] for s in scenes])}
    gt = np.stack([s[3] for s in scenes])
    x["flow"] = (gt + 0.03 * rng.randn(*gt.shape)).astype(np.float32)
    x["flow_gt"] = gt
    x["mask1"] = np.stack([_soft(rng, s[2], 3, 1.0) for s in scenes])
    x["mask2"] = np.stack([_soft(rng, s[2], 3, 1.0)[:, [2, 0, 1]]
                           for s in scenes])
    T, n, K = 4, 96, 3
    x["v_pc"] = rng.rand(T, n, 3).astype(np.float32)
    x["v_flows"] = (0.05 * rng.randn(T - 1, 2, n, 3)).astype(np.float32)
    x["v_mask"] = rng.dirichlet(np.ones(K), size=(T, n)).astype(np.float32)
    m = _soft(rng, rng.randint(0, 4, 60), 4, 2.0)
    x["c_mask1"] = m
    x["c_mask2"] = (0.8 * m[:, [3, 1, 0, 2]]
                    + 0.2 * rng.dirichlet(np.ones(4), 60)).astype(np.float32)
    return x


def _grid(rng, shape, step=1 / 64):
    return (np.round((rng.rand(*shape) - 0.5) / step) * step).astype(
        np.float32)


def _sapien_loss_block():
    with open(f"{REPO}/config/seg/sapien/sapien_unsup.yaml") as f:
        return yaml.safe_load(f)["loss"]


def _train_params(model, seed):
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


def _write_cli_root(tmp, rng):
    root = str(tmp / "MBS_SAPIEN")
    part = osp.join(root, "mbs-shapepart")
    make_sapien_root(part, n_scenes=3, n_points=64, seed=1)
    make_sapien_root(osp.join(root, "mbs-sapien"), n_scenes=2, n_points=64,
                     seed=2)
    pf = osp.join(part, "flow_preds", "flowstep3d")
    os.makedirs(pf)
    with open(pf + ".json", "w") as f:
        json.dump({"view_sel": VIEW_SELS}, f)
    for split in ("train", "val"):
        ds = SapienDataset(part, split=split, view_sels=VIEW_SELS)
        for sid in range(0, len(ds), len(VIEW_SELS)):
            fl = np.stack([ds[sid + k][2][0] for k in range(len(VIEW_SELS))])
            fl = fl + 0.02 * rng.randn(*fl.shape).astype(np.float32)
            ds._save_predflow(fl, save_root=pf, batch_size=len(VIEW_SELS),
                              n_frame=len(VIEW_SELS),
                              offset=sid // len(VIEW_SELS))
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_refine")
    rng = np.random.RandomState(17)
    refine_x = _refine_inputs(rng)
    model = MaskFormer3D(**SAPIEN)
    params = _train_params(model, 23)
    data = {"pcs": _grid(rng, (B, 4, N, 3)),
            "flows": _grid(rng, (B, 4, N, 3), 1 / 64) * 0.25}

    # The CLI fixture: a tiny root, one flax checkpoint and its port copy.
    root = _write_cli_root(tmp, rng)
    save_path = str(tmp / "ckpt" / "sapien_unsup")
    cfg = {"dataset": "sapien", "save_path": save_path,
           "predflow_path": "flowstep3d",
           "data": {"root": root, "decentralize": False},
           "segnet": CLI_SEGNET}
    cfg_path = str(tmp / "sapien.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    cli_params = _random_flax_params(5)
    best = osp.join(save_path + "_R1", "best")
    os.makedirs(osp.dirname(best))
    save_checkpoint({"model_state": cli_params}, True,
                    filename=osp.join(osp.dirname(best), "current"),
                    bestname=best)

    cases = [("refine", pack(str(tmp / "refine.in.npz"), refine_x,
                             {"icp_iter": ICP_ITER, "chains": CHAINS}),
              str(tmp / "refine.out.npz"))]
    for T in (2, 4):
        x = {k: v[:, :T] for k, v in data.items()}
        c = {"segnet": SAPIEN, "loss": _sapien_loss_block(), "aug": T == 4}
        cases.append(("ogc_loss", pack(str(tmp / f"loss{T}.in.npz"), x, c,
                                       segnet_state_dict_from_jax(params)),
                      str(tmp / f"loss{T}.out.npz")))
    cases.append(("save_ckpt", pack(str(tmp / "ckpt.in.npz"), {},
                                    {"path": best},
                                    segnet_state_dict_from_jax(cli_params)),
                  str(tmp / "ckpt.out.npz")))

    icp_flags = ["--split", "train", "--round", "1", "--save",
                 "--test_batch_size", "6"]
    vote_flags = ["--split", "test", "--round", "1", "--use_gt_flow",
                  "--test_batch_size", "4"]
    env = dict(os.environ, OGC_PLATFORM="cpu")
    jax_runs = [subprocess.Popen(
        [sys.executable, script, cfg_path, *flags], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, flags in (
            ("oa_icp.py", icp_flags + ["--saveflow_path", "jaxflow"]),
            ("vote.py", vote_flags))]
    try:
        out = run_torch(cases, timeout=900)
        port = {}
        for cli, flags in (("oa_icp", icp_flags), ("vote", vote_flags)):
            port[cli] = subprocess.run(
                [sys.executable, "-m", f"ogc_tpu_torch.{cli}", cfg_path,
                 *flags, "--device", "cpu"], cwd=REPO, capture_output=True,
                text=True, timeout=600,
                env=dict(os.environ, OMP_NUM_THREADS="2"))
        jax_out = [p.communicate(timeout=900) for p in jax_runs]
    finally:
        for p in jax_runs:
            p.kill()
    for p, (_, err) in zip(jax_runs, jax_out):
        assert p.returncode == 0, err[-3000:]
    for cli, r in port.items():
        assert r.returncode == 0, (cli, r.stderr[-3000:])
    return {"x": refine_x, "refine": out[0], "loss2": out[1],
            "loss4": out[2], "model": model, "params": params, "data": data,
            "root": root, "jax_icp": jax_out[0][0], "jax_vote": jax_out[1][0],
            "port_icp": port["oa_icp"].stdout,
            "port_vote": port["vote"].stdout}


def _j(x):
    return jnp.asarray(x)


def test_weighted_kabsch_matches_jax(setup):
    x, out = setup["x"], setup["refine"]
    want = weighted_kabsch(_j(x["pc1"]), _j(x["flow"]), _j(x["mask1"]))
    np.testing.assert_allclose(out["kabsch"], np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "block"])
def test_object_aware_icp_matches_jax(setup, mode):
    x, out = setup["x"], setup["refine"]
    args = [_j(x[k]) for k in ("pc1", "pc2", "flow", "mask1", "mask2")]
    kw = {"dense": True} if mode == "dense" else {"dense": False, "tile": 64}
    want = np.asarray(object_aware_icp(*args, icp_iter=ICP_ITER, **kw))
    np.testing.assert_allclose(out["icp_" + mode], want, rtol=1e-4,
                               atol=1e-5)
    # The refinement does its job on this scene: closer to the true flow.
    gt = x["flow_gt"]
    assert (np.linalg.norm(out["icp_" + mode] - gt, axis=-1).mean()
            < np.linalg.norm(x["flow"] - gt, axis=-1).mean())


def test_interpolate_mask_by_flow_matches_jax(setup):
    x, out = setup["x"], setup["refine"]
    args = [_j(x[k]) for k in ("pc1", "pc2", "mask1", "flow")]
    np.testing.assert_array_equal(
        out["interp"], np.asarray(interpolate_mask_by_flow(*args)))
    # k = 3 weighs by 1/dist.  The JAX KNN's distances carry errors up to
    # ~1e-5 at unit scale (its expanded d2 form; the port's are direct-form
    # and exact to rounding), which at neighbour distances ~0.01 moves a
    # weight by ~1e-3 relative.  The neighbour indices agree.
    np.testing.assert_allclose(
        out["interp3"], np.asarray(interpolate_mask_by_flow(*args, k=3)),
        rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("measure", ["ce", "iou"])
def test_match_mask_by_cost_picks_jax_columns(setup, measure):
    x, out = setup["x"], setup["refine"]
    want = match_mask_by_cost(_j(x["c_mask1"]), _j(x["c_mask2"]), measure)
    # A permutation of the same columns: equal iff col_ind is equal.
    np.testing.assert_array_equal(out["cost_" + measure], np.asarray(want))


def test_warp_mask_chain_and_voting_match_jax(setup):
    x, out = setup["x"], setup["refine"]
    pc, flows, mask = _j(x["v_pc"]), _j(x["v_flows"]), _j(x["v_mask"])
    corrs = collect_correspondences(pc, flows)
    for t, v in CHAINS:
        want = warp_mask_chain(pc, flows, t, v, mask[v], tile=32)
        dense = corrs[f"{t}_{v}"] @ mask[v]
        for key, ref in (("chain", want), ("dense", dense)):
            np.testing.assert_allclose(out[f"{key}/{t}_{v}"],
                                       np.asarray(ref), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{key} {t}->{v}")
    want = mask_voting(pc, mask, flows, time_window_size=2, tile=32)
    np.testing.assert_allclose(out["voted"], np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_eval_flow_matches_jax(setup):
    x, out = setup["x"], setup["refine"]
    want = eval_flow(x["flow_gt"], x["flow"], 0.01)
    np.testing.assert_array_equal(out["eval_flow"], np.array(want))
    np.testing.assert_array_equal(out["launches"], [0, 0, 0, 0])
    np.testing.assert_array_equal(out["launches_onehot"], [0, 0])


@pytest.mark.parametrize("T", [2, 4], ids=["2frame", "4frame_aug"])
def test_sapien_train_step_matches_jax(setup, T, monkeypatch):
    model, params = setup["model"], setup["params"]
    pcs = _j(setup["data"]["pcs"][:, :T])
    flows = _j(setup["data"]["flows"][:, :T])
    cfg = OGCLossConfig.from_dict(_sapien_loss_block())

    def loss_fn(p, pcs, flows):
        flat = pcs.reshape(B * T, N, 3)
        masks = model.apply(p, flat, flat).reshape(B, T, N, -1)
        loss, ld = ogc_loss([pcs[:, t] for t in range(T)],
                            [masks[:, t] for t in range(T)],
                            [flows[:, t] for t in range(T)], cfg,
                            aug_transform=T == 4)
        return loss, ld

    monkeypatch.setenv("OGC_EVAL_FOLD", "off")
    prev = ops.exact_neighbors()
    ops.set_exact_neighbors(True)
    try:
        (loss, ld), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, pcs, flows)
    finally:
        ops.set_exact_neighbors(prev)
    out = setup[f"loss{T}"]
    np.testing.assert_allclose(out["ld/sum"], float(loss), rtol=1e-4)
    assert float(ld["smooth"]) > 0
    want = segnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             grads))
    keys = sorted(want)
    g = np.concatenate([out["g/" + k].ravel() for k in keys])
    w = np.concatenate([want[k].ravel() for k in keys])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= 3e-3, f"relative Frobenius gradient error {rel}"


def _reports(stdout):
    return {name: ast.literal_eval(m) for name, m in re.findall(
        r"^(Original flow|Weighted Kabsch flow|Object-Aware ICP flow): "
        r"(\{.*\})$", stdout, re.M)}


def test_oa_icp_cli_matches_jax(setup):
    want, got = _reports(setup["jax_icp"]), _reports(setup["port_icp"])
    assert len(want) == 3 and sorted(got) == sorted(want), setup["port_icp"]
    for name in want:
        for k in want[name]:
            assert abs(got[name][k] - want[name][k]) <= 1e-3, (name, k, got,
                                                                want)
    # The flow directory the port wrote is read by the JAX package's
    # dataset, and holds the JAX CLI's flows.
    part = osp.join(setup["root"], "mbs-shapepart")
    read = [SapienDataset(part, split="train", view_sels=VIEW_SELS,
                          predflow_path=name)
            for name in ("flowstep3d_R1", "jaxflow_R1")]
    assert len(read[0]) == len(VIEW_SELS) * 2
    for i in range(len(read[0])):
        np.testing.assert_allclose(read[0][i][2], read[1][i][2], rtol=0,
                                   atol=1e-4)


def test_port_synth_writes_the_same_scenes(tmp_path):
    """ogc_tpu_torch/tools/synth.py (numpy and scipy only) writes the
    files tests/synth.py writes, byte for byte."""
    from ogc_tpu_torch.tools import synth as port_synth
    from tests import synth

    for name, mod in (("ref", synth), ("port", port_synth)):
        mod.make_sapien_root_coherent(str(tmp_path / name), n_scenes=4,
                                      n_points=96, seed=3)
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert len(files) == 5
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f


def _vote_metrics(stdout):
    return {m: float(re.search(re.escape(m) + r":? (\S+)", stdout).group(1))
            for m in ("AveragePrecision@50", "PanopticQuality@50",
                      "F1-score@50")}


def test_vote_cli_matches_jax(setup):
    want, got = _vote_metrics(setup["jax_vote"]), _vote_metrics(
        setup["port_vote"])
    for m in want:
        assert abs(got[m] - want[m]) <= 1e-3, (m, got, want)
    assert "Evaluation on sapien-test" in setup["port_vote"]


@pytest.mark.parametrize("cli,flag", [("oa_icp", ["--dp", "2"]),
                                      ("oa_icp", ["--approx_knn"]),
                                      ("vote", ["--approx_knn"])])
def test_unported_options_are_refused(setup, cli, flag):
    """Options the port refused when this test was named, which now run and
    match the JAX CLI under the same flag: flow reports or voted metrics
    within 1e-3.  --dp 2 (the JAX CLI on 2 virtual CPU devices, the port on
    2 CPU replicas) shards each batch of 6 frame pairs 3 a shard;
    --approx_knn runs the approximate mode (nested FPS; these 64-point
    clouds are below the block-min gate)."""
    cfg_path = osp.join(osp.dirname(setup["root"]), "sapien.yaml")
    args = [cfg_path, *flag] + {
        "oa_icp": ["--split", "train", "--round", "1",
                   "--test_batch_size", "6"],
        "vote": ["--split", "test", "--round", "1", "--use_gt_flow",
                 "--test_batch_size", "4"]}[cli]
    jax_run = subprocess.Popen(
        [sys.executable, f"{cli}.py", *args], cwd=REPO,
        env=dict(os.environ, OGC_PLATFORM="cpu", **(
            {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
            if "--dp" in flag else {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        r = subprocess.run(
            [sys.executable, "-m", f"ogc_tpu_torch.{cli}", *args,
             "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
            timeout=300)
        jax_out, jax_err = jax_run.communicate(timeout=600)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, jax_err[-3000:]
    assert r.returncode == 0, r.stderr[-3000:]
    if cli == "vote":
        want, got = _vote_metrics(jax_out), _vote_metrics(r.stdout)
        pairs = [(m, got[m], want[m]) for m in want]
    else:
        want, got = _reports(jax_out), _reports(r.stdout)
        assert len(want) == 3 and sorted(got) == sorted(want), r.stdout
        pairs = [((n, k), got[n][k], want[n][k]) for n in want
                 for k in want[n]]
    for key, g, w in pairs:
        assert abs(g - w) <= 1e-3, (key, g, w)
