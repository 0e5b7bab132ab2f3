"""Torch side of the PyTorch port's parity tests (tests/test_torch_*.py).

tests/conftest.py imports jax into every pytest worker, and torch must not
share a process with JAX, so a test writes its inputs (numpy arrays made
from a seed, carried weights under ``sd/<key>``, a JSON ``cfg``) to an .npz,
runs the torch side here in a subprocess, and reads the outputs back:

    python -m tests.torch_port_helper <case> <in.npz> <out.npz> [<case> ...]

Every case also reports the kernel launch counters (FPS, exact KNN, ball
query, scatter-add; the small-source gather and scatter as
``launches_onehot``; the block-min KNN and ball query as
``launches_blockmin``; the row-group pool and the bound-pruned KNN as
``launches_flow``; the block-sparse gather and scatter and the
candidate-pruned KNN as ``launches_cand``), which must stay at 0 on CPU
tensors.  The torch side
runs with exact neighbours (``OGC_EXACT_NEIGHBORS=1``) unless a test asks
for the environment without it; a case's ``compute_dtype: bf16`` runs it in
the bf16 compute mode.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# pytest side (no torch import)
# ---------------------------------------------------------------------------


def pack(path: str, arrays: Dict[str, np.ndarray], cfg=None,
         state: Dict[str, np.ndarray] = None) -> str:
    """Write one case's inputs; returns ``path``."""
    data = dict(arrays)
    if cfg is not None:
        data["cfg"] = np.array(json.dumps(cfg))
    for k, v in (state or {}).items():
        data["sd/" + k] = v
    np.savez(path, **data)
    return path


def run_torch(cases: List[Tuple[str, str, str]], timeout: float = 300.0,
              exact: bool = True) -> List[Dict[str, np.ndarray]]:
    """Run (case, in.npz, out.npz) triples in ONE torch subprocess and load
    the outputs.  ``exact=False`` runs it with no ``OGC_EXACT_NEIGHBORS``
    (the port's default: approximate)."""
    argv = [a for c in cases for a in c]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    if exact:
        env["OGC_EXACT_NEIGHBORS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "tests.torch_port_helper", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"torch helper failed:\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-4000:]}")
    out = []
    for _, _, out_path in cases:
        with np.load(out_path) as z:
            out.append({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# torch side (each case imports torch itself: the pytest process imports
# this module too, and must not load torch)
# ---------------------------------------------------------------------------


def _load(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    cfg = json.loads(str(data.pop("cfg"))) if "cfg" in data else {}
    state = {k[3:]: data.pop(k) for k in list(data) if k.startswith("sd/")}
    return data, cfg, state


def _case_kernels(x, cfg, state):
    import torch

    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.ops.knn import knn_exact

    out = {}
    for name in cfg["fps"]:
        out[name] = fps(torch.from_numpy(x[name]), cfg["fps"][name]).numpy()
    for name, k in cfg["knn"].items():
        d, i = knn_exact(torch.from_numpy(x[name + "/q"]),
                         torch.from_numpy(x[name + "/p"]), k)
        out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
    return out


def _case_core(x, cfg, state):
    import torch

    from ogc_tpu_torch import ops

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    feats, gxyz = ops.query_and_group(cfg["radius"], cfg["nsample"], t["xyz"],
                                      t["new_xyz"], t["feats"])
    idx, w = ops.interpolate_weights(t["xyz"], t["new_xyz"])
    interp = ops.three_interpolate(t["known_feats"], idx, w)
    d, i = ops.knn(cfg["big_k"], t["xyz"], t["small"])
    return {"qg_feats": feats.numpy(), "qg_xyz": gxyz.numpy(),
            "iw_idx": idx.numpy(), "iw_w": w.numpy(), "interp": interp.numpy(),
            "knn_dist": d.numpy(), "knn_idx": i.numpy()}


def _load_module(module, state):
    import torch

    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module.eval()


def _case_sa(x, cfg, state):
    import torch

    from ogc_tpu_torch.nn.pointnet2 import SAModuleMSG

    m = _load_module(SAModuleMSG(cfg["npoint"], cfg["radii"], cfg["nsamples"],
                                 cfg["mlps"], x["feats"].shape[-1], 4), state)
    with torch.no_grad():
        new_xyz, new_feats = m(torch.from_numpy(x["xyz"]),
                               torch.from_numpy(x["feats"]))
    return {"new_xyz": new_xyz.numpy(), "new_feats": new_feats.numpy()}


def _case_fp(x, cfg, state):
    import torch

    from ogc_tpu_torch.nn.pointnet2 import FPModule

    cin = x["known_feats"].shape[-1] + x["unknown_feats"].shape[-1]
    m = _load_module(FPModule(cin, cfg["mlp"], 4), state)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with torch.no_grad():
        y = m(t["unknown"], t["known"], t["unknown_feats"], t["known_feats"])
    return {"out": y.numpy()}


def _case_mf_head(x, cfg, state):
    import torch

    from ogc_tpu_torch.nn.transformer import MaskFormerHead

    m = _load_module(MaskFormerHead(**cfg), state)
    with torch.no_grad():
        y = m(torch.from_numpy(x["feats"]), torch.from_numpy(x["pos"]))
    return {"out": y.numpy()}


def _case_segnet(x, cfg, state):
    import torch

    from ogc_tpu_torch.models.segnet import ARCHS, MaskFormer3D

    m = _load_module(MaskFormer3D(**cfg), state)
    with torch.no_grad():
        pc = torch.from_numpy(x["pc"])
        mask = m(pc, pc)
    archs = {k: dataclasses.asdict(v) for k, v in ARCHS.items()}
    return {"mask": mask.numpy(), "archs": np.array(json.dumps(archs))}


def _case_save_ckpt(x, cfg, state):
    import torch

    from ogc_tpu_torch.utils.checkpoint import save_model_state

    save_model_state({k: torch.from_numpy(v) for k, v in state.items()},
                     cfg["path"])
    return {}


def _case_imports(x, cfg, state):
    import ogc_tpu_torch.oa_icp  # noqa: F401
    import ogc_tpu_torch.test_flow  # noqa: F401
    import ogc_tpu_torch.test_seg  # noqa: F401
    import ogc_tpu_torch.tools.protocol_sapien  # noqa: F401
    import ogc_tpu_torch.train_seg  # noqa: F401
    import ogc_tpu_torch.vote  # noqa: F401

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ogc_tpu"))
    return {"leaked": np.array(json.dumps(leaked))}


def _case_ball_scatter(x, cfg, state):
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    for name, (radius, nsample) in cfg["ball"].items():
        out[name] = ops.ball_query(radius, nsample, t[name + "/xyz"],
                                   t[name + "/centres"]).numpy()
    for name, n_dest in cfg["scatter"].items():
        out[name] = scatter_add_rows(t[name + "/idx"], t[name + "/g"],
                                     n_dest).numpy()
    points = t["group/points"].clone().requires_grad_(True)
    (ops.group(points, t["group/idx"]) * t["group/w"]).sum().backward()
    out["group/grad"] = points.grad.numpy()
    return out


def _case_onehot(x, cfg, state):
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                          onehot_path_applicable,
                                          scatter_add_rows_onehot)

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {"gate": np.array([onehot_path_applicable(*s)
                             for s in cfg["gate"]])}
    for name in cfg["gather"]:
        out[name] = gather_rows_onehot(t[name + "/src"],
                                       t[name + "/idx"]).numpy()
    for name, n in cfg["scatter"].items():
        out[name] = scatter_add_rows_onehot(t[name + "/idx"],
                                            t[name + "/cot"], n).numpy()
    points = t["group/points"].clone().requires_grad_(True)
    g = ops.group(points, t["group/idx"])
    (g * t["group/w"]).sum().backward()
    out["group/out"] = g.detach().numpy()
    out["group/grad"] = points.grad.numpy()
    return out


def _case_refine(x, cfg, state):
    import torch

    from ogc_tpu_torch.losses.seg_unsup import interpolate_mask_by_flow
    from ogc_tpu_torch.metrics.flow import eval_flow
    from ogc_tpu_torch.refine.oa_icp import object_aware_icp, weighted_kabsch
    from ogc_tpu_torch.refine.vote import (collect_correspondences,
                                           mask_voting, match_mask_by_cost,
                                           warp_mask_chain)

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    icp = (t["pc1"], t["pc2"], t["flow"], t["mask1"], t["mask2"])
    out = {
        "kabsch": weighted_kabsch(t["pc1"], t["flow"], t["mask1"]).numpy(),
        # One tile at the default (the JAX dense path's counterpart), and
        # several at tile 64.
        "icp_dense": object_aware_icp(*icp,
                                      icp_iter=cfg["icp_iter"]).numpy(),
        "icp_block": object_aware_icp(*icp, icp_iter=cfg["icp_iter"],
                                      tile=64).numpy(),
        "interp": interpolate_mask_by_flow(t["pc1"], t["pc2"], t["mask1"],
                                           t["flow"]).numpy(),
        "interp3": interpolate_mask_by_flow(t["pc1"], t["pc2"], t["mask1"],
                                            t["flow"], k=3).numpy(),
        "eval_flow": np.array(eval_flow(x["flow_gt"], x["flow"], 0.01)),
        "voted": mask_voting(t["v_pc"], t["v_mask"], t["v_flows"],
                             time_window_size=2, tile=32).numpy(),
    }
    for measure in ("ce", "iou"):
        out["cost_" + measure] = match_mask_by_cost(
            t["c_mask1"], t["c_mask2"], measure).numpy()
    corrs = collect_correspondences(t["v_pc"], t["v_flows"])
    for tt, v in cfg["chains"]:
        out[f"chain/{tt}_{v}"] = warp_mask_chain(
            t["v_pc"], t["v_flows"], tt, v, t["v_mask"][v], tile=32).numpy()
        out[f"dense/{tt}_{v}"] = (corrs[f"{tt}_{v}"] @ t["v_mask"][v]).numpy()
    return out


def _case_lap(x, cfg, state):
    from ogc_tpu_torch.utils.lap import linear_sum_assignment

    return {"col_ind": linear_sum_assignment(x["iou"], maximize=True)}


def _segnet(cfg, state):
    import torch

    from ogc_tpu_torch.models.segnet import MaskFormer3D

    m = MaskFormer3D(**cfg["segnet"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _case_ogc_loss(x, cfg, state):
    import torch

    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, ogc_loss

    model = _segnet(cfg, state)
    pcs, flows = torch.from_numpy(x["pcs"]), torch.from_numpy(x["flows"])
    B, T, N, _ = pcs.shape
    flat = pcs.reshape(B * T, N, 3)
    masks = model(flat, flat).reshape(B, T, N, -1)
    loss, ld = ogc_loss([pcs[:, t] for t in range(T)],
                        [masks[:, t] for t in range(T)],
                        [flows[:, t] for t in range(T)],
                        OGCLossConfig.from_dict(cfg["loss"]),
                        aug_transform=cfg["aug"])
    loss.backward()
    out = {"ld/" + k: v.detach().numpy() for k, v in ld.items()}
    out["masks"] = masks.detach().numpy()
    for k, p in model.named_parameters():
        out["g/" + k] = p.grad.numpy()
    return out


def _case_train_steps(x, cfg, state):
    import torch

    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
    from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule

    model = _segnet(cfg, state)
    opt = Adam(dict(model.named_parameters()),
               make_lr_schedule(**cfg["lr"]))
    trainer = SegTrainer(model, OGCLossConfig.from_dict(cfg["loss"]), opt,
                         aug_transform_epoch=0, ignore_npoint_thresh=0,
                         exp_base=cfg["exp_base"], device=torch.device("cpu"))
    sums = []
    for it in range(x["pcs"].shape[0]):
        batch = (x["pcs"][it], x["segms"][it], x["flows"][it], None)
        ld, _, _ = trainer.train_it(it, batch, aug_transform=True)
        sums.append([ld[k] for k in ("sum", "dynamic", "smooth",
                                     "invariance")])
    return {"ld": np.array(sums)}


def _case_adam(x, cfg, state):
    import torch

    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule

    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in state.items()}
    opt = Adam(params, make_lr_schedule(**cfg["lr"]), cfg["weight_decay"])
    out = {}
    for s in range(cfg["steps"]):
        for k, p in params.items():
            p.grad = torch.from_numpy(x[f"g{s}/{k}"])
        opt.step()
        out.update({f"p{s}/{k}": p.detach().numpy().copy()
                    for k, p in params.items()})
    out["count"] = np.array(opt.count)
    return out


def _case_blockmin(x, cfg, state):
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops import core
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                knn_blockmin)

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    for name, (k, recall) in cfg["knn"].items():
        d, i = knn_blockmin(t[name + "/q"], t[name + "/p"], k, recall)
        out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
    for name, (radius, ns) in cfg["ball"].items():
        out[name] = ball_query_blockmin(t[name + "/xyz"], t[name + "/centres"],
                                        radius, ns).numpy()
    # Which route ops.knn / ops.ball_query take in approximate mode.
    used = []
    core.knn_blockmin = lambda *a: used.append(1) or knn_blockmin(*a)
    core.ball_query_blockmin = (lambda *a: used.append(1)
                                or ball_query_blockmin(*a))
    gates = []
    for fn, grid in ((lambda m, k: ops.knn(k, torch.zeros(1, 1, 3),
                                            torch.rand(1, m, 3)),
                       cfg["gate_knn"]),
                      (lambda n, ns: ops.ball_query(0.5, ns,
                                                    torch.rand(1, n, 3),
                                                    torch.zeros(1, 1, 3)),
                       cfg["gate_ball"])):
        for m, k in grid:
            used.clear()
            fn(m, k)
            gates.append(bool(used))
    core.knn_blockmin, core.ball_query_blockmin = (knn_blockmin,
                                                   ball_query_blockmin)
    out["gates"] = np.array(gates)
    out["exact_mode"] = np.array(ops.exact_neighbors())
    return out


def _case_symgrad(x, cfg, state):
    import torch

    from ogc_tpu_torch.losses.seg_unsup import _SymGradDiscrepancy

    out = {}
    for norm in cfg["loss_norms"]:
        mask = torch.from_numpy(x["mask"]).requires_grad_(True)
        loss = _SymGradDiscrepancy.apply(mask, torch.from_numpy(x["idx"]),
                                         norm)
        (loss * float(x["g"])).backward()
        out[f"loss{norm}"] = loss.detach().numpy()
        out[f"grad{norm}"] = mask.grad.numpy()
    return out


def _case_train_mode(x, cfg, state):
    """``train_seg.main`` in this process, counting the model's forwards
    and the FPS calls they make."""
    from ogc_tpu_torch import ops, train_seg
    from ogc_tpu_torch.models.segnet import MaskFormer3D
    from ogc_tpu_torch.ops import fps as fps_mod

    counts = {"fps": 0, "forward": 0}
    plain, forward = fps_mod.fps_plain, MaskFormer3D.forward

    def count_fps(*a):
        counts["fps"] += 1
        return plain(*a)

    def count_forward(self, *a):
        counts["forward"] += 1
        return forward(self, *a)

    fps_mod.fps_plain, MaskFormer3D.forward = count_fps, count_forward
    train_seg.main(cfg["argv"])
    return {"fps": np.array(counts["fps"]),
            "forward": np.array(counts["forward"]),
            "exact_mode": np.array(ops.exact_neighbors())}


def _case_pool(x, cfg, state):
    """#12's plain version (rowgroup_pool on CPU tensors), pool_neighbors
    with the gate at ``interpret`` and ``off``, and ``supported``."""
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops.pool import rowgroup_pool, supported

    def t(name, bf16):
        v = torch.from_numpy(x[name])
        return v.to(torch.bfloat16) if bf16 else v

    out = {}
    for name, (s, relu, mean, bf16) in cfg["rowgroup"].items():
        y = rowgroup_pool(t(name + "/x", bf16), t(name + "/scale", False),
                          t(name + "/add", bf16), s, relu=relu, mean=mean)
        out[name] = y.float().numpy()
    for name, (mean, relu) in cfg["neighbors"].items():
        kw = {k: torch.from_numpy(x[f"{name}/{k}"]) for k in ("scale", "add")
              if f"{name}/{k}" in x}
        for mode in ("interpret", "off"):
            ops.set_pool_mode(mode)
            out[f"{name}/{mode}"] = ops.pool_neighbors(
                torch.from_numpy(x[name + "/x"]), mean=mean,
                differentiable=False, relu=relu, **kw).numpy()
    ops.set_pool_mode("off")
    out["supported"] = np.array([supported(*g) for g in cfg["grid"]])
    return out


def _case_pool_special(x, cfg, state):
    """#12's route through pool_neighbors at OGC_PALLAS_POOL=interpret (on
    CPU tensors the plain version) on NaN and -0.0 rows, with the scale and
    the add absent or given."""
    import torch

    from ogc_tpu_torch import ops

    ops.set_pool_mode("interpret")
    out = {}
    for name, (mean, relu) in cfg["cases"].items():
        kw = {k: torch.from_numpy(x[f"{name}/{k}"]) for k in ("scale", "add")
              if f"{name}/{k}" in x}
        out[name] = ops.pool_neighbors(
            torch.from_numpy(x[name + "/x"]), mean=mean, differentiable=False,
            relu=relu, **kw).numpy()
    ops.set_pool_mode("off")
    return out


def _case_knn_select(x, cfg, state):
    """#2's key (csrc/knn_exact.cu: d2's float bits, which order d2 >= +0
    as the float does, above the index) packed in an int64 and sorted, its
    first k as (d2, index), beside knn_exact on CPU tensors
    (knn_exact_plain)."""
    import torch

    from ogc_tpu_torch.ops.knn import knn_exact, pair_d2

    out = {}
    for name, k in cfg["cases"].items():
        q = torch.from_numpy(x[name + "/q"])
        p = torch.from_numpy(x[name + "/p"])
        d, i = knn_exact(q, p, k)
        d2 = pair_d2(q, p)
        bits = d2.view(torch.int32).to(torch.int64)
        packed = (bits << 32) | torch.arange(d2.shape[-1])
        keys = torch.sort(packed, dim=-1).values[..., :k]
        out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
        out[name + "/key_idx"] = (keys & 0xFFFFFFFF).to(torch.int32).numpy()
        out[name + "/key_d2"] = (keys >> 32).to(torch.int32).view(
            torch.float32).numpy()
    return out


def _case_plans(x, cfg, state):
    """The kernels' host-side dispatch at the sites chip_smoke.py drives:
    ops/pool.py::pool_plan at every pool of flow_pool_sites (KITTI-SF and
    SAPIEN) that the gate sends to #12, in float32 and bf16, and
    ops/knn.py::knn_plan at every KNN_SHAPES search at B 16 and 8 and at
    the other exact k's over 512 to 131072 queries."""
    import chip_smoke as cs
    from ogc_tpu_torch.ops.knn import knn_plan
    from ogc_tpu_torch.ops.pool import pool_plan, supported

    sites = (cs.flow_pool_sites("kitti", cs.N_POINT, cs.FLOW_B,
                                cs.FLOW_ITERS, cs.FLOW_KW["loc_flow_nn"])
             + cs.flow_pool_sites("sapien", cs.SAP_N, cs.SAP_FLOW_B,
                                  cs.SAP_FLOW_ITERS, 8))
    pools = []
    for _, clouds, m, s, c, _, _, _ in sites:
        if supported(clouds * m, s, c):
            for size in (4, 2):
                s_t, vec = pool_plan(s, c, size)
                pools.append([s, c, size, s_t, int(vec)])
    searches = [(b * nq, k) for b in (16, 8) for nq, _, k in cs.KNN_SHAPES]
    searches += [(n, k) for n in (512, 16384, 65536, 131072)
                 for k in (1, 4, cs.SAP_KNN_K, cs.FLOW_KW["loc_flow_nn"],
                           cs.SMOOTH_K, cs.SA0_NS)]
    knns = [[n, k, int(knn_plan(k, n)[0] == "warp"), knn_plan(k, n)[1]]
            for n, k in searches]
    return {"pool_plans": np.array(pools), "knn_plans": np.array(knns)}


def _case_blockmin_select(x, cfg, state):
    """#3's KNN on CPU tensors (knn_blockmin_plain) for every case, and
    ops/knn_blockmin.py::blockmin_plan at every #3 KNN site chip_smoke.py
    drives, as (k, queries, blk, warp, cap) rows."""
    import torch

    import chip_smoke as cs
    from ogc_tpu_torch.ops.knn_blockmin import (block_size, blockmin_plan,
                                                knn_blockmin)
    from ogc_tpu_torch.ops.knn_pruned import RECALL
    from ogc_tpu_torch.tools.bench_knn_pruned import CASES

    out = {}
    for name, (k, recall) in cfg["cases"].items():
        d, i = knn_blockmin(torch.from_numpy(x[name + "/q"]),
                            torch.from_numpy(x[name + "/p"]), k, recall)
        out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
    # (clouds, queries, points, k, recall): the fast step's and eval's
    # model sites, the smooth KNN, check_blockmin's ragged cases, the
    # approximate flow forward's, bench_knn_pruned's, and #4's pre-pass
    # on the flow forward (gates on).
    sites = [(b, nq, m, k, rec) for b in (16, 8)
             for nq, m, k, rec in cs.BLOCKMIN_SHAPES]
    sites += [(cs.TRAIN_B, cs.N_POINT, cs.N_POINT, cs.SMOOTH_K, 0.95),
              (2, 1500, 1500, 16, 0.95), (2, 1500, 1500, 3, 0.99)]
    sites += cs.FLOW_BLOCKMIN_SITES
    sites += [(b, n, m, k, 0.95) for b, n, m, k, _ in CASES]
    sites += [(b, nq, m, 32, RECALL) for b in (2 * cs.FLOW_B, cs.FLOW_B)
              for nq, m in ((4096, 8192), (2048, 4096))]
    rows = []
    for b, nq, m, k, rec in sites:
        blk = block_size(m, k, rec)
        kernel, cap = blockmin_plan(k, b * nq, blk)
        rows.append([k, b * nq, blk, int(kernel == "warp"), cap])
    out["plans"] = np.array(rows)
    return out


def _case_ball_select(x, cfg, state):
    """The exact ball (ball_query_plain) and the block-min ball
    (ball_query_blockmin_plain) on CPU tensors for every case, with the
    block-min run length."""
    import torch

    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                block_size)

    out = {}
    for name, (radius, ns) in cfg["cases"].items():
        xyz = torch.from_numpy(x[name + "/xyz"])
        c = torch.from_numpy(x[name + "/centres"])
        out[name + "/exact"] = ball_query_exact(xyz, c, radius, ns).numpy()
        out[name + "/blockmin"] = ball_query_blockmin(xyz, c, radius,
                                                      ns).numpy()
        out[name + "/blk"] = np.array(block_size(xyz.shape[1], ns, 0.95))
    return out


def _case_fps_select(x, cfg, state):
    """FPS on CPU tensors (fps_plain) for every cloud of the case, and
    ops/fps.py::fps_plan for every N of ``cfg["plan_n"]`` as (N, ppt,
    threads, reg_xyz) rows."""
    import torch

    from ogc_tpu_torch.ops.fps import fps, fps_plan

    out = {name: fps(torch.from_numpy(x[name]), npoint).numpy()
           for name, npoint in cfg["clouds"].items()}
    out["plans"] = np.array([[n, *map(int, fps_plan(n))]
                             for n in cfg["plan_n"]])
    return out


def _case_scatter_csr(x, cfg, state):
    """The plain scatter-add (CPU tensors) and its prologue's (order, start)
    for every case, int32 and int64 idx, and ops/scatter.py::csr_plan of
    each case's (B, R, n_dest) and of ``cfg["plan_sites"]``."""
    import torch

    from ogc_tpu_torch.ops.scatter import csr_plan, scatter_add_rows, segments

    out = {}
    for name, n_dest in cfg["cases"].items():
        idx = torch.from_numpy(x[name + "/idx"])
        g = torch.from_numpy(x[name + "/g"])
        out[name + "/sum"] = scatter_add_rows(idx, g, n_dest).numpy()
        out[name + "/sum64"] = scatter_add_rows(idx.long(), g, n_dest).numpy()
        _, order, start = segments(idx, n_dest)
        out[name + "/order"], out[name + "/start"] = order.numpy(), start.numpy()
        out[name + "/plan"] = np.array(csr_plan(*idx.shape, n_dest))
    out["site_plans"] = np.array([[*site, *csr_plan(*site)]
                                  for site in cfg["plan_sites"]])
    return out


def _case_scatter_onehot_csr(x, cfg, state):
    """The small-source scatter-add's plain version (CPU tensors) for every
    case, int32 and int64 idx, and ops/onehot.py::onehot_scatter_plan of
    each case; and of ``cfg["plan_sites"]`` (B, n, C, rows): the plan's
    window where rows is None, else ``scatter_window``'s cut of rows."""
    import torch

    from ogc_tpu_torch.ops.onehot import (onehot_scatter_plan,
                                          scatter_add_rows_onehot,
                                          scatter_window)

    out = {}
    for name, n in cfg["cases"].items():
        idx = torch.from_numpy(x[name + "/idx"])
        g = torch.from_numpy(x[name + "/g"])
        out[name + "/sum"] = scatter_add_rows_onehot(idx, g, n).numpy()
        out[name + "/sum64"] = scatter_add_rows_onehot(idx.long(), g,
                                                       n).numpy()
        out[name + "/plan"] = np.array(onehot_scatter_plan(
            idx.shape[0], n, g.shape[-1]))
    out["site_plans"] = np.array([
        onehot_scatter_plan(B, n, C) if rows is None
        else scatter_window(n, C, rows)
        for B, n, C, rows in cfg["plan_sites"]])
    return out


def _case_search_form(x, cfg, state):
    """The port's exact routes (``ops.knn`` / ``ops.ball_query`` with
    ``exact=True``) on each site's CPU clouds: raw (dist, idx) of a KNN,
    the filled ball of a ball query."""
    import torch

    from ogc_tpu_torch import ops

    out = {}
    for name, (kind, k, radius) in cfg["sites"].items():
        q = torch.from_numpy(x[name + "/q"])
        p = torch.from_numpy(x[name + "/p"])
        if kind == "knn":
            d, i = ops.knn(k, q, p, exact=True)
            out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
        else:
            out[name + "/idx"] = ops.ball_query(radius, k, p, q,
                                                exact=True).numpy()
    return out


def _case_pruned(x, cfg, state):
    """#4's plain version, its prologue's survivors, and which shapes
    ops.knn routes to #4 under each gate setting (exact mode)."""
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops import core
    from ogc_tpu_torch.ops.knn_pruned import (knn_exact_pruned_plain,
                                              prologue, survivors)

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    for name, (k, cb, qt) in cfg["cases"].items():
        q, p = t[name + "/q"], t[name + "/p"]
        d, i = knn_exact_pruned_plain(q, p, k, cb, qt)
        out[name + "/dist"], out[name + "/idx"] = d.numpy(), i.numpy()
        pro = prologue(q, p, cb, qt)
        order, count = survivors(pro, p, k, qt)
        out[name + "/order"], out[name + "/count"] = (order.numpy(),
                                                      count.numpy())
    used, saved = [], (core.knn_exact_pruned, core.knn_exact)

    def fake(query, points, k):
        used.append(1)
        shape = query.shape[:2] + (k,)
        return torch.zeros(shape), torch.zeros(shape, dtype=torch.int32)

    core.knn_exact_pruned = fake
    core.knn_exact = lambda q, p, k: (torch.zeros(q.shape[:2] + (k,)),
                                      torch.zeros(q.shape[:2] + (k,),
                                                  dtype=torch.int32))
    routes = []
    for mode in ("on", "knn"):
        ops.set_exact_prune(mode)
        for n, m, k in cfg["gate"]:
            used.clear()
            ops.knn(k, torch.zeros(1, n, 3), torch.zeros(1, m, 3))
            routes.append(bool(used))
    core.knn_exact_pruned, core.knn_exact = saved
    ops.set_exact_prune("on")
    out["routes"] = np.array(routes)
    return out


def _case_blocksparse(x, cfg, state):
    """#9/#10's plain versions through ``group_blocksparse`` (forward, and
    the backward of a cotangent), the prologue's lists and presence, #9's
    and #10's launch plans, and #11's plain version on the flattened table;
    and the launch plans of ``cfg["plans"]`` (n, M, S) shapes for #9 and
    ``cfg["scatter_plans"]`` (n, M, S) for #10."""
    import torch

    from ogc_tpu_torch.ops import blocksparse as bs
    from ogc_tpu_torch.ops.blocksparse import bs_prologue, group_blocksparse
    from ogc_tpu_torch.ops.scatter import scatter_add_rows_plain

    out = {"plans": np.array([bs.bs_gather_plan(*shape)
                              for shape in cfg["plans"]]),
           "plan_consts": np.array([bs.RQ, bs.CB, bs.GATHER_WARPS,
                                    bs.SMEM_LIMIT]),
           "scatter_plans": np.array([bs.bs_scatter_plan(*site)
                                      for site in cfg["scatter_plans"]])}
    for name in cfg["cases"]:
        src = torch.from_numpy(x[name + "/src"]).requires_grad_(True)
        idx = torch.from_numpy(x[name + "/idx"])
        cot = torch.from_numpy(x[name + "/cot"])
        B, M, S = idx.shape
        pro = bs_prologue(idx, src.shape[1])
        got = group_blocksparse(src, idx)
        got.backward(cot)
        out.update({name + "/order": pro.order.numpy(),
                    name + "/count": pro.count.numpy(),
                    name + "/overflow": pro.overflow.numpy(),
                    name + "/presence": pro.presence.numpy(),
                    name + "/padded": pro.idx.numpy(),
                    name + "/plan": np.array(bs.bs_gather_plan(
                        src.shape[1], M, S)),
                    name + "/splan": np.array(bs.bs_scatter_plan(
                        src.shape[1], M, S)),
                    name + "/out": got.detach().numpy(),
                    name + "/grad": src.grad.numpy(),
                    name + "/scatter11": scatter_add_rows_plain(
                        idx.reshape(B, M * S), cot.reshape(B, M * S, -1),
                        src.shape[1]).numpy()})
    return out


def _case_smooth_mxu(x, cfg, state):
    """``smooth_loss`` (value and mask gradient) for each named
    OGCLossConfig of ``cfg["runs"]`` on its cloud and mask, with whether
    it took the mxu engine; and ``from_dict`` on each smooth block of
    ``cfg["from_dict"]`` (its engine, or the error it raised)."""
    import torch

    from ogc_tpu_torch.losses import seg_unsup as SU

    taken = []
    mxu = SU._smooth_mxu
    SU._smooth_mxu = lambda *a: taken.append(1) or mxu(*a)
    out = {}
    for name, (data, fields) in cfg["runs"].items():
        mask = torch.from_numpy(x[data + "/mask"]).requires_grad_(True)
        taken.clear()
        loss = SU.smooth_loss(torch.from_numpy(x[data + "/pc"]), mask,
                              SU.OGCLossConfig(**fields))
        loss.backward()
        out.update({name + "/loss": loss.detach().numpy(),
                    name + "/grad": mask.grad.numpy(),
                    name + "/mxu": np.array(bool(taken))})
    SU._smooth_mxu = mxu
    parsed = []
    for smooth in cfg["from_dict"]:
        try:
            lc = SU.OGCLossConfig.from_dict({"smooth_loss_params": smooth})
            parsed.append(lc.smooth_edge_engine)
        except (NotImplementedError, ValueError) as e:
            parsed.append(type(e).__name__)
    out["from_dict"] = np.array(parsed)
    return out


def _case_knn_cand(x, cfg, state):
    """#6's plain version through ``knn_cand`` for each named case, whether
    it routed to #3, and ``resolve`` on each (M, k, n_cand, blk) of
    ``cfg["resolve"]``."""
    import torch

    from ogc_tpu_torch.ops import knn_cand as KC

    routed = []
    blockmin = KC.knn_blockmin
    KC.knn_blockmin = lambda *a: routed.append(1) or blockmin(*a)
    out = {}
    for name, (k, n_cand, blk) in cfg["cases"].items():
        routed.clear()
        d, i = KC.knn_cand(torch.from_numpy(x[name + "/q"]),
                           torch.from_numpy(x[name + "/p"]), k, n_cand,
                           blk=blk)
        out.update({name + "/dist": d.numpy(), name + "/idx": i.numpy(),
                    name + "/blockmin": np.array(bool(routed))})
    KC.knn_blockmin = blockmin
    out["resolve"] = np.array([KC.resolve(m, k, n, b)
                               for m, k, n, b in cfg["resolve"]])
    return out


def _flow_arch(arch):
    from ogc_tpu_torch.models.flownet import FlowNetArch, SASpec

    if isinstance(arch, str):
        return arch
    spec = {k: (tuple(SASpec(*s) for s in v) if k in ("enc_loc", "enc_glob",
                                                       "corr_sa")
                else SASpec(*v) if k in ("flow_conv1", "flow_conv2")
                else tuple(v) if isinstance(v, list) else v)
            for k, v in arch.items()}
    return FlowNetArch(**spec)


def _case_flownet(x, cfg, state):
    """The port's FlowStep3D forward in each neighbour mode of
    ``cfg["modes"]``; exact mode again with the pool gate at
    ``interpret``."""
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.models.flownet import FlowStep3D

    m = _load_module(FlowStep3D(arch=_flow_arch(cfg["arch"]),
                                **cfg["model"]), state)
    pc1, pc2 = torch.from_numpy(x["pc1"]), torch.from_numpy(x["pc2"])
    out = {}
    runs = [(mode, "off") for mode in cfg["modes"]] + [("exact", "interpret")]
    for mode, pool in runs:
        ops.set_exact_neighbors(mode == "exact")
        ops.set_pool_mode(pool)
        with torch.no_grad():
            flows = m(pc1, pc2, pc1, pc2, cfg["iters"])
        out[mode if pool == "off" else f"{mode}/{pool}"] = torch.stack(
            flows).numpy()
    ops.set_pool_mode("off")
    return out


CASES = {
    "kernels": _case_kernels,
    "core": _case_core,
    "sa": _case_sa,
    "fp": _case_fp,
    "mf_head": _case_mf_head,
    "segnet": _case_segnet,
    "save_ckpt": _case_save_ckpt,
    "imports": _case_imports,
    "ball_scatter": _case_ball_scatter,
    "onehot": _case_onehot,
    "refine": _case_refine,
    "lap": _case_lap,
    "ogc_loss": _case_ogc_loss,
    "train_steps": _case_train_steps,
    "adam": _case_adam,
    "blockmin": _case_blockmin,
    "symgrad": _case_symgrad,
    "train_mode": _case_train_mode,
    "pool": _case_pool,
    "pool_special": _case_pool_special,
    "knn_select": _case_knn_select,
    "plans": _case_plans,
    "fps_select": _case_fps_select,
    "blockmin_select": _case_blockmin_select,
    "ball_select": _case_ball_select,
    "scatter_csr": _case_scatter_csr,
    "scatter_onehot_csr": _case_scatter_onehot_csr,
    "search_form": _case_search_form,
    "pruned": _case_pruned,
    "flownet": _case_flownet,
    "blocksparse": _case_blocksparse,
    "smooth_mxu": _case_smooth_mxu,
    "knn_cand": _case_knn_cand,
}


def main(argv: List[str]) -> None:
    import torch

    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)
    if len(argv) % 3:
        raise SystemExit(__doc__)
    for i in range(0, len(argv), 3):
        case, in_path, out_path = argv[i:i + 3]
        x, cfg, state = _load(in_path)
        from ogc_tpu_torch.utils.config import apply_compute_dtype

        apply_compute_dtype({"compute_dtype": cfg.pop("compute_dtype", None)})
        out = CASES[case](x, cfg, state)
        from ogc_tpu_torch.ops.ball import ball_query_exact
        from ogc_tpu_torch.ops.blocksparse import (gather_blocksparse,
                                                   scatter_add_blocksparse)
        from ogc_tpu_torch.ops.fps import fps
        from ogc_tpu_torch.ops.knn_cand import knn_cand
        from ogc_tpu_torch.ops.knn import knn_exact
        from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                    knn_blockmin)
        from ogc_tpu_torch.ops.knn_pruned import knn_exact_pruned
        from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                              scatter_add_rows_onehot)
        from ogc_tpu_torch.ops.pool import rowgroup_pool
        from ogc_tpu_torch.ops.scatter import scatter_add_rows

        out["launches"] = np.array([fps.launches, knn_exact.launches,
                                    ball_query_exact.launches,
                                    scatter_add_rows.launches])
        out["launches_onehot"] = np.array([gather_rows_onehot.launches,
                                           scatter_add_rows_onehot.launches])
        out["launches_blockmin"] = np.array([knn_blockmin.launches,
                                             ball_query_blockmin.launches])
        out["launches_flow"] = np.array([rowgroup_pool.launches,
                                         knn_exact_pruned.launches])
        out["launches_cand"] = np.array([gather_blocksparse.launches,
                                         scatter_add_blocksparse.launches,
                                         knn_cand.launches])
        np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
