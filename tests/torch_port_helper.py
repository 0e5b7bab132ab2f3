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
candidate-pruned KNN as ``launches_cand``; the IoU matching as
``launches_match``), which must stay at 0 on CPU tensors.  The torch side
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
    return start_torch(cases, timeout, exact)()


def start_torch(cases: List[Tuple[str, str, str]], timeout: float = 300.0,
                exact: bool = True):
    """``run_torch`` started in the background: returns a function that
    waits for the subprocess and returns the outputs (the caller computes
    its JAX side meanwhile)."""
    argv = [a for c in cases for a in c]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    if exact:
        env["OGC_EXACT_NEIGHBORS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port_helper", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def finish() -> List[Dict[str, np.ndarray]]:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            proc.kill()
        if proc.returncode != 0:
            raise RuntimeError(f"torch helper failed:\n{stdout[-2000:]}\n"
                               f"{stderr[-4000:]}")
        out = []
        for _, _, out_path in cases:
            with np.load(out_path) as z:
                out.append({k: z[k] for k in z.files})
        return out

    return finish


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
    """``col_ind`` of every ``iou*`` input, as ``col_ind*``."""
    from ogc_tpu_torch.utils.lap import linear_sum_assignment

    return {k.replace("iou", "col_ind", 1): linear_sum_assignment(v, True)
            for k, v in x.items()}


def _case_match(x, cfg, state):
    """match_mask_by_iou on CPU masks ``mask1_<K>``, ``mask2_<K>``: the
    columns as returned, with their dtype and device."""
    import torch

    from ogc_tpu_torch.losses.seg_unsup import match_mask_by_iou

    out = {}
    for k in x:
        if k.startswith("mask1_"):
            tag = k[len("mask1_"):]
            col = match_mask_by_iou(torch.from_numpy(x[k]),
                                    torch.from_numpy(x["mask2_" + tag]))
            out["col_ind_" + tag] = col.numpy()
            out["meta_" + tag] = np.array([str(col.dtype), str(col.device)])
    return out


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
    ops/fps.py::fps_plan for every N of ``cfg["plan_n"]`` (at most MAX_N)
    as (N, ppt, threads, reg_xyz) rows."""
    import torch

    from ogc_tpu_torch.ops.fps import fps, fps_plan

    out = {name: fps(torch.from_numpy(x[name]), npoint).numpy()
           for name, npoint in cfg["clouds"].items()}
    # Up to MAX_N a cloud takes one CTA (the plan's cluster is 1).
    out["plans"] = np.array([[n, *map(int, fps_plan(n)[:3])]
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


def _case_pruned_select(x, cfg, state):
    """The torch prologues of #4 (prologue, survivors, with the #3
    pre-pass's distances) and #6 (prologue), and both plain versions, for
    each named case of ``cfg["exact"]`` and ``cfg["cand"]``."""
    import torch

    from ogc_tpu_torch.ops import knn_cand as KC
    from ogc_tpu_torch.ops import knn_pruned as KP

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    for name, (k, cb, qt) in cfg["exact"].items():
        q, p = t[name + "/q"], t[name + "/p"]
        pro = KP.prologue(q, p, cb, qt)
        fd, _ = KP.knn_blockmin(pro.q_s, p, k, KP.RECALL)
        order, count = KP.survivors(pro, p, k, qt)
        d, i = KP.knn_exact_pruned(q, p, k, cb, qt)
        for key, v in (("q_s", pro.q_s), ("p_s", pro.p_s), ("pid", pro.pid),
                       ("qid", pro.qid), ("q_box", pro.q_box),
                       ("p_box", pro.p_box), ("lb2", pro.lb2), ("fd", fd),
                       ("order", order), ("count", count), ("dist", d),
                       ("idx", i)):
            out[f"{name}/{key}"] = v.numpy()
    for name, (k, n_cand, blk, cb) in cfg["cand"].items():
        q, p = t[name + "/q"], t[name + "/p"]
        n, blk_r, _ = KC.resolve(p.shape[1], k, n_cand, blk, cb)
        pro = KC.prologue(q, p, n, cb)
        d, i = KC.knn_cand(q, p, k, n_cand, blk=blk, cb=cb)
        for key, v in (("q_s", pro.q_s), ("p_s", pro.p_s), ("pid", pro.pid),
                       ("qid", pro.qid), ("q_box", pro.q_box),
                       ("p_box", pro.p_box), ("lb2", pro.lb2),
                       ("score", pro.score), ("cand", pro.cand), ("dist", d),
                       ("idx", i)):
            out[f"{name}/{key}"] = v.numpy()
        out[name + "/blk"] = np.array(blk_r)
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


def _case_mutual_keep(x, cfg, state):
    """The exact radius-clamped KNN and ball tables of ``pc`` and their
    ``mutual_keep_mask``s."""
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.losses.seg_unsup import mutual_keep_mask

    pc = torch.from_numpy(x["pc"])
    dist, idx = ops.knn(cfg["knn_k"], pc, pc, exact=True)
    knn = torch.where(dist > cfg["knn_radius"], idx[..., :1], idx)
    ball = ops.ball_query(cfg["ball_radius"], cfg["ball_k"], pc, pc,
                          exact=True)
    return {"knn": knn.numpy(), "ball": ball.numpy(),
            "knn_keep": mutual_keep_mask(knn).numpy(),
            "ball_keep": mutual_keep_mask(ball).numpy()}


def _case_ogc_terms(x, cfg, state):
    """ogc_loss on given clouds, masks and flows (frames on axis 1) for each
    loss block of ``cfg["losses"]``: the terms and d(sum)/d(masks)."""
    import torch

    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, ogc_loss

    out = {}
    T = x["pcs"].shape[1]
    for name, block in cfg["losses"].items():
        masks = torch.from_numpy(x["masks"]).requires_grad_(True)
        loss, ld = ogc_loss([torch.from_numpy(x["pcs"][:, t])
                             for t in range(T)],
                            [masks[:, t] for t in range(T)],
                            [torch.from_numpy(x["flows"][:, t])
                             for t in range(T)],
                            OGCLossConfig.from_dict(block),
                            aug_transform=cfg["aug"])
        loss.backward()
        out.update({f"{name}/ld/{k}": v.detach().numpy()
                    for k, v in ld.items()})
        out[f"{name}/grad"] = masks.grad.numpy()
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



def _case_flow_modes(x, cfg, state):
    """FlowStep3D on the carried weights in the case's compute dtype (and
    ``OGC_EVAL_FOLD`` of ``cfg["eval_fold"]``; in float64 with
    ``cfg["float64"]``), exact neighbours: the eval flows, and unless
    ``cfg["train"]`` is false one train-mode forward and backward of
    sum_i iters_w[i] * mean(flow_i ** 2) (its flows, parameter gradients and
    the running statistics after it)."""
    import torch

    from ogc_tpu_torch import ops
    from ogc_tpu_torch.nn.flowstep3d import set_bn_momentum

    os.environ["OGC_EVAL_FOLD"] = cfg.get("eval_fold", "on")
    ops.set_exact_neighbors(True)
    dt = torch.float64 if cfg.get("float64") else torch.float32
    pc1, pc2 = (torch.from_numpy(x[k]).to(dt) for k in ("pc1", "pc2"))
    m = _flow_model(cfg, state).to(dt).eval()
    with torch.no_grad():
        out = {"eval": torch.stack(m(pc1, pc2, pc1, pc2,
                                     cfg["iters"])).numpy()}
    if cfg.get("train", True):
        m = _flow_model(cfg, state).to(dt).train()
        set_bn_momentum(m, cfg["bn_momentum"])
        flows = m(pc1, pc2, pc1, pc2, cfg["iters"])
        loss = sum(w * (f * f).mean() for w, f in zip(cfg["iters_w"], flows))
        loss.backward()
        out["train/flows"] = torch.stack(flows).detach().numpy()
        out.update({"train/g/" + k: q.grad.numpy()
                    for k, q in m.named_parameters()})
        out.update({"train/s/" + k: v.numpy()
                    for k, v in m.state_dict().items() if "running_" in k})
    os.environ.pop("OGC_EVAL_FOLD")
    return out


def _case_remat(x, cfg, state):
    """One step of SegTrainer (MaskFormer3D from ``cfg["segnet"]``, seeded
    weights), SupSegTrainer and FlowTrainer (FlowStep3D from
    ``cfg["flow"]``) under each remat mode: the loss terms, the parameters
    after the Adam step and the running statistics; and, of the step's
    backward, the BatchNorm forwards (the recompute) and the neighbour
    searches (0: the selections are pinned)."""
    import torch

    from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig
    from ogc_tpu_torch.losses.seg_sup import SupLossConfig
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
    from ogc_tpu_torch.models.flownet import FlowStep3D
    from ogc_tpu_torch.models.segnet import MaskFormer3D
    from ogc_tpu_torch.nn import flowstep3d, layers
    from ogc_tpu_torch.ops import core
    from ogc_tpu_torch.train.flow import FlowTrainer
    from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule
    from ogc_tpu_torch.train.seg_sup import SupSegTrainer

    counts = {"norm": 0, "search": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    flowstep3d.SchedulableBatchNorm.forward = count(
        "norm", flowstep3d.SchedulableBatchNorm.forward)
    layers.GroupNorm.forward = count("norm", layers.GroupNorm.forward)
    for name in ("knn_exact", "fps", "ball_query_exact"):
        setattr(core, name, count("search", getattr(core, name)))
    backward = torch.Tensor.backward

    def counted_backward(self, *a, **kw):
        before = dict(counts)
        backward(self, *a, **kw)
        counted_backward.seen = {k: counts[k] - before[k] for k in counts}

    torch.Tensor.backward = counted_backward
    pcs, flows = torch.from_numpy(x["pcs"]), torch.from_numpy(x["flows"])
    out = {}
    for mode in ["off"] + cfg["modes"]:
        for kind in ("seg", "sup", "flow"):
            if mode == "scan" and kind != "flow":
                continue
            gen = torch.Generator().manual_seed(0)
            opt_kw = dict(schedule=make_lr_schedule(**cfg["lr"]))
            common = dict(exp_base=cfg["exp_base"],
                          device=torch.device("cpu"),
                          remat="off" if mode == "scan" else mode)
            if kind == "flow":
                m = FlowStep3D(generator=gen, **cfg["flow"])
                m.remat_refine = mode == "scan"
                trainer = FlowTrainer(
                    m, cfg["iters"], FlowLossConfig.from_dict(cfg["loss"]),
                    Adam(dict(m.named_parameters()), **opt_kw), **common)
                ld = trainer.train_step(0, pcs[:, 0], pcs[:, 1],
                                        flows[:, 0])
            elif kind == "seg":
                m = MaskFormer3D(generator=gen, **cfg["segnet"])
                trainer = SegTrainer(
                    m, OGCLossConfig(), Adam(dict(m.named_parameters()),
                                             **opt_kw),
                    aug_transform_epoch=0, ignore_npoint_thresh=0, **common)
                ld, _ = trainer.train_step(pcs, flows, 0, False)
            else:
                m = MaskFormer3D(generator=gen, **cfg["segnet"])
                trainer = SupSegTrainer(
                    m, SupLossConfig(), Adam(dict(m.named_parameters()),
                                             **opt_kw),
                    ignore_npoint_thresh=0, **common)
                K = cfg["segnet"]["n_slot"]
                gt = torch.nn.functional.one_hot(
                    torch.from_numpy(x["segms"]).long(), K).float()
                ld, _ = trainer.train_step(pcs[:, 0], gt,
                                           torch.ones(gt.shape[:2]))
            p = f"{kind}/{mode}/"
            out.update({p + "ld/" + k: torch.as_tensor(v).detach().numpy()
                        for k, v in ld.items()})
            out.update({p + "p/" + k: v.detach().numpy()
                        for k, v in m.state_dict().items()})
            out[p + "backward"] = np.array([counted_backward.seen["norm"],
                                            counted_backward.seen["search"]])
    torch.Tensor.backward = backward
    return out


def _flow_model(cfg, state):
    import torch

    from ogc_tpu_torch.models.flownet import FlowStep3D

    m = FlowStep3D(arch=_flow_arch(cfg["arch"]), **cfg["model"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _case_flow_loss(x, cfg, state):
    """The port's flowstep3d_loss on given flows, with and without the
    symmetric smooth gradient: the terms and d(sum)/d(flows)."""
    import torch

    from ogc_tpu_torch.losses.flow_unsup import (FlowLossConfig,
                                                 flowstep3d_loss)

    pc1, pc2 = torch.from_numpy(x["pc1"]), torch.from_numpy(x["pc2"])
    out = {}
    for sym in (False, True):
        loss_cfg = dict(cfg["loss"])
        loss_cfg["smooth_loss_params"] = dict(
            loss_cfg["smooth_loss_params"], symmetric_grad=sym)
        flows = torch.from_numpy(x["flows"]).requires_grad_(True)
        loss, ld = flowstep3d_loss(pc1, pc2, list(flows),
                                   FlowLossConfig.from_dict(loss_cfg))
        loss.backward()
        tag = "sym" if sym else "ref"
        out.update({f"{tag}/ld/{k}": v.detach().numpy()
                    for k, v in ld.items()})
        out[f"{tag}/grad"] = flows.grad.numpy()
    return out


def _case_flow_train(x, cfg, state):
    """FlowStep3D in train mode on the carried weights, in float32 and in
    float64 (the witness of float32 rounding): one forward and backward of
    the flow loss (flows, terms, parameter gradients, the running
    statistics after it) for each loss block of ``cfg["losses"]``, and
    FlowTrainer's steps of ``cfg["train_iters"]`` iterations from the same
    weights on ``tr_*`` batches; and make_bn_schedule's values."""
    import torch

    from ogc_tpu_torch.losses.flow_unsup import (FlowLossConfig,
                                                 flowstep3d_loss)
    from ogc_tpu_torch.nn.flowstep3d import set_bn_momentum
    from ogc_tpu_torch.train.flow import FlowTrainer, make_bn_schedule
    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule

    out = {}
    for dt, dtype, dtype_np in (("f32", torch.float32, np.float32),
                                ("f64", torch.float64, np.float64)):
        for name, loss_cfg in cfg["losses"].items():
            loss_cfg = FlowLossConfig.from_dict(loss_cfg)
            m = _flow_model(cfg, state).to(dtype).train()
            set_bn_momentum(m, cfg["bn_momentum"])
            pc1, pc2 = (torch.from_numpy(x[k]).to(dtype)
                        for k in ("pc1", "pc2"))
            flows = m(pc1, pc2, pc1, pc2, cfg["iters"])
            loss, ld = flowstep3d_loss(pc1, pc2, flows, loss_cfg)
            loss.backward()
            p = f"{dt}/{name}/"
            out[p + "flows"] = torch.stack(flows).detach().numpy()
            out.update({p + "ld/" + k: v.detach().numpy()
                        for k, v in ld.items()})
            out.update({p + "g/" + k: q.grad.numpy()
                        for k, q in m.named_parameters()})
            out.update({p + "s/" + k: v.numpy()
                        for k, v in m.state_dict().items() if "running_" in k})
        m = _flow_model(cfg, state).to(dtype)
        opt = Adam(dict(m.named_parameters()),
                   make_lr_schedule(**cfg["lr"]))
        loss = dict(cfg["losses"]["full"])
        loss["iters_w"] = loss["iters_w"][:cfg["train_iters"]]
        trainer = FlowTrainer(m, cfg["train_iters"],
                              FlowLossConfig.from_dict(loss), opt,
                              exp_base=cfg["exp_base"],
                              device=torch.device("cpu"),
                              bn_schedule=make_bn_schedule(**cfg["bn"]))
        steps = []
        for it in range(x["tr_pcs"].shape[0]):
            batch = (x["tr_pcs"][it].astype(dtype_np), None,
                     x["tr_flows"][it].astype(dtype_np), None)
            ld = trainer.train_it(it, batch)
            steps.append([ld[k] for k in cfg["step_keys"]])
        out[f"{dt}/steps"] = np.array(steps)
    out["bn_schedule"] = np.array([[make_bn_schedule(**kw)(it)
                                    for it in cfg["bn_its"]]
                                   for kw in cfg["bn_cases"]])
    return out


def _case_seg_sup(x, cfg, state):
    """supervised_mask_loss on given masks (terms, match cost, col_ind and
    d(sum)/d(mask)), the LAP on the JAX package's costs, the unmatched
    losses without a valid mask."""
    import torch

    from ogc_tpu_torch.losses.seg_sup import (SupLossConfig, ce_loss,
                                              dice_loss, focal_loss,
                                              match_cost,
                                              supervised_mask_loss)
    from ogc_tpu_torch.utils.lap import linear_sum_assignment

    gt, valid = torch.from_numpy(x["gt"]), torch.from_numpy(x["valid"])
    out = {}
    for focal in (False, True):
        tag = "focal" if focal else "ce"
        lcfg = SupLossConfig(weights=tuple(cfg["weights"]), use_focal=focal)
        mask = torch.from_numpy(x["mask"]).requires_grad_(True)
        loss, ld = supervised_mask_loss(mask, gt, valid, lcfg)
        loss.backward()
        cost = match_cost(mask, gt, valid, lcfg).numpy()
        out.update({f"{tag}/ld/{k}": v.detach().numpy()
                    for k, v in ld.items()})
        out[f"{tag}/grad"] = mask.grad.numpy()
        out[f"{tag}/cost"] = cost
        out[f"{tag}/col_ind"] = linear_sum_assignment(cost, False)
        out[f"{tag}/col_ind_jax_cost"] = linear_sum_assignment(
            x[f"jax_cost/{tag}"], False)
    m = torch.from_numpy(x["mask"])
    out["ce_novalid"] = ce_loss(m, gt).numpy()
    out["dice_novalid"] = dice_loss(m, gt).numpy()
    out["focal_novalid"] = focal_loss(m, gt).numpy()
    return out


def _case_seg_sup_train(x, cfg, state):
    """SupSegTrainer's steps from the carried segnet on the ``tr_*``
    batches, in float32 (``f32/steps``) and in float64 (``f64/steps``):
    (sum, cross_entropy, dice) a step."""
    import torch

    from ogc_tpu_torch.losses.seg_sup import SupLossConfig
    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule
    from ogc_tpu_torch.train.seg_sup import SupSegTrainer

    out = {}
    for dt, dtype, dtype_np in (("f32", torch.float32, np.float32),
                                ("f64", torch.float64, np.float64)):
        model = _segnet(cfg, state).to(dtype)
        opt = Adam(dict(model.named_parameters()),
                   make_lr_schedule(**cfg["lr"]))
        trainer = SupSegTrainer(model, SupLossConfig(weights=tuple(
            cfg["weights"])), opt, ignore_npoint_thresh=0,
            exp_base=cfg["exp_base"], device=torch.device("cpu"))
        steps = []
        for it in range(x["tr_pcs"].shape[0]):
            batch = tuple(None if a is None else a.astype(dtype_np)
                          for a in (x["tr_pcs"][it], x["tr_segms"][it], None,
                                    x["tr_valids"][it]))
            ld, _, _ = trainer.train_it(it, batch)
            steps.append([ld[k] for k in ("sum", "cross_entropy", "dice")])
        out[f"{dt}/steps"] = np.array(steps)
    return out


def _case_outdoor_utils(x, cfg, state):
    """The outdoor path's utilities on CPU tensors: FPS (fps_plain) of
    every ``fps/<name>`` cloud and fps_plan of ``cfg["plan_n"]`` as (N,
    ppt, threads, reg_xyz, cluster) rows; icp_batched and the numpy icp on
    ``icp/A`` -> ``icp/B``; ground_plane_fitting_batched on ``gpf/P`` with
    each ``cfg["gpf"]`` mask setting, and the numpy ground_plane_fitting of
    every ``gpf_np/<i>`` cloud; the KITTI benchmark's preproc from numpy
    seed 18 on ``bench/<i>/{pc1,pc2,flow}``."""
    import torch

    from ogc_tpu_torch.ops.fps import fps, fps_plan
    from ogc_tpu_torch.test_flow_kittisf_benchmark import preproc
    from ogc_tpu_torch.utils.gpf import (ground_plane_fitting,
                                         ground_plane_fitting_batched)
    from ogc_tpu_torch.utils.icp import icp, icp_batched

    out = {}
    for name, npoint in cfg["fps"].items():
        out["fps/" + name] = fps(torch.from_numpy(x["fps/" + name]),
                                 npoint).numpy()
    out["plans"] = np.array([[n, *map(int, fps_plan(n))]
                             for n in cfg["plan_n"]])
    it = cfg["icp_iters"]
    out["icp/T"] = icp_batched(torch.from_numpy(x["icp/A"]),
                               torch.from_numpy(x["icp/B"]), it).numpy()
    out["icp/T_np"] = np.stack([icp(a, b, max_iterations=it)[0]
                                for a, b in zip(x["icp/A"], x["icp/B"])])
    P = torch.from_numpy(x["gpf/P"])
    for name, (v, fv) in cfg["gpf"].items():
        out["gpf/" + name] = ground_plane_fitting_batched(
            P, valid=None if v is None else torch.from_numpy(x[v]),
            fit_valid=None if fv is None else torch.from_numpy(x[fv]),
            **cfg["gpf_kw"]).numpy()
    for i in range(cfg["n_gpf_np"]):
        out[f"gpf_np/{i}"] = ground_plane_fitting(
            x[f"gpf_np/{i}"], device="cpu", **cfg["gpf_np_kw"])
    np.random.seed(18)
    for i in range(cfg["n_bench"]):
        for k, v in zip(("pc1", "pc2", "flow"), preproc(
                *(x[f"bench/{i}/{k}"] for k in ("pc1", "pc2", "flow")),
                remove_ground=True, n_sample_point=cfg["bench_n"])):
            out[f"bench/{i}/{k}"] = v
    return out


def _case_waymo_train(x, cfg, state):
    """One step of the port's train_seg_waymo trainer (SegTrainer, frame
    stride 2) on ``unsup/*`` and of its train_seg_waymo_sup trainer
    (SupSegTrainer on FlowPad items) on ``sup/*``, from the carried
    segnets ``unsup.<key>`` / ``sup.<key>``: the loss terms."""
    import torch

    from ogc_tpu_torch.losses.seg_sup import SupLossConfig
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
    from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule
    from ogc_tpu_torch.train.seg_sup import SupSegTrainer

    out = {}
    for tag in ("unsup", "sup"):
        model = _segnet({"segnet": cfg[tag + "_segnet"]},
                        {k[len(tag) + 1:]: v for k, v in state.items()
                         if k.startswith(tag + ".")})
        opt = Adam(dict(model.named_parameters()),
                   make_lr_schedule(**cfg["lr"]))
        common = dict(ignore_npoint_thresh=cfg["ignore_npoint_thresh"],
                      exp_base=cfg["exp_base"] + tag,
                      device=torch.device("cpu"))
        if tag == "unsup":
            trainer = SegTrainer(model, OGCLossConfig.from_dict(cfg["loss"]),
                                 opt, aug_transform_epoch=0, frame_stride=2,
                                 **common)
            batch = tuple(x[f"unsup/{k}"] for k in ("pcs", "segms", "flows",
                                                    "valids"))
            ld, _, _ = trainer.train_it(0, batch, aug_transform=True)
        else:
            trainer = SupSegTrainer(model, SupLossConfig(weights=tuple(
                cfg["sup_weights"])), opt, **common)
            batch = tuple(x[f"sup/{k}"] for k in ("pcs", "segms", "flows",
                                                  "valids"))
            ld, _, _ = trainer.train_it(0, batch)
        for k, v in ld.items():
            out[f"{tag}/{k}"] = np.array(v)
    return out


# ---------------------------------------------------------------------------
# data parallelism: a case spawns ``cfg["world"]`` gloo ranks on the CPU
# ---------------------------------------------------------------------------


def _case_dp_mesh(x, cfg, state):
    """parallel/mesh.py without a process group: pad_batch and every
    rank's shard_padded block and true rows of ``x["rows"]`` over
    ``cfg["size"]`` ranks; dp_eval_fwd of a tree-valued function over
    ``cfg["size"]`` CPU shards and over one; eval_devices on the CPU, and
    its error for ``--dp 2`` on a machine of one card."""
    import torch

    from ogc_tpu_torch.parallel import mesh

    rows, size = x["rows"], cfg["size"]
    out = {"padded": mesh.pad_batch([rows], mesh.padded_size(len(rows),
                                                             size))[0]}
    for r in range(size):
        (block,), b = mesh.shard_padded([rows], r, size)
        out[f"block{r}"] = block
        out[f"true{r}"] = np.array([b, mesh.true_rows(len(rows), r, size)])

    def fn(_, a, c):
        return {"a": a * 2.0, "b": [a + c, a.sum(-1)]}

    for name, n in (("dp", size), ("dp1", 1)):
        devices = mesh.eval_devices(n, "cpu")
        got = mesh.dp_eval_fwd(fn, devices)(x["a"], torch.from_numpy(x["c"]))
        out[f"{name}/a"], (out[f"{name}/b0"], out[f"{name}/b1"]) = \
            got["a"], got["b"]
        out[f"{name}/n_devices"] = np.array(len(devices))
    # --dp 2 on a machine with one card.
    real = torch.cuda.device_count
    torch.cuda.device_count = lambda: 1
    try:
        mesh.eval_devices(2, "cuda")
    except ValueError as e:
        out["raises"] = np.array(str(e))
    finally:
        torch.cuda.device_count = real
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_CURRENT = {}


def _case_dp(x, cfg, state):
    """Spawn ``cfg["world"]`` gloo ranks on the CPU (launcher environment
    set by hand, as torchrun sets it), each running ``_DP_RUNS[cfg["run"]]``
    on the same inputs; rank r's outputs under ``r<r>/``."""
    import torch.multiprocessing as mp

    world, port = cfg["world"], _free_port()
    mp.spawn(_dp_worker, args=(world, port, _CURRENT["in"],
                               _CURRENT["out"]), nprocs=world)
    out = {}
    for r in range(world):
        path = f"{_CURRENT['out']}.rank{r}.npz"
        with np.load(path) as z:
            out.update({f"r{r}/{k}": z[k] for k in z.files})
        os.remove(path)
    return out


def _dp_worker(rank, world, port, in_path, out_path):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from ogc_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    device = mesh.init_data_parallel("cpu")
    assert device == torch.device("cpu") and mesh.world() == (rank, world)
    x, cfg, state = _load(in_path)
    out = _DP_RUNS[cfg["run"]](x, cfg, state)
    out["launches"] = _launches()
    np.savez(f"{out_path}.rank{rank}.npz", **out)
    mesh.shutdown()


class _Items:
    """An in-memory dataset: item i is ``tuple(a[i] for a in arrays)``."""

    def __init__(self, *arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


def _loader(arrays, batch_size, dtype=None):
    """The port's DataLoader (sharded over the process group's ranks) over
    the items of ``arrays``, cast to ``dtype``."""
    from ogc_tpu_torch.data.base import DataLoader

    if dtype is not None:
        arrays = [a.astype(dtype) if a.dtype.kind == "f" else a
                  for a in arrays]
    return DataLoader(_Items(*arrays), batch_size=batch_size, shuffle=False,
                      num_workers=1)


def _state_out(prefix, model):
    """A copy of ``model``'s state (not a view the next step moves)."""
    return {f"{prefix}/s/{k}": v.detach().numpy().copy()
            for k, v in model.state_dict().items()
            if "num_batches" not in k}


def _dp_resume_check(prefix, trainer, make, batches, it):
    """Rank 0 alone writes the checkpoint (counted per rank), every rank
    finds it after ``save`` returns, and a fresh trainer resumed from it
    takes step ``it`` as the continuing trainer does: both steps' terms
    and parameters under ``<prefix>/``."""
    from ogc_tpu_torch.utils import checkpoint

    writes = []
    real = checkpoint.save_train_state
    checkpoint.save_train_state = lambda *a: writes.append(1) or real(*a)
    try:
        trainer.save(True, 1)
    finally:
        checkpoint.save_train_state = real
    path = trainer.checkpoint_name + checkpoint.SUFFIX
    out = {f"{prefix}/writes": np.array(len(writes)),
           f"{prefix}/found": np.array(os.path.exists(path))}
    resumed = make()
    out[f"{prefix}/epoch"] = np.array(resumed.resume(path))
    for tag, tr in (("cont", trainer), ("resumed", resumed)):
        ld = _dp_step(tr, it, batches[it])
        out[f"{prefix}/{tag}/ld"] = np.array([ld[k] for k in sorted(ld)])
        out.update(_state_out(f"{prefix}/{tag}", tr.model))
    return out


def _dp_sync_check(prefix, trainer):
    """Rank 1 moves its weights and Adam moments away from rank 0's, then
    ``sync_replicas``: the state every rank then starts from, under
    ``<prefix>/start/``."""
    import torch

    from ogc_tpu_torch.parallel import mesh

    if mesh.world()[0] == 1:
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.add_(1.0)
            for m in trainer.optimizer.mu.values():
                m.add_(1.0)
    trainer.sync_replicas()
    out = _state_out(f"{prefix}/start", trainer.model)
    out[f"{prefix}/start/mu"] = np.concatenate(
        [m.detach().numpy().ravel() for m in trainer.optimizer.mu.values()])
    return out


def _dp_step(trainer, it, batch):
    ld = trainer.train_it(it, batch, **getattr(trainer, "_step_kw", {}))
    return ld[0] if isinstance(ld, tuple) else ld


def _dp_run_trainers(x, cfg, state):
    """``_dp_run_trainer`` for each trainer of ``cfg["trainers"]``, on the
    inputs ``<trainer>/*`` and weights ``<trainer>.*``; its outputs under
    ``<trainer>/``."""
    out = {}
    for kind in cfg["trainers"]:
        sub = {k[len(kind) + 1:]: v for k, v in x.items()
               if k.startswith(kind + "/")}
        weights = {k[len(kind) + 1:]: v for k, v in state.items()
                   if k.startswith(kind + ".")}
        res = _dp_run_trainer(sub, {**cfg, **cfg[kind], "trainer": kind},
                              weights)
        out.update({f"{kind}/{k}": v for k, v in res.items()})
    return out


def _dp_run_trainer(x, cfg, state):
    """``cfg["trainer"]`` (seg, sup, flow_local, flow_global): in float32
    one step, in float64 ``cfg["steps"]``, on this rank's blocks of the
    global batches of ``cfg["batch"]`` (terms; in float64 every parameter
    and running statistic after the steps), with ``cfg["eval"]`` an eval
    pass in float64 over ``ev_*`` (a global batch padded to a multiple of
    the ranks: its loss and terms), and in float64 the checkpoint check of
    ``_dp_resume_check`` at step ``steps``."""
    import torch

    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule

    kind = cfg["trainer"]
    keys = ("pcs", "segms", "flows", "valids")
    out = {}
    for dt, dtype, dtype_np, n_steps in (
            ("f32", torch.float32, np.float32, 1),
            ("f64", torch.float64, np.float64, cfg["steps"])):
        def make():
            if kind.startswith("flow"):
                from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig
                from ogc_tpu_torch.train.flow import (FlowTrainer,
                                                      make_bn_schedule)

                m = _flow_model(cfg, state).to(dtype)
                opt = Adam(dict(m.named_parameters()),
                           make_lr_schedule(**cfg["lr"]))
                return FlowTrainer(
                    m, cfg["iters"], FlowLossConfig.from_dict(cfg["loss"]),
                    opt, exp_base=cfg["exp_base"] + dt,
                    device=torch.device("cpu"),
                    bn_schedule=make_bn_schedule(**cfg["bn"]),
                    bn_sync=kind[len("flow_"):])
            m = _segnet(cfg, state).to(dtype)
            opt = Adam(dict(m.named_parameters()),
                       make_lr_schedule(**cfg["lr"]))
            if kind == "sup":
                from ogc_tpu_torch.losses.seg_sup import SupLossConfig
                from ogc_tpu_torch.train.seg_sup import SupSegTrainer

                return SupSegTrainer(
                    m, SupLossConfig(weights=tuple(cfg["weights"])), opt,
                    ignore_npoint_thresh=0, exp_base=cfg["exp_base"] + dt,
                    device=torch.device("cpu"))
            from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
            from ogc_tpu_torch.train.seg import SegTrainer

            tr = SegTrainer(m, OGCLossConfig.from_dict(cfg["loss"]), opt,
                            aug_transform_epoch=0, ignore_npoint_thresh=0,
                            exp_base=cfg["exp_base"] + dt,
                            device=torch.device("cpu"))
            tr._step_kw = {"aug_transform": True}
            return tr

        trainer = make()
        if dt == "f64":
            out.update(_dp_sync_check(dt, trainer))
        batches = list(_loader([x[k] for k in keys], cfg["batch"],
                               dtype_np))
        steps = []
        for it in range(n_steps):
            ld = _dp_step(trainer, it, batches[it])
            steps.append([ld[k] for k in sorted(ld)])
        out[f"{dt}/keys"] = np.array(sorted(ld))
        out[f"{dt}/steps"] = np.array(steps)
        if dt == "f32":
            continue
        out.update(_state_out(dt, trainer.model))
        if cfg["eval"]:
            ev = list(_loader([x["ev_" + k] for k in keys],
                              len(x["ev_pcs"]), dtype_np))
            out[f"{dt}/ev_true_b"] = np.array([ev[0].true_b,
                                               ev[0].global_b])
            loss, ld = trainer._validate(ev)[:2]
            out[f"{dt}/ev_loss"] = np.array(loss)
            out[f"{dt}/ev_ld"] = np.array([ld[k] for k in sorted(ld)])
        out.update(_dp_resume_check(dt, trainer, make, batches,
                                    cfg["steps"]))
    return out


_DP_RUNS = {"trainers": _dp_run_trainers}


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
    "match": _case_match,
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
    "pruned_select": _case_pruned_select,
    "flownet": _case_flownet,
    "blocksparse": _case_blocksparse,
    "smooth_mxu": _case_smooth_mxu,
    "knn_cand": _case_knn_cand,
    "flow_loss": _case_flow_loss,
    "flow_modes": _case_flow_modes,
    "mutual_keep": _case_mutual_keep,
    "remat": _case_remat,
    "ogc_terms": _case_ogc_terms,
    "flow_train": _case_flow_train,
    "seg_sup": _case_seg_sup,
    "seg_sup_train": _case_seg_sup_train,
    "outdoor_utils": _case_outdoor_utils,
    "waymo_train": _case_waymo_train,
    "dp_mesh": _case_dp_mesh,
    "dp": _case_dp,
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
        _CURRENT.update({"in": in_path, "out": out_path})
        out = CASES[case](x, cfg, state)
        out.update(_launch_counts())
        np.savez(out_path, **out)


def _launches() -> np.ndarray:
    """FPS, exact KNN, ball query and scatter-add launches."""
    return _launch_counts()["launches"]


def _launch_counts() -> Dict[str, np.ndarray]:
    """Every wrapper's launch counter, under the keys the module docstring
    names."""
    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.blocksparse import (gather_blocksparse,
                                               scatter_add_blocksparse)
    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.ops.iou_match import iou_match
    from ogc_tpu_torch.ops.knn_cand import knn_cand
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                knn_blockmin)
    from ogc_tpu_torch.ops.knn_pruned import knn_exact_pruned
    from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                          scatter_add_rows_onehot)
    from ogc_tpu_torch.ops.pool import rowgroup_pool
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    return {
        "launches": np.array([fps.launches, knn_exact.launches,
                              ball_query_exact.launches,
                              scatter_add_rows.launches]),
        "launches_onehot": np.array([gather_rows_onehot.launches,
                                     scatter_add_rows_onehot.launches]),
        "launches_blockmin": np.array([knn_blockmin.launches,
                                       ball_query_blockmin.launches]),
        "launches_flow": np.array([rowgroup_pool.launches,
                                   knn_exact_pruned.launches]),
        "launches_cand": np.array([gather_blocksparse.launches,
                                   scatter_add_blocksparse.launches,
                                   knn_cand.launches]),
        "launches_match": np.array([iou_match.launches])}


if __name__ == "__main__":
    main(sys.argv[1:])
