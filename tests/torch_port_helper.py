"""Torch side of the PyTorch port's parity tests (tests/test_torch_*.py).

tests/conftest.py imports jax into every pytest worker, and torch must not
share a process with JAX, so a test writes its inputs (numpy arrays made
from a seed, carried weights under ``sd/<key>``, a JSON ``cfg``) to an .npz,
runs the torch side here in a subprocess, and reads the outputs back:

    python -m tests.torch_port_helper <case> <in.npz> <out.npz> [<case> ...]

Every case also reports the kernel launch counters (FPS, exact KNN, ball
query, scatter-add), which must stay at 0 on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Dict, List, Tuple

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


def run_torch(cases: List[Tuple[str, str, str]], timeout: float = 300.0
              ) -> List[Dict[str, np.ndarray]]:
    """Run (case, in.npz, out.npz) triples in ONE torch subprocess and load
    the outputs."""
    argv = [a for c in cases for a in c]
    env = dict(os.environ, OMP_NUM_THREADS="2")
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
    import ogc_tpu_torch.test_seg  # noqa: F401
    import ogc_tpu_torch.train_seg  # noqa: F401

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
    "lap": _case_lap,
    "ogc_loss": _case_ogc_loss,
    "train_steps": _case_train_steps,
    "adam": _case_adam,
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
        out = CASES[case](x, cfg, state)
        from ogc_tpu_torch.ops.ball import ball_query_exact
        from ogc_tpu_torch.ops.fps import fps
        from ogc_tpu_torch.ops.knn import knn_exact
        from ogc_tpu_torch.ops.scatter import scatter_add_rows

        out["launches"] = np.array([fps.launches, knn_exact.launches,
                                    ball_query_exact.launches,
                                    scatter_add_rows.launches])
        np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
