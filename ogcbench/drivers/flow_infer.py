"""Flow extraction, as ``test_flow`` runs it: the FlowStep3D eval forward
``model(pc1, pc2, pc1, pc2, iters)[-1]`` behind ``mesh.dp_eval_fwd`` on one
card (numpy pairs in, numpy flows out), TF32 off, with the traffic's
neighbour mode and compute dtype (``--approx_knn``; ``compute_dtype``).

Set-up loads the seeded weights and BatchNorm statistics into the model
and warms the forward on two batches; the window cycles the traffic's
batches.  The flows of a seeded sample of the distinct batches, as the
window produced them, are kept; after the window the reference recomputes
those batches and each pair's flow is compared (``gaps``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ogcbench import weights
from ogcbench.reference import flownet as ref_flownet
from ogcbench.reference import search as ref_search
from ogcbench.reference.nn import Products
from ogcbench.traffic.generate import batches
from ogcbench.traffic.street import rng_for
from ogcbench.work.flowstep3d import forward_flops

#: The numbers compared, and their limits, by compute dtype (PERF.md gives
#: the readings they were set from).  In bf16 the worst pair's relative
#: gap swings too far for the float8 control to stand three times above
#: it, so the share of points off by more than FAR metres is compared.
LIMITS = {"f32": {"flow_gap": 1.5e-3}, "bf16": {"flow_far_share": 0.4}}
FAR = 0.1


def gaps(outs: Dict[int, np.ndarray], refs: Dict[int, np.ndarray]
         ) -> List[Tuple[str, float]]:
    """Over every compared batch, the worst pair's relative gap
    ||flow - ref|| / ||ref|| over its points (``flow_gap``), and the worst
    pair's share of points whose flow lies more than FAR from the
    reference's (``flow_far_share``)."""
    rel, far = 0.0, 0.0
    for b, out in outs.items():
        d = np.linalg.norm(out - refs[b], axis=-1)  # (pairs, points)
        r = np.linalg.norm(refs[b], axis=-1)
        rel = max(rel, float((np.sqrt((d ** 2).sum(1))
                              / np.maximum(np.sqrt((r ** 2).sum(1)),
                                           1e-12)).max()))
        far = max(far, float((d > FAR).mean(1).max()))
    return [("flow_gap", rel), ("flow_far_share", far)]


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from ogc_tpu_torch import ops
        from ogc_tpu_torch.models.flownet import FlowStep3D
        from ogc_tpu_torch.ops import _build
        from ogc_tpu_torch.parallel import mesh
        from ogc_tpu_torch.utils.config import apply_compute_dtype

        if device.type == "cuda":
            _build.lib()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        apply_compute_dtype({"compute_dtype": traffic["compute_dtype"]})
        ops.set_exact_neighbors(traffic["neighbors"] == "exact")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.B = traffic["batch"]
        self.samples_per_step = self.B
        self.iters = cfg["test_model_iters"]
        fn = cfg["flownet"]
        self.P0 = weights.make(ref_flownet.param_shapes(cfg), seed, device)
        model = FlowStep3D(npoint=fn["npoint"], arch=cfg["dataset"],
                           use_instance_norm=fn["use_instance_norm"],
                           loc_flow_nn=fn["loc_flow_nn"],
                           loc_flow_rad=fn["loc_flow_rad"],
                           k_decay_fact=fn["test_k_decay_fact"])
        model.to(device)
        model.load_state_dict(self.P0, strict=True)
        model.eval()
        iters = self.iters
        self.forward = mesh.dp_eval_fwd(
            lambda m, pc1, pc2: m(pc1, pc2, pc1, pc2, iters)[-1], [device],
            model)
        self.batches = [b[0] for b in batches(traffic, cfg, seed)]
        n = len(self.batches)
        self.sample = set(rng_for(seed + 1).choice(
            n, min(traffic["check_batches"], n), replace=False).tolist())
        self.outs: Dict[int, np.ndarray] = {}

    def warm(self) -> None:
        for pcs in self.batches[:2]:
            self.forward(pcs[:, 0], pcs[:, 1])

    def step(self, i: int) -> None:
        b = i % len(self.batches)
        pcs = self.batches[b]
        out = self.forward(pcs[:, 0], pcs[:, 1])
        if b in self.sample and b not in self.outs:
            self.outs[b] = out

    def free(self) -> None:
        del self.forward
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pr: Products = Products()) -> Dict[int, np.ndarray]:
        """The reference's flows of the kept batches."""
        torch.use_deterministic_algorithms(False)
        search = ref_search.Search(self.traffic["neighbors"] == "exact")
        out = {}
        for b in sorted(self.outs):
            pcs = torch.from_numpy(self.batches[b]).to(self.device)
            out[b] = ref_flownet.forward(self.P0, self.cfg, pcs[:, 0],
                                         pcs[:, 1], self.iters, search,
                                         pr).cpu().numpy()
        return out

    def check(self) -> List[Tuple[str, float, float]]:
        if not self.outs:
            return []
        lim = LIMITS[self.traffic["compute_dtype"]]
        refs = self.reference()
        mean = np.mean([np.linalg.norm(r, axis=-1).mean()
                        for r in refs.values()])
        print(f"flow_infer: {len(refs)} batches compared, the reference's "
              f"mean flow {mean:.4f} m", file=sys.stderr)
        return [(n, v, lim[n]) for n, v in gaps(self.outs, refs) if n in lim]

    def model_products(self):
        return forward_flops(self.cfg, self.B, self.iters,
                             self.traffic["compute_dtype"])
