"""Flow training, as ``train_flow`` runs it: ``FlowTrainer.train_it`` on
host batches of OGC-DR-style room pairs (``traffic/room.py``: the first
augmented view's pair of each item), float32 with TF32 off and
deterministic algorithms (``set_deterministic``), the iteration counter
from 0 as the CLI's first epoch passes it.

Set-up builds the one trainer as the CLI does (FlowStep3D at the
configuration's widths, the flow loss, Adam with the staircase learning
rate, the BatchNorm momentum schedule), loads the seeded weights, and takes
the check's steps through ``train_it`` on the traffic's first
``check_steps`` batches: the loss terms of each, the first gradient as
Adam got it (its first moment over 1 - b1) and the parameters' change
after the last.  Those steps warm every shape; the window then cycles the
batches through the same trainer.  After the window the reference
(``ogcbench/reference/flow_train.py``) follows the same steps from the same
weights and batches, and the gaps are compared (``gaps``).
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from ogcbench import weights
from ogcbench.drivers.seg_train import record_norms
from ogcbench.reference import flow_train as ref_train
from ogcbench.reference import flownet as ref_flownet
from ogcbench.reference import ogc_loss as ref_loss
from ogcbench.reference import search as ref_search
from ogcbench.reference.nn import Products
from ogcbench.traffic.room import batches
from ogcbench.work.flowstep3d import forward_flops

#: Leaves whose reference first gradient is under this share of the
#: median leaf's are not compared in the change (Adam moves their elements
#: by about the learning rate whatever the gradient's size).
STILL = 1e-3
#: Limits of the gaps, set from the card's readings at the cell's size
#: (PERF.md gives them): each lies between the program's largest reading
#: and the smaller of the TF32 control's and a planted fault's smallest,
#: with room on both sides.  TF32 hardly moves the change, so its limit
#: lies between the program's reading and 1, what a state left unchanged
#: reads, with more room above the reading.
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.3}


def gaps(prog: dict, ref: dict) -> List[Tuple[str, float]]:
    """The compared numbers of a program (or control) record against the
    reference's: the worst relative gap of a loss term at the first step
    (every iteration's Chamfer and smoothness terms); the worst leaf's gap
    between the two first-gradient norms, and between the two
    parameter-change norms after the last step, each over the larger of
    the reference's norm of that leaf and of the median leaf."""
    loss = loss_gaps(prog, ref)[0]
    g_med = float(np.median(list(ref["grad"].values())))
    grad = max(abs(prog["grad"][k] - g) / max(g, g_med)
               for k, g in ref["grad"].items())
    moving = [k for k, g in ref["grad"].items() if g >= STILL * g_med]
    c_med = float(np.median([ref["change"][k] for k in moving]))
    change = max(abs(prog["change"][k] - ref["change"][k])
                 / max(ref["change"][k], c_med) for k in moving)
    return [("loss_gap", loss), ("grad_gap", grad), ("change_gap", change)]


def loss_gaps(prog: dict, ref: dict) -> List[float]:
    """Each step's worst relative gap of a loss term (only the first
    step's is compared: after Adam's first update the rounding that
    train-mode BatchNorm amplifies has moved the weights apart)."""
    return [max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12) for t in r)
            for p, r in zip(prog["losses"], ref["losses"])]


def loss_terms(ld: Dict[str, float]) -> Dict[str, float]:
    return {t: v for t, v in ld.items()
            if t.startswith(("chamfer_loss_#", "smooth_loss_#"))}


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from ogc_tpu_torch import ops
        from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig
        from ogc_tpu_torch.models.flownet import FlowStep3D
        from ogc_tpu_torch.ops import _build
        from ogc_tpu_torch.train.flow import FlowTrainer, make_bn_schedule
        from ogc_tpu_torch.train.seg import Adam, make_lr_schedule
        from ogc_tpu_torch.train_seg import set_deterministic
        from ogc_tpu_torch.utils.config import apply_compute_dtype

        if device.type == "cuda":
            _build.lib()
        set_deterministic(device)
        apply_compute_dtype({"compute_dtype": traffic["compute_dtype"]})
        ops.set_exact_neighbors(traffic["neighbors"] == "exact")
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.B = traffic["batch"]
        self.samples_per_step = self.B
        fn = cfg["flownet"]
        self.P0 = weights.make(ref_flownet.param_shapes(cfg), seed, device)
        model = FlowStep3D(npoint=fn["npoint"], arch=cfg["dataset"],
                           use_instance_norm=fn["use_instance_norm"],
                           loc_flow_nn=fn["loc_flow_nn"],
                           loc_flow_rad=fn["loc_flow_rad"],
                           k_decay_fact=fn["k_decay_fact"])
        model.to(device)
        model.load_state_dict(self.P0, strict=True)
        self.optimizer = Adam(
            dict(model.named_parameters()),
            make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                             cfg["decay_step"], self.B),
            cfg["weight_decay"])
        self.exp_base = tempfile.mkdtemp(prefix="ogcbench-")
        self.trainer = FlowTrainer(
            model, cfg["model_iters"], FlowLossConfig.from_dict(cfg["loss"]),
            self.optimizer, exp_base=self.exp_base, device=device,
            bn_schedule=make_bn_schedule(cfg["bn_momentum"], cfg["bn_decay"],
                                         cfg["decay_step"], self.B))
        self.batches = batches(traffic, cfg, seed)
        self.it = 0

    def _train(self, k: int) -> Dict[str, float]:
        ld = self.trainer.train_it(self.it, self.batches[k % len(self.batches)])
        self.it += 1
        return ld

    def warm(self) -> None:
        """The check's steps, recorded; they warm every shape."""
        b1 = self.optimizer.b1
        rec = {"losses": [], "grad": {}, "change": {}}
        for s in range(self.traffic["check_steps"]):
            rec["losses"].append(loss_terms(self._train(s)))
            if s == 0:
                rec["grad"] = record_norms({k: m / (1 - b1) for k, m in
                                            self.optimizer.mu.items()})
        params = dict(self.trainer.model.named_parameters())
        rec["change"] = record_norms({k: params[k].detach() - v
                                      for k, v in self.P0.items()
                                      if k in params})
        self.record = rec

    def step(self, i: int) -> None:
        """The window's step i takes the batch after the check's steps."""
        self._train(self.traffic["check_steps"] + i)

    def free(self) -> None:
        del self.trainer, self.optimizer
        shutil.rmtree(self.exp_base, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pr: Products = Products()) -> dict:
        """The reference's record of the check's steps."""
        return reference_steps(self.cfg, self.traffic, self.P0, self.batches,
                               self.device, pr)

    def check(self) -> List[Tuple[str, float, float]]:
        return [(n, v, LIMITS[n]) for n, v in gaps(self.record,
                                                    self.reference())]

    def model_products(self):
        f = forward_flops(self.cfg, self.B, self.cfg["model_iters"],
                          self.traffic["compute_dtype"])
        return [(3 * flops, kind) for flops, kind in f]


def reference_steps(cfg, traffic, P0, host_batches, device,
                    pr: Products = Products()) -> dict:
    """``check_steps`` reference steps (train-mode forward, flow loss,
    backward, Adam) from the weights P0 on the traffic's first batches."""
    torch.use_deterministic_algorithms(False)
    search = ref_search.Search(traffic["neighbors"] == "exact")
    P = {k: v.detach().clone() for k, v in P0.items()}
    params = ref_train.leaves(P)
    for v in params.values():
        v.requires_grad_(True)
    adam = ref_loss.Adam(params, cfg, traffic["batch"])
    rec = {"losses": [], "grad": {}, "change": {}}
    for s in range(traffic["check_steps"]):
        pcs = torch.from_numpy(host_batches[s][0]).to(device)
        pc1, pc2 = pcs[:, 0].contiguous(), pcs[:, 1].contiguous()
        flows = ref_train.forward(P, cfg, pc1, pc2, cfg["model_iters"],
                                  search, pr)
        loss, terms = ref_train.flow_loss(pc1, pc2, flows, cfg["loss"],
                                          search)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        rec["losses"].append({t: float(v.detach())
                              for t, v in terms.items()})
        if s == 0:
            rec["grad"] = record_norms(grads)
        adam.step(grads)
        del flows, loss, terms, grads
    rec["change"] = record_norms({k: v.detach() - P0[k]
                                  for k, v in params.items()})
    return rec
