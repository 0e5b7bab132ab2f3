"""Segmentation training, as ``train_seg`` runs it: ``SegTrainer.train_it``
on host batches of KITTI-SF items (two frames in two augmented views),
float32 with TF32 off and deterministic algorithms (``set_deterministic``),
the sample counter past every loss term's start step.

Set-up builds the one trainer (MaskFormer3D, the OGC loss, Adam), loads the
seeded weights, and takes the check's steps through ``train_it`` on the
traffic's first ``check_steps`` batches: the loss terms of each, the first
gradient as Adam got it (its first moment over 1 - b1) and the parameters'
change after the last.  Those steps warm every shape; the window then
cycles the batches through the same trainer.  After the window the
reference (``ogcbench/reference/``) follows the same steps from the same
weights and batches, and the gaps are compared (``gaps``).
"""

from __future__ import annotations

import math
import shutil
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from ogcbench import weights
from ogcbench.reference import ogc_loss as ref_loss
from ogcbench.reference import search as ref_search
from ogcbench.reference import segnet as ref_segnet
from ogcbench.reference.nn import Products
from ogcbench.traffic.generate import batches
from ogcbench.work.maskformer3d import forward_flops

TERMS = ("dynamic", "smooth", "invariance")
#: Leaves whose reference first gradient is under this share of the
#: median leaf's move by round-off alone under Adam; their change is not
#: compared.
STILL = 1e-3
#: Limits of the gaps (PERF.md gives the readings they were set from).
LIMITS = {"loss_gap": 2e-5, "grad_gap": 3e-4, "change_gap": 0.2}


def record_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def gaps(prog: dict, ref: dict) -> List[Tuple[str, float]]:
    """The compared numbers of a program (or control) record against the
    reference's: the worst relative gap of a loss term at the first step;
    the worst leaf's gap between the two first-gradient norms, and between
    the two parameter-change norms after the last step, each over the
    larger of the reference's norm of that leaf and of the median leaf.

    The later steps' loss terms are not compared: Adam's first update
    moves every element by about the learning rate whatever its
    gradient's size, so elements whose gradient is near zero take the
    sign of their rounding; the masks then differ by ~1e-3, the argmax
    segmentations at some points, and the invariance term's matching by
    IoU flips (``loss_gaps``; PERF.md gives the readings)."""
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
    """Each step's worst relative gap of a loss term."""
    return [max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12) for t in TERMS)
            for p, r in zip(prog["losses"], ref["losses"])]


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        from ogc_tpu_torch import ops
        from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
        from ogc_tpu_torch.models.segnet import MaskFormer3D
        from ogc_tpu_torch.ops import _build
        from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule
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
        sn = cfg["segnet"]
        self.P0 = weights.make(ref_segnet.param_shapes(cfg), seed, device)
        model = MaskFormer3D(
            n_slot=sn["n_slot"], n_point=sn["n_point"], arch=sn["arch"],
            use_xyz=sn["use_xyz"],
            n_transformer_layer=sn["n_transformer_layer"],
            transformer_embed_dim=sn["transformer_embed_dim"],
            transformer_input_pos_enc=sn["transformer_input_pos_enc"])
        model.to(device)
        model.load_state_dict(self.P0, strict=True)
        schedule = make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                                    cfg["decay_step"], self.B)
        self.optimizer = Adam(dict(model.named_parameters()), schedule,
                              cfg["weight_decay"])
        self.exp_base = tempfile.mkdtemp(prefix="ogcbench-")
        self.trainer = SegTrainer(
            model, OGCLossConfig.from_dict(cfg["loss"]), self.optimizer,
            aug_transform_epoch=cfg["aug_transform_epoch"],
            ignore_npoint_thresh=cfg["ignore_npoint_thresh"],
            exp_base=self.exp_base, device=device)
        self.batches = batches(traffic, cfg, seed)
        # The sample counter (it x B) starts past every term's start step.
        self.it = math.ceil(max(cfg["loss"]["start_steps"]) / self.B)

    def _train(self, k: int) -> Dict[str, float]:
        batch = self.batches[k % len(self.batches)]
        ld, _, _ = self.trainer.train_it(self.it, batch, aug_transform=True)
        self.it += 1
        return ld

    def warm(self) -> None:
        """The check's steps, recorded; they warm every shape."""
        b1 = self.optimizer.b1
        rec = {"losses": [], "grad": {}, "change": {}}
        for s in range(self.traffic["check_steps"]):
            rec["losses"].append({t: v for t, v in self._train(s).items()
                                  if t in TERMS})
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
        ref = self.reference()
        return [(n, v, LIMITS[n]) for n, v in gaps(self.record, ref)]

    def model_products(self):
        f = forward_flops(self.cfg, self.B * 4)
        return [(3 * flops, kind) for flops, kind in f]


def reference_steps(cfg, traffic, P0, host_batches, device,
                    pr: Products = Products()) -> dict:
    """``check_steps`` reference steps (forward, OGC loss, backward, Adam)
    from the weights P0 on the traffic's first batches."""
    torch.use_deterministic_algorithms(False)
    search = ref_search.Search(traffic["neighbors"] == "exact")
    P = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in P0.items()}
    leaves = {k: v for k, v in P.items() if v.requires_grad}
    adam = ref_loss.Adam(leaves, cfg, traffic["batch"])
    rec = {"losses": [], "grad": {}, "change": {}}
    for s in range(traffic["check_steps"]):
        pcs, _, flows = host_batches[s]
        pcs = torch.from_numpy(pcs).to(device)
        flows = torch.from_numpy(flows).to(device)
        B, T, N, _ = pcs.shape
        masks = ref_segnet.forward(P, cfg, pcs.reshape(B * T, N, 3), search,
                                   pr).reshape(B, T, N, -1)
        loss, terms = ref_loss.ogc_loss([pcs[:, t] for t in range(T)],
                                        [masks[:, t] for t in range(T)],
                                        [flows[:, t] for t in range(T)],
                                        cfg["loss"], search, pr)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        rec["losses"].append({t: float(v.detach())
                              for t, v in terms.items()})
        if s == 0:
            rec["grad"] = record_norms(grads)
        adam.step(grads)
        del masks, loss, terms, grads
    rec["change"] = record_norms({k: v.detach() - P0[k]
                                  for k, v in leaves.items()})
    return rec
