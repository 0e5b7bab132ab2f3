"""Readings that the limits of ``correct`` are set from, for one cell, in
one process (the kernels build once):

    python3 -m ogcbench.calibrate --workload <cell> --seeds 11 12 ... \
        [--control 3] [--faults half,unchanged] [--seconds 3]

For each seed it prints one JSON line per kind of reading, each number a
run's check compares: ``program`` (the cell's timed path against the
reference, as a run compares it), ``control`` (the reference in the
precision below the cell's, float32 -> TF32, bf16 -> float8 e4m3, put in
the program's place; on the first ``--control`` seeds) and each planted
fault (``FAULTS``; on the same seeds).  The benchmark's own runs never run
the control or a fault.  A last line gives each number's lower reading
(the program's largest), the control's smallest and each fault's
smallest.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from typing import Dict, List

import torch

from ogcbench import run
from ogcbench.drivers import flow_infer, seg_train
from ogcbench.reference.nn import FP8Products, TF32Products


@contextlib.contextmanager
def _half_batch():
    """Training: half of the batch left out, the mean over the rest."""
    from ogc_tpu_torch.train.seg import SegTrainer

    orig = SegTrainer.train_step

    def half(self, pcs, flows, it_samples, aug):
        h = pcs.shape[0] // 2
        return orig(self, pcs[:h], flows[:h], it_samples, aug)

    SegTrainer.train_step = half
    try:
        yield
    finally:
        SegTrainer.train_step = orig


@contextlib.contextmanager
def _unchanged():
    """A step that returns its state unchanged: Adam's update skipped
    (training); the refinement iterations skipped, flow0 returned
    (inference)."""
    from ogc_tpu_torch.models.flownet import FlowStep3D
    from ogc_tpu_torch.train.seg import Adam

    step, fwd = Adam.step, FlowStep3D.forward
    Adam.step = lambda self: True
    FlowStep3D.forward = (lambda self, pc1, pc2, f1, f2, iters=1:
                          fwd(self, pc1, pc2, f1, f2, 1))
    try:
        yield
    finally:
        Adam.step, FlowStep3D.forward = step, fwd


@contextlib.contextmanager
def _altered():
    """An answer altered where it is produced: the first pair's flow
    replaced by the second pair's."""
    from ogc_tpu_torch.models.flownet import FlowStep3D

    fwd = FlowStep3D.forward

    def altered(self, *args, **kwargs):
        flows = fwd(self, *args, **kwargs)
        last = flows[-1].clone()
        last[0] = last[1]
        return flows[:-1] + [last]

    FlowStep3D.forward = altered
    try:
        yield
    finally:
        FlowStep3D.forward = fwd


FAULTS = {"half": _half_batch, "unchanged": _unchanged, "altered": _altered}


def control_products(traffic: dict):
    return FP8Products() if traffic["compute_dtype"] == "bf16" \
        else TF32Products()


def program_cell(spec, seed, device, seconds, fault=None):
    """A cell run through set-up, the check's steps or a short window, and
    free: the cell, holding what the check compares."""
    ctx = FAULTS[fault]() if fault else contextlib.nullcontext()
    with ctx:
        drv = importlib.import_module("ogcbench.drivers."
                                      + spec["traffic"]["driver"])
        cell = drv.Cell(spec["cfg"], spec["traffic"], seed, device)
        cell.warm()
        if spec["traffic"]["driver"] == "flow_infer":
            n = len(cell.batches)
            run.window(cell, seconds, n)
            # every sampled batch is compared
            for i in range(n):
                if len(cell.outs) == len(cell.sample):
                    break
                cell.step(i)
        cell.free()
    return cell


def readings(spec: dict, seed: int, device, seconds: float,
             control: bool, faults: List[str]) -> List[dict]:
    drv = spec["traffic"]["driver"]
    gaps = seg_train.gaps if drv == "seg_train" else flow_infer.gaps
    cell = program_cell(spec, seed, device, seconds)
    ref = cell.reference()
    got = cell.record if drv == "seg_train" else cell.outs
    out = [{"seed": seed, "kind": "program", "readings": dict(gaps(got, ref))}]
    if drv == "seg_train":
        out[0]["loss_gap_by_step"] = seg_train.loss_gaps(got, ref)
    if control:
        ctrl = cell.reference(control_products(spec["traffic"]))
        out.append({"seed": seed, "kind": "control",
                    "readings": dict(gaps(ctrl, ref))})
    for f in faults:
        fc = program_cell(spec, seed, device, seconds, f)
        got = fc.record if drv == "seg_train" else fc.outs
        out.append({"seed": seed, "kind": f,
                    "readings": dict(gaps(got, ref))})
    return out



def summary(lines: List[dict]) -> Dict[str, dict]:
    res: Dict[str, dict] = {}
    for ln in lines:
        for name, v in ln["readings"].items():
            r = res.setdefault(name, {})
            if ln["kind"] == "program":
                r["lower"] = max(r.get("lower", 0.0), v)
            else:
                r[ln["kind"]] = min(r.get(ln["kind"], float("inf")), v)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = run.resolve(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    faults = [f for f in args.faults.split(",") if f]
    lines = []
    for i, seed in enumerate(args.seeds):
        for ln in readings(spec, seed, device, args.seconds,
                           i < args.control, faults if i < args.control
                           else []):
            lines.append(ln)
            print(json.dumps(ln), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
