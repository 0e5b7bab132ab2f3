"""Readings that the limits of a flow-training cell's ``correct`` are set
from, in one process (the kernels build once):

    python3 -m ogcbench.calibrate_flow_train --workload flow_train.ogcdr \\
        --seeds 11 12 ... [--control 3] [--faults unchanged,altered]

As ``ogcbench.calibrate`` does it for the other cells, whose readings know
only the ``seg_train`` and ``flow_infer`` drivers: for each seed one JSON
line per kind of reading, each number the run's check compares.
``program`` is the cell's check steps against the reference; ``control``
the reference with its products rounded to TF32 (TF32 off), put in the
program's place, on the first ``--control`` seeds; each planted fault
(``FAULTS``) on the same seeds.  A last line gives each number's lower
reading (the program's largest), the control's smallest and each fault's
smallest.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import List

import torch

from ogcbench import calibrate, run
from ogcbench.drivers import flow_train


@contextlib.contextmanager
def _unchanged():
    """A step that returns its state unchanged: Adam's update skipped; the
    forward, the loss and the backward run whole (``calibrate``'s own
    ``unchanged`` also cuts the refinement, which the flow loss refuses)."""
    from ogc_tpu_torch.train.seg import Adam

    step = Adam.step
    Adam.step = lambda self: True
    try:
        yield
    finally:
        Adam.step = step


#: ``altered``: the first pair's last flow replaced by the second pair's
FAULTS = {"unchanged": _unchanged, "altered": calibrate._altered}


def program_cell(spec: dict, seed: int, device, fault=None):
    """A cell through set-up, the check's steps and free: the cell,
    holding the record the check compares."""
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        cell = flow_train.Cell(spec["cfg"], spec["traffic"], seed, device)
        cell.warm()
        cell.free()
    return cell


def readings(spec: dict, seed: int, device, control: bool,
             faults: List[str]) -> List[dict]:
    cell = program_cell(spec, seed, device)
    ref = cell.reference()
    out = [{"seed": seed, "kind": "program",
            "readings": dict(flow_train.gaps(cell.record, ref)),
            "loss_gap_by_step": flow_train.loss_gaps(cell.record, ref)}]
    if control:
        ctrl = cell.reference(calibrate.control_products(spec["traffic"]))
        out.append({"seed": seed, "kind": "control",
                    "readings": dict(flow_train.gaps(ctrl, ref))})
    for f in faults:
        got = program_cell(spec, seed, device, f).record
        out.append({"seed": seed, "kind": f,
                    "readings": dict(flow_train.gaps(got, ref))})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = run.resolve(args.workload)
    if spec["traffic"]["driver"] != "flow_train":
        raise SystemExit(f"{args.workload} is no flow_train cell")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    faults = [f for f in args.faults.split(",") if f]
    lines = []
    for i, seed in enumerate(args.seeds):
        first = i < args.control
        for ln in readings(spec, seed, device, first, faults if first else []):
            lines.append(ln)
            print(json.dumps(ln), flush=True)
    print(json.dumps({"workload": args.workload,
                      "summary": calibrate.summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
