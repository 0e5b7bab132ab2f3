"""Each cell's control, and each fault its timed path can have, make
``correct`` come out false, at a size a CPU run holds.

The control is the reference put in the program's place in the precision
below the cell's (float32 -> TF32, bf16 -> float8 e4m3); the faults are
planted in the program (``calibrate.FAULTS``): a step that returns its
state unchanged, half of the batch left out (training), an answer altered
where it is produced (inference).  The check's own code, limits and
reference are the run's."""

import pytest
import torch

from ogcbench import calibrate, run
from ogcbench.drivers import flow_infer, seg_train
from ogcbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")
SEED = 4242


def fails(driver, traffic, got, ref):
    limits = (seg_train.LIMITS if driver is seg_train
              else flow_infer.LIMITS[traffic["compute_dtype"]])
    return any(v > limits[n] for n, v in driver.gaps(got, ref)
               if n in limits)


@pytest.mark.parametrize("workload", ["seg_train.kittisf",
                                      "seg_train.kittisf.exact",
                                      "flow_infer.kittisf",
                                      "flow_infer.kittisf.bf16"])
def test_control_is_not_correct(workload):
    spec = tiny_spec(workload)
    drv = seg_train if spec["traffic"]["driver"] == "seg_train" \
        else flow_infer
    cell = calibrate.program_cell(spec, SEED, CPU, 0.0)
    ref = cell.reference()
    ctrl = cell.reference(calibrate.control_products(spec["traffic"]))
    assert fails(drv, spec["traffic"], ctrl, ref)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("seg_train.kittisf", "seg_train.kittisf.exact")
    for f in ("unchanged", "half")] + [
    (w, f) for w in ("flow_infer.kittisf", "flow_infer.kittisf.bf16")
    for f in ("unchanged", "altered")])
def test_a_run_with_a_fault_is_not_correct(workload, fault):
    spec = tiny_spec(workload, batch=4 if fault == "half" else 2)
    with calibrate.FAULTS[fault]():
        out = run.run_cell(workload, SEED, 0.0, False, device="cpu",
                           spec=spec, max_steps=3)
    assert out["correct"] is False, out["checks"]
