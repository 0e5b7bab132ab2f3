"""The plain reference against the port's CPU path at a tiny size: a whole
run of each cell (set-up, the window, the check) on the CPU comes out
correct."""

import pytest

from ogcbench import run
from ogcbench.tests.tiny import tiny_spec

CELLS = ["seg_train.kittisf", "seg_train.kittisf.exact",
         "flow_infer.kittisf", "flow_infer.kittisf.bf16"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_cpu(workload):
    out = run.run_cell(workload, 2 ** 31 + 12345, 0.0, False, device="cpu",
                       spec=tiny_spec(workload), max_steps=3)
    assert out["correct"], out["checks"]
