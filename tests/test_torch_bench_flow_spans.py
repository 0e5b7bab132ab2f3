"""The flow-training cell's spans and the ``.pool`` cell, on the CPU.

A profiled ``FlowTrainer`` step (the ``flow_train.ogcdr`` cell's trainer
at a tiny size) records its phases, one step id, and returns bit-equal
results with the profiler on and off; a traced window of the cell gives
numbers to the two readers that split its idle time
(``unroll_idle_ms``, ``flow_loss_idle_ms``) beside the other span readers;
and the ``flow_infer.kittisf.pool`` cell, which turns the row-group pool
on, runs through ``run_cell`` with ``correct`` true and gives the pool the
environment's mode back when it frees.

torch must not share a process with JAX (tests/conftest.py imports jax),
so the torch side runs once in a subprocess of this file
(``python -m tests.test_torch_bench_flow_spans <out.json>``) and the tests
read its JSON."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import Counter

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2718281829

#: (span, its parent's name) pairs of one flow-train step: three inputs
#: copied, the unrolled forward, the flow loss, Adam with its finite
#: guard, the loss terms read back
FLOW_TREE = Counter({
    ("train.step", None): 1, ("train.h2d", "train.step"): 1,
    ("sync.to_device", "train.h2d"): 3,
    ("flow.unroll", "train.step"): 1, ("loss.flow", "train.step"): 1,
    ("train.optimizer", "train.step"): 1,
    ("sync.finite_guard", "train.optimizer"): 1,
    ("sync.loss_terms", "train.step"): 1,
})


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bench_flow_spans") / "out.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    env.pop("OGC_PALLAS_POOL", None)
    proc = subprocess.run([sys.executable, "-m",
                           "tests.test_torch_bench_flow_spans", out],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def tree(spans):
    return Counter((s[0], None if s[3] is None else spans[s[3]][0])
                   for s in spans)


def test_flow_train_step_records_its_phases_one_step(got):
    spans = got["step"]["spans"]
    assert tree(spans) == FLOW_TREE
    assert len({s[4] for s in spans}) == 1 and spans[0][4] is not None


def test_flow_train_step_is_bit_equal_with_the_profiler_on(got):
    assert got["step"]["equal"] == {"loss_terms": True, "params": True,
                                    "moments": True, "running": True}


@pytest.mark.parametrize("metric", ["unroll_idle_ms.train",
                                    "flow_loss_idle_ms.train",
                                    "dispatch_idle_ms.train",
                                    "optimizer_idle_ms.train",
                                    "h2d_idle_ms.train"])
def test_traced_window_reads_each_idle_split(got, metric):
    assert got["traced"]["metrics"][metric]["value"] >= 0.0


def test_traced_window_counts_five_syncs_a_step(got):
    assert got["traced"]["metrics"]["syncs_per_step.train"]["value"] == 5.0


def test_pool_cell_is_correct_and_gives_the_mode_back(got):
    pool = got["pool"]
    assert pool["correct"], pool["checks"]
    assert pool["mode_in_cell"] == "on" and pool["mode_after"] == "off"


# ---------------------------------------------------------------------------
# torch side (``python -m tests.test_torch_bench_flow_spans <out.json>``)
# ---------------------------------------------------------------------------


def _step():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ogc_tpu_torch.utils import trace
    from ogcbench.drivers import flow_train
    from ogcbench.tests.tiny import tiny_spec

    spec = tiny_spec("flow_train.ogcdr", n=256, batch=2, batches=1)
    runs = []
    for profiled in (False, True):
        cell = flow_train.Cell(spec["cfg"], spec["traffic"], SEED,
                               torch.device("cpu"))
        trace.clear()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                ld = cell.trainer.train_it(0, cell.batches[0])
            spans = trace.spans()
        else:
            ld = cell.trainer.train_it(0, cell.batches[0])
        model, opt = cell.trainer.model, cell.optimizer
        runs.append((ld, {k: p.detach().clone()
                          for k, p in model.named_parameters()},
                     {k: (opt.mu[k].clone(), opt.nu[k].clone())
                      for k in opt.mu},
                     {k: b.clone() for k, b in model.named_buffers()}))
        cell.free()
    (l0, p0, m0, b0), (l1, p1, m1, b1) = runs
    equal = {
        "loss_terms": l0 == l1,
        "params": all(torch.equal(p0[k], p1[k]) for k in p0),
        "moments": all(torch.equal(m0[k][0], m1[k][0])
                       and torch.equal(m0[k][1], m1[k][1]) for k in m0),
        "running": all(torch.equal(b0[k], b1[k]) for k in b0),
    }
    return {"spans": spans, "equal": equal}


def _traced():
    from ogcbench import run
    from ogcbench.tests.tiny import tiny_spec

    spec = tiny_spec("flow_train.ogcdr", n=256, batch=2, batches=2)
    spec["traffic"]["check_steps"] = 1
    return run.run_cell("flow_train.ogcdr", SEED, 0.0, True, device="cpu",
                        spec=spec, max_steps=2)


def _pool():
    from ogc_tpu_torch.ops import pool
    from ogcbench import run
    from ogcbench.drivers import flow_infer_pool
    from ogcbench.tests.tiny import tiny_spec

    seen = {}
    init = flow_infer_pool.Cell.__init__

    def spy(self, *args):
        init(self, *args)
        seen["mode"] = pool._MODE

    flow_infer_pool.Cell.__init__ = spy
    try:
        spec = tiny_spec("flow_infer.kittisf.pool", n=512, batch=1,
                         batches=2)
        out = run.run_cell("flow_infer.kittisf.pool", SEED, 0.0, False,
                           device="cpu", spec=spec, max_steps=2)
    finally:
        flow_infer_pool.Cell.__init__ = init
    return {"correct": out["correct"], "checks": out["checks"],
            "mode_in_cell": seen["mode"], "mode_after": pool._MODE}


def main(path: str) -> None:
    import torch

    torch.set_num_threads(2)
    got = {"step": _step(), "traced": _traced(), "pool": _pool()}
    with open(path, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1])
