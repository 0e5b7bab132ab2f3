"""The ``flow_train.ogcdr`` cell on the CPU: its traffic, the port's
``FlowTrainer`` against the plain train-mode reference, and the cell's
check against its control and faults.

The rooms (``ogcbench/traffic/room.py``) are numpy and are tested here in
the pytest process: their shapes and ids as ``train_flow``'s dataset
yields them, flows that carry each object rigidly onto its next pose, the
same batches from the same seed.  The torch side runs once in a
subprocess of this file (``python -m tests.test_torch_bench_flow_train
<out.json>``; torch must not share a process with JAX, which
tests/conftest.py imports) at a small size: the ogcdr widths, B = 2 pairs
of 256 points, two steps from the seeded weights.

On the CPU, PyTorch's float32 sqrt is not always correctly rounded, so
some of the port's distances sit one ulp from the reference's, and
train-mode FlowStep3D amplifies that through the refinement (ROADMAP
C.6); so the port is held to the reference relative to the TF32 control
at the same size: the gaps of the port must lie well under the control's,
which rounds the reference's products to TF32.  The factors leave room on
both sides of the readings at this size (first-step loss terms ~1e-3 of
the control's, first gradient ~1/36).  The cell's own limits
(``flow_train.LIMITS``) are the card's, set at the cell's size; here the
cell runs through ``run_cell`` under limits of this size (the control's
gaps over the factors above, and ``CHANGE_GAP``) with ``correct`` true,
and a step that skips Adam, or a flow altered where the model returns
it, makes its check fail under the same limits.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3141592653
#: the port's gap must be under the control's gap over these factors
UNDER_CONTROL = {"loss_gap": 30.0, "grad_gap": 3.0}
#: the parameters' change after two steps: Adam moves every element by
#: about the learning rate, so elements whose gradient is rounding noise
#: take its sign; a skipped update reads 1
CHANGE_GAP = 0.3
TRAFFIC = {"batch": 4, "batches": 3, "n_points": 512}


def _rooms(seed):
    from ogcbench import run
    from ogcbench.traffic import room

    cfg = run.resolve("flow_train.ogcdr")["cfg"]
    return room, room.batches(TRAFFIC, cfg, seed)


def test_room_batches_have_the_datasets_shapes_and_ids():
    _, out = _rooms(SEED)
    assert len(out) == TRAFFIC["batches"]
    pcs, segms, flows, valids = out[0]
    B, N = TRAFFIC["batch"], TRAFFIC["n_points"]
    assert pcs.shape == flows.shape == (B, 4, N, 3)
    assert segms.shape == valids.shape == (B, 4, N)
    assert (pcs.dtype, segms.dtype, flows.dtype) == (np.float32, np.int32,
                                                     np.float32)
    assert (valids == 1).all()
    for b in range(B):
        ids = np.unique(segms[b])
        # compressed object ids, 4-8 objects, the same in both views
        assert ids[0] == 0 and len(ids) == ids[-1] + 1
        assert 4 <= len(ids) <= 8
        assert (segms[b, :2] == segms[b, 2:]).all()


def test_room_flows_carry_each_object_rigidly():
    room, _ = _rooms(SEED)
    rng = np.random.RandomState(7)
    for _ in range(3):
        r = room.Room(rng)
        (pc1, s1), (pc2, s2) = r.frame(0, 1024), r.frame(1, 1024)
        flow = room.compute_flow(pc1, s1, r.poses[0], r.poses[1])
        for k in np.unique(s1):
            a, w = pc1[s1 == k], (pc1 + flow)[s1 == k]
            # a rigid motion keeps every distance within the object
            da = np.linalg.norm(a[:, None] - a[None], axis=-1)
            dw = np.linalg.norm(w[:, None] - w[None], axis=-1)
            assert np.abs(da - dw).max() < 1e-9
        # the warped cloud lies on the moved objects: nearer to frame 2
        # than the unwarped one
        near = np.linalg.norm((pc1 + flow)[:, None] - pc2[None], axis=-1)
        far = np.linalg.norm(pc1[:, None] - pc2[None], axis=-1)
        assert near.min(1).mean() < far.min(1).mean()


def test_room_batches_are_the_same_from_the_same_seed():
    _, a = _rooms(SEED)
    _, b = _rooms(SEED)
    _, c = _rooms(SEED + 1)
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    assert not np.array_equal(a[0][0], c[0][0])


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bench_flow_train") / "out.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    proc = subprocess.run([sys.executable, "-m",
                           "tests.test_torch_bench_flow_train", out],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("number", sorted(UNDER_CONTROL))
def test_port_is_nearer_the_reference_than_the_control(got, number):
    prog, ctrl = got["program"][number], got["control"][number]
    assert prog * UNDER_CONTROL[number] < ctrl, (prog, ctrl)


def test_port_moves_the_parameters_as_the_reference_does(got):
    assert got["program"]["change_gap"] < CHANGE_GAP


def test_flow_train_cell_is_correct(got):
    assert got["cell"]["correct"], got["cell"]["checks"]


def test_port_reads_every_loss_term_of_the_reference(got):
    assert got["terms"] == [f"{k}_loss_#{i}" for i in range(4)
                            for k in ("chamfer", "smooth")]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_step_with_a_fault_is_not_correct(got, fault):
    assert any(v > lim for v, lim in got["faults"][fault]), \
        got["faults"][fault]


# ---------------------------------------------------------------------------
# torch side (``python -m tests.test_torch_bench_flow_train <out.json>``)
# ---------------------------------------------------------------------------


def main(path: str) -> None:
    import torch

    from ogcbench import calibrate, run
    from ogcbench import calibrate_flow_train as cf
    from ogcbench.drivers import flow_train
    from ogcbench.reference.nn import TF32Products
    from ogcbench.tests.tiny import tiny_spec

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    spec = tiny_spec("flow_train.ogcdr", n=256, batch=2, batches=3)
    spec["traffic"]["check_steps"] = 2
    assert calibrate.control_products(spec["traffic"]).__class__ \
        is TF32Products
    cell = cf.program_cell(spec, SEED, cpu)
    ref = cell.reference()
    prog = dict(flow_train.gaps(cell.record, ref))
    ctrl = dict(flow_train.gaps(cell.reference(TF32Products()), ref))
    # the limits of this size, in place of the card's
    limits = {n: ctrl[n] / f for n, f in UNDER_CONTROL.items()}
    limits["change_gap"] = CHANGE_GAP
    card = dict(flow_train.LIMITS)
    flow_train.LIMITS.update(limits)
    try:
        out = run.run_cell("flow_train.ogcdr", SEED, 0.0, False,
                           device="cpu", spec=spec, max_steps=1)
        faults = {f: [(v, flow_train.LIMITS[n]) for n, v in flow_train.gaps(
            cf.program_cell(spec, SEED, cpu, f).record, ref)]
            for f in ("unchanged", "altered")}
    finally:
        flow_train.LIMITS.update(card)
    got = {"cell": {"correct": out["correct"], "checks": out["checks"]},
           "program": prog, "control": ctrl,
           "terms": sorted(ref["losses"][0], key=lambda t: (t[-1], t)),
           "faults": faults}
    with open(path, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1])
