"""The span readers (``metrics/{loss,optimizer,dispatch,h2d}_idle_ms``,
``metrics/syncs_per_step``, over ``spans.py``): hand-computed values on a
hand-built window, a traced tiny CPU run of a train and a flow cell, and
on the card, the program's spans and the device's events on one clock."""

import importlib

import pytest
import torch

from ogcbench import run, spans
from ogcbench.trace import STEP, Summary
from ogcbench.tests.tiny import tiny_spec

MS = 10 ** 6  # ns
READERS = ("loss_idle_ms", "optimizer_idle_ms", "syncs_per_step",
           "dispatch_idle_ms", "h2d_idle_ms")


def summary(steps=2):
    """Two steps of 1000 ms; the device busy over [100, 300], [500, 600],
    [1100, 1500] and [1900, 2100] ms: idle [0, 100], [300, 500],
    [600, 1100] and [1500, 1900] inside the steps' range."""
    dev = [("k", a * MS, b * MS) for a, b in
           ((100, 300), (500, 600), (1100, 1500), (1900, 2100))]
    cpu = [(STEP, 0, 1000 * MS), ("aten::mm", 20 * MS, 30 * MS),
           (STEP, 1000 * MS, 2000 * MS)]
    return Summary(2.0, 2.0, steps, dev, cpu, [], {}, [], {})


#: (name, start ms, end ms, parent, step); each span's own idle ms beside
SPANS = [
    ("train.step", 10, 990, None, 0),        # 680 - 90 - 300 - 280 = 10
    ("train.h2d", 10, 120, 0, 0),            # 90 - 50 = 40
    ("sync.to_device", 50, 110, 1, 0),       # 50
    ("loss.match", 250, 700, 0, 0),          # 300 - 50 = 250
    ("sync.match_argmax", 250, 350, 3, 0),   # 50
    ("train.optimizer", 700, 980, 0, 0),     # 280 - 20 = 260
    ("sync.finite_guard", 700, 720, 5, 0),   # 20
    ("train.step", 1010, 1990, None, 1),     # 490 - 100 = 390
    ("loss.match", 1500, 1600, 7, 1),        # 100
    ("loss.match", 3000, 3100, None, None),  # outside the steps: left out
    ("train.step", 2500, None, None, 2),     # still open: left out
]


def program(rows):
    return [(n, a * MS, None if b is None else b * MS, p, s, 1)
            for n, a, b, p, s in rows]


def read(name, s):
    return importlib.import_module(f"ogcbench.metrics.{name}").read(s)


@pytest.mark.parametrize("name,want", [
    ("loss_idle_ms", (250 + 100) / 2), ("optimizer_idle_ms", 260 / 2),
    ("syncs_per_step", 3 / 2), ("dispatch_idle_ms", (10 + 390) / 2),
    ("h2d_idle_ms", 40 / 2)])
def test_reader_on_a_hand_built_window(monkeypatch, name, want):
    monkeypatch.setattr(spans, "program_spans", lambda: program(SPANS))
    assert read(name, summary()) == pytest.approx(want)


def test_own_idle_splits_the_steps_idle():
    rows = spans.own_idle(summary(), program(SPANS))
    assert [ns / MS for _, ns in rows] == [10, 40, 50, 250, 50, 260, 20,
                                           390, 100]
    assert sum(ns for _, ns in rows) == (680 + 490) * MS


def test_flow_batch_is_a_step_span(monkeypatch):
    rows = [("flow.batch", 0, 1000, None, 0), ("flow.h2d", 0, 50, 0, 0),
            ("sync.flow_in", 20, 50, 1, 0), ("sync.flow_out", 900, 1000, 0,
                                             0)]
    monkeypatch.setattr(spans, "program_spans", lambda: program(rows))
    s = summary(steps=1)
    # idle in [0, 1000]: 100 + 200 + 400 = 700; flow.h2d 50, its sync 30;
    # the readback's [900, 1000] is idle
    assert read("dispatch_idle_ms", s) == pytest.approx(700 - 50 - 100)
    assert read("h2d_idle_ms", s) == pytest.approx(20)
    assert read("syncs_per_step", s) == pytest.approx(2)


@pytest.mark.parametrize("found", [[], program(SPANS[9:])])
def test_no_span_reads_none(monkeypatch, found):
    monkeypatch.setattr(spans, "program_spans", lambda: found)
    assert all(read(name, summary()) is None for name in READERS)


def test_no_step_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: program(SPANS))
    s = summary()
    s.cpu = [c for c in s.cpu if c[0] != STEP]
    assert all(read(name, s) is None for name in READERS)


@pytest.mark.parametrize("workload,syncs", [("seg_train.kittisf", 21),
                                            ("flow_infer.kittisf", 3)])
def test_a_traced_cpu_run_reports_every_span_metric(workload, syncs):
    spec = tiny_spec(workload, n=512, batch=1)
    out = run.run_cell(workload, 5, 0.0, True, device="cpu", spec=spec,
                       max_steps=2)
    listed = {m["name"] for m in spec["per_layer"]
              if run.base_name(m["name"]) in READERS}
    assert len(listed) == (5 if workload.startswith("seg") else 3)
    assert listed <= set(out["metrics"])
    kind = workload.split("_")[0].replace("seg", "train")
    assert out["metrics"][f"syncs_per_step.{kind}"]["value"] == syncs


# ---------------------------------------------------------------------------
# on the card: the spans' clock is the device events'
# ---------------------------------------------------------------------------


def device_events(prof):
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU]


@pytest.mark.card
def test_a_kernel_lies_inside_its_spans_on_the_card(card):
    from torch.profiler import ProfilerActivity, profile

    from ogc_tpu_torch.utils import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):  # the trace can miss its first kernels
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with trace.span("launch"):
            torch.cuda._sleep(20_000_000)
        with trace.span("sync.wait"):
            torch.cuda.synchronize()
    launch, wait = trace.spans()
    sleep = max(device_events(prof), key=lambda e: e[2] - e[1])
    assert sleep[2] - sleep[1] > 5 * 10 ** 6
    assert launch[1] <= sleep[1] and sleep[2] <= wait[2]
    assert wait[1] < sleep[2]  # the host waited while it ran


@pytest.mark.card
def test_a_train_steps_kernels_lie_inside_its_span_on_the_card(card):
    from torch.profiler import ProfilerActivity, profile

    from ogc_tpu_torch.utils import trace
    from ogcbench.drivers import seg_train

    spec = tiny_spec("seg_train.kittisf", n=1024, batch=2)
    cell = seg_train.Cell(spec["cfg"], spec["traffic"], 7, card)
    cell.warm()
    torch.cuda.synchronize()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        cell.step(0)  # ends synchronised: it reads the masks back
    steps = [sp for sp in trace.spans() if sp[0] == "train.step"]
    assert len(steps) == 1
    _, a, b = steps[0][:3]
    kernels = [e for e in device_events(prof) if e[1] >= a]
    assert len(kernels) > 100
    assert all(e[2] <= b for e in kernels)
    syncs = [sp for sp in trace.spans() if sp[0].startswith("sync.")]
    assert len(syncs) == 21
    cell.free()


@pytest.mark.card
@pytest.mark.parametrize("workload", ["seg_train.kittisf",
                                      "flow_infer.kittisf"])
def test_every_wait_of_a_step_lies_in_a_sync_span_on_the_card(card,
                                                               workload):
    """The sync spans are complete: each synchronising call that the
    card's sync debug mode reports in a step of the cell, at its size, is
    made inside one."""
    import warnings
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from ogc_tpu_torch.utils import trace

    spec = run.resolve(workload)
    driver = importlib.import_module("ogcbench.drivers."
                                     + spec["traffic"]["driver"])
    cell = driver.Cell(spec["cfg"], spec["traffic"], 11, card)
    cell.warm()
    torch.cuda.synchronize()
    waits, outside = [], []

    def show(message, *args, **kwargs):
        if "called a synchronizing" not in str(message):
            return  # e.g. the mode's own notice, once a process
        stack = getattr(trace._LOCAL, "stack", None)
        name = stack[-1][0][stack[-1][1]][0] if stack else None
        waits.append(name)
        if not (name or "").startswith("sync."):
            outside.append((name, str(message)[:120]))

    with profile(activities=[ProfilerActivity.CPU]), \
            warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.step(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    cell.free()
    assert not outside, outside
    assert len(waits) == (25 if workload.startswith("seg") else 3), \
        Counter(waits)
