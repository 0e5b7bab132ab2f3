"""The port's span recorder (``ogc_tpu_torch/utils/trace.py``) on the CPU.

Off (no profiler running) ``span`` is one shared null context and records
nothing; under ``torch.profiler`` spans nest by thread with their parent
and step, stamped on the profiler's own clock; a tiny ``SegTrainer``
step records its phases and returns bit-equal results with the profiler
on and off; a ``dp_eval_fwd`` batch records its copy and readback.

torch must not share a process with JAX (tests/conftest.py imports jax),
so the torch side runs once in a subprocess of this file
(``python -m tests.test_torch_trace <out.json>``) and the tests read its
JSON."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import Counter

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (span, its parent's name) pairs of one tiny augmented train step: two
#: inputs copied, four clouds' Kabsch fits, two invariance pairs, each
#: matched both ways
TRAIN_TREE = Counter({
    ("train.step", None): 1, ("train.h2d", "train.step"): 1,
    ("sync.to_device", "train.h2d"): 2,
    ("sync.kabsch_svd", "train.step"): 4,
    ("loss.match", "train.step"): 4,
    ("sync.permute_cols", "train.step"): 4,
    ("sync.match_argmax", "loss.match"): 8,
    ("train.optimizer", "train.step"): 1,
    ("sync.finite_guard", "train.optimizer"): 1,
    ("sync.loss_terms", "train.step"): 1,
    ("sync.masks_out", "train.step"): 1,
})


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_trace") / "out.json")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("OGC_EXACT_NEIGHBORS", None)
    proc = subprocess.run([sys.executable, "-m", "tests.test_torch_trace",
                           out], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def tree(spans):
    return Counter((s[0], None if s[3] is None else spans[s[3]][0])
                   for s in spans)


def test_off_is_one_shared_null_and_records_nothing(got):
    assert got["off"] == {"shared": True, "spans": []}


def test_spans_nest_by_thread_with_parent_and_step(got):
    main, other = got["nest"]["main"], got["nest"]["other"]
    spans = got["nest"]["spans"]
    assert [s[0] for s in spans] == ["train.step", "a", "b", "c",
                                     "flow.batch", "d", "e"]
    step, a, b, c, flow, d, e = spans
    assert [s[3] for s in spans] == [None, 0, 1, 0, None, 4, None]
    assert step[4] == a[4] == b[4] == c[4]
    assert flow[4] == d[4] != step[4] and e[4] is None
    assert {s[5] for s in spans[:4]} == {main}
    assert {s[5] for s in spans[4:]} == {other} != {main}
    for s in spans:
        assert s[1] <= s[2]
    for child in (a, b, c, d):
        parent = spans[child[3]]
        assert parent[1] <= child[1] and child[2] <= parent[2]


def test_span_holds_its_op_on_the_profilers_clock(got):
    span, op = got["clock"]["span"], got["clock"]["op"]
    assert op is not None
    assert span[0] <= op[0] and op[1] <= span[1]


def test_train_step_records_its_phases_one_step(got):
    spans = got["train"]["spans"]
    assert tree(spans) == TRAIN_TREE
    assert len({s[4] for s in spans}) == 1 and spans[0][4] is not None


def test_train_step_is_bit_equal_with_the_profiler_on(got):
    assert got["train"]["equal"] == {"loss_terms": True, "segm": True,
                                     "mask": True, "params": True,
                                     "moments": True}


def test_eval_batch_records_copy_and_readback(got):
    spans = got["eval"]["spans"]
    assert tree(spans) == Counter({("flow.batch", None): 1,
                                   ("flow.h2d", "flow.batch"): 1,
                                   ("sync.flow_in", "flow.h2d"): 1,
                                   ("sync.flow_out", "flow.batch"): 1})
    assert got["eval"]["equal"]


# ---------------------------------------------------------------------------
# torch side (``python -m tests.test_torch_trace <out.json>``)
# ---------------------------------------------------------------------------


def _off():
    from ogc_tpu_torch.utils import trace

    trace.clear()
    a, b = trace.span("train.step", step=True), trace.span("x")
    with a, b:
        pass
    return {"shared": a is b, "spans": trace.spans()}


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    from ogc_tpu_torch.utils import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return trace.spans(), prof, out


def _nest():
    import threading

    from ogc_tpu_torch.utils.trace import span

    def other():
        with span("flow.batch", step=True):
            with span("d"):
                pass
        with span("e"):
            pass

    def run():
        with span("train.step", step=True):
            with span("a"):
                with span("b"):
                    pass
            with span("c"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        return t.ident

    spans, _, ident = _profiled(run)
    return {"spans": spans, "main": threading.get_ident(), "other": ident}


def _clock():
    import torch

    from ogc_tpu_torch.utils.trace import span

    x = torch.randn(256, 256)

    def run():
        with span("mm"):
            torch.mm(x, x)

    spans, prof, _ = _profiled(run)
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    return {"span": spans[0][1:3], "op": ops[0] if ops else None}


def _train():
    import numpy as np
    import torch

    from ogcbench.drivers import seg_train
    from ogcbench.tests.tiny import tiny_spec

    spec = tiny_spec("seg_train.kittisf", n=256, batch=2, batches=1)
    cpu = torch.device("cpu")

    def step(cell):
        return cell.trainer.train_it(cell.it, cell.batches[0],
                                     aug_transform=True)

    runs = []
    for profiled in (False, True):
        cell = seg_train.Cell(spec["cfg"], spec["traffic"], 31, cpu)
        if profiled:
            spans, _, out = _profiled(lambda: step(cell))
        else:
            out = step(cell)
        opt = cell.optimizer
        runs.append((out, {k: p.detach().clone() for k, p in
                           cell.trainer.model.named_parameters()},
                     {k: (opt.mu[k].clone(), opt.nu[k].clone())
                      for k in opt.mu}))
        cell.free()
    (ld0, segm0, mask0), p0, m0 = runs[0]
    (ld1, segm1, mask1), p1, m1 = runs[1]
    equal = {
        "loss_terms": ld0 == ld1,
        "segm": bool(np.array_equal(segm0, segm1)),
        "mask": bool(np.array_equal(mask0, mask1)),
        "params": all(torch.equal(p0[k], p1[k]) for k in p0),
        "moments": all(torch.equal(m0[k][0], m1[k][0])
                       and torch.equal(m0[k][1], m1[k][1]) for k in m0),
    }
    return {"spans": spans, "equal": equal}


def _eval():
    import numpy as np
    import torch

    from ogc_tpu_torch.parallel import mesh

    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 4)
    fwd = mesh.dp_eval_fwd(lambda m, x: m(x), [torch.device("cpu")], lin)
    x = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(
        np.float32)
    plain = fwd(x)
    spans, _, out = _profiled(lambda: fwd(x))
    return {"spans": spans, "equal": bool(np.array_equal(plain, out))}


def main(path: str) -> None:
    got = {"off": _off(), "nest": _nest(), "clock": _clock(),
           "train": _train(), "eval": _eval()}
    with open(path, "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1])
