"""The traced window of a ``--trace 1`` run and what the per-layer metrics
read from it.

``Recorder`` runs ``torch.profiler`` (CPU and CUDA activity) around the
window, after 256 guard spin kernels (the trace can miss the first kernels
after it starts; the spins take that loss), and marks the window and each
step with ``record_function`` spans of the benchmark's own.  After the
window, ``Recorder.replay`` takes the window's steps again, untraced, with
every program function that a file of ``ogcbench/work/`` names
(``TARGET``) wrapped to record its calls; the work those calls need is
worked out from them.  The traced window thus holds only the program's own
work, and no recorded tensor stays alive in it.

``Summary`` is what the readers of ``ogcbench/metrics/`` see: the window's
host seconds, the device's busy seconds (the union of the device events'
intervals inside the window), the device events by name, the recorded
calls' least times and the kernel symbols that implement them, and the
step's model products.
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import os.path as osp
import sys
from typing import Dict, List, Tuple

import torch

GUARD_SPINS = 256
WINDOW = "ogcbench.window"
STEP = "ogcbench.step"
#: the benchmark's own spans, which the trace also shows on the device's
#: timeline as annotations; they are no device work
SPANS = "ogcbench."
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by
#: the precision a product runs in.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def peaks() -> Dict[str, float]:
    """FLOP/s by a product's precision, as this process runs float32
    products: 495 TFLOP/s where it finds TF32 on, else 67."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    return {"f32": PEAK_FLOPS["tf32" if tf32 else "f32"],
            "bf16": PEAK_FLOPS["bf16"]}


def work_modules():
    """Every ``ogcbench/work/<function>.py`` that names a program
    function (``TARGET``), with the kernel symbols that implement it: its
    ``KERNELS`` and the lines of any ``work/<function>-<kernel>.txt`` (a
    later kernel of the function adds its symbol as such a file)."""
    here = osp.join(osp.dirname(osp.abspath(__file__)), "work")
    mods = []
    for path in sorted(glob.glob(osp.join(here, "*.py"))):
        name = osp.splitext(osp.basename(path))[0]
        if name.startswith("_"):
            continue
        mod = importlib.import_module(f"ogcbench.work.{name}")
        if hasattr(mod, "TARGET"):
            extra = [ln.strip() for txt in sorted(glob.glob(
                osp.join(here, f"{name}-*.txt"))) for ln in open(txt)
                if ln.strip()]
            mods.append((mod, tuple(mod.KERNELS) + tuple(extra)))
    return mods


def kernel_name(raw: str) -> str:
    """A device event's name without ``void``, the anonymous namespace
    and the argument list."""
    name = raw.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:160]


class _Patch:
    """Wraps one program function in every loaded module that holds it."""

    def __init__(self, mod, calls: List):
        module, attr = mod.TARGET
        self.orig = getattr(importlib.import_module(module), attr)
        self.places = [m for m in list(sys.modules.values())
                       if getattr(m, "__name__", "").startswith(
                           "ogc_tpu_torch")
                       and getattr(m, attr, None) is self.orig]
        self.attr, orig, name = attr, self.orig, mod.__name__

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out

        for k, v in vars(orig).items():  # the launch counters
            setattr(wrapper, k, v)
        self.wrapper = wrapper

    def __enter__(self):
        for m in self.places:
            setattr(m, self.attr, self.wrapper)

    def __exit__(self, *exc):
        for m in self.places:
            setattr(m, self.attr, self.orig)


class Recorder:
    def __init__(self, device: torch.device):
        self.device = device
        self.calls: List = []
        found = work_modules()
        self.mods = {m.__name__: m for m, _ in found}
        self.kernels = {m.__name__: k for m, k in found}
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = self.stack.enter_context(profile(activities=acts))
        if self.device.type == "cuda":
            for _ in range(GUARD_SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        self.stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        self.stack.close()

    def replay(self, cell, steps: int) -> None:
        """The window's steps again, untraced, recording the calls."""
        with contextlib.ExitStack() as stack:
            for m in self.mods.values():
                stack.enter_context(_Patch(m, self.calls))
            for i in range(steps):
                cell.step(i)

    @staticmethod
    def step_span():
        return torch.profiler.record_function(STEP)

    def summary(self, window_s: float, steps: int, cell) -> "Summary":
        from torch.autograd import DeviceType

        events = list(self.prof.profiler.kineto_results.events())
        win = [e for e in events if e.name() == WINDOW
               and e.device_type() == DeviceType.CPU]
        w0 = win[0].start_ns() if win else 0
        w1 = w0 + win[0].duration_ns() if win else 0
        dev, cpu = [], []
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if e.name() not in (WINDOW,) and s >= w0 and s < w1:
                    cpu.append((e.name(), s, s + d))
            elif s >= w0 and s < w1 and not e.name().startswith(SPANS):
                dev.append((kernel_name(e.name()), s, s + d))
        least = []
        for name, args, kwargs, out in self.calls:
            ops, nbytes, kind = self.mods[name].work(args, kwargs, out)
            least.append((name, max(nbytes / HBM_BPS,
                                    ops / PEAK_FLOPS[kind])))
        return Summary(window_s, (w1 - w0) / 1e9, steps, dev, cpu, least,
                       self.kernels, cell.model_products(), peaks())


class Summary:
    def __init__(self, window_s, traced_s, steps, dev, cpu, least, kernels,
                 products, peaks):
        #: the traced window's seconds (the host's, where nothing is traced)
        self.window_s = traced_s or window_s
        self.steps = steps
        self.dev = dev        # (kernel name, start ns, end ns)
        self.cpu = cpu        # (host op, start ns, end ns)
        self.least = least    # (work module, least seconds)
        self.kernels = kernels  # work module -> kernel symbol prefixes
        self.products = products  # [(FLOPs a step, precision)]
        self.peaks = peaks    # precision -> FLOP/s
        self.busy_s = sum(b - a for a, b in self._merged()) / 1e9

    def _merged(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, a, b in sorted(self.dev, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def device_seconds(self, prefixes: Tuple[str, ...]) -> float:
        return sum(b - a for n, a, b in self.dev
                   if n.startswith(prefixes)) / 1e9

    def breakdown(self) -> Dict[str, list]:
        by: Dict[str, float] = {}
        for n, a, b in self.dev:
            by[n] = by.get(n, 0.0) + (b - a) / 1e9
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        merged = self._merged()
        if not merged:
            return {"device_ops": [list(t) for t in top], "idle_gaps": []}
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            host = [c for c in self.cpu if c[1] <= mid < c[2]]
            name = max(host, key=lambda c: c[1])[0] if host else "(none)"
            if name == STEP:
                name = "host code between operators"
            named.append([name[:160], (b - a) / 1e9])
        return {"device_ops": [list(t) for t in top], "idle_gaps": named}


def model_work(products: List[Tuple[float, str]],
               peaks: Dict[str, float]) -> float:
    """The least seconds a step's products take at their peaks."""
    return sum(f / peaks[kind] for f, kind in products)
