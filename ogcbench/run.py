"""The benchmark of ogc_tpu_torch, one cell a run.

    python3 -m ogcbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run: builds or loads the port's kernels (``ogc_tpu_torch/_build/``,
inside the checkout), makes the weights on the card and the traffic from
``--seed``, warms up the cell's shapes (a train cell's first steps are the
steps the check follows), then measures for ``--seconds``: with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
read from a ``torch.profiler`` trace of the window.  After the window it
frees the program's state and compares what the timed path produced with
the plain reference (``ogcbench/reference/``), and prints one JSON line.

Everything of a cell is found by name: the cell in ``BENCHMARK.json``, its
configuration (``ogcbench/configs/<config>.json``), its traffic
(``ogcbench/workloads/<traffic>.json``, whose ``driver`` names
``ogcbench/drivers/<driver>.py``) and each per-layer metric
(``ogcbench/metrics/<quantity>.py``, the name before its first dot).  A run without a card exits 2 and
prints no result; so does one whose process holds JAX or the JAX package
once the window has closed (exit 3).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
HERE = osp.join(ROOT, "ogcbench")
#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "ogc_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(osp.join(root, "BENCHMARK.json"))


def resolve(workload: str, bench: Optional[dict] = None,
            here: str = HERE) -> dict:
    """The cell ``workload``: its entry, configuration, traffic and the
    metrics it reports (end-to-end, per-layer), all found by name."""
    bench = bench or manifest(osp.dirname(here))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"names {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(osp.join(osp.dirname(here), conf["file"]))
    traffic = load_json(osp.join(here, "workloads", cell["traffic"] + ".json"))

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "cfg": cfg, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def base_name(metric: str) -> str:
    """The quantity a metric's name measures, before its first dot: the
    cells of one kind report ``samples_per_s.train``, those of another
    ``samples_per_s.flow``, one quantity under bounds of their own; a
    per-layer metric's reader is ``ogcbench/metrics/<quantity>.py``."""
    return metric.split(".", 1)[0]


def forbidden_modules() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[dict] = None,
             max_steps: Optional[int] = None) -> dict:
    """One run of ``workload``; returns the result line's object.  ``spec``
    replaces ``resolve(workload)`` (the CPU tests shrink sizes with it);
    ``max_steps`` ends the window early (the CPU tests)."""
    import torch

    spec = spec or resolve(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    driver = importlib.import_module("ogcbench.drivers."
                                     + spec["traffic"]["driver"])
    t_cell = time.time()
    cell = driver.Cell(spec["cfg"], spec["traffic"], seed, dev)
    t_warm = time.time()
    cell.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - T_START
    print(f"ogcbench: set-up {setup_s:.3f} s: start to the cell "
          f"{t_cell - T_START:.3f}, the cell (kernels, weights, model, "
          f"traffic) {t_warm - t_cell:.3f}, warm-up "
          f"{time.time() - t_warm:.3f}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    limit = max_steps if max_steps is not None else (
        spec["traffic"]["trace_steps"] if trace else None)
    if trace:
        from ogcbench import trace as tr

        with tr.Recorder(dev) as rec:
            times, window_s = window(cell, seconds, limit, rec.step_span)
        info = device_info(torch, dev)
        rec.replay(cell, len(times))
    else:
        times, window_s = window(cell, seconds, limit)
        info = device_info(torch, dev)
    steps = len(times)
    out: Dict[str, object] = {"attempted": steps * cell.samples_per_step}
    if trace:
        summary = rec.summary(window_s, steps, cell)
        info["busy_s"], info["window_s"] = summary.busy_s, summary.window_s
        metrics = {}
        for m in spec["per_layer"]:
            reader = importlib.import_module("ogcbench.metrics."
                                             + base_name(m["name"]))
            value = reader.read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = summary.breakdown()
    else:
        values = {
            "samples_per_s": steps * cell.samples_per_step / window_s,
            "step_ms_p90": percentile(times, 90) * 1e3,
            "peak_mem_gib": info["memory_peak_bytes"] / 2 ** 30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[base_name(m["name"])],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    cell.free()
    checks = cell.check()
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    # A failed check leaves no sample of the window trusted.
    out.update(correct=correct, failed=0 if correct else out["attempted"],
               metrics=metrics, device=info)
    out["checks"] = {name: {"value": value, "limit": lim}
                     for name, value, lim in checks}
    return out


def window(cell, seconds: float, limit: Optional[int], span=None):
    """Timed steps until ``seconds`` have passed (or ``limit`` steps):
    (each step's seconds, the window's seconds).  Every step ends
    synchronised with the card."""
    times = []
    t0 = t = time.perf_counter()
    while True:
        if span is not None:
            with span():
                cell.step(len(times))
        else:
            cell.step(len(times))
        now = time.perf_counter()
        times.append(now - t)
        t = now
        if now - t0 >= seconds or (limit is not None and len(times) >= limit):
            break
    return times, t - t0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = resolve(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ogcbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   spec=spec)
    found = forbidden_modules()
    if found:
        print(f"ogcbench: the run's process holds {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
