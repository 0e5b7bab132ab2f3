"""Discovery by name: a configuration, a cell (its traffic) and a
per-layer metric, added as new files and new BENCHMARK.json entries in a
copy of the benchmark, run without an edit to any file that was there."""

import hashlib
import json
import os
import os.path as osp
import shutil
import subprocess
import sys

from ogcbench import run

READER = '''"""Host operations a step in the traced window."""

LAYER = "trainer"
UNIT = "ops/step"
MOVES = "samples_per_s"


def read(s):
    return len(s.cpu) / s.steps if s.cpu and s.steps else None
'''


def digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = osp.join(d, f)
                out[osp.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_files_and_entries_run_unedited(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "ogcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(osp.join(run.ROOT, "BENCHMARK.json"), root)
    before = digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "ogcbench/configs/maskformer3d-kittisf.json")
                     .read_text())
    cfg.update(name="maskformer3d-small")
    cfg["segnet"]["n_point"] = 512
    (root / "ogcbench/configs/maskformer3d-small.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "ogcbench/workloads/seg_train.json")
                         .read_text())
    traffic.update(batch=1, n_points=512, batches=2, check_steps=1,
                   trace_steps=1)
    (root / "ogcbench/workloads/seg_train_small.json").write_text(
        json.dumps(traffic))
    (root / "ogcbench/metrics/host_ops_per_step.py").write_text(READER)
    bench["configs"].append({
        "name": "maskformer3d-small", "source": "a test's copy",
        "file": "ogcbench/configs/maskformer3d-small.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({
        "name": "seg_train.small", "config": "maskformer3d-small",
        "traffic": "seg_train_small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"].endswith(".train"):
            m["workloads"].append("seg_train.small")
    bench["per_layer"].append({
        "name": "host_ops_per_step", "unit": "ops/step", "better": "lower",
        "source": "host_clock", "layer": "trainer",
        "moves": "samples_per_s.train", "workloads": ["seg_train.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\nfrom ogcbench import run\n"
            "out = [run.run_cell('seg_train.small', 9, 0.0, t,"
            " device='cpu', max_steps=1) for t in (False, True)]\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=run.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"], traced["checks"]
    assert set(plain["metrics"]) == {"samples_per_s.train",
                                     "step_ms_p90.train", "peak_mem_gib",
                                     "setup_s"}
    assert traced["metrics"]["host_ops_per_step"]["value"] > 0
    after = digest(root)
    assert all(after[k] == v for k, v in before.items() if k !=
               "BENCHMARK.json")
