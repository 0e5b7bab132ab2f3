"""The import guard: no module the benchmark runs imports a module whose
top-level name, compared whole, is ``jax``, ``jaxlib``, ``flax`` or
``ogc_tpu`` (the port's name begins with the JAX package's, so names are
compared whole), and the reference imports nothing of ``ogc_tpu_torch``;
a run's process holds none of them once its window has closed."""

import ast
import glob
import os.path as osp
import subprocess
import sys

from ogcbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "ogc_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    return [p for p in glob.glob(osp.join(run.HERE, sub, "**", "*.py"),
                                 recursive=True)
            if "/tests/" not in p]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        bad = top_level_imports(path) & (FORBIDDEN | {"ogc_tpu_torch"})
        assert not bad, f"{path} imports {bad}"


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ogc_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ogc_tpu.ops", sys)
    assert run.forbidden_modules() == ["ogc_tpu.ops"]


def test_a_run_process_holds_no_forbidden_module():
    code = (
        "import sys\n"
        "from ogcbench import run\n"
        "from ogcbench.tests.tiny import tiny_spec\n"
        "spec = tiny_spec('seg_train.kittisf', n=512, batch=1, batches=3)\n"
        "spec['traffic']['check_steps'] = 1\n"
        "run.run_cell('seg_train.kittisf', 5, 0.0, False, device='cpu',"
        " spec=spec, max_steps=1)\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "ogcbench.run", "--workload",
                          "flow_infer.kittisf", "--seed", "1", "--seconds",
                          "1"], cwd=run.ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin",
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == ""
