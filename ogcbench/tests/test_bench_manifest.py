"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, the files every entry names, the readers' own layer, unit and
``moves``, and the run length's budget."""

import json
import os.path as osp
import re

import pytest

from ogcbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def test_keys_and_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and osp.isdir(osp.join(ROOT, p))
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert osp.getsize(osp.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_the_check(bench):
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({g["name"] for g in group}) == len(group)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_name_has_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        spec = run.resolve(w["name"], bench)
        used.add(w["config"])
        assert spec["cfg"]["name"] == w["config"]
        assert osp.isfile(osp.join(run.HERE, "drivers",
                                   spec["traffic"]["driver"] + ".py"))
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert "source" in run.load_json(osp.join(ROOT, c["file"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        moves = e2e[m["moves"]]
        # the metric's cells all report the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= set(
            moves.get("workloads", cells))
        reader = __import__(f"ogcbench.metrics.{run.base_name(m['name'])}",
                            fromlist=["read"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], run.base_name(m["moves"]))


def test_result_line_keys_on_the_cpu():
    """A tiny CPU run's line has the contract's keys, ``checks`` last."""
    from ogcbench.tests.tiny import tiny_spec

    out = run.run_cell("flow_infer.kittisf", 3, 0.0, False, device="cpu",
                       spec=tiny_spec("flow_infer.kittisf", n=512, batch=1,
                                      batches=2), max_steps=2)
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"samples_per_s.flow", "step_ms_p90.flow",
                                   "peak_mem_gib", "setup_s"}
    json.dumps(out)
