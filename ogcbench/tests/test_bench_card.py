"""On the card (``python -m pytest ogcbench/tests -m card``): a short run
of each cell through the command, correct, with its metrics."""

import json
import subprocess
import sys

import pytest

from ogcbench import run


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      run.manifest()["workloads"]])
def test_a_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "ogcbench.run", "--workload",
                          workload, "--seed", "77", "--seconds", "3",
                          "--trace", "0"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["samples_per_s"]["value"] > 0
