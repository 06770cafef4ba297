"""Card-only: one short run of each cell through the command, as the check
runs it (``pytest perfbench/tests -m card`` on a machine with an H100)."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import registry


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "2147483901", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=registry.REPO, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
