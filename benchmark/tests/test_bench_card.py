"""A short run of each cell on the card, through the command the checks
run (``python3 benchmark/run.py``); skipped where no CUDA device is."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from vbench.spec import Spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in Spec().data["workloads"]])
def test_cell_on_the_card(cell, card):
    got = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483901", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-4000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
