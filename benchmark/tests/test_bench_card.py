"""On the card: each cell, run as the checks run it, comes out correct
with a short window, and a second run finds every kernel built. Skips
without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
