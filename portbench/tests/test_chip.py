"""On the card: each cell runs briefly and comes out correct, and its
control at the cell's own size, on three seeds, comes out not correct.

    python3 -m pytest portbench/tests/test_chip.py -q -p no:cacheprovider   (on the card)
"""

import json
import os
import subprocess
import sys

import pytest

import calibrate
from yardstick import manifest

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2718281829",
         "--seconds", "3", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    lines = calibrate.main(["--workload", cell, "--seeds", "0", "--control", "3", "--seconds", "1"],
                           device=card)
    cfg = manifest.config(BENCH, manifest.cell(BENCH, cell)["config"])
    loop = manifest.traffic(manifest.cell(BENCH, cell)["traffic"])["loop"]
    limits = cfg["check"][loop]["limits"]
    assert all(any(v > limits[k] for k, v in ln["readings"].items()) for ln in lines)
