"""The benchmark on the card: each cell for a short window, as the driver
runs it, comes out correct. Skipped without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

import common


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in common.benchmark_file()["workloads"]])
def test_cell_runs_correct(cuda, cell):
    out = subprocess.run([sys.executable, os.path.join("benchmark", "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
