"""One short run of each cell on the card (``-m gpu``; skips without one)."""
import json
import subprocess
import sys

import pytest

from bench import spec
from conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace, cuda_device):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    for name, m in res["metrics"].items():
        if m["unit"] == "%" and not name.startswith("device_idle"):
            assert 0 < m["value"] <= 100.0
