"""One short run of each cell on a card (marker ``gpu``; each skips without
one). Run on a card with

    python -m pytest -o addopts='' -p no:cacheprovider -m gpu portbench/tests
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "1", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
