"""A short run of each cell on the card: it builds, runs and prints a
correct line with the contract's keys.  Marked ``gpu``: skipped without a
card (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

import tiny

CELLS = ["rfans16_5hz.patrol", "vlp16_10hz.patrol", "rfans16_5hz.survey"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "4294967311", "--seconds", "12", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
