"""On the card: one short run of each cell through the command line, as
the benchmark is run (python3 -m benchmark.run from the checkout's root).
Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import benchmark.run as R


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["m3500-perstep", "city10k-stream"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", "4000000001", "--seconds", "1", "--trace", str(trace)],
        cwd=R.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
