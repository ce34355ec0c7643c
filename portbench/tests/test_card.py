"""Each one-card cell, briefly, through the benchmark's command on the
card (skipped without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import run as harness

ONE_CARD = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())[
    "workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_cell_runs_on_the_card(cell, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    done = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed",
                           str(2**31 + 7), "--seconds", "2", "--trace", str(traced)],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
