"""Each cell's control, the reference one precision below the
configuration's put in the program's place, comes out not correct at a
small size: at least one compared number past its limit."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run as harness
from portbench.tests import small

torch.set_num_threads(2)

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 3, 2**33 + 5, 3 * 2**31 + 7])
def test_the_control_fails_a_limit(name, seed, tmp_path):
    cell = small.cell(name)
    run = harness.Run(cell, seed, ["cpu"], tmp_path, False)
    numbers = harness.kind_module(cell).control(run)
    limits = cell.workload["limits"]
    assert any(value > limits[k] for k, (value, _) in numbers.items()), numbers
