"""The benchmark's cells at a size a CPU test run holds: each traffic
kind's batch and clips cut, every width and limit as the cell has them."""

from __future__ import annotations

import dataclasses

from portbench import run as harness

SMALL = {
    "train_batches": {"batch": 4, "samples": 4096, "pool": 4},
    "bucketed_enhance": {"batch": 2, "samples": 8000, "pool": 2, "sample_rows": 4},
    "exact_enhance": {"samples": 8000, "pool": 3, "sample_rows": 4},
}
SEED = 2**31 + 11


def cell(name: str, root=harness.ROOT) -> harness.Cell:
    """The cell ``name`` of ``root``'s manifest, its traffic cut to SMALL."""
    c = harness.load_cell(name, root)
    return dataclasses.replace(c, traffic={**c.traffic, **SMALL[c.traffic["kind"]]})


def run(name: str, seconds: float = 0.5, root=harness.ROOT) -> dict:
    """One run of the small cell on the CPU (as many CPU devices as the cell
    asks for chips), past the harness's look for a card."""
    c = cell(name, root)
    return harness.run_cell(c, SEED, seconds, False, ["cpu"] * c.chips, root=root)
