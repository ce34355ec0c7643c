"""The numbers that decide ``correct``, each the program's gap from the
plain reference.

Training (the first steps, which set-up drives through the window's own
call): ``loss_gap``, the largest relative gap of a step's loss over the
cell's ``loss_steps`` first steps (every step's beside it);
``grad_gap``, the worst leaf's gap between the norms of the first step's
gradient as Adam gets it (after clipping); ``change_gap``, the gap between
the norms of a leaf's change over the steps, at the worst leaf or, where
the cell's ``change_leaf`` says so, at the median leaf (the other beside
it). A leaf's gap is measured against the reference's norm of that leaf or
of the median leaf, whichever is larger, since some gradients are all but
zero. Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone and are left out of
``change_gap``.

A cell takes the change at the median leaf, and its loss at the first step
alone, only where the worst leaf's change and the later steps' losses swing
from seed to seed by the noise of single leaves: a leaf whose gradient is
near Adam's epsilon (1e-8), as Fast FullSubNet's bottleneck's recurrent
weights are under a mostly silent ReLU head, moves in proportion to a
gradient that is itself a sum cancelling to rounding, so its change, and
the losses after it, differ between two correct summation orders by a few
percent of that leaf on a few seeds.

Enhancement: ``wave_gap``, the largest gap of a compared clip, its largest
sample error over the reference clip's peak.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

# a leaf moves by rounding alone below this share of the median gradient
STILL_LEAF = 1e-3


def worst(gaps) -> tuple[float, str]:
    """The largest (gap, where) pair; a gap that is not finite first."""
    gaps = list(gaps)
    return next((g for g in gaps if not math.isfinite(g[0])), None) or max(gaps)


def leaf_gap(program: dict, reference: dict, leaves=None) -> tuple[float, str]:
    """The worst leaf's gap and its name."""
    med = statistics.median(reference.values())
    return worst((abs(program[k] - reference[k]) / max(reference[k], med), k)
                 for k in (reference if leaves is None else leaves))


def change_gap(program: dict, reference: dict, leaves, at: str) -> tuple[float, str]:
    """The gap of the leaves' changes at the ``at`` ("worst" or "median")
    leaf, and the other beside it."""
    med = statistics.median(reference.values())
    gaps = [(abs(program[k] - reference[k]) / max(reference[k], med), k) for k in leaves]
    top, leaf = worst(gaps)
    values = [g for g, _ in gaps]
    middle = statistics.median(values) if all(map(math.isfinite, values)) else math.nan
    if at == "worst":
        return top, f"worst at {leaf}; median {middle:.6g} of {len(gaps)} leaves"
    return middle, f"median of {len(gaps)} leaves; worst {top:.6g} at {leaf}"


def train_numbers(losses, grad1: dict, change: dict, reference: dict,
                  loss_steps: int, change_leaf: str) -> dict[str, tuple]:
    """Each number with where it was read (the steps, or the leaves);
    ``reference``: ``reference.steps.train_steps``' result on the same
    weights and batches."""
    med = statistics.median(reference["grad1"].values())
    moving = [k for k, g in reference["grad1"].items() if g >= STILL_LEAF * med]
    steps = [abs(p - r) / abs(r) for p, r in zip(losses, reference["losses"], strict=True)]
    return {
        "loss_gap": (worst((g, "") for g in steps[:loss_steps])[0],
                     "steps: " + ", ".join(f"{g:.6g}" for g in steps)),
        "grad_gap": leaf_gap(grad1, reference["grad1"]),
        "change_gap": change_gap(change, reference["change"], moving, change_leaf),
    }


def wave_gaps(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """[K, L] pairs of clips -> each clip's largest error over its peak."""
    peak = np.abs(reference).max(axis=1)
    return np.abs(program - reference).max(axis=1) / np.maximum(peak, 1e-30)
