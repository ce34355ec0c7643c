"""The frozen counts give the figures the program's accounting gave."""

from __future__ import annotations

import pytest

from portbench import counts
from portbench import run as harness

FLAGSHIP = harness.load_cell("fullsubnet.train.b32x3s").config["model"]["args"]
FAST = harness.load_cell("fast_fullsubnet.train.b72x3s").config["model"]["args"]


def test_the_forward_at_b1_x_10_s_and_the_b32_step():
    frames = counts.frames(160000, 256)
    assert frames == 626
    assert round(counts.forward_flops("fullsubnet", FLAGSHIP, 1, frames) / 1e12, 4) == 0.5921
    step = counts.step_flops("fullsubnet", FLAGSHIP, 32, counts.frames(49152, 256))
    assert round(step / 3 / 1e12, 3) == 2.954


def test_a_layer_backward_counts_twice_its_gate_products():
    # dgates into x and h, and the weight gradients; a recompute is not counted
    t, n, f_in, hidden, layers = 195, 4096, 32, 384, 2
    gates = counts.stack_flops(t, n, f_in, hidden, 0, layers)
    assert counts.layer_bwd_flops(t, n, f_in, hidden, layers) == 2 * gates
    per_stage = [(counts.stack_flops(t, n, s.f_in, s.hidden, 0, s.layers),
                  counts.layer_bwd_flops(t, n, s.f_in, s.hidden, s.layers))
                 for s, n, t in counts.model_stages("fullsubnet", FLAGSHIP, 32, 193, True)]
    assert all(bwd == 2 * fwd for fwd, bwd in per_stage)


def test_k1s_bound_at_n257_t400():
    t, n, f_in, hidden, out = 400, 257, 32, 384, 2
    nbytes = 4 * (t * n * f_in + counts.weight_elems(f_in, hidden, out, 2) + t * n * out)
    seconds = counts.bound(counts.stack_flops(t, n, f_in, hidden, out, 2), nbytes, "fp32")
    assert round(seconds * 1e3, 2) == 5.58


def test_drop_band_and_fast_fullsubnets_stages():
    stages = counts.model_stages("fullsubnet", FLAGSHIP, 32, 193, training=True)
    assert [(n, t) for _, n, t in stages] == [(32, 195), (32 * 128, 195)]
    fast = counts.model_stages("fast_fullsubnet", FAST, 72, 193, training=True)
    assert [(s.hidden, n, t) for s, n, t in fast] == [
        (384, 72, 195), (257, 72, 195), (384, 72 * 64, 98), (512, 72, 195), (512, 72, 195)]
    assert counts.step_flops("fast_fullsubnet", FAST, 72, 193) / 1e12 == pytest.approx(5.2695,
                                                                                      abs=1e-4)


def test_fp32_stacks_take_the_fp32_peak():
    fp32 = counts.stacks_bound("fast_fullsubnet", FAST, 72, 193, "fp32", training=True)
    bf16 = counts.stacks_bound("fast_fullsubnet", FAST, 72, 193, "bf16", training=True)
    assert fp32 / bf16 == pytest.approx(989 / 67, rel=0.05)
