"""The plain reference against the port's CPU path at small sizes, for
both families: the forward, and training steps through the port's Trainer
(fp32, so the two agree to float32's rounding)."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from portbench import compare, synth
from portbench import run as harness
from portbench.reference import models
from portbench.tests import small
from portbench.traffic import train_batches

torch.set_num_threads(2)

TINY_FULLSUBNET = {"num_freqs": 33, "sb_num_neighbors": 3, "fb_model_hidden_size": 24,
                   "sb_model_hidden_size": 16}
TINY_ACOUSTICS = {"n_fft": 64, "win_length": 64, "hop_length": 32, "sr": 16000}
CASES = {
    "fullsubnet": ("fullsubnet.train.b32x3s", TINY_FULLSUBNET, TINY_ACOUSTICS),
    "fast_fullsubnet": ("fast_fullsubnet.train.b72x3s", {}, {}),
}


def _cell(family: str, use_amp: bool = False) -> harness.Cell:
    name, args, acoustics = CASES[family]
    cell = small.cell(name)
    config = copy.deepcopy(cell.config)
    config["model"]["args"].update(args)
    config["acoustics"].update(acoustics)
    config["meta"]["use_amp"] = use_amp
    traffic = {**cell.traffic, "batch": 3 if family == "fullsubnet" else 2, "samples": 2048}
    precision = {"cast": "bf16", "products": "bf16" if family == "fullsubnet" else "fp32"}
    workload = {**cell.workload, "precision": precision if use_amp else {"products": "fp32"}}
    return dataclasses.replace(cell, config=config, traffic=traffic, workload=workload)


@pytest.mark.parametrize("family", sorted(CASES))
def test_the_forward_matches_the_ports(family, tmp_path):
    from fullsubnet_tpu_torch.config import build_model

    cell = _cell(family)
    run = harness.Run(cell, small.SEED, ["cpu"], tmp_path, False)
    model, _ = build_model(run.recipe)
    weights = synth.weights(family, run.args, run.sr, small.SEED, "cpu")
    model.load_state_dict(weights)
    mag = torch.rand(4, 1, run.acoustics["n_fft"] // 2 + 1, 21,
                     generator=torch.Generator().manual_seed(1)) * 2
    for drop in (False, True) if family == "fullsubnet" else (False,):
        with torch.no_grad():
            want = models.forward(family, weights, run.args, mag, drop, "fp32")
            got = model(mag, dropping_band=drop)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", sorted(CASES))
def test_training_steps_match_the_ports_trainer(family, tmp_path):
    cell = _cell(family)
    run = harness.Run(cell, small.SEED, ["cpu"], tmp_path, False)
    train_batches.setup(run)
    train_batches.release(run)
    s = run.state
    numbers = compare.train_numbers(s.losses, s.grad1, s.change, train_batches.reference(run),
                                    loss_steps=3, change_leaf="worst")
    assert numbers["loss_gap"][0] < 1e-5
    assert numbers["grad_gap"][0] < 1e-4
    assert numbers["change_gap"][0] < 1e-3


def test_the_control_is_the_reference_one_precision_down(tmp_path):
    """The tf32 and fp8 products round their operands and sum in fp32."""
    from portbench.reference.precision import matmul, round_e4m3, round_tf32

    a = torch.randn(8, 16, generator=torch.Generator().manual_seed(2))
    b = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))
    assert torch.equal(matmul(a, b, "tf32"), round_tf32(a) @ round_tf32(b))
    assert torch.equal(matmul(a, b, "fp8"), round_e4m3(a) @ round_e4m3(b))
    bits = round_tf32(a).view(torch.int32)
    assert torch.equal(bits & 0x1FFF, torch.zeros_like(bits))
    assert (round_tf32(a) - a).abs().max() <= a.abs().max() * 2**-11
