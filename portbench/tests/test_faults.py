"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, at a small size on
the CPU past the harness's look for a card; and a sound run comes out
correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests import small

torch.set_num_threads(2)


def _state_unchanged(monkeypatch):
    from fullsubnet_tpu_torch.train.trainer import Trainer

    def step(self, noisy, clean):  # the loss and gradients, no update
        return self.loss_and_grads(noisy, clean)

    monkeypatch.setattr(Trainer, "train_step", step)


def _half_batch_step(monkeypatch):
    from fullsubnet_tpu_torch.train.trainer import Trainer

    original = Trainer.train_step

    def step(self, noisy, clean):  # the mean over the first half of the rows
        return original(self, noisy[: len(noisy) // 2], clean[: len(clean) // 2])

    monkeypatch.setattr(Trainer, "train_step", step)


def _half_batch_enhanced(monkeypatch):
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    original = Inferencer.enhance_bucket

    def enhance(self, waves, bucket):  # the second half returned as it came
        half = len(waves) // 2
        return original(self, waves[:half], bucket) + [np.asarray(w) for w in waves[half:]]

    monkeypatch.setattr(Inferencer, "enhance_bucket", enhance)


def _answer_altered(monkeypatch):
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    original = Inferencer.enhance_bucket

    def enhance(self, waves, bucket):  # one sample of every answer moved by 1% of its peak
        out = [y.copy() for y in original(self, waves, bucket)]
        for y in out:
            y[len(y) // 2] += 0.01 * np.abs(y).max()
        return out

    monkeypatch.setattr(Inferencer, "enhance_bucket", enhance)


def _input_returned(monkeypatch):
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    def enhance(self, noisy):  # the clip returned as it came, not enhanced
        return noisy[0].cpu().numpy()

    monkeypatch.setattr(Inferencer, "full_band_crm_mask", enhance)


def _exact_answer_altered(monkeypatch):
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    original = Inferencer.full_band_crm_mask

    def enhance(self, noisy):  # one sample moved by 1% of the answer's peak
        y = original(self, noisy).copy()
        y[len(y) // 2] += 0.01 * np.abs(y).max()
        return y

    monkeypatch.setattr(Inferencer, "full_band_crm_mask", enhance)


FAULTS = {
    "fullsubnet.train.b32x3s": [_state_unchanged, _half_batch_step],
    "fast_fullsubnet.train.b72x3s": [_state_unchanged, _half_batch_step],
    "fullsubnet.enhance.b32x10s": [_half_batch_enhanced, _answer_altered],
    "fullsubnet.enhance.b1x10s": [_input_returned, _exact_answer_altered],
}
CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = small.run(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_a_sound_run_is_correct(cell):
    result = small.run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
