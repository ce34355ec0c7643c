"""The port's metrics (its numpy copies of ``fullsubnet_tpu/metrics.py`` and
``fullsubnet_tpu/pesq.py``) against the JAX package's on seeded signals.
Both run the same numpy code, so every score must be the same bits."""

import numpy as np
import pytest
import torch

from fullsubnet_tpu import metrics as jax_metrics
from fullsubnet_tpu_torch import metrics

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)


def _pair(seed: int, seconds: float, sr: int, snr_db: float):
    """An amplitude-modulated, gliding tone (the clean signal) and the same
    with white noise at ``snr_db``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    clean = 0.3 * np.sin(2 * np.pi * 220 * t + 3 * np.sin(2 * np.pi * 0.7 * t))
    clean *= 0.55 + 0.45 * np.sin(2 * np.pi * 3 * t)
    noise = rng.standard_normal(t.size)
    noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** (snr_db / 10))
    return clean.astype(np.float32), (clean + noise).astype(np.float32)


@pytest.mark.parametrize("snr_db", [-5.0, 5.0, 20.0])
@pytest.mark.parametrize("name", ["SI_SDR", "STOI", "WB_PESQ", "NB_PESQ"])
def test_metrics_equal_jax(name, snr_db):
    sr = 8000 if name == "NB_PESQ" else 16000
    clean, noisy = _pair(int(snr_db) + 7, 2.0, sr, snr_db)
    got = metrics.REGISTERED_METRICS[name](clean, noisy, sr=sr)
    want = jax_metrics.REGISTERED_METRICS[name](clean, noisy, sr=sr)
    assert np.isfinite(got)
    assert got == want


@pytest.mark.parametrize("name", ["WB_PESQ", "STOI"])
def test_metrics_resample_48k_like_jax(name):
    """PESQ resamples other rates to 16 kHz, STOI to its 10 kHz."""
    clean, noisy = _pair(3, 1.5, 48000, 10.0)
    got = metrics.REGISTERED_METRICS[name](clean, noisy, sr=48000)
    assert got == jax_metrics.REGISTERED_METRICS[name](clean, noisy, sr=48000)


def test_pesq_range_transform_and_registry():
    scores = np.array([-0.5, 1.0, 2.5, 4.5])
    np.testing.assert_array_equal(metrics.transform_pesq_range(scores), [0.0, 0.3, 0.6, 1.0])
    np.testing.assert_array_equal(metrics.transform_pesq_range(scores),
                                  jax_metrics.transform_pesq_range(scores))
    assert metrics.pesq_available() and jax_metrics.pesq_available()
    assert sorted(metrics.REGISTERED_METRICS) == sorted(jax_metrics.REGISTERED_METRICS)


def test_validation_metrics_are_the_jax_trainers_row():
    """``validation_metrics`` is the JAX Trainer's per-row unit: STOI and
    SI-SDR of the noisy and the enhanced signal, and WB-PESQ when asked."""
    clean, noisy = _pair(11, 1.0, 16000, 0.0)
    enhanced = (0.5 * (clean + noisy)).astype(np.float32)
    row = metrics.validation_metrics(noisy, clean, enhanced, 16000, True)
    assert row == {
        "stoi_n": jax_metrics.STOI(clean, noisy), "stoi_e": jax_metrics.STOI(clean, enhanced),
        "sisdr_n": jax_metrics.SI_SDR(clean, noisy), "sisdr_e": jax_metrics.SI_SDR(clean, enhanced),
        "pesq_n": jax_metrics.WB_PESQ(clean, noisy), "pesq_e": jax_metrics.WB_PESQ(clean, enhanced),
    }
    assert sorted(metrics.validation_metrics(noisy, clean, enhanced, 16000, False)) == [
        "sisdr_e", "sisdr_n", "stoi_e", "stoi_n"]
