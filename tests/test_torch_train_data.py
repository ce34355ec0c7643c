"""The port's training data path against the JAX package on the CPU:
``drop_band``, the host-side numpy helpers, ``TrainDataset`` items and
the loader's epoch permutation, on the same synthetic lists (written from
a numpy seed) and the same seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics.feature import drop_band as jax_drop_band
from fullsubnet_tpu.data.datasets import TrainDataset as JaxTrainDataset
from fullsubnet_tpu.data.loader import DataLoader as JaxDataLoader
from fullsubnet_tpu_torch.acoustics.feature import drop_band, subsample
from fullsubnet_tpu_torch.data.datasets import TrainDataset
from fullsubnet_tpu_torch.data.loader import DataLoader
from fullsubnet_tpu_torch.data.wavio import read_wav, resampled_length, wav_frames, write_wav

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

SR = 16000


def write_lists(root, seed=0, n_clean=8, clean_seconds=(1.0, 0.3)):
    """Synthetic clean, noise and RIR wavs and their list files under
    ``root``; returns the three list paths. Clean: amplitude-modulated
    tones, alternating between ``clean_seconds`` (the second one shorter
    than a 0.4 s crop, so the padded path runs too). Noise: white and
    brown noise of 0.3 s and 0.7 s, and an 8 kHz file (resampled on
    read, so it cannot be a partial read). RIRs: a mono one and a
    two-channel one (its channel is drawn)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lists = {"clean": [], "noise": [], "rir": []}
    for i in range(n_clean):
        seconds = clean_seconds[i % len(clean_seconds)]
        t = np.arange(int(seconds * SR)) / SR
        freq = 150 + 40 * i
        wave = 0.4 * np.sin(2 * np.pi * freq * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        path = root / f"clean_{i:02d}.wav"
        write_wav(path, wave.astype(np.float32), SR)
        lists["clean"].append(path)
    noises = [
        (0.1 * rng.standard_normal(int(0.3 * SR)), SR),
        (0.02 * np.cumsum(rng.standard_normal(int(0.7 * SR))) / 30, SR),
        (0.1 * rng.standard_normal(int(0.5 * 8000)), 8000),
    ]
    for i, (wave, sr) in enumerate(noises):
        path = root / f"noise_{i}.wav"
        write_wav(path, np.clip(wave, -0.9, 0.9).astype(np.float32), sr)
        lists["noise"].append(path)
    decay = np.exp(-np.arange(200) / 40.0)
    rirs = [decay * rng.standard_normal(200), decay * rng.standard_normal((2, 200))]
    for i, rir in enumerate(rirs):
        rir = rir / np.max(np.abs(rir)) * 0.9
        path = root / f"rir_{i}.wav"
        write_wav(path, rir.astype(np.float32), SR)
        lists["rir"].append(path)
    out = {}
    for kind, paths in lists.items():
        out[kind] = root / f"{kind}.txt"
        out[kind].write_text("".join(f"{p}\n" for p in paths))
    return out["clean"], out["noise"], out["rir"]


@pytest.mark.parametrize("shape, groups", [((5, 2, 7, 3), 2), ((7, 1, 10, 4), 3), ((3, 2, 6, 2), 2)])
def test_drop_band_matches_jax(shape, groups):
    """F = 7 and 10 are not multiples of G: the spectrum is truncated."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_drop_band(jnp.asarray(x), groups))
    got = drop_band(torch.from_numpy(x), groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_drop_band_needs_more_samples_than_groups():
    with pytest.raises(ValueError, match="larger than the number of groups"):
        drop_band(torch.zeros(2, 1, 8, 3), 2)


def test_subsample_draws_like_jax():
    from fullsubnet_tpu.acoustics.feature import subsample as jax_subsample

    data = np.arange(100, dtype=np.float32)
    for length in (40, 100, 130):
        want = jax_subsample(data, length, rng=np.random.default_rng(3))
        np.testing.assert_array_equal(subsample(data, length, rng=np.random.default_rng(3)), want)


def test_wav_headers(tmp_path):
    write_wav(tmp_path / "a.wav", np.zeros((2, 123), np.float32), 8000)
    assert wav_frames(tmp_path / "a.wav") == (123, 8000, 2)
    assert read_wav(tmp_path / "a.wav")[0].shape == (2, 123)
    assert resampled_length(123, 8000, 16000) == read_wav(tmp_path / "a.wav", sr=16000)[0].shape[-1]


@pytest.mark.parametrize("reverb_proportion", [0.0, 1.0, 0.5])
def test_train_dataset_items_match_jax(tmp_path, reverb_proportion):
    """Every item of two epochs, from the same lists and seed. Both
    packages mix with their C++ mixer (the same source;
    tests/test_torch_native.py holds the items bit-equal)."""
    clean, noise, rir = write_lists(tmp_path)
    args = dict(
        clean_dataset=str(clean), noise_dataset=str(noise), rir_dataset=str(rir),
        snr_range=[-5, 20], reverb_proportion=reverb_proportion, silence_length=0.05,
        target_dB_FS=-25, target_dB_FS_floating_value=10, sub_sample_length=0.4, sr=SR,
        clean_dataset_limit=False, seed=7,
    )
    jax_ds, port_ds = JaxTrainDataset(**args), TrainDataset(**args)
    assert len(port_ds) == len(jax_ds) == 8
    for epoch in (0, 1):
        jax_ds.set_epoch(epoch)
        port_ds.set_epoch(epoch)
        for item in range(len(port_ds)):
            noisy, clean_y = port_ds[item]
            want_noisy, want_clean = jax_ds[item]
            assert noisy.dtype == clean_y.dtype == np.float32
            assert noisy.shape == clean_y.shape == (int(0.4 * SR),)
            np.testing.assert_allclose(noisy, want_noisy, atol=1e-6, rtol=1e-5)
            np.testing.assert_allclose(clean_y, want_clean, atol=1e-6, rtol=1e-5)


def test_train_dataset_refuses_device_synthesis(tmp_path):
    """Device synthesis (A.21) is ported: the dataset that refused it
    constructs, and its item is the JAX dataset's 6-tuple of components
    (tests/test_torch_device_mixer.py holds the mixing); an unknown
    transfer is refused with the JAX message."""
    clean, noise, rir = write_lists(tmp_path, n_clean=1)
    port = TrainDataset(str(clean), str(noise), str(rir), device_synthesis=True)
    want = JaxTrainDataset(str(clean), str(noise), str(rir), device_synthesis=True)[0]
    for got, w in zip(port[0], want, strict=True):
        np.testing.assert_array_equal(got, w)
    with pytest.raises(ValueError, match="must be 'f32' or 'int16', got 'f16'"):
        TrainDataset(str(clean), str(noise), str(rir), device_synthesis=True,
                     device_synthesis_transfer="f16")


class _Indices:
    """A dataset whose item i is [i]."""

    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i], np.int64)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_jax(drop_last):
    """The same batches, in the same order, epoch by epoch."""
    port = DataLoader(_Indices(11), batch_size=4, shuffle=True, drop_last=drop_last, seed=3)
    jax_loader = JaxDataLoader(_Indices(11), batch_size=4, shuffle=True, drop_last=drop_last,
                               seed=3)
    assert len(port) == len(jax_loader)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got = [b.numpy()[:, 0].tolist() for b in port]
        want = [np.asarray(b)[:, 0].tolist() for b in jax_loader]
        assert got == want
    assert port.dataset.epochs == [1, 2]
