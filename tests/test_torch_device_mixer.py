"""The port's device synthesis (``data/device_mixer.py``,
``TrainDataset(device_synthesis=True)``, the Trainer's synthesised step)
on the CPU against the JAX package: ``fft_convolve_trunc`` and
``device_snr_mix`` on seeded arrays (reverb on and off, the R = 1
placeholder, int16 input, a row whose mixture clips), the component items
at both transfers, and a synthesised batch against the port's host mixer.
The lists of tests/test_torch_train_data.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.data.datasets import TrainDataset as JaxTrainDataset
from fullsubnet_tpu.data.device_mixer import device_snr_mix as jax_device_snr_mix
from fullsubnet_tpu.data.device_mixer import fft_convolve_trunc as jax_fft_convolve_trunc
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.data.datasets import TrainDataset, _quantize_int16
from fullsubnet_tpu_torch.data.device_mixer import (
    _as_audio_f32,
    device_snr_mix,
    fft_convolve_trunc,
    make_device_synthesis,
)
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_train import write_config
from test_torch_train_data import SR, write_lists

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 on both sides (pocketfft against XLA's CPU FFT, the same constants
# and order): each row within this share of its peak
PEAK_RTOL = 1e-6


def _close_to_peak(got, want, rtol=PEAK_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = np.max(np.abs(want), axis=-1, keepdims=True)
    err = np.max(np.abs(got - want) / peak)
    assert err <= rtol, err


def _components(rng, batch=6, length=4000, taps=900):
    """Seeded rows: the clean of row 4 a spike over a whisper, so its
    mixture clips and the rescue runs; RIRs of 300 and 900 taps; reverb
    on rows 1, 2, 3 and 5."""
    clean = (0.3 * rng.standard_normal((batch, length))).astype(np.float32)
    clean[4] *= 0.01
    clean[4, 100] = 5.0
    noise = (0.1 * rng.standard_normal((batch, length))).astype(np.float32)
    rir = np.zeros((batch, taps), np.float32)
    rir[:, 0] = 1.0
    rir[1, 120], rir[5, 120] = 0.5, 0.5
    rir[2:4] += (0.2 * rng.standard_normal((2, taps))).astype(np.float32)
    use_reverb = np.array([0, 1, 1, 1, 0, 1], np.float32)
    snr = np.array([-5, 0, 7, 20, 3, 12], np.float32)
    target = np.array([-35, -25, -20, -30, -16, -24], np.float32)
    return clean, noise, rir, use_reverb, snr, target


def test_fft_convolve_trunc_matches_jax():
    rng = np.random.default_rng(0)
    clean = rng.standard_normal((3, 1000)).astype(np.float32)
    rir = rng.standard_normal((3, 77)).astype(np.float32)
    want = np.asarray(jax.jit(jax_fft_convolve_trunc)(jnp.asarray(clean), jnp.asarray(rir)))
    got = fft_convolve_trunc(torch.from_numpy(clean), torch.from_numpy(rir)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 1000)
    _close_to_peak(got, want)


@pytest.mark.parametrize("form", ["f32", "int16", "placeholder"])
def test_device_snr_mix_matches_jax(form):
    """Reverb on and off per row and the clip rescue at fp32; the same rows
    as int16 PCM; and the [B, 1] placeholder RIR, whose gate skips the
    FFT (a one-tap kernel scales)."""
    clean, noise, rir, use_reverb, snr, target = _components(np.random.default_rng(1))
    if form == "int16":
        clean, noise, rir = (_quantize_int16(np.clip(v, -1, 1)) for v in (clean, noise, rir))
    if form == "placeholder":
        rir = np.full((len(clean), 1), 0.5, np.float32)
    args = (clean, noise, rir, use_reverb, snr, target)
    want = jax.jit(jax_device_snr_mix)(*map(jnp.asarray, args))
    got = device_snr_mix(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == clean.shape
        _close_to_peak(g.numpy(), np.asarray(w))
    if form == "f32":  # row 4 clips: the rescue holds the mixture under 0.99
        assert np.abs(np.asarray(want[0][4])).max() == pytest.approx(0.99 - 1e-6, rel=1e-5)
    if form == "int16":
        x = torch.from_numpy(clean)
        assert x.dtype == torch.int16
        assert torch.equal(_as_audio_f32(x), x.float() / 32768)


def _datasets(tmp_path, transfer):
    clean, noise, rir = write_lists(tmp_path)
    args = dict(
        clean_dataset=str(clean), noise_dataset=str(noise), rir_dataset=str(rir),
        snr_range=[-5, 20], reverb_proportion=0.5, silence_length=0.05, target_dB_FS=-25,
        target_dB_FS_floating_value=10, sub_sample_length=0.4, sr=SR, seed=7,
    )
    synth = dict(args, device_synthesis=True, device_synthesis_transfer=transfer)
    return TrainDataset(**synth), JaxTrainDataset(**synth), TrainDataset(**args)


@pytest.mark.parametrize("transfer", ["f32", "int16"])
def test_component_items_match_jax(tmp_path, transfer):
    """Every item of two epochs, the 6-tuple of the JAX dataset: the same
    arrays, dtypes and draws; the RIR buffer sized from the headers (200
    taps, the RIRs' length)."""
    port, ref, _ = _datasets(tmp_path, transfer)
    assert port.rir_samples == ref.rir_samples == 200
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for item in range(len(port)):
            got, want = port[item], ref[item]
            assert len(got) == len(want) == 6
            for g, w in zip(got, want):
                assert np.asarray(g).dtype == np.asarray(w).dtype
                np.testing.assert_array_equal(g, w)
    assert got[0].dtype == (np.int16 if transfer == "int16" else np.float32)


@pytest.mark.parametrize("transfer", ["f32", "int16"])
def test_synthesised_batch_matches_the_host_mixer(tmp_path, transfer):
    """The port's loader batch of components (torch's default collate)
    mixed by ``make_device_synthesis`` equals the host mixer's batch of the
    same (seed, epoch, index): with the f32 transfer within float32
    rounding of each row's peak (the RIR convolved at its own FFT size, not
    scipy's); the int16 transfer ships int16 tensors, and its rows move by
    the quantisation of the one noise file read at 8 kHz and resampled off
    the int16 grid (the 16 kHz wavs are 16-bit PCM and land on it)."""
    port, _, host = _datasets(tmp_path, transfer)
    loader = torch.utils.data.DataLoader(port, batch_size=8)
    port.set_epoch(2)
    host.set_epoch(2)
    batch = next(iter(loader))
    assert [tuple(x.shape) for x in batch[3:]] == [(8,)] * 3
    assert batch[0].dtype == (torch.int16 if transfer == "int16" else torch.float32)
    noisy, clean = make_device_synthesis(target_db_fs=-25)(batch)
    rtol = 1e-4 if transfer == "int16" else 1e-5
    for i in range(8):
        want_noisy, want_clean = host[i]
        _close_to_peak(noisy[i].numpy(), want_noisy, rtol)
        _close_to_peak(clean[i].numpy(), want_clean, rtol)


def test_trainer_trains_on_synthesised_batches(tmp_path):
    """``device_synthesis = true`` constructs and trains (an epoch of two
    steps), with a finite loss; the step's first loss equals the host-mixed
    step's within float32 rounding."""
    cfg = write_config(tmp_path, epochs=1)
    config = load_config(cfg)
    host = Trainer(config, output_dir=str(tmp_path / "host"), device="cpu")
    config["train_dataset"]["args"]["device_synthesis"] = True
    synth = Trainer(config, output_dir=str(tmp_path / "synth"), device="cpu")
    assert synth.synthesize is not None and host.synthesize is None
    synth.train_loader.set_epoch(1)
    host.train_loader.set_epoch(1)
    components = next(iter(synth.train_loader))
    noisy, clean = next(iter(host.train_loader))
    got = synth.compute_loss(*synth.synthesize(components)).detach()
    want = host.compute_loss(noisy, clean).detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    synth.train()
    assert synth.steps == 2 and np.isfinite(synth.epoch_losses[1])
