"""Mixture synthesis on the device (counterpart of
``fullsubnet_tpu/data/device_mixer.py``): the DSP half of the training
data pipeline (RIR reverb, SNR mixing, loudness retargeting, the
anti-clipping rescale) as one batched function of tensors.

With ``TrainDataset(device_synthesis=True)`` the loader's workers only
read and crop; they ship the raw components and the per-item draws, and
the Trainer mixes the batch on its device before the step. The semantics
are ``TrainDataset.snr_mix``'s (the same constants and order, the same
clipping quirk: detected at 0.999, rescaled to 0.99 - eps), so a batch
mixed here matches the host mixer to float32 rounding. The randomness
stays on the host, so (seed, epoch, index) still fixes every item.
The RIR convolution is ``torch.fft.rfft``/``irfft`` at
``next_pow2(L + R - 1)`` (cuFFT on the card), as the JAX package computes
it outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1)).bit_length()


def _rms(y: torch.Tensor) -> torch.Tensor:
    """Per-row RMS of [B, L] -> [B, 1]."""
    return torch.sqrt(torch.mean(torch.square(y), dim=-1, keepdim=True))


def _tailor_db_fs(y: torch.Tensor, target_db, eps: float):
    """Batched ``acoustics.feature.tailor_dB_FS``; returns (scaled,
    scalar [B, 1])."""
    target_db = torch.as_tensor(target_db, dtype=torch.float32, device=y.device)
    scalar = 10.0 ** (target_db / 20.0) / (_rms(y) + eps)
    return y * scalar, scalar


def _as_audio_f32(x: torch.Tensor) -> torch.Tensor:
    """Waveform to float32: integer dtypes are wav-native PCM and scale by
    1/32768 (an exact power of two); floats pass through."""
    if not x.dtype.is_floating_point:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x.to(torch.float32)


def fft_convolve_trunc(clean: torch.Tensor, rir: torch.Tensor) -> torch.Tensor:
    """Batched FFT convolution truncated to the clean length:
    ``scipy.signal.fftconvolve(clean, rir)[:L]`` per row.

    clean: [B, L], rir: [B, R] (zero-padded rows are fine: the padding
    adds nothing to the product). Returns [B, L] float32."""
    length = clean.shape[-1]
    n = _next_pow2(length + rir.shape[-1] - 1)
    spec = torch.fft.rfft(clean, n) * torch.fft.rfft(rir, n)
    return torch.fft.irfft(spec, n)[..., :length].to(torch.float32)


def device_snr_mix(
    clean: torch.Tensor,
    noise: torch.Tensor,
    rir: torch.Tensor,
    use_reverb: torch.Tensor,
    snr: torch.Tensor,
    noisy_target_db_fs: torch.Tensor,
    target_db_fs: float = -25.0,
    eps: float = 1e-6,
):
    """Batched ``snr_mix`` (reference ``dataset_train.py:136-195``).

    Args:
      clean:  [B, L], the cropped clean speech (float32, or int16 PCM).
      noise:  [B, L], the assembled noise track.
      rir:    [B, R], a mono RIR per row, zero-padded to R (the channel
              already drawn on the host).
      use_reverb: [B], rows whose clean signal is reverbed (non-zero).
      snr:    [B], each row's SNR in dB.
      noisy_target_db_fs: [B], each row's mixture loudness target.
      target_db_fs: the dataset's pre-mix loudness.
      eps: the reference's 1e-6.

    Returns (noisy [B, L], clean_target [B, L]) float32: the host mixer's
    result on the same draws (the clean target is the reverbed clean, as
    in the reference). Integer inputs (``device_synthesis_transfer =
    "int16"``) are read as wav-native audio, x / 32768.
    """
    clean = _as_audio_f32(clean)
    noise = _as_audio_f32(noise)
    rir = _as_audio_f32(rir)
    reverb_mask = use_reverb.to(torch.bool)[:, None]
    snr = snr.to(torch.float32)[:, None]
    noisy_target_db_fs = noisy_target_db_fs.to(torch.float32)[:, None]

    # a dataset with no usable RIRs ships a [B, 1] placeholder buffer
    # (TrainDataset.rir_samples == 1): a length-1 kernel is a per-row
    # scale, so the batch's FFTs are skipped
    if rir.shape[-1] > 1:
        reverbed = fft_convolve_trunc(clean, rir)
    else:
        reverbed = clean * rir
    clean = torch.where(reverb_mask, reverbed, clean)

    # norm_amplitude + tailor_dB_FS on both signals
    clean = clean / (torch.amax(torch.abs(clean), dim=-1, keepdim=True) + eps)
    clean, _ = _tailor_db_fs(clean, target_db_fs, eps)
    clean_rms = _rms(clean)

    noise = noise / (torch.amax(torch.abs(noise), dim=-1, keepdim=True) + eps)
    noise, _ = _tailor_db_fs(noise, target_db_fs, eps)
    noise_rms = _rms(noise)

    snr_scalar = clean_rms / (10.0 ** (snr / 20.0)) / (noise_rms + eps)
    noisy = clean + noise * snr_scalar

    noisy, noisy_scalar = _tailor_db_fs(noisy, noisy_target_db_fs, eps)
    clean = clean * noisy_scalar

    # the reference's quirk: clipping detected at |y| > 0.999 but rescaled
    # to a 0.99 - eps ceiling
    peak = torch.amax(torch.abs(noisy), dim=-1, keepdim=True)
    rescue = torch.where(peak > 0.999, peak / (0.99 - eps), torch.ones_like(peak))
    return noisy / rescue, clean / rescue


def make_device_synthesis(target_db_fs: float = -25.0, eps: float = 1e-6):
    """A function of the 6-tuple a ``device_synthesis`` TrainDataset's
    collated batch holds -> (noisy, clean), with the dataset's constants."""

    def synthesize(batch):
        clean, noise, rir, use_reverb, snr, noisy_target = batch
        return device_snr_mix(clean, noise, rir, use_reverb, snr, noisy_target,
                              target_db_fs=target_db_fs, eps=eps)

    return synthesize
