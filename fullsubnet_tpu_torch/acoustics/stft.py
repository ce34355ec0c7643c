"""Batched STFT / iSTFT on ``torch.stft`` / ``torch.istft`` (counterpart
of ``fullsubnet_tpu/acoustics/stft.py``).

Conventions are the reference's: periodic Hann window, center=True with
reflect padding, onesided spectrum, no normalisation, and iSTFT
overlap-add with the squared-window envelope and the ``length=`` trim
(with an explicit length, samples ``[n_fft//2 : n_fft//2 + length]`` are
kept, zero-padded if the signal is shorter). On a CUDA tensor both run
on cuFFT. All functions take leading batch dims: [..., T] <-> [..., F, T'].
"""

from __future__ import annotations

import torch


def hann_window(
    win_length: int, device=None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    return torch.hann_window(win_length, periodic=True, device=device, dtype=dtype)


def stft_complex(
    y: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: torch.Tensor | None = None,
    center: bool = True,
) -> torch.Tensor:
    """Complex STFT of [..., T] -> [..., F, T'] with F = n_fft // 2 + 1.
    A window shorter than ``n_fft`` is zero-padded on both sides."""
    if window is None:
        window = hann_window(win_length, device=y.device, dtype=y.dtype)
    lead = y.shape[:-1]
    spec = torch.stft(
        y.reshape(-1, y.shape[-1]),
        n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=window,
        center=center,
        pad_mode="reflect",
        normalized=False,
        onesided=True,
        return_complex=True,
    )
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(
    features,
    n_fft: int,
    hop_length: int,
    win_length: int,
    length: int | None = None,
    input_type: str = "complex",
    window: torch.Tensor | None = None,
    center: bool = True,
) -> torch.Tensor:
    """Inverse STFT of [..., F, T'] -> [..., T].

    ``input_type``: "complex" | "real_imag" (tuple) | "mag_phase" (tuple).
    """
    if input_type == "real_imag":
        real, imag = features
        spec = torch.complex(real, imag)
    elif input_type == "complex":
        spec = features
    elif input_type == "mag_phase":
        mag, phase = features
        spec = torch.polar(mag, phase)
    else:
        raise NotImplementedError(
            "Only 'real_imag', 'complex', and 'mag_phase' are supported."
        )
    if window is None:
        window = hann_window(win_length, device=spec.device)
    lead = spec.shape[:-2]
    out = torch.istft(
        spec.reshape(-1, *spec.shape[-2:]),
        n_fft,
        hop_length=hop_length,
        win_length=win_length,
        window=window,
        center=center,
        length=length,
    )
    return out.reshape(*lead, out.shape[-1])


def num_stft_frames(
    num_samples: int, hop_length: int, n_fft: int | None = None,
    center: bool = True,
) -> int:
    """Frame count produced by :func:`stft_complex` for a sample count.

    ``n_fft`` matters only when odd (center padding adds 2*(n_fft//2)
    samples, which is n_fft - 1 then); omitted = assume even n_fft."""
    if center:
        extra = 0 if n_fft is None else 2 * (n_fft // 2) - n_fft
        return 1 + (num_samples + extra) // hop_length
    raise NotImplementedError("non-centered frame math not needed yet")
