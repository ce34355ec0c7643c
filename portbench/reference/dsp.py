"""The recipes' signal processing in plain PyTorch, written from the
published FullSubNet code (Audio-WestlakeU/FullSubNet, ``audio_zen``): the
STFT pair, the offline Laplace norm, the frequency unfold, drop_band, the
compressed cIRM and the HTK mel filterbank. Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = float(np.finfo(np.float32).eps)


def _window(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, device=device, dtype=torch.float32)


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """[B, L] -> complex [B, n_fft // 2 + 1, 1 + L // hop]: periodic Hann,
    centred with reflection, one-sided, not normalised."""
    return torch.stft(y, n_fft, hop_length=hop, win_length=win, window=_window(win, y.device),
                      center=True, pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)


def istft(spec: torch.Tensor, n_fft: int, hop: int, win: int, length: int) -> torch.Tensor:
    """complex [B, F, T] -> [B, length], overlap-add over the squared window."""
    return torch.istft(spec, n_fft, hop_length=hop, win_length=win,
                       window=_window(win, spec.device), center=True, length=length)


def laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """``offline_laplace_norm``: each row over the mean of all its elements."""
    mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + 1e-5)


def unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, 1, F, T] -> [B, F, 2n + 1, T]: each bin with its n neighbours on
    either side, the spectrum's edges reflected."""
    b, _, f, t = x.shape
    if n == 0:
        return x.permute(0, 2, 1, 3)
    xp = F.pad(x, (0, 0, n, n), mode="reflect")
    return xp.unfold(2, 2 * n + 1, 1).reshape(b, f, t, 2 * n + 1).transpose(2, 3)


def drop_band(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C, F, T] -> [B, C, F // G, T]: sample g, g + G, ... keeps bins
    g, g + G, ... of the spectrum cut to a multiple of G; the samples
    regrouped group by group."""
    f = x.shape[2]
    x = x[:, :, : f - f % groups]
    return torch.cat([x[g::groups][:, :, g::groups] for g in range(groups)])


def compressed_cirm(noisy: torch.Tensor, clean: torch.Tensor, k: float = 10.0,
                    c: float = 0.1) -> torch.Tensor:
    """complex [..., F, T] pair -> [..., F, T, 2]: the complex ideal ratio
    mask clean / noisy, compressed by K (1 - e^{-CM}) / (1 + e^{-CM})."""
    den = noisy.real**2 + noisy.imag**2 + EPSILON
    real = (noisy.real * clean.real + noisy.imag * clean.imag) / den
    imag = (noisy.real * clean.imag - noisy.imag * clean.real) / den
    mask = torch.stack((real, imag), dim=-1).clamp(min=-100.0)
    return k * (1 - torch.exp(-c * mask)) / (1 + torch.exp(-c * mask))


def decompress_cirm(mask: torch.Tensor, k: float = 10.0, limit: float = 9.9) -> torch.Tensor:
    mask = mask.clamp(-limit, limit)
    return -k * torch.log((k - mask) / (k + mask))


def mel_filterbank(num_freqs: int, num_mels: int, sr: int) -> torch.Tensor:
    """torchaudio's ``melscale_fbanks(norm=None, mel_scale="htk")`` from 0 Hz
    to sr / 2: [num_freqs, num_mels] float32."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, sr // 2, num_freqs)
    pts = 700.0 * (10.0 ** (np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), num_mels + 2)
                            / 2595.0) - 1.0)
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    return torch.from_numpy(fb.astype(np.float32))
