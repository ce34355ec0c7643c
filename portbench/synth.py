"""Everything a run is given, made from ``--seed``: the model's weights and
noisy/clean speech pairs, on the device in a few large calls.

The pairs follow the DNS-2020 recipe's mixing: a clean signal, noise at an
SNR drawn from the recipe's integer range, the mixture set to a level drawn
from target ± floating dB FS, the clean signal scaled with it. The clean
signal is speech-like: a harmonic voice with a drifting pitch under a
syllable-rate envelope with pauses; the noise is white or low-passed. The
model's work does not depend on the signal's content, only its sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import models


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number)."""
    words = np.random.SeedSequence(seed % 2**64, spawn_key=stream).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def generator(seed: int, device, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *stream))


def weights(family: str, args: dict, sr: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights under the published keys, U(-b, b) with PyTorch's
    default bound b = 1 / sqrt(hidden), drawn in one call; and the fixed
    buffers."""
    shapes = models.weight_shapes(family, args)
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    flat = torch.rand(sum(sizes), generator=generator(seed, device, 0), device=device)
    out = {}
    for (name, (shape, bound)), piece in zip(shapes.items(), torch.split(flat, sizes)):
        out[name] = (piece * 2 - 1).mul_(bound).reshape(shape)
    out.update({k: v.to(device) for k, v in models.buffers(family, args, sr).items()})
    return out


def speech_pairs(seed: int, stream: int, rows: int, samples: int, sr: int, snr_db, level_dbfs,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(noisy, clean), each [rows, samples] float32 on ``device``."""
    gen = generator(seed, device, 1, stream)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) + lo

    t = torch.arange(samples, device=device, dtype=torch.float32)[None] / sr
    f0 = uniform(90.0, 250.0, rows, 1)
    drift = uniform(-0.15, 0.15, rows, 1)
    phase = 2 * math.pi * f0 * (t + drift * t * t / 2) + 3 * torch.sin(2 * math.pi * 0.7 * t)
    clean = sum(torch.sin(k * phase) / k for k in range(1, 9))
    syllables = torch.sin(2 * math.pi * uniform(2.0, 5.0, rows, 1) * t + uniform(0, 6.3, rows, 1))
    pauses = torch.sin(2 * math.pi * uniform(0.2, 0.5, rows, 1) * t + uniform(0, 6.3, rows, 1))
    clean = clean * syllables.clamp(min=0) * (pauses > -0.5)

    noise = torch.randn(rows, samples, generator=gen, device=device)
    low = F.conv1d(noise[:, None], torch.full((1, 1, 15), 1 / 15, device=device), padding="same")
    noise = torch.where(torch.arange(rows, device=device)[:, None] % 2 == 1, low[:, 0], noise)

    def rms(x):
        return x.square().mean(dim=1, keepdim=True).sqrt().clamp(min=1e-8)

    snr = torch.randint(int(snr_db[0]), int(snr_db[1]) + 1, (rows, 1), generator=gen,
                        device=device).float()
    noise = noise * rms(clean) / rms(noise) / 10 ** (snr / 20)
    noisy = clean + noise
    gain = 10 ** (uniform(level_dbfs[0], level_dbfs[1], rows, 1) / 20) / rms(noisy)
    peak = (noisy * gain).abs().amax(dim=1, keepdim=True)
    gain = gain * torch.where(peak > 0.99, 0.99 / peak, torch.ones_like(peak))
    return noisy * gain, clean * gain
