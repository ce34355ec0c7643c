"""Spectrogram features (counterpart of ``fullsubnet_tpu/acoustics/feature.py``).

Only ``freq_unfold`` so far; ``drop_band`` (training) comes with slice 2.
"""

import torch
import torch.nn.functional as F


def freq_unfold(
    x: torch.Tensor, num_neighbors: int, mode: str = "reflect"
) -> torch.Tensor:
    """Split a spectrogram into overlapping sub-band units along frequency.

    x: [B, C, F, T] -> [B, F, C, 2*num_neighbors+1, T], one (2N+1)-bin unit
    per frequency, padded at the spectrum edges with ``mode``.
    """
    if x.ndim != 4:
        raise ValueError(f"The dim of the input is {x.ndim}. It should be 4.")
    b, c, f, t = x.shape
    if num_neighbors <= 0:
        return x.permute(0, 2, 1, 3).reshape(b, f, c, 1, t)

    size = 2 * num_neighbors + 1
    xp = F.pad(x, (0, 0, num_neighbors, num_neighbors), mode=mode)
    units = xp.unfold(2, size, 1)  # [B, C, F, T, size]
    return units.permute(0, 2, 1, 4, 3)  # [B, F, C, size, T]
