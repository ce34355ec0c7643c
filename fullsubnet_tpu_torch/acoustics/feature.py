"""Spectrogram and waveform features (counterpart of
``fullsubnet_tpu/acoustics/feature.py``).

Tensor side (torch): ``freq_unfold`` and ``drop_band``. Host side
(numpy, the data pipeline): ``norm_amplitude``, ``tailor_dB_FS``,
``is_clipped`` and ``subsample``, copies of the JAX package's numpy
functions, so that the port imports nothing of it.
"""

import numpy as np
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


def drop_band(x: torch.Tensor, num_groups: int = 2) -> torch.Tensor:
    """Interleaved frequency subsampling across batch groups.

    Sample i of group g (samples g, g+G, ...) keeps only frequencies
    g, g+G, g+2G, ... of the spectrum truncated to a multiple of G.
    [B, C, F, T] -> [B, C, F//G, T], samples regrouped group-major.
    """
    batch_size, _, num_freqs, _ = x.shape
    if batch_size <= num_groups:
        raise ValueError(
            f"Batch size = {batch_size}, num_groups = {num_groups}. The batch "
            "size should be larger than the number of groups."
        )
    if num_groups <= 1:
        return x
    x = x[..., : num_freqs - num_freqs % num_groups, :]
    return torch.cat(
        [x[g::num_groups][:, :, g::num_groups] for g in range(num_groups)], dim=0
    )


# --------------------------------------------------------------------------
# Host side (numpy): data-pipeline utilities
# --------------------------------------------------------------------------


def norm_amplitude(y: np.ndarray, scalar=None, eps: float = 1e-6):
    """Peak-normalize; returns (y / scalar, scalar)."""
    if not scalar:
        scalar = np.max(np.abs(y)) + eps
    return y / scalar, scalar


def tailor_dB_FS(y: np.ndarray, target_dB_FS: float = -25, eps: float = 1e-6):
    """Scale to a target loudness in dB FS; returns (y, rms, scalar)."""
    rms = np.sqrt(np.mean(y**2))
    scalar = 10 ** (target_dB_FS / 20) / (rms + eps)
    return y * scalar, rms, scalar


def is_clipped(y: np.ndarray, clipping_threshold: float = 0.999) -> bool:
    return bool(np.any(np.abs(y) > clipping_threshold))


def subsample(
    data: np.ndarray,
    sub_sample_length: int,
    start_position: int = -1,
    return_start_position: bool = False,
    rng: np.random.Generator | None = None,
):
    """Random fixed-length crop (pad with zeros if too short). 1-D only."""
    if np.ndim(data) != 1:
        raise ValueError(f"Only support 1D data. The dim is {np.ndim(data)}")
    length = len(data)
    rng = rng or np.random.default_rng()

    if length > sub_sample_length:
        if start_position < 0:
            start_position = int(rng.integers(0, length - sub_sample_length))
        data = data[start_position : start_position + sub_sample_length]
    elif length < sub_sample_length:
        data = np.append(
            data, np.zeros(sub_sample_length - length, dtype=np.float32)
        )

    if return_start_position:
        return data, start_position
    return data
