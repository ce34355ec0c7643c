"""Spectrogram and waveform features (counterpart of
``fullsubnet_tpu/acoustics/feature.py``).

Tensor side (torch): ``freq_unfold``, ``unfold_along_time``,
``drop_band``, ``batch_shuffle_frequency``, ``overlap_cat``,
``channel_wise_layer_norm`` and ``reduce_complexity_separately``. Host
side (numpy, the data pipeline and the tools): ``norm_amplitude``,
``tailor_dB_FS``, ``is_clipped``, ``subsample``, ``aligned_subsample``,
``frame_energies_db`` (the host mixer's windows, ``native``) and
``activity_detector``, copies of the JAX package's functions, so that the
port imports nothing of it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from fullsubnet_tpu_torch import native


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


def unfold_along_time(x: torch.Tensor, context_size: int) -> torch.Tensor:
    """Overlapping time-context chunks of a spectrogram, with no padding:
    [B, C, F, T] -> [B, T - N, C, F, N + 1], chunk i holding frames
    i .. i + N (N = ``context_size``)."""
    if x.ndim != 4:
        raise ValueError(f"The dims of input is {x.ndim}. It should be 4.")
    return x.unfold(3, context_size + 1, 1).permute(0, 3, 1, 2, 4)


def drops_band(rows: int, num_groups: int,
               band_rows: tuple[int, int] | None = None) -> bool:
    """Whether a training forward applies drop_band to ``rows`` rows: more
    than one group, and more rows than groups in the batch they belong to
    (``band_rows``, as in ``drop_band``), the JAX package's gate."""
    return num_groups > 1 and (band_rows or (0, rows))[1] > num_groups


def drop_band(x: torch.Tensor, num_groups: int = 2,
              band_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Interleaved frequency subsampling across batch groups.

    Sample i of group g (samples g, g+G, ...) keeps only frequencies
    g, g+G, g+2G, ... of the spectrum truncated to a multiple of G.
    [B, C, F, T] -> [B, C, F//G, T], samples regrouped group-major.

    ``band_rows`` = (row offset, batch rows) says that ``x`` is a slice of
    a larger batch, its rows from the offset on (one data-parallel rank's
    share of a microbatch). A row's group is then its index in that batch
    modulo G, and the size check is the batch's, as the JAX step sees the
    whole batch. None: ``x`` is the whole batch.
    """
    rows, _, num_freqs, _ = x.shape
    row_offset, batch_size = band_rows or (0, rows)
    if batch_size <= num_groups:
        raise ValueError(
            f"Batch size = {batch_size}, num_groups = {num_groups}. The batch "
            "size should be larger than the number of groups."
        )
    if num_groups <= 1:
        return x
    x = x[..., : num_freqs - num_freqs % num_groups, :]
    return torch.cat(
        [x[(g - row_offset) % num_groups :: num_groups][:, :, g::num_groups]
         for g in range(num_groups)],
        dim=0,
    )


def batch_shuffle_frequency(
    x: torch.Tensor,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
):
    """Permute the frequency axis of each batch element: x [B, C, F, T]
    -> (shuffled, indices [B, F]). ``indices`` given are used as they
    are; otherwise each row's permutation is drawn from ``generator``."""
    if x.ndim != 4:
        raise ValueError(f"x must be [B, C, F, T], got {tuple(x.shape)}")
    b, c, f, t = x.shape
    if indices is None:
        if generator is None:
            raise ValueError("Provide a torch.Generator or explicit indices.")
        indices = torch.stack([torch.randperm(f, generator=generator) for _ in range(b)])
    indices = torch.as_tensor(indices, device=x.device).long()
    out = torch.gather(x, 2, indices[:, None, :, None].expand(b, c, f, t))
    return out, indices


def overlap_cat(chunk_list, dim: int = -1) -> torch.Tensor:
    """Concatenate equal-length chunks that overlap by half, averaging the
    overlapping halves."""
    pieces = []
    for i, chunk in enumerate(chunk_list):
        half = chunk.shape[dim] // 2
        first_half, last_half = chunk.split([half, chunk.shape[dim] - half], dim=dim)
        if i == 0:
            pieces += [first_half, last_half]
        else:
            pieces[-1] = (pieces[-1] + first_half) / 2
            pieces.append(last_half)
    return torch.cat(pieces, dim=dim)


def channel_wise_layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the channel axis of [B, N, K]: the statistics over N
    for each batch row and position (biased variance), then ``scale`` [N]
    and ``bias`` [N]."""
    mu = torch.mean(x, dim=1, keepdim=True)
    var = torch.var(x, dim=1, keepdim=True, unbiased=False)
    normed = (x - mu) * torch.rsqrt(var + eps)
    return normed * scale[None, :, None] + bias[None, :, None]


def reduce_complexity_separately(
    sub_band_input: torch.Tensor, full_band_output: torch.Tensor
) -> torch.Tensor:
    """FullSubNet's deterministic group selection: the batch splits into 3
    groups, group i keeps frequencies i+1, i+4, ... (never the first or
    last bin) and joins its sub-band and full-band units on the unit axis.
    sub_band_input [B, F, C, F_s, T], full_band_output [B, F, C, F_f, T]
    -> [3·(B // 3), ~F // 3, C, F_s + F_f, T]."""
    sub_batch_size = full_band_output.shape[0] // 3
    n_freqs = full_band_output.shape[1]
    selected = []
    for idx in range(3):
        rows = slice(idx * sub_batch_size, (idx + 1) * sub_batch_size)
        freqs = torch.arange(idx + 1, n_freqs - 1, 3, device=full_band_output.device)
        selected.append(torch.cat([sub_band_input[rows][:, freqs],
                                   full_band_output[rows][:, freqs]], dim=-2))
    return torch.cat(selected, dim=0)


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


def aligned_subsample(
    data_a: np.ndarray,
    data_b: np.ndarray,
    sub_sample_length: int,
    rng: np.random.Generator | None = None,
):
    """Crop the same random segment from two aligned signals (last axis),
    zero-padding both when they are shorter."""
    if data_a.shape[-1] != data_b.shape[-1]:
        raise ValueError("Inconsistent dataset size.")
    rng = rng or np.random.default_rng()
    length = data_a.shape[-1]
    if length > sub_sample_length:
        start = int(rng.integers(0, length - sub_sample_length + 1))
        end = start + sub_sample_length
        return data_a[..., start:end], data_b[..., start:end]
    if length < sub_sample_length:
        pad_width = [(0, 0)] * (data_a.ndim - 1) + [(0, sub_sample_length - length)]
        return (
            np.pad(data_a, pad_width, mode="constant"),
            np.pad(data_b, pad_width, mode="constant"),
        )
    return data_a, data_b


def frame_energies_db(x: np.ndarray, window: int, eps: float = 1e-6) -> np.ndarray:
    """The energy in dB of each ``window``-sample window of x (the last
    window partial), summed in float64 by the host mixer."""
    return native.frame_energies_db(x, window, eps)


def plain_frame_energies_db(x: np.ndarray, window: int, eps: float = 1e-6) -> np.ndarray:
    """``frame_energies_db`` in numpy: the plain version the tests hold the
    host mixer to."""
    x = np.asarray(x, np.float32)
    out = [20 * np.log10(np.sum(x[s : s + window].astype(np.float64) ** 2) + eps)
           for s in range(0, len(x), window)]
    return np.asarray(out, dtype=np.float32)


def activity_detector(
    audio: np.ndarray,
    fs: int = 16000,
    activity_threshold: float = 0.13,
    target_level: float = -25,
    eps: float = 1e-6,
) -> float:
    """The fraction of 50 ms windows whose smoothed energy probability
    exceeds ``activity_threshold``: a frame-energy VAD with attack and
    release smoothing, which filters the clean speech lists."""
    audio, _, _ = tailor_dB_FS(audio, target_level)
    energies_db = frame_energies_db(audio, int(fs * 50 / 1000), eps)

    a, b = -1.0, 0.2
    alpha_rel, alpha_att = 0.05, 0.8
    prev_energy_prob = 0.0
    active_frames = 0
    for frame_rms in energies_db:
        frame_energy_prob = 1.0 / (1 + np.exp(-(a + b * frame_rms)))
        if frame_energy_prob > prev_energy_prob:
            smoothed = frame_energy_prob * alpha_att + prev_energy_prob * (1 - alpha_att)
        else:
            smoothed = frame_energy_prob * alpha_rel + prev_energy_prob * (1 - alpha_rel)
        if smoothed > activity_threshold:
            active_frames += 1
        prev_energy_prob = frame_energy_prob
    return active_frames / len(energies_db)
