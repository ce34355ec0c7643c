"""Batched STFT / iSTFT on ``torch.stft`` / ``torch.istft`` (counterpart
of ``fullsubnet_tpu/acoustics/stft.py``).

Conventions are the reference's: periodic Hann window, center=True with
reflect padding, onesided spectrum, no normalisation, and iSTFT
overlap-add with the squared-window envelope and the ``length=`` trim
(with an explicit length, samples ``[n_fft//2 : n_fft//2 + length]`` are
kept, zero-padded if the signal is shorter). On a CUDA tensor both run
on cuFFT. All functions take leading batch dims: [..., T] <-> [..., F, T'].
A signal of at most ``n_fft // 2`` samples is reflect-padded as numpy
(and the JAX package) pad it, by repeated reflection, which
``torch.stft`` refuses. ``insert_tail_reflection`` and
``traced_num_frames`` serve the length-bucketed paths, and so does the
iSTFT's ``frame_mask``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hann_window(
    win_length: int, device=None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``), in a
    storage of its own: torch's is a view of a window one sample longer,
    which an exported program holding it as a constant would save in part."""
    return torch.hann_window(win_length, periodic=True, device=device, dtype=dtype).clone()


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
    flat = y.reshape(-1, y.shape[-1])
    if center and flat.shape[-1] <= n_fft // 2:
        flat, center = _reflect_pad(flat, n_fft // 2), False
    spec = torch.stft(
        flat,
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


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """[..., L] -> [..., L + 2 pad] by numpy's ``mode="reflect"`` for any
    ``pad``: the signal reflected about its end samples again and again
    (period 2 (L - 1); a single sample repeats)."""
    length = y.shape[-1]
    idx = torch.arange(-pad, length + pad, device=y.device)
    if length == 1:
        return y[..., idx * 0]
    period = 2 * (length - 1)
    idx = idx % period
    idx = torch.where(idx >= length, period - idx, idx)
    return y[..., idx]


def istft(
    features,
    n_fft: int,
    hop_length: int,
    win_length: int,
    length: int | None = None,
    input_type: str = "complex",
    window: torch.Tensor | None = None,
    center: bool = True,
    frame_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse STFT of [..., F, T'] -> [..., T].

    ``input_type``: "complex" | "real_imag" (tuple) | "mag_phase" (tuple).
    ``frame_mask``: 0/1 over the frames, [T'] or the batch's shape + [T']
    (each row's true frames in a zero-padded batch). Masked frames add
    neither signal nor envelope, so each row's samples over its true
    frames equal the iSTFT of its unpadded spectrum (``torch.istft``
    divides by the envelope of every frame, which differs there).
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
    if frame_mask is not None:
        return _masked_istft(spec, n_fft, hop_length, window, length, center, frame_mask)
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


def _masked_istft(spec, n_fft, hop_length, window, length, center, frame_mask,
                  epsilon: float = 1e-11):
    """The iSTFT as the JAX package's ``istft(frame_mask=)`` computes it:
    the windowed frames and the squared window, both masked, overlap-added
    (``F.fold``), the signal divided by the envelope (at least
    ``epsilon``), then the center trim and the ``length`` cut."""
    lead, num_frames = spec.shape[:-2], spec.shape[-1]
    left = (n_fft - window.shape[-1]) // 2
    window = F.pad(window, (left, n_fft - window.shape[-1] - left))
    mask = frame_mask.to(window.dtype)[..., :, None]  # [..., T', 1]
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft) * window * mask
    env = (window**2 * mask).expand(*lead, num_frames, n_fft)
    out_len = n_fft + (num_frames - 1) * hop_length

    def overlap_add(v):  # [..., T', n_fft] -> [..., out_len]
        flat = v.reshape(-1, num_frames, n_fft).transpose(1, 2)
        out = F.fold(flat, (1, out_len), (1, n_fft), stride=(1, hop_length))
        return out.reshape(*lead, out_len)

    out = overlap_add(frames) / torch.clamp(overlap_add(env), min=epsilon)
    start = n_fft // 2 if center else 0
    end = out_len - start if length is None else min(start + length, out_len)
    out = out[..., start:end]
    if length is not None and out.shape[-1] < length:
        out = F.pad(out, (0, length - out.shape[-1]))
    return out


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


def traced_num_frames(true_len, hop_length: int, n_fft: int):
    """:func:`num_stft_frames` (center=True) of a sample count that may be a
    tensor of counts: ``1 + (true_len + extra) // hop`` elementwise."""
    extra = 2 * (n_fft // 2) - n_fft
    return 1 + (true_len + extra) // hop_length


def insert_tail_reflection(y: torch.Tensor, true_len: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Re-create torch's center-pad tail reflection of zero-padded waves at
    their true lengths: ``y_pad[b, L + i] = y[b, L - 2 - i]`` for
    ``i < n_fft // 2``, with ``L = true_len[b]``. ``y``: [B, bucket];
    ``true_len``: [B] int64 on y's device, each with
    ``n_fft // 2 < L`` and ``L + n_fft // 2 <= bucket``. Returns a new
    tensor."""
    i = torch.arange(n_fft // 2, device=y.device)
    lengths = true_len.reshape(-1, 1)
    return y.scatter(-1, lengths + i, y.gather(-1, lengths - 2 - i))
