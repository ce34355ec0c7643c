"""Improved FullSubNet (counterpart of
``fullsubnet_tpu/models/improved_fullsubnet.py``): a wave-to-wave model
with finer-to-coarser sub-band sections, at 16 kHz and 48 kHz.

STFT -> magnitude ** ``fdrc`` -> the last bin dropped -> norm -> the
full-band stack -> per section (the spectrum split at ``freq_cutoffs``),
a strided unfold of the magnitude and of the full-band output, its own
norm over the whole section and its own 2-layer stack emitting 2·c mask
values a unit of c center bins -> the cRM, its last bin 0 -> the mask
applied per component -> iSTFT at the input length. Every stack runs
through the fused scan op: on a CUDA tensor K1 at inference, K2 and K3
under autograd (at fp32 under the bf16 policy too: the stacks' inputs
come from the fp32 STFT, so the bf16 weights promote, as in the JAX
package).

``compute_dtype`` (None, ``"bfloat16"`` or ``torch.bfloat16``, as the JAX
model's argument): the compressed magnitude is cast to it before the
norm, so the stacks run on bf16 inputs and weights (K1-bf16 at inference,
the bf16 K2/K3 under autograd) with fp32 sums; the full-band output comes
back in bf16 and feeds the sections, whose cRM stays fp32, as do the STFT,
the masking and the iSTFT. The JAX package takes its kernel at bf16 only
from 128 section rows and 64 full-band rows on the TPU (an fp32 scan on
bf16 inputs below); the port runs K1-bf16 at every row count on CUDA.

``valid_samples`` takes length-bucketed waveforms: zero-padded batches
whose rows have their own true sample counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.norm import masked_offline_norm, norm_wrapper
from fullsubnet_tpu_torch.acoustics.stft import (
    insert_tail_reflection,
    istft,
    stft_complex,
    traced_num_frames,
)
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel


def _strided_freq_unfold(
    x: torch.Tensor,
    lower_cutoff: int,
    upper_cutoff: int,
    num_center_freqs: int,
    num_neighbor_freqs: int,
) -> torch.Tensor:
    """Strided sub-band unfold of one frequency section: x [B, 1, F, T] ->
    [B, N_units, 1, center + 2·neighbours, T], a unit every
    ``num_center_freqs`` bins. The lowest and the highest section
    reflect-pad outward by the neighbour count; an interior section reads
    its neighbours from the adjacent sections."""
    b, c, f, t = x.shape
    if c != 1:
        raise ValueError("Only mono audio is supported.")
    if (upper_cutoff - lower_cutoff) % num_center_freqs != 0:
        raise ValueError(
            "The number of center frequencies should be divisible by the "
            f"subband frequency interval. Got num_center_freqs={num_center_freqs}, "
            f"upper_cutoff_freq={upper_cutoff}, lower_cutoff_freq={lower_cutoff}."
        )
    nb = num_neighbor_freqs
    if lower_cutoff == 0:
        valid = F.pad(x[..., : upper_cutoff + nb, :], (0, 0, nb, 0), mode="reflect")
    elif upper_cutoff == f:
        valid = F.pad(x[..., lower_cutoff - nb :, :], (0, 0, 0, nb), mode="reflect")
    else:
        valid = x[..., lower_cutoff - nb : upper_cutoff + nb, :]
    # [B, 1, N, T, width] -> [B, N, 1, width, T]
    units = valid.unfold(2, num_center_freqs + 2 * nb, num_center_freqs)
    return units.permute(0, 2, 1, 4, 3)


class SubbandModel(nn.Module):
    """The finer-to-coarser sub-band stage: one 2-layer stack per section,
    at ``sb_models.{i}``."""

    def __init__(
        self,
        freq_cutoffs,
        sb_num_center_freqs,
        sb_num_neighbor_freqs,
        fb_num_center_freqs,
        fb_num_neighbor_freqs,
        sequence_model: str,
        hidden_size: int,
        activate_function: str | None = None,
        norm_type: str = "offline_laplace_norm",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.freq_cutoffs = list(freq_cutoffs)
        self.sb_num_center_freqs = list(sb_num_center_freqs)
        self.sb_num_neighbor_freqs = list(sb_num_neighbor_freqs)
        self.fb_num_center_freqs = list(fb_num_center_freqs)
        self.fb_num_neighbor_freqs = list(fb_num_neighbor_freqs)
        self.norm = norm_wrapper(norm_type)
        self.sb_models = nn.ModuleList(
            SequenceModel(
                input_size=(sc + 2 * sn) + (fc + 2 * fn),
                output_size=sc * 2,
                hidden_size=hidden_size,
                num_layers=2,
                bidirectional=False,
                sequence_model=sequence_model,
                output_activate_function=activate_function,
                generator=generator,
            )
            for sc, sn, fc, fn in zip(
                self.sb_num_center_freqs,
                self.sb_num_neighbor_freqs,
                self.fb_num_center_freqs,
                self.fb_num_neighbor_freqs,
            )
        )

    def _section_bounds(self, sb_idx: int, num_freqs: int) -> tuple[int, int]:
        if sb_idx == 0:
            return 0, self.freq_cutoffs[0]
        if sb_idx == len(self.sb_models) - 1:
            return self.freq_cutoffs[-1], num_freqs
        return self.freq_cutoffs[sb_idx - 1], self.freq_cutoffs[sb_idx]

    def forward(self, noisy_input: torch.Tensor, fb_output: torch.Tensor,
                valid_total: torch.Tensor | None = None) -> torch.Tensor:
        """noisy_input and fb_output [B, 1, F, T] -> cRM [B, 2, F, T].

        ``valid_total``: [b, 1, 1, 1] true frame counts of a zero-padded
        batch; an offline norm then takes its statistics over them (a
        causal norm is exact under zero tails as it is)."""
        b, c, f, t = noisy_input.shape
        if c != 1:
            raise ValueError("Only mono audio is supported.")
        norm = self.norm
        if valid_total is not None:
            norm = masked_offline_norm(self.norm, valid_total) or norm

        sections = []
        for sb_idx, sb_model in enumerate(self.sb_models):
            lower, upper = self._section_bounds(sb_idx, f)
            noisy_sub = _strided_freq_unfold(noisy_input, lower, upper,
                                             self.sb_num_center_freqs[sb_idx],
                                             self.sb_num_neighbor_freqs[sb_idx])
            fb_sub = _strided_freq_unfold(fb_output, lower, upper,
                                          self.fb_num_center_freqs[sb_idx],
                                          self.fb_num_neighbor_freqs[sb_idx])
            sb_in = torch.cat([noisy_sub, fb_sub], dim=-2)  # [B, N, 1, width, T]
            n_units, width = sb_in.shape[1], sb_in.shape[-2]
            # the norm's statistics span the whole section (all its units),
            # not one unit, as in the reference
            sb_in = norm(sb_in.reshape(b, n_units, width, t))
            # without an activation the stack's fp32 output is kept, as the
            # JAX package's kernel route keeps it for a bf16 input
            out_dtype = None if sb_model.output_activate_function else torch.float32
            out = sb_model(sb_in.reshape(b * n_units, width, t), out_dtype)  # [B·N, 2c, T]
            # -> [B, N, 2, c, T] -> [B, 2, N·c, T]
            out = out.reshape(b, n_units, 2, -1, t).transpose(1, 2)
            sections.append(out.reshape(b, 2, -1, t))
        return torch.cat(sections, dim=-2)


def _compute_dtype(value: str | torch.dtype | None) -> torch.dtype | None:
    """The stacks' compute dtype from the model's argument: None, a torch
    dtype, or ``"bfloat16"`` as a TOML gives it."""
    if value is None or isinstance(value, torch.dtype):
        return value
    if value == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be None, 'bfloat16' or a torch dtype, got {value!r}")


class ImprovedFullSubNet(nn.Module):
    """Wave-to-wave model: STFT, FDRC, full-band stack, multi-section
    sub-band cRM, masking, iSTFT."""

    # maps the noisy waveform [B, S] to the enhanced one and takes
    # ``valid_samples`` (:func:`fullsubnet_tpu_torch.models.is_wave_to_wave`)
    wave_to_wave = True

    def __init__(
        self,
        n_fft: int = 512,
        hop_length: int = 128,
        win_length: int = 512,
        fdrc: float = 0.5,
        num_freqs: int = 257,
        freq_cutoffs=(20, 80),
        sb_num_center_freqs=(1, 4, 8),
        sb_num_neighbor_freqs=(15, 15, 15),
        fb_num_center_freqs=(1, 4, 8),
        fb_num_neighbor_freqs=(15, 15, 15),
        fb_hidden_size: int = 512,
        sb_hidden_size: int = 384,
        sequence_model: str = "LSTM",
        fb_output_activate_function: str | None = None,
        sb_output_activate_function: str | None = None,
        norm_type: str = "offline_laplace_norm",
        compute_dtype: str | torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ):
        """``generator`` seeds the random initial weights (default: a
        generator seeded with 0). ``compute_dtype``: None (fp32), or
        ``"bfloat16"`` / ``torch.bfloat16`` for the stacks."""
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.compute_dtype = _compute_dtype(compute_dtype)
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.fdrc = fdrc
        self.num_freqs = num_freqs
        self.norm = norm_wrapper(norm_type)
        self.fb_model = SequenceModel(
            input_size=num_freqs - 1,  # the last bin is dropped
            output_size=num_freqs - 1,
            hidden_size=fb_hidden_size,
            num_layers=2,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=fb_output_activate_function,
            generator=generator,
        )
        self.sb_model = SubbandModel(
            freq_cutoffs=freq_cutoffs,
            sb_num_center_freqs=sb_num_center_freqs,
            sb_num_neighbor_freqs=sb_num_neighbor_freqs,
            fb_num_center_freqs=fb_num_center_freqs,
            fb_num_neighbor_freqs=fb_num_neighbor_freqs,
            hidden_size=sb_hidden_size,
            sequence_model=sequence_model,
            activate_function=sb_output_activate_function,
            norm_type=norm_type,
            generator=generator,
        )

    def forward(self, y: torch.Tensor, valid_samples: int | torch.Tensor | None = None
                ) -> torch.Tensor:
        """y [B, S] or [B, 1, S] noisy waveform -> enhanced [B, 1, S].

        ``valid_samples`` (a count, or a [B] tensor of counts, each above
        ``n_fft // 2`` and at most S - ``n_fft // 2``) marks a zero-padded,
        length-bucketed batch: row b's first ``valid_samples[b]`` output
        samples equal its unpadded run's. The tail reflection is re-created
        at the true length, the padded frames of the magnitude are zeroed,
        every offline norm takes the true frame count, the full-band output
        is zeroed past it, and the iSTFT leaves the padded frames out. The
        caller discards the output past each count."""
        if y.ndim == 3:
            if y.shape[1] != 1:
                raise ValueError(f"y must be [B, S] or [B, 1, S], got {tuple(y.shape)}")
            y = y[:, 0]
        elif y.ndim != 2:
            raise ValueError(f"y must be [B, S] or [B, 1, S], got {tuple(y.shape)}")
        num_samples = y.shape[-1]
        frames_real = None
        if valid_samples is not None:
            counts = torch.as_tensor(valid_samples, device=y.device).reshape(-1).long()
            y = insert_tail_reflection(y, counts.expand(y.shape[0]), self.n_fft)
            frames_real = traced_num_frames(counts, self.hop_length, self.n_fft)

        spec = stft_complex(y, self.n_fft, self.hop_length, self.win_length)  # [B, F, T]
        noisy_mag = spec.abs()[:, None]
        tmask = valid_total = None
        norm = self.norm
        if frames_real is not None:
            tmask = (torch.arange(spec.shape[-1], device=y.device) < frames_real[:, None]
                     ).to(torch.float32)  # [b, T], b in {1, B}
            noisy_mag = noisy_mag * tmask[:, None, None, :]
            valid_total = frames_real.to(torch.float32)[:, None, None, None]
            norm = masked_offline_norm(self.norm, valid_total) or norm

        # the full-band stage on the compressed magnitude, last bin dropped
        noisy_mag = (noisy_mag**self.fdrc)[..., :-1, :]
        if self.compute_dtype is not None:
            noisy_mag = noisy_mag.to(self.compute_dtype)
        b, _, f, t = noisy_mag.shape
        fb_output = self.fb_model(norm(noisy_mag).reshape(b, f, t)).reshape(b, 1, f, t)
        if tmask is not None:
            # the padded frames' outputs (the biases) would reach the
            # sections' norm statistics
            fb_output = fb_output * tmask[:, None, None, :].to(fb_output.dtype)

        crm = self.sb_model(noisy_mag, fb_output, valid_total=valid_total).float()
        crm = F.pad(crm, (0, 0, 0, 1))  # the last bin's mask is 0
        # the mask per component (real by real, imag by imag), not a complex
        # product, as the reference applies it
        enhanced_real = crm[:, 0] * spec.real
        enhanced_imag = crm[:, 1] * spec.imag
        frame_mask = None
        if tmask is not None:
            enhanced_real = enhanced_real * tmask[:, None, :]
            enhanced_imag = enhanced_imag * tmask[:, None, :]
            frame_mask = tmask if tmask.shape[0] > 1 else tmask[0]
        return istft((enhanced_real, enhanced_imag), self.n_fft, self.hop_length,
                     self.win_length, length=num_samples, input_type="real_imag",
                     frame_mask=frame_mask)[:, None, :]
