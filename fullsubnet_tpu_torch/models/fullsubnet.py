"""FullSubNet — the flagship full-band + sub-band fusion model
(counterpart of ``fullsubnet_tpu/models/fullsubnet.py``).

The unfused inference forward: pad the look-ahead frames, normalise, run
the full-band stage over B rows of F features, unfold the magnitude and
the full-band output along frequency, normalise again, and run ONE
shared sub-band stage batched over all B·F frequencies. Both stages run
through the fused LSTM-scan kernel on a CUDA tensor.

Not ported yet: ``valid_frames`` (length-bucketed inputs), ``drop_band``
(training only), the fused sub-band input builder and the mesh hooks
(ROADMAP A.4, A.13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.feature import freq_unfold
from fullsubnet_tpu_torch.acoustics.norm import norm_wrapper
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel


class FullSubNet(nn.Module):
    def __init__(
        self,
        num_freqs: int = 257,
        look_ahead: int = 2,
        sequence_model: str = "LSTM",
        fb_num_neighbors: int = 0,
        sb_num_neighbors: int = 15,
        fb_output_activate_function: str | None = "ReLU",
        sb_output_activate_function: str | None = None,
        fb_model_hidden_size: int = 512,
        sb_model_hidden_size: int = 384,
        norm_type: str = "offline_laplace_norm",
        num_groups_in_drop_band: int = 2,
        generator: torch.Generator | None = None,
    ):
        """``num_groups_in_drop_band`` is kept for the recipe schema; it
        acts only in training. ``generator`` seeds the random initial
        weights (default: a generator seeded with 0)."""
        super().__init__()
        if sequence_model not in ("GRU", "LSTM"):
            raise ValueError("FullSubNet only supports GRU and LSTM.")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_freqs = num_freqs
        self.look_ahead = look_ahead
        self.fb_num_neighbors = fb_num_neighbors
        self.sb_num_neighbors = sb_num_neighbors
        self.num_groups_in_drop_band = num_groups_in_drop_band
        self.norm = norm_wrapper(norm_type)

        self.fb_model = SequenceModel(
            input_size=num_freqs,
            output_size=num_freqs,
            hidden_size=fb_model_hidden_size,
            num_layers=2,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=fb_output_activate_function,
            generator=generator,
        )
        self.sb_model = SequenceModel(
            input_size=(sb_num_neighbors * 2 + 1) + (fb_num_neighbors * 2 + 1),
            output_size=2,
            hidden_size=sb_model_hidden_size,
            num_layers=2,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=sb_output_activate_function,
            generator=generator,
        )

    def forward(self, noisy_mag: torch.Tensor) -> torch.Tensor:
        """noisy_mag [B, 1, F, T] -> cRM [B, 2, F, T]."""
        if noisy_mag.ndim != 4:
            raise ValueError(f"noisy_mag must be [B, 1, F, T], got {tuple(noisy_mag.shape)}")
        x = F.pad(noisy_mag, (0, self.look_ahead))
        batch_size, num_channels, num_freqs, num_frames = x.shape
        if num_channels != 1:
            raise ValueError("FullSubNet takes the mag feature as input.")

        # Full-band stage
        fb_input = self.norm(x).reshape(batch_size, num_freqs, num_frames)
        fb_output = self.fb_model(fb_input).reshape(batch_size, 1, num_freqs, num_frames)

        # Unfold: [B, F, fb_unit, T] and [B, F, sb_unit, T]
        fb_unit = self.fb_num_neighbors * 2 + 1
        sb_unit = self.sb_num_neighbors * 2 + 1
        fb_unfolded = freq_unfold(fb_output, self.fb_num_neighbors).reshape(
            batch_size, num_freqs, fb_unit, num_frames
        )
        noisy_unfolded = freq_unfold(x, self.sb_num_neighbors).reshape(
            batch_size, num_freqs, sb_unit, num_frames
        )
        sb_input = self.norm(torch.cat([noisy_unfolded, fb_unfolded], dim=2))
        sb_input = sb_input.reshape(batch_size * num_freqs, sb_unit + fb_unit, num_frames)

        # One shared sub-band LSTM batched over all frequencies
        sb_mask = self.sb_model(sb_input)  # [B*F, 2, T]
        sb_mask = sb_mask.reshape(batch_size, num_freqs, 2, num_frames).permute(0, 2, 1, 3)
        return sb_mask[..., self.look_ahead :]
