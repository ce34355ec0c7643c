"""FullSubNet — the flagship full-band + sub-band fusion model
(counterpart of ``fullsubnet_tpu/models/fullsubnet.py``).

The unfused forward: pad the look-ahead frames, normalise, run the
full-band stage over B rows of F features, unfold the magnitude and the
full-band output along frequency, normalise again, drop bands (training
batches), and run ONE shared sub-band stage batched over all its rows.
Both stages run through the fused scan op, with the LSTM cell or the GRU
cell (``sequence_model``): on a CUDA tensor K1 or K1-GRU at inference,
K2 and K3 or K2-GRU and K4 under autograd.

``valid_frames`` takes length-bucketed inputs: zero-padded batches whose
rows have their own true frame counts. Not ported yet: the fused sub-band
input path (inference and training; the unfused path computes the same
function) and the mesh hooks (ROADMAP A.4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.feature import drop_band, drops_band, freq_unfold
from fullsubnet_tpu_torch.acoustics.norm import masked_offline_norm, norm_wrapper
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
        """``num_groups_in_drop_band`` is drop_band's group count (see
        ``forward``). ``generator`` seeds the random initial weights
        (default: a generator seeded with 0)."""
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

    def forward(
        self,
        noisy_mag: torch.Tensor,
        dropping_band: bool = True,
        valid_frames: int | torch.Tensor | None = None,
        band_rows: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """noisy_mag [B, 1, F, T] -> cRM [B, 2, F', T].

        F' = F unless drop_band applies: ``dropping_band`` and
        ``B > num_groups_in_drop_band > 1``, the JAX package's gate. Then
        the sub-band stage sees only F // G frequencies per sample, group
        by group, and F' = F // G (samples regrouped group-major), as in
        training. Inference passes ``dropping_band=False``.
        ``band_rows`` = (row offset, batch rows) says that these B rows are
        a slice of a larger training batch (a rank's share of a microbatch):
        the gate and each row's group are then that batch's
        (``acoustics.feature.drop_band``).

        ``valid_frames`` (a count, or a [B] tensor of counts) marks a
        zero-padded, length-bucketed input: row b's first
        ``valid_frames[b]`` frames are real, and its output there equals
        an unpadded run's. The caller zeroes the padded frames and
        discards the outputs past them. The offline norm takes the true
        count, including the model's own look-ahead frames; the full-band
        output is zeroed past them before the sub-band norm. Such calls
        are inference-shaped: drop_band must not apply.
        """
        if noisy_mag.ndim != 4:
            raise ValueError(f"noisy_mag must be [B, 1, F, T], got {tuple(noisy_mag.shape)}")
        x = F.pad(noisy_mag, (0, self.look_ahead))
        batch_size, num_channels, num_freqs, num_frames = x.shape
        if num_channels != 1:
            raise ValueError("FullSubNet takes the mag feature as input.")
        groups = self.num_groups_in_drop_band
        drop = dropping_band and drops_band(batch_size, groups, band_rows)

        norm, frame_mask = self.norm, None
        if valid_frames is not None:
            if drop:
                raise ValueError("valid_frames calls are inference-shaped: pass dropping_band=False")
            real = torch.as_tensor(valid_frames, device=x.device).reshape(-1) + self.look_ahead
            frame_mask = (torch.arange(num_frames, device=x.device) < real[:, None]).to(x.dtype)
            # causal norms return None: zero-padded tails leave them exact
            norm = masked_offline_norm(self.norm, real.to(torch.float32)[:, None, None, None]) or norm

        # Full-band stage
        fb_input = norm(x).reshape(batch_size, num_freqs, num_frames)
        fb_output = self.fb_model(fb_input).reshape(batch_size, 1, num_freqs, num_frames)
        if frame_mask is not None:
            # the padded frames' outputs (the biases) would reach the
            # sub-band norm's statistics
            fb_output = fb_output * frame_mask[:, None, None, :]

        # Unfold: [B, F, fb_unit, T] and [B, F, sb_unit, T]
        fb_unit = self.fb_num_neighbors * 2 + 1
        sb_unit = self.sb_num_neighbors * 2 + 1
        fb_unfolded = freq_unfold(fb_output, self.fb_num_neighbors).reshape(
            batch_size, num_freqs, fb_unit, num_frames
        )
        noisy_unfolded = freq_unfold(x, self.sb_num_neighbors).reshape(
            batch_size, num_freqs, sb_unit, num_frames
        )
        sb_input = norm(torch.cat([noisy_unfolded, fb_unfolded], dim=2))
        if drop:
            # drop after the full-spectrum norm, as the reference does
            sb_input = drop_band(sb_input.transpose(1, 2), groups, band_rows).transpose(1, 2)
            num_freqs = sb_input.shape[1]
        sb_input = sb_input.reshape(batch_size * num_freqs, sb_unit + fb_unit, num_frames)

        # One shared sub-band stack batched over all frequencies
        sb_mask = self.sb_model(sb_input)  # [B*F, 2, T]
        sb_mask = sb_mask.reshape(batch_size, num_freqs, 2, num_frames).permute(0, 2, 1, 3)
        return sb_mask[..., self.look_ahead :]
