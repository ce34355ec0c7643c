"""Sub-band baseline (counterpart of ``fullsubnet_tpu/models/subband_baseline.py``):
one shared LSTM over per-frequency neighbourhood units, with no full-band
stream, the paper's third baseline. Each frequency is enhanced from its
(2N+1)-bin unit alone (31 inputs at N = 15), the frequencies riding the
stack's batch axis as in FullSubNet's sub-band stage. Its stack runs
through the fused scan op: on a CUDA tensor K1 at inference, K2 and K3
under autograd.

It takes two input forms: the noisy magnitude [B, 1, F, T] (training,
and the ``full_band_crm_mask``, ``mag`` and ``scaled_mask`` strategies),
and pre-unfolded units [F, F_s, T] of one utterance, the contract of its
own ``sub_band_crm_mask`` strategy (``infer/inferencer.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.feature import drop_band, drops_band, freq_unfold
from fullsubnet_tpu_torch.acoustics.norm import norm_wrapper
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel


class SubBandBaseline(nn.Module):
    def __init__(
        self,
        num_neighbors: int = 15,
        look_ahead: int = 2,
        sequence_model: str = "LSTM",
        hidden_size: int = 384,
        num_layers: int = 2,
        output_activate_function: str | None = None,
        norm_type: str = "offline_laplace_norm",
        num_groups_in_drop_band: int = 2,
        generator: torch.Generator | None = None,
    ):
        """``generator`` seeds the random initial weights (default: a
        generator seeded with 0)."""
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_neighbors = num_neighbors
        self.look_ahead = look_ahead
        self.num_groups_in_drop_band = num_groups_in_drop_band
        self.norm = norm_wrapper(norm_type)
        self.sb_model = SequenceModel(
            input_size=num_neighbors * 2 + 1,
            output_size=2,
            hidden_size=hidden_size,
            num_layers=num_layers,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=output_activate_function,
            generator=generator,
        )

    def forward(self, x: torch.Tensor, dropping_band: bool = True,
                band_rows: tuple[int, int] | None = None) -> torch.Tensor:
        """[B, 1, F, T] noisy magnitude -> cRM [B, 2, F', T], F' = F unless
        drop_band applies (``dropping_band`` and ``B > groups > 1``, as in
        FullSubNet: then F // G frequencies per sample, samples regrouped
        group-major; ``band_rows`` as there); or [F, F_s, T] pre-unfolded
        units of one utterance -> [F, 2, T], normalised with the statistics
        of the whole utterance."""
        if x.ndim == 3:
            units = self.norm(x[None])[0]  # the training statistics at B = 1
            return self.sb_model(units)

        if x.ndim != 4 or x.shape[1] != 1:
            raise ValueError(f"x must be [B, 1, F, T] or [F, F_s, T], got {tuple(x.shape)}")
        x = F.pad(x, (0, self.look_ahead))
        b, _, f, t = x.shape
        unit = 2 * self.num_neighbors + 1
        units = self.norm(freq_unfold(x, self.num_neighbors).reshape(b, f, unit, t))
        groups = self.num_groups_in_drop_band
        if dropping_band and drops_band(b, groups, band_rows):
            units = drop_band(units.transpose(1, 2), groups, band_rows).transpose(1, 2)
            f = units.shape[1]
        mask = self.sb_model(units.reshape(b * f, unit, t))  # [B·F, 2, T]
        mask = mask.reshape(b, f, 2, t).permute(0, 2, 1, 3)
        return mask[..., self.look_ahead :]
