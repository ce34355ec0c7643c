"""Full-band cIRM baseline (counterpart of ``fullsubnet_tpu/models/fullband.py``):
a 3-layer unidirectional LSTM over the magnitude spectrum emitting a 2F
cRM, the reference recipe's model
(``recipes/dns_interspeech_2020/fullband_baseline/model.py:8-68``):
look-ahead pad -> norm -> stacked LSTM -> Linear 2F -> the look-ahead
frames cut off. Its stack runs through the fused scan op: on a CUDA
tensor K1 at inference, K2 and K3 under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.acoustics.norm import masked_offline_norm, norm_wrapper
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel


class FullBandModel(nn.Module):
    def __init__(
        self,
        num_freqs: int,
        hidden_size: int,
        sequence_model: str = "LSTM",
        output_activate_function: str | None = None,
        look_ahead: int = 2,
        norm_type: str = "offline_laplace_norm",
        num_layers: int = 3,
        generator: torch.Generator | None = None,
    ):
        """``generator`` seeds the random initial weights (default: a
        generator seeded with 0)."""
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_freqs = num_freqs
        self.look_ahead = look_ahead
        self.norm = norm_wrapper(norm_type)
        self.fullband_model = SequenceModel(
            input_size=num_freqs,
            output_size=num_freqs * 2,
            hidden_size=hidden_size,
            num_layers=num_layers,
            bidirectional=False,
            sequence_model=sequence_model,
            output_activate_function=output_activate_function,
            generator=generator,
        )

    def forward(
        self,
        noisy_mag: torch.Tensor,
        dropping_band: bool = True,
        valid_frames: int | torch.Tensor | None = None,
    ) -> torch.Tensor:
        """noisy_mag [B, 1, F, T] -> cRM [B, 2, F, T]. ``dropping_band`` is
        taken for the trainer's and inferencer's one calling convention;
        this model has no drop_band.

        ``valid_frames`` (a count, or a [B] tensor of counts) marks a
        zero-padded, length-bucketed input, as ``FullSubNet.forward`` takes
        it: the offline norm's statistics cover each row's true frames,
        the model's own look-ahead frames counted as in an unpadded run, so
        the real frames' outputs equal an unpadded run's. The caller zeroes
        the padded frames and discards the outputs past them."""
        del dropping_band
        if noisy_mag.ndim != 4:
            raise ValueError(f"noisy_mag must be [B, 1, F, T], got {tuple(noisy_mag.shape)}")
        x = F.pad(noisy_mag, (0, self.look_ahead))
        b, c, f, t = x.shape
        if c != 1:
            raise ValueError("FullBandModel takes the mag feature as input.")

        norm = self.norm
        if valid_frames is not None:
            real = torch.as_tensor(valid_frames, device=x.device).reshape(-1) + self.look_ahead
            # causal norms return None: zero-padded tails leave them exact
            valid_total = real.to(torch.float32)[:, None, None, None]
            norm = masked_offline_norm(self.norm, valid_total) or norm

        out = self.fullband_model(norm(x).reshape(b, c * f, t))
        return out.reshape(b, 2, f, t)[..., self.look_ahead :]
