"""Causal convolution blocks (counterpart of ``fullsubnet_tpu/nn/conv.py``):
the temporal conv net (TCN) and the 2-D causal conv and transposed-conv
blocks of an encoder-decoder. No model of the package builds them; they
are part of the library's surface.

Causality follows the reference: pad both sides, then chop the trailing
padded frames. The TCN's convolutions are weight-normalised, stored as a
direction ``v`` and a magnitude ``g`` per output channel. The 2-D blocks
hold their BatchNorm's running statistics, updated in training as
``torch.nn.BatchNorm2d`` does (momentum 0.1, unbiased running variance).
:func:`fullsubnet_tpu_torch.checkpoint.conv_state_from_jax_params` loads
the JAX package's parameters into these modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class WeightNormConv1d(nn.Module):
    """A dilated 1-D convolution whose weight is ``g * v / ||v||``, the norm
    over (in, k) per output channel, initialised as in the JAX package:
    v ~ 0.01·N(0, 1), g = 1, bias = 0."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.v = nn.Parameter(0.01 * torch.randn(n_outputs, n_inputs, kernel_size,
                                                 generator=generator))
        self.g = nn.Parameter(torch.ones(n_outputs))
        self.bias = nn.Parameter(torch.zeros(n_outputs))

    def weight(self) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(self.v ** 2, dim=(1, 2), keepdim=True))
        return self.g[:, None, None] * self.v / torch.clamp(norm, min=1e-12)

    def forward(self, x: torch.Tensor, padding: int, dilation: int) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.bias, padding=padding, dilation=dilation)


class TemporalBlock(nn.Module):
    """One causal residual block of the TCN: two weight-normalised dilated
    convolutions, each chopped, ReLU'd and dropped out, plus a 1x1
    downsample of the residual where the widths differ."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int, dilation: int,
                 dropout: float, generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size, self.dilation, self.dropout = kernel_size, dilation, dropout
        self.conv1 = WeightNormConv1d(n_inputs, n_outputs, kernel_size, generator)
        self.conv2 = WeightNormConv1d(n_outputs, n_outputs, kernel_size, generator)
        self.downsample = None
        if n_inputs != n_outputs:
            self.downsample = nn.Conv1d(n_inputs, n_outputs, 1)
            with torch.no_grad():
                self.downsample.weight.copy_(
                    0.01 * torch.randn(n_outputs, n_inputs, 1, generator=generator))
                self.downsample.bias.zero_()

    def _drop(self, h: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not (self.training and self.dropout):
            return h
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1 - self.dropout
        return torch.where(keep, h / (1 - self.dropout), torch.zeros_like(h))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        padding = (self.kernel_size - 1) * self.dilation
        out = x
        for conv in (self.conv1, self.conv2):
            out = conv(out, padding, self.dilation)
            out = out[:, :, : out.shape[-1] - padding] if padding else out  # chop
            out = self._drop(F.relu(out), generator)
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class TemporalConvNet(nn.Module):
    """A stack of causal residual blocks dilated 1, 2, 4, ...; x [B, C, T]
    -> [B, num_channels[-1], T]. In training with dropout the forward
    takes a ``torch.Generator`` that draws the dropout masks."""

    def __init__(self, num_inputs: int, num_channels, kernel_size: int = 2,
                 dropout: float = 0.2, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        widths = [num_inputs, *num_channels]
        self.blocks = nn.ModuleList(
            TemporalBlock(widths[i], widths[i + 1], kernel_size, 2 ** i, dropout, generator)
            for i in range(len(num_channels)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training and self.blocks and self.blocks[0].dropout and generator is None:
            raise ValueError("TemporalConvNet: training with dropout needs a torch.Generator "
                             "(otherwise dropout would be silently off)")
        for block in self.blocks:
            x = block(x, generator)
        return x


_ACTIVATIONS = {"ReLU": F.relu, "ELU": F.elu, "Tanh": torch.tanh,
                "LeakyReLU": lambda v: F.leaky_relu(v, 0.01)}


class CausalConvBlock(nn.Module):
    """x [B, C, F, T] -> a Conv2d with kernel (3, 2), stride (2, 1) and
    padding (0, 1), the future frame chopped, BatchNorm and
    ``activation``."""

    def __init__(self, in_channels: int, out_channels: int, activation: str = "ReLU"):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.conv = nn.Conv2d(in_channels, out_channels, (3, 2), stride=(2, 1), padding=(0, 1))
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation(self.bn(self.conv(x)[:, :, :, :-1]))


class CausalTransConvBlock(nn.Module):
    """x [B, C, F, T] -> a ConvTranspose2d with kernel (3, 2) and stride
    (2, 1), the future frame chopped, BatchNorm, then ReLU for the last
    block of a decoder and ELU for the others."""

    def __init__(self, in_channels: int, out_channels: int, is_last: bool = False,
                 output_padding=(0, 0)):
        super().__init__()
        self.is_last = is_last
        self.conv = nn.ConvTranspose2d(in_channels, out_channels, (3, 2), stride=(2, 1),
                                       output_padding=tuple(output_padding))
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn(self.conv(x)[:, :, :, :-1])
        return F.relu(out) if self.is_last else F.elu(out)
