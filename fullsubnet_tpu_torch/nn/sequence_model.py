"""SequenceModel — stacked LSTM + Linear head + activation (counterpart of
``fullsubnet_tpu/nn/sequence_model.py``).

Operates on [B, F, T] with time last, like the reference. Parameter names
reproduce the reference state-dict keys
(``sequence_model.{weight,bias}_{ih,hh}_l{K}``,
``fc_output_layer.{weight,bias}``), so loading a reference checkpoint is
``load_state_dict``. The LSTM weights are plain parameters, not an
``nn.LSTM``: every forward goes through
``ops.subband_lstm.fused_subband_lstm``, which runs the hand-written CUDA
kernel on a CUDA tensor and the plain version on a CPU tensor.

Ported so far: unidirectional LSTM stacks of 1 to 3 layers with a Linear
head and a fixed activation (the flagship FullSubNet stages). GRU and
bidirectional stacks (ROADMAP B.1) and PReLU (A.3) raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.ops.subband_lstm import MAX_LAYERS, fused_subband_lstm

_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": F.relu6,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
}


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class StackedLSTMWeights(nn.Module):
    """The weights of a unidirectional ``nn.LSTM``, under its names, as
    plain parameters: ``weight_ih_l{K}`` [4H, in], ``weight_hh_l{K}``
    [4H, H], ``bias_ih_l{K}``, ``bias_hh_l{K}`` [4H]. Initialised like
    ``nn.LSTM``: U(±1/sqrt(H)) from ``generator``."""

    def __init__(self, input_size, hidden_size, num_layers, generator):
        super().__init__()
        self.num_layers = num_layers
        bound = 1.0 / hidden_size**0.5
        for k in range(num_layers):
            in_k = input_size if k == 0 else hidden_size
            g = 4 * hidden_size
            self.register_parameter(f"weight_ih_l{k}", _uniform((g, in_k), bound, generator))
            self.register_parameter(f"weight_hh_l{k}", _uniform((g, hidden_size), bound, generator))
            self.register_parameter(f"bias_ih_l{k}", _uniform((g,), bound, generator))
            self.register_parameter(f"bias_hh_l{k}", _uniform((g,), bound, generator))

    def layers(self) -> list[dict]:
        """Per-layer {w_ih, w_hh, b_ih, b_hh} dicts, as the ops take them."""
        return [
            {
                "w_ih": getattr(self, f"weight_ih_l{k}"),
                "w_hh": getattr(self, f"weight_hh_l{k}"),
                "b_ih": getattr(self, f"bias_ih_l{k}"),
                "b_hh": getattr(self, f"bias_hh_l{k}"),
            }
            for k in range(self.num_layers)
        ]


class LinearWeights(nn.Module):
    """An ``nn.Linear``'s ``weight`` [out, in] and ``bias`` [out],
    initialised like it (U(±1/sqrt(in))) from ``generator``."""

    def __init__(self, in_features, out_features, generator):
        super().__init__()
        bound = 1.0 / in_features**0.5
        self.weight = _uniform((out_features, in_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator)


class SequenceModel(nn.Module):
    def __init__(
        self,
        input_size: int,
        output_size: int,
        hidden_size: int,
        num_layers: int,
        bidirectional: bool,
        sequence_model: str = "GRU",
        output_activate_function: str | None = "Tanh",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if sequence_model != "LSTM" or bidirectional:
            raise NotImplementedError(
                f"only unidirectional LSTM stacks are ported; {sequence_model} "
                f"(bidirectional={bidirectional}) comes with ROADMAP B.1"
            )
        if not output_size:
            raise NotImplementedError("stacks without a Linear head are not ported")
        if not 1 <= num_layers <= MAX_LAYERS:
            raise NotImplementedError(f"1..{MAX_LAYERS} layers are supported")
        if output_activate_function and output_activate_function not in _ACTIVATIONS:
            if output_activate_function == "PReLU":
                raise NotImplementedError("PReLU is not ported yet (ROADMAP A.3)")
            raise NotImplementedError(
                f"Not implemented activation function {output_activate_function}"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_size = input_size
        self.output_size = int(output_size)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.output_activate_function = output_activate_function
        self._act = _ACTIVATIONS.get(output_activate_function or "")
        self.sequence_model = StackedLSTMWeights(
            input_size, hidden_size, num_layers, generator
        )
        self.fc_output_layer = LinearWeights(hidden_size, self.output_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, F, T] -> [B, F_out, T]."""
        if x.ndim != 3:
            raise ValueError(f"The shape of input is {tuple(x.shape)}.")
        fc = {"weight": self.fc_output_layer.weight, "bias": self.fc_output_layer.bias}
        out = fused_subband_lstm(
            x.permute(2, 0, 1),  # [T, B, F]
            *self.sequence_model.layers(),
            fc,
        )  # [T, B, out] float32
        if self._act is not None:
            out = self._act(out)
        return out.permute(1, 2, 0).to(x.dtype)
