"""SequenceModel — stacked LSTM or GRU + Linear head + activation
(counterpart of ``fullsubnet_tpu/nn/sequence_model.py``).

Operates on [B, F, T] with time last, like the reference. Parameter names
reproduce the reference state-dict keys
(``sequence_model.{weight,bias}_{ih,hh}_l{K}``,
``fc_output_layer.{weight,bias}``), so loading a reference checkpoint is
``load_state_dict``. The recurrent weights are plain parameters, not an
``nn.LSTM`` / ``nn.GRU``: every forward goes through
``ops.subband_lstm.fused_subband_lstm``, which runs the hand-written CUDA
kernels on a CUDA tensor (K1 or K1-GRU at inference; K2 and K3, or K2-GRU
and K4, under autograd) and the plain versions on a CPU tensor. Inputs
and weights may be bf16 (the training compute policy, or Improved
FullSubNet's ``compute_dtype``): a bf16 input runs the stack on bf16
weights with fp32 sums, and the output comes back in the input's dtype.

Ported so far: unidirectional LSTM and GRU stacks of 1 to 3 layers of any
width, with a Linear head (``output_size`` > 0) or without one
(``output_size`` = 0: no ``fc_output_layer``, the output is the top
layer's h, as Fast FullSubNet's encoder and decoder build them), and a
fixed activation. Bidirectional stacks and PReLU (ROADMAP A.3) raise.
A training call whose stash would pass ``_TRAIN_STASH_SHARE`` of the card
takes the op's time-chunked stash (``ops.subband_lstm.train_chunk``).
:meth:`SequenceModel.orthogonal_init_` draws the reference's
``weight_init`` (``nn/init.py``). The streaming engines carry the stack's
state from hop to hop: :meth:`SequenceModel.init_state`,
:meth:`SequenceModel.step` and :meth:`SequenceModel.step_block`, through
``ops.subband_lstm.fused_subband_lstm_step`` (K1 or K1-GRU from the
carried state on a CUDA tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fullsubnet_tpu_torch.nn.init import linear_init, rnn_weight_init
from fullsubnet_tpu_torch.nn.rnn import rnn_init_state
from fullsubnet_tpu_torch.ops.subband_lstm import (
    MAX_LAYERS,
    fused_subband_lstm,
    fused_subband_lstm_step,
    stash_budget_bytes,
)

_ACTIVATIONS = {
    "Tanh": torch.tanh,
    "ReLU": torch.relu,
    "ReLU6": F.relu6,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
}


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


_GATES = {"LSTM": 4, "GRU": 3}


class StackedRNNWeights(nn.Module):
    """The weights of a unidirectional ``nn.LSTM`` (G = 4) or ``nn.GRU``
    (G = 3), under their names, as plain parameters: ``weight_ih_l{K}``
    [G·H, in], ``weight_hh_l{K}`` [G·H, H], ``bias_ih_l{K}``,
    ``bias_hh_l{K}`` [G·H]. Initialised like ``nn.LSTM`` and ``nn.GRU``:
    U(±1/sqrt(H)) from ``generator``."""

    def __init__(self, input_size, hidden_size, num_layers, num_gates, generator):
        super().__init__()
        self.num_layers = num_layers
        bound = 1.0 / hidden_size**0.5
        for k in range(num_layers):
            in_k = input_size if k == 0 else hidden_size
            g = num_gates * hidden_size
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
    # the share of the card's memory one training call of the stack may hold
    # before the op chunks its stash over time: the JAX package's side-stack
    # budget (3 GiB of a 16 GiB v5e), since these stacks share the card with
    # a model's main stage
    _TRAIN_STASH_SHARE = 3 / 16

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
        if sequence_model not in _GATES:
            raise NotImplementedError(f"Not implemented {sequence_model}")
        if bidirectional:
            raise NotImplementedError(
                "only unidirectional stacks are ported; bidirectional ones come "
                "with ROADMAP A.3"
            )
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
        self.output_size = int(output_size) if output_size else 0
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.cell_type = sequence_model
        self.output_activate_function = output_activate_function
        self._act = _ACTIVATIONS.get(output_activate_function or "")
        self.sequence_model = StackedRNNWeights(
            input_size, hidden_size, num_layers, _GATES[sequence_model], generator
        )
        if self.output_size:
            self.fc_output_layer = LinearWeights(hidden_size, self.output_size, generator)

    @torch.no_grad()
    def orthogonal_init_(self, generator: torch.Generator) -> None:
        """The reference's ``weight_init``, as the JAX package's
        ``SequenceModel.init(orthogonal_init=True)`` draws it: per layer,
        orthogonal W_ih and W_hh and N(0,1) biases; the head's weight
        Xavier-normal and its bias N(0,1). In place, from ``generator``."""
        for layer in self.sequence_model.layers():
            for name, value in rnn_weight_init(layer, generator).items():
                layer[name].copy_(value)
        if self.output_size:
            fc = linear_init(self.hidden_size, self.output_size, generator)
            self.fc_output_layer.weight.copy_(fc["weight"])
            self.fc_output_layer.bias.copy_(fc["bias"])

    def _head(self):
        if not self.output_size:
            return None
        return {"weight": self.fc_output_layer.weight, "bias": self.fc_output_layer.bias}

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """x: [B, F, T] -> [B, F_out, T] (F_out = H for a head-less stack),
        in ``out_dtype``, x's dtype by default. A bf16 x runs the stack on
        bf16 weights (K1-bf16 at inference, the bf16 K2/K3 under autograd),
        with fp32 sums and an fp32 output before the cast."""
        if x.ndim != 3:
            raise ValueError(f"The shape of input is {tuple(x.shape)}.")
        out = fused_subband_lstm(
            x.permute(2, 0, 1),  # [T, B, F]
            *self.sequence_model.layers(),
            self._head(),
            stash_budget=stash_budget_bytes(self._TRAIN_STASH_SHARE, x.device),
        )  # [T, B, out] float32 (out = H head-less)
        if self._act is not None:
            out = self._act(out)
        return out.permute(1, 2, 0).to(out_dtype or x.dtype)

    # -- streaming -------------------------------------------------------

    def init_state(self, batch_size: int, device=None) -> list:
        """The zero state of B streamed rows: per layer (h, c) [B, H] for an
        LSTM, h for a GRU (``nn.rnn.rnn_init_state``), on ``device`` (the
        weights' by default)."""
        if device is None:
            device = self.sequence_model.weight_hh_l0.device
        return rnn_init_state(self.sequence_model.layers(), batch_size, self.cell_type, device)

    def step_block(self, state, x: torch.Tensor):
        """K frames of B rows from a carried state, the stack run once over
        them: x [K, B, F] fp32 -> (state, y [K, B, F_out]). No autograd."""
        out, state = fused_subband_lstm_step(x, *self.sequence_model.layers(), self._head(),
                                             states=state)
        if self._act is not None:
            out = self._act(out)
        return state, out

    def step(self, state, x: torch.Tensor):
        """One frame (JAX ``SequenceModel.step``): x [B, F] -> (state,
        y [B, F_out]); a head-less stack gives the top layer's h."""
        state, out = self.step_block(state, x[None])
        return state, out[0]
