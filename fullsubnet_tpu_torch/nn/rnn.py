"""The plain stacked LSTM forward (counterpart of ``fullsubnet_tpu/nn/rnn.py``).

Parameters keep the torch ``nn.LSTM`` layout, as in the JAX package:
``w_ih`` [4H, in], ``w_hh`` [4H, H], ``b_ih``/``b_hh`` [4H], gate order
i, f, g, o. The input projection of every step is one matmul outside the
time loop; the loop holds only the recurrent product and the cell. This
is the reference arithmetic of the fused kernel in ``ops/subband_lstm.py``
and what its CPU path runs. Unidirectional stacks only.
"""

from __future__ import annotations

import torch


def lstm_layer(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer with zero initial state: x [T, N, in] -> [T, N, H]."""
    t, n, _ = x.shape
    w_hh_t = layer["w_hh"].t()
    hidden = w_hh_t.shape[0]
    x_proj = x @ layer["w_ih"].t() + (layer["b_ih"] + layer["b_hh"])  # [T, N, 4H]
    h = x.new_zeros(n, hidden)
    c = x.new_zeros(n, hidden)
    hs = []
    for step in range(t):
        gates = x_proj[step] + h @ w_hh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def lstm_forward(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked unidirectional LSTM: x [T, N, in] -> [T, N, H]."""
    for layer in layers:
        x = lstm_layer(layer, x)
    return x
