"""The plain stacked LSTM and GRU forwards (counterpart of
``fullsubnet_tpu/nn/rnn.py``).

Parameters keep the torch ``nn.LSTM`` / ``nn.GRU`` layout, as in the JAX
package: ``w_ih`` [G·H, in], ``w_hh`` [G·H, H], ``b_ih``/``b_hh`` [G·H],
gate order i, f, g, o (LSTM, G = 4) or r, z, n (GRU, G = 3). The input
projection of every step is one matmul outside the time loop; the loop
holds only the recurrent product and the cell. This is the reference
arithmetic of the fused kernels in ``ops/subband_lstm.py`` and what
their CPU path runs. Unidirectional stacks only.

The streaming engines carry a stack's state from hop to hop:
:func:`rnn_init_state` makes it, :func:`lstm_step` and :func:`gru_step`
are one transition of either cell.
"""

from __future__ import annotations

import torch


def rnn_init_state(layers, batch_size: int, cell_type: str = "LSTM", device=None,
                   dtype: torch.dtype = torch.float32) -> list:
    """The zero state a stack streams from (JAX ``rnn_init_state``): per
    layer (h, c) for an LSTM, h for a GRU, each [batch_size, H] at the
    layer's H, on ``device``."""
    states = []
    for layer in layers:
        h = torch.zeros((batch_size, layer["w_hh"].shape[1]), device=device, dtype=dtype)
        states.append((h, torch.zeros_like(h)) if cell_type == "LSTM" else h)
    return states


def lstm_step(w_hh_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, x_proj: torch.Tensor):
    """One LSTM transition: (h, c) [N, H] and the input projection
    ``x_proj`` [N, 4H] with both biases -> (h, c). ``w_hh_t`` is W_hh^T
    [H, 4H]."""
    i, f, g, o = (x_proj + h @ w_hh_t).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


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
        h, c = lstm_step(w_hh_t, h, c, x_proj[step])
        hs.append(h)
    return torch.stack(hs)


def lstm_forward(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked unidirectional LSTM: x [T, N, in] -> [T, N, H]."""
    for layer in layers:
        x = lstm_layer(layer, x)
    return x


def gru_step(w_hh_t: torch.Tensor, b_hh: torch.Tensor, h: torch.Tensor, x_proj: torch.Tensor):
    """One GRU transition, torch semantics: the reset gate scales
    (W_hn h + b_hn). ``x_proj`` [N, 3H] is the input projection with b_ih;
    ``w_hh_t`` is W_hh^T [H, 3H]."""
    hidden = h.shape[-1]
    hw = h @ w_hh_t + b_hh
    r, z = torch.sigmoid(x_proj[:, : 2 * hidden] + hw[:, : 2 * hidden]).chunk(2, dim=-1)
    n = torch.tanh(x_proj[:, 2 * hidden :] + r * hw[:, 2 * hidden :])
    return (1.0 - z) * n + z * h


def gru_layer(layer: dict, x: torch.Tensor) -> torch.Tensor:
    """One GRU layer with zero initial state: x [T, N, in] -> [T, N, H]."""
    t, n, _ = x.shape
    w_hh_t = layer["w_hh"].t()
    x_proj = x @ layer["w_ih"].t() + layer["b_ih"]  # [T, N, 3H]; b_hh stays in the step
    h = x.new_zeros(n, w_hh_t.shape[0])
    hs = []
    for step in range(t):
        h = gru_step(w_hh_t, layer["b_hh"], h, x_proj[step])
        hs.append(h)
    return torch.stack(hs)


def gru_forward(layers, x: torch.Tensor) -> torch.Tensor:
    """Stacked unidirectional GRU: x [T, N, in] -> [T, N, H]."""
    for layer in layers:
        x = gru_layer(layer, x)
    return x
