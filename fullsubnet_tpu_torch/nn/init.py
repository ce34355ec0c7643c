"""Parameter initialisers of the reference's ``weight_init`` (counterpart
of ``fullsubnet_tpu/nn/init.py``).

The reference applies (``audio_zen/model/base_model.py:374-439``):
* LSTM/GRU: orthogonal for >=2-D parameters, N(0,1) for biases,
* Linear: Xavier-normal weight, N(0,1) bias.

Each draws from a ``torch.Generator``, so the draws are not those of
``jax.random``: a freshly initialised model is statistically
interchangeable with the JAX package's and the reference's, not equal.
"""

from __future__ import annotations

import torch


def normal(shape, generator: torch.Generator, mean: float = 0.0, std: float = 1.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return mean + std * torch.randn(shape, generator=generator, dtype=dtype)


def xavier_normal(shape, generator: torch.Generator, gain: float = 1.0,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Xavier/Glorot normal for an [out, in] (or conv) weight."""
    fan_out, fan_in = shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    std = gain * (2.0 / ((fan_in + fan_out) * receptive)) ** 0.5
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def orthogonal(shape, generator: torch.Generator, gain: float = 1.0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(Semi-)orthogonal init of a 2-D matrix, torch's semantics: the QR
    of a standard normal [max, min] matrix, Q's columns sign-corrected by
    the diagonal of R, transposed where the matrix is wide. An LSTM's
    [4H, H] weight gets orthonormal columns: WᵀW = I."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.t()
    return (gain * q[:rows, :cols]).to(dtype)


def rnn_weight_init(params: dict, generator: torch.Generator) -> dict:
    """New values for an LSTM/GRU layer's tensors {name: tensor}: orthogonal
    matrices, N(0,1) biases, in each tensor's shape and dtype."""
    return {
        name: (orthogonal(tuple(v.shape), generator, dtype=v.dtype) if v.ndim >= 2
               else normal(tuple(v.shape), generator, dtype=v.dtype))
        for name, v in params.items()
    }


def linear_init(in_features: int, out_features: int, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> dict:
    """An ``nn.Linear``'s weight [out, in] and bias [out]: Xavier-normal
    weight and N(0,1) bias, per the reference's ``weight_init``."""
    return {
        "weight": xavier_normal((out_features, in_features), generator, dtype=dtype),
        "bias": normal((out_features,), generator, dtype=dtype),
    }
