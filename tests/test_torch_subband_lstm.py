"""The port's fused LSTM-scan op (fullsubnet_tpu_torch.ops.subband_lstm)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
as tests/test_pallas_subband.py runs it. Same weights and inputs, made
from a numpy seed; fp32.

The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops.subband_lstm import fused_subband_lstm as jax_fused
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5


def _stack(rng, f_in, hidden, out_dim, num_layers):
    """numpy layer dicts (torch layout) and head, U(±1/sqrt(H))."""
    b = 1.0 / np.sqrt(hidden)

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({
            "w_ih": u(4 * hidden, in_dim), "w_hh": u(4 * hidden, hidden),
            "b_ih": u(4 * hidden), "b_hh": u(4 * hidden),
        })
        in_dim = hidden
    return layers, {"weight": u(out_dim, hidden), "bias": u(out_dim)}


def _to(tree, fn):
    return [{k: fn(v) for k, v in d.items()} for d in tree]


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("time_major_features", [False, True])
def test_plain_matches_pallas_interpret(num_layers, time_major_features):
    """N = 13 and T = 11 are not multiples of 8 (the TPU tile edges)."""
    t, n, f_in, hidden, out_dim = 11, 13, 8, 16, 3
    rng = np.random.default_rng(num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    if time_major_features:
        x = np.ascontiguousarray(np.swapaxes(x, 1, 2))  # [T, F_in, N]

    want = jax_fused(
        jnp.asarray(x), *_to(layers, jnp.asarray), {k: jnp.asarray(v) for k, v in fc.items()},
        row_tile=8, interpret=True, time_major_features=time_major_features,
    )
    got = ops.fused_subband_lstm(
        torch.from_numpy(x), *_to(layers, torch.from_numpy),
        {k: torch.from_numpy(v) for k, v in fc.items()},
        time_major_features=time_major_features,
    )
    assert got.shape == (t, n, out_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_call_takes_the_plain_path_and_counts_no_launch():
    rng = np.random.default_rng(0)
    layers, fc = _stack(rng, 4, 8, 2, 2)
    x = torch.from_numpy(rng.standard_normal((5, 3, 4)).astype(np.float32))
    before = ops.lstm_scan.launches
    a = ops.fused_subband_lstm(x, *_to(layers, torch.from_numpy),
                               {k: torch.from_numpy(v) for k, v in fc.items()})
    b = ops.plain_fused_subband_lstm(x, _to(layers, torch.from_numpy),
                                     {k: torch.from_numpy(v) for k, v in fc.items()})
    assert ops.lstm_scan.launches == before
    assert torch.equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: a CPU tensor is an error there."""
    rng = np.random.default_rng(1)
    layers, fc = _stack(rng, 4, 8, 2, 2)
    x = torch.zeros(5, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_scan(x, _to(layers, torch.from_numpy), {k: torch.from_numpy(v) for k, v in fc.items()})


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda l, fc: ([{**l[0], "w_ih": l[0]["w_ih"][:-1]}, l[1]], fc), "w_ih"),
        (lambda l, fc: (l * 2, fc), "layers supported"),
        (lambda l, fc: (l, {**fc, "weight": fc["weight"][:, :-1]}), "fc weight"),
    ],
)
def test_stack_validation(bad, match):
    rng = np.random.default_rng(2)
    layers, fc = _stack(rng, 4, 8, 2, 2)
    layers, fc = bad(_to(layers, torch.from_numpy), {k: torch.from_numpy(v) for k, v in fc.items()})
    with pytest.raises(ValueError, match=match):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4), *layers, fc)


def test_rows_per_block_choice():
    # enough rows for ~one block per SM: the widest tile
    assert ops.pick_rows_per_block(8 * 257, 32, 384, 2) == 8
    # fewer rows than SMs at 8 per block (B = 1): two rows per block
    assert ops.pick_rows_per_block(257, 32, 384, 2) == 2
    assert ops.pick_rows_per_block(1, 257, 512, 2) == 2
    # every choice fits the 227 KB a block may use
    for n in (1, 7, 257, 2056, 32896):
        rows = ops.pick_rows_per_block(n, 257, 512, 3)
        assert ops.smem_bytes(257, 512, 3, rows) <= 232_448
    # 8 rows of a wide stack would not fit: 2 rows
    assert ops.pick_rows_per_block(32896, 2049, 1024, 3) == 2
