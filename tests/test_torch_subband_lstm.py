"""The port's fused scan op (fullsubnet_tpu_torch.ops.subband_lstm), with
the LSTM and the GRU cell, against the JAX package's Pallas kernel, run in
interpret mode on the CPU, as tests/test_pallas_subband.py runs it. Same
weights and inputs, made from a numpy seed; fp32.

The CUDA kernels themselves run only on a card: its tests are in
tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops.subband_lstm import fused_subband_lstm as jax_fused
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5


GATES = {"lstm": 4, "gru": 3}


def _stack(rng, f_in, hidden, out_dim, num_layers, cell="lstm"):
    """numpy layer dicts (torch layout) and head, U(±1/sqrt(H))."""
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({
            "w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh),
        })
        in_dim = hidden
    return layers, {"weight": u(out_dim, hidden), "bias": u(out_dim)}


def _to(tree, fn):
    return [{k: fn(v) for k, v in d.items()} for d in tree]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("time_major_features", [False, True])
def test_plain_matches_pallas_interpret(num_layers, time_major_features, cell):
    """K1's and K1-GRU's plain versions. N = 13 and T = 11 are not
    multiples of 8 (the TPU tile edges)."""
    t, n, f_in, hidden, out_dim = 11, 13, 8, 16, 3
    rng = np.random.default_rng(num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cell)
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


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_call_takes_the_plain_path_and_counts_no_launch(cell):
    rng = np.random.default_rng(0)
    layers, fc = _stack(rng, 4, 8, 2, 2, cell)
    x = torch.from_numpy(rng.standard_normal((5, 3, 4)).astype(np.float32))
    for kernel in (ops.lstm_scan, ops.gru_scan):
        kernel.reset_counts()
    plain = ops.plain_fused_subband_lstm if cell == "lstm" else ops.plain_fused_subband_gru
    a = ops.fused_subband_lstm(x, *_to(layers, torch.from_numpy),
                               {k: torch.from_numpy(v) for k, v in fc.items()})
    b = plain(x, _to(layers, torch.from_numpy), {k: torch.from_numpy(v) for k, v in fc.items()})
    assert ops.lstm_scan.launches == ops.gru_scan.launches == 0
    assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_kernel_wrapper_refuses_cpu_tensors(cell):
    """No fallback inside the wrapper: a CPU tensor is an error there."""
    rng = np.random.default_rng(1)
    layers, fc = _stack(rng, 4, 8, 2, 2, cell)
    x = torch.zeros(5, 3, 4)
    kernel = ops.lstm_scan if cell == "lstm" else ops.gru_scan
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(x, _to(layers, torch.from_numpy), {k: torch.from_numpy(v) for k, v in fc.items()})


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda l, fc: ([{**l[0], "w_ih": l[0]["w_ih"][:-1]}, l[1]], fc), "w_ih"),
        (lambda l, fc: (l * 2, fc), "layers supported"),
        (lambda l, fc: (l, {**fc, "weight": fc["weight"][:, :-1]}), "fc weight"),
        # a GRU layer on an LSTM stack: one cell per stack
        (lambda l, fc: ([l[0], {k: v[: 3 * 8] for k, v in l[1].items()}], fc), "w_ih"),
        # two gates of H: neither cell
        (lambda l, fc: ([{k: v[: 2 * 8] for k, v in l[0].items()}, l[1]], fc), "neither"),
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


def test_gru_shared_memory_forms():
    """K1-GRU keeps h by step parity only; K2-GRU at bf16 adds the fp32
    h carry; the LSTM kernels hold c in its place."""
    f_in, hidden, layers, rows = 32, 384, 2, 8
    lstm = ops.smem_bytes(f_in, hidden, layers, rows)
    assert ops.smem_bytes(f_in, hidden, layers, rows, "gru") == 4 * (rows * f_in
                                                                    + 2 * layers * rows * hidden)
    assert ops.smem_bytes(f_in, hidden, layers, rows, "gru", torch.bfloat16) == lstm
    # the flagship GRU stages take the LSTM's rows per block
    for n, f, h in ((257, 32, 384), (8 * 257, 32, 384), (1, 257, 512), (8, 257, 512)):
        assert (ops.pick_rows_per_block(n, f, h, 2, "gru")
                == ops.pick_rows_per_block(n, f, h, 2))
