"""The inference forward as stages (K1 and K1-GRU: the input-projection
and head GEMM and the cluster walk of ``csrc/rnn_fwd.cu``), through their
plain versions on the CPU: the chunked composition against the JAX
package's Pallas kernel in interpret mode, chunking, the GRU's b_hh
placement, the walk's tile picker and the chunk budget. The kernels
themselves run only on a card: tests/test_torch_kernel_cuda.py.
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
# the same plain stages cut into other chunks: the GEMMs' blocking over
# Tc*N rows may change the order of a sum, nothing else
CHUNK_ATOL = 1e-6

GATES = {"lstm": 4, "gru": 3}


def _stack(rng, f_in, hidden, out_dim, num_layers, cell):
    """numpy layer dicts (torch layout) and head, U(±1/sqrt(H))."""
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh),
                       "b_hh": u(gh)})
        in_dim = hidden
    return layers, {"weight": u(out_dim, hidden), "bias": u(out_dim)}


def _torch(layers, fc):
    return ([{k: torch.from_numpy(v) for k, v in l.items()} for l in layers],
            {k: torch.from_numpy(v) for k, v in fc.items()})


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_chunked_plain_stages_match_pallas_interpret(cell, num_layers):
    """The plain stages, two steps a chunk, against the Pallas kernel.
    N = 37 and T = 5 are ragged against the TPU tiles and the chunks."""
    t, n, f_in, hidden, out_dim = 5, 37, 12, 32, 3
    rng = np.random.default_rng(10 + num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cell)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    want = jax_fused(jnp.asarray(x), *[{k: jnp.asarray(v) for k, v in l.items()} for l in layers],
                     {k: jnp.asarray(v) for k, v in fc.items()}, row_tile=8, interpret=True)
    got = ops.plain_fused_forward(torch.from_numpy(x), *_torch(layers, fc), chunk=2)
    assert got.shape == (t, n, out_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("chunk", [1, 2, 6])
def test_chunks_match_one_pass(cell, chunk):
    """Chunks of 1, 2 and T steps against one pass of the plain forward
    (plain_fused_subband_lstm / _gru): the (h, c) carries join them."""
    t, n, f_in, hidden, out_dim = 6, 9, 8, 16, 2
    rng = np.random.default_rng(chunk)
    layers, fc = _torch(*_stack(rng, f_in, hidden, out_dim, 2, cell))
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    one_pass = (ops.plain_fused_subband_lstm if cell == "lstm" else ops.plain_fused_subband_gru)(
        x, layers, fc)
    got = ops.plain_fused_forward(x, layers, fc, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), atol=CHUNK_ATOL)
    np.testing.assert_allclose(got.numpy(), ops.plain_fused_forward(x, layers, fc).numpy(),
                               atol=CHUNK_ATOL)


def test_gru_b_hh_stays_in_the_walk():
    """The GRU's GEMM adds b_ih alone; b_hh is added to h · W_hh^T in the
    walk, where the reset gate scales its n part. Fused into P as the LSTM
    fuses its biases, the result moves far beyond the tolerance."""
    t, n, f_in, hidden = 4, 5, 6, 16
    rng = np.random.default_rng(3)
    (layer,), _ = _torch(*_stack(rng, f_in, hidden, 1, 1, "gru"))
    layer["b_hh"] = layer["b_hh"] * 8.0  # a b_hn large enough to show
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    h0 = torch.zeros(n, hidden)
    p = ops.plain_fwd_gemm(x.reshape(t * n, f_in), layer["w_ih"], layer["b_ih"]).view(t, n, -1)
    want = ops.plain_fused_subband_gru(x, [layer], {"weight": torch.eye(hidden),
                                                    "bias": torch.zeros(hidden)})
    hseq, h_t = ops.plain_gru_fwd_walk(p, layer["w_hh"], layer["b_hh"], h0)
    np.testing.assert_allclose(hseq.numpy(), want.numpy(), atol=ATOL)
    assert torch.equal(h_t, hseq[-1])
    fused, _ = ops.plain_gru_fwd_walk(p + layer["b_hh"], layer["w_hh"],
                                      torch.zeros_like(layer["b_hh"]), h0)
    assert float((fused - want).abs().max()) > 100 * ATOL


def test_lstm_walk_carries_its_state():
    """Two walks of 3 steps from the first's (h, c) equal one walk of 6."""
    t, n, hidden = 6, 7, 16
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.standard_normal((t, n, 4 * hidden)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.25, 0.25, (4 * hidden, hidden)).astype(np.float32))
    h0, c0 = (torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32))
              for _ in range(2))
    whole, h_t, c_t = ops.plain_lstm_fwd_walk(p, w, h0, c0)
    first, h_a, c_a = ops.plain_lstm_fwd_walk(p[:3], w, h0, c0)
    second, h_b, c_b = ops.plain_lstm_fwd_walk(p[3:], w, h_a, c_a)
    assert torch.equal(torch.cat([first, second]), whole)
    assert torch.equal(h_b, h_t) and torch.equal(c_b, c_t)


# the four shapes chip_smoke.py times (KERNEL_CASES) and the B = 128 x 30 s
# sub-band stage, with each stage's H
_SHAPES = [(257, 384), (8 * 257, 384), (1, 512), (8, 512), (128 * 257, 384)]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("n, hidden", _SHAPES)
@pytest.mark.parametrize("clusters", [7, 8])
def test_fwd_tile_fits(cell, n, hidden, clusters):
    """Every pick fits the 232,448 bytes a CTA may use and 512 threads; one
    wave where a tile of FWD_ROWS allows it, else the widest tile."""
    rows, kr = ops.pick_fwd_tile(n, hidden, cell, clusters)
    assert rows in ops.FWD_ROWS and kr in (0, ops.FWD_REG_ROWS)
    assert ops.fwd_walk_smem_bytes(rows, hidden, cell, kr) <= 232_448
    assert ops.fwd_walk_threads(hidden, cell) <= ops.FWD_MAX_THREADS
    widest = max(r for r in ops.FWD_ROWS if ops.fwd_walk_kr(r, hidden, cell) is not None)
    if -(-n // widest) <= clusters:
        assert -(-n // rows) <= clusters
        smaller = [r for r in ops.FWD_ROWS if r < rows]
        assert not smaller or -(-n // smaller[-1]) > clusters
    else:
        assert rows == widest


def test_fwd_tile_choices():
    # the flagship sub-band stage at B = 1: one wave of 40-row tiles
    assert ops.pick_fwd_tile(257, 384, "lstm", 8) == (40, 0)
    # full-band at B = 1: one row; the LSTM's 256 KB of W_hh^T a CTA needs
    # 48 rows of each K slice in registers, the GRU's 192 KB fits
    assert ops.pick_fwd_tile(1, 512, "lstm", 8) == (1, ops.FWD_REG_ROWS)
    assert ops.pick_fwd_tile(1, 512, "gru", 8) == (1, 0)
    # at H = 512 the LSTM walks at most 16 rows a cluster
    assert ops.fwd_walk_kr(16, 512, "lstm") == ops.FWD_REG_ROWS
    assert ops.fwd_walk_kr(32, 512, "lstm") is None
    assert ops.pick_fwd_tile(128, 512, "lstm", 8) == (16, ops.FWD_REG_ROWS)
    # a picker that asks the card, instance by instance
    seen = []
    assert ops.pick_fwd_tile(37, 32, "gru", lambda r, k: seen.append((r, k)) or 8) == (8, 0)
    assert seen == [(1, 0), (2, 0), (4, 0), (8, 0)]
    # the full-band stage at B = 8 with 7 clusters in flight: four of 2 rows
    assert ops.pick_fwd_tile(8, 512, "gru", 7) == (2, 0)
    # wide tiles give a thread 4 of the CTA's columns: a GRU at H = 32 has 6
    assert ops.fwd_walk_kr(16, 32, "gru") is None and ops.fwd_walk_kr(16, 32, "lstm") == 0
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.pick_fwd_tile(8, 40, "lstm", 8)
    with pytest.raises(ValueError, match="threads"):
        ops.pick_fwd_tile(8, 1024, "lstm", 8)


def test_fwd_chunk_budget():
    # the sub-band stage at B = 128 x 30 s: 202 MB of P a step
    steps = ops.fwd_chunk_steps(1876, 128 * 257, 384, "lstm")
    assert steps == 21 and 4 * steps * 128 * 257 * 4 * 384 <= ops.FWD_P_BUDGET
    # B = 1 and the full-band stage at 10 s take one chunk, the sub-band
    # stage at B = 8 two
    for n, hidden in ((257, 384), (8, 512)):
        assert ops.fwd_chunk_steps(626, n, hidden, "lstm") == 626
    assert ops.fwd_chunk_steps(626, 8 * 257, 384, "lstm") == 340
    assert ops.fwd_chunk_steps(5, 10**9, 512, "gru") == 1


def test_fwd_wrappers_refuse_cpu_tensors():
    """No fallback inside the wrappers: a CPU tensor is an error there."""
    t, n, hidden = 3, 4, 16
    p = torch.zeros(t, n, 4 * hidden)
    w = torch.zeros(4 * hidden, hidden)
    h0 = torch.zeros(n, hidden)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fwd_gemm(h0, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_fwd_walk(p, w, h0, h0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_fwd_walk(p[..., : 3 * hidden], w[: 3 * hidden], torch.zeros(3 * hidden), h0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fused_forward(torch.zeros(t, n, 8), *_torch(*_stack(np.random.default_rng(0), 8,
                                                                hidden, 2, 2, "lstm")))
