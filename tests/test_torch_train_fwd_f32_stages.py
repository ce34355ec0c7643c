"""The training forward at fp32 storage as stages (K2 and K2-GRU at fp32:
the GEMM of ``csrc/rnn_fwd.cu`` for the input projections and the head,
around a walk with only h · W_hh^T on the time chain: the cluster walk of
``csrc/rnn_fwd.cu`` with its c stream for few rows, the streaming walk of
``csrc/rnn_train_fwd_f32.cu`` for many), through their plain versions on
the CPU: the plain composition against the JAX package's Pallas kernel
``_stash_fwd_call`` in interpret mode and against the bf16 stages' plain
composition at fp32, the plain walks' stash form, the form picker and the
streaming walk's width rules, its regrouped weights, and the wrappers'
refusal of CPU tensors. The kernels themselves run only on a card:
tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops.subband_lstm import _stash_fwd_call
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 on both sides; only the order of the sums differs (the stages add P
# and h · W_hh^T as two fp32 sums, the JAX kernel takes one product)
ATOL = 1e-5

GATES = {"lstm": 4, "gru": 3}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers):
    """numpy layers and head (torch layout) and non-zero initial states
    (h0 and c0 of layer 0, then of layer 1, ...), and the fp32 operands of
    plain_f32_stash_forward: (layers, fc, states, (x, ws, bs, wfc, bfc,
    h0s[, c0s]))."""
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    layers, in_dim = [], f_in
    for _ in range(num_layers):
        layers.append({"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh),
                       "b_hh": u(gh)})
        in_dim = hidden
    fc = {"weight": u(out_dim, hidden), "bias": u(out_dim)}
    per_layer = 2 if cell == "lstm" else 1
    states = [rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)
              for _ in range(per_layer * num_layers)]
    x = _t(rng.standard_normal((t, n, f_in)).astype(np.float32))
    ws, bs, wfc, bfc = ops.prep_weights([{k: _t(v) for k, v in l.items()} for l in layers],
                                        {k: _t(v) for k, v in fc.items()}, torch.float32)
    ts = [_t(s) for s in states]
    args = (x, ws, bs, wfc, bfc, ts[::per_layer])
    if cell == "lstm":
        args += (ts[1::2],)
    return layers, fc, states, args


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_plain_f32_stages_match_pallas(cell, num_layers):
    """The fp32 stages in their plain versions (``plain_f32_stash_forward``:
    plain_fwd_gemm with B in PyTorch's layout around the plain walks' stash
    form) against ``_stash_fwd_call`` in interpret mode from non-zero initial
    states: the head output and every layer's h and c stash (h for the
    GRU), within ATOL = 1e-5."""
    t, n, f_in, hidden, out_dim = 9, 40, 8, 16, 3
    rng = np.random.default_rng(40 + num_layers)
    layers, fc, states, args = _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers)
    out, stashes = _stash_fwd_call(
        jnp.asarray(np.swapaxes(args[0].numpy(), 1, 2)),
        [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers],
        {k: jnp.asarray(v) for k, v in fc.items()},
        tuple(jnp.asarray(s) for s in states), row_tile=8, interpret=True,
    )
    got_out, *got = ops.plain_f32_stash_forward(*args)
    assert got_out.dtype == torch.float32 and got_out.shape == (t, n, out_dim)
    np.testing.assert_allclose(got_out.numpy(), np.transpose(np.asarray(out), (1, 2, 0)),
                               atol=ATOL, rtol=0)
    per_layer = len(got)
    assert per_layer == (2 if cell == "lstm" else 1)
    for li in range(num_layers):
        for k, stash in enumerate(got):  # h, then c
            assert stash[li].dtype == torch.float32 and stash[li].shape == (t, n, hidden)
            np.testing.assert_allclose(stash[li].numpy(), np.asarray(stashes[per_layer * li + k]),
                                       atol=ATOL, rtol=0, err_msg=f"layer {li}, stash {k}")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden, out_dim, num_layers",
                         [(7, 37, 12, 40, 2, 2), (1, 5, 257, 16, 257, 3), (4, 40, 32, 64, 2, 2)])
def test_plain_f32_stages_equal_plain_stash_forward(cell, t, n, f_in, hidden, out_dim,
                                                    num_layers):
    """At fp32 the bf16 stages' plain composition (``plain_stash_forward``:
    plain_tc_gemm with B as [K, Ncols] and the training walks, whose
    roundings are then no-ops) and the fp32 stages' (B in PyTorch's layout,
    the forward walks' stash form) give the same head output and stashes up
    to the order of the sums (1e-6)."""
    rng = np.random.default_rng(t * n + hidden)
    *_, args = _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers)
    got = ops.plain_f32_stash_forward(*args)
    want = ops.plain_stash_forward(*args)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-6)
    for got_stashes, want_stashes in zip(got[1:], want[1:]):
        for g, w in zip(got_stashes, want_stashes):
            assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape == (t, n, hidden)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_walk_stash_form(cell):
    """The plain forward walks' ``stash`` form, which the fp32 training
    walk follows: the same h stream; the LSTM's c stream beside it, whose
    last step is c_T; the GRU's h stream alone (its stash)."""
    t, n, hidden = 5, 7, 16
    rng = np.random.default_rng(9)
    gh = GATES[cell] * hidden
    p = _t(rng.standard_normal((t, n, gh)).astype(np.float32))
    w = _t(rng.uniform(-0.25, 0.25, (gh, hidden)).astype(np.float32))
    h0 = _t(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32))
    if cell == "lstm":
        c0 = _t(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32))
        hseq, h_t, c_t = ops.plain_lstm_fwd_walk(p, w, h0, c0)
        hs, cs = ops.plain_lstm_fwd_walk(p, w, h0, c0, stash=True)
        assert torch.equal(cs[-1], c_t) and cs.shape == (t, n, hidden)
        c1 = (torch.sigmoid(p[0, :, 16:32] + h0 @ w[16:32].t()) * c0
              + torch.sigmoid(p[0, :, :16] + h0 @ w[:16].t())
              * torch.tanh(p[0, :, 32:48] + h0 @ w[32:48].t()))
        np.testing.assert_allclose(cs[0].numpy(), c1.numpy(), rtol=0, atol=1e-6)
    else:
        b_hh = _t(rng.uniform(-0.25, 0.25, gh).astype(np.float32))
        hseq, h_t = ops.plain_gru_fwd_walk(p, w, b_hh, h0)
        hs = ops.plain_gru_fwd_walk(p, w, b_hh, h0, stash=True)
    assert torch.equal(hs, hseq) and torch.equal(hs[-1], h_t)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_train_f32_form_choice(cell):
    """The form picker, a pure function of (N, H, cell, clusters in
    flight): at 7 clusters (an H100) the sub-band stage (N = 4096, H = 384)
    streams and the full-band stage (N = 32, H = 512) takes the cluster
    form, as do the B = 4 step's full-band N = 4; the cluster form walks up
    to 7 x 40 rows in one wave at H = 384, so 281 rows stream; a width the
    cluster form does not take (H not a multiple of 16) streams, up to
    H = 512; a width neither form takes raises and names the limits."""
    pick = ops.train_f32_streams
    assert pick(4096, 384, cell, 7) and pick(512, 384, cell, 7)
    assert not pick(32, 512, cell, 7) and not pick(4, 512, cell, 7)
    assert not pick(280, 384, cell, 7) and pick(281, 384, cell, 7)
    assert not pick(280, 384, cell, lambda rows, kr: 7) and pick(280, 384, cell, 6)
    assert pick(8192, 512, cell, 7)
    assert pick(37, 40, cell, 7) and pick(1, 40, cell, 7) and pick(3, 500, cell, 7)
    for hidden in (513, 600, 672, 1024):
        with pytest.raises(ValueError, match="up to 512"):
            pick(32, hidden, cell, 7)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_train_f32_stream_width_rules(cell):
    """The streaming walk's shared memory: h_{t-1} and h_t [32, H rounded
    up to 32] beside a ring of 2 slots [32 K rows, 96 units, G gates], within
    a block's 227 KB for every H up to 512, and 512 the last width it
    takes."""
    g = GATES[cell]
    assert ops.train_f32_stream_smem_bytes(384, cell) == 4 * (2 * 32 * 384 + 2 * 32 * 96 * g)
    assert ops.train_f32_stream_smem_bytes(40, cell) == 4 * (2 * 32 * 64 + 2 * 32 * 96 * g)
    for hidden in range(1, 513):
        assert ops.train_f32_stream_fits(hidden, cell)
        assert ops.train_f32_stream_smem_bytes(hidden, cell) <= 232_448
    assert not ops.train_f32_stream_fits(513, cell) and not ops.train_f32_stream_fits(0, cell)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [40, 200])
def test_streaming_walk_weight_layout(cell, hidden):
    """The regrouped W_hh^T the streaming walk reads: [NG, HP, 96, G] with
    element [g, k, u, j] = W_hh[j·H + 96 g + u, k], zero past H in units and
    in K rows (HP = H rounded up to 32); read from the transposed view of
    :func:`prep_weights`' [W_ih^T ; W_hh^T] as ``stash_forward`` hands it
    over."""
    gates = GATES[cell]
    rng = np.random.default_rng(hidden)
    w = _t(rng.standard_normal((5 + hidden, gates * hidden)).astype(np.float32))
    w_hh = w[5:].t()
    got = ops._group_hh(w_hh, gates)
    groups, hp = -(-hidden // 96), -(-hidden // 32) * 32
    assert got.shape == ops._grouped_hh_shape(hidden, gates) == (groups, hp, 96, gates)
    assert got.is_contiguous()
    for g in range(groups):
        units = min(96, hidden - 96 * g)
        for j in range(gates):
            rows = slice(j * hidden + 96 * g, j * hidden + 96 * g + units)
            assert torch.equal(got[g, :hidden, :units, j], w_hh[rows].t())
        assert not got[g, :, units:].any() and not got[g, hidden:].any()


def test_train_f32_walks_refuse_cpu_tensors():
    """No fallback inside the fp32 training walks' wrappers: a CPU tensor is
    an error there, and no launch is counted."""
    t, n, hidden = 3, 5, 16
    h0 = torch.zeros(n, hidden)
    for kernel, gates, state in ((ops.lstm_train_walk_f32, 4, (h0, h0)),
                                 (ops.gru_train_walk_f32, 3, (torch.zeros(3 * hidden), h0))):
        kernel.reset_counts()
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(torch.zeros(t, n, gates * hidden), torch.zeros(gates * hidden, hidden), *state)
        assert kernel.launches == 0 and not kernel.launches_by_form


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_f32_cpu_stash_forward_is_plain(cell):
    """``stash_forward`` on a CPU tensor at fp32 storage runs the plain
    composition and launches nothing: neither the fp32 stages nor the
    earlier fp32 kernels."""
    rng = np.random.default_rng(3)
    *_, args = _operands(rng, cell, 4, 6, 5, 16, 2, 2)
    kernels = (ops.fwd_gemm, ops.lstm_train_walk_f32, ops.gru_train_walk_f32, ops.stash_fwd,
               ops.gru_stash_fwd, ops.tc_gemm, ops.lstm_train_walk, ops.gru_train_walk)
    for kernel in kernels:
        kernel.reset_counts()
    got, want = ops.stash_forward(*args), ops.plain_stash_forward(*args)
    assert [k.launches for k in kernels] == [0] * len(kernels)
    flat = lambda r: [r[0], *(v for stash in r[1:] for v in stash)]  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w)
