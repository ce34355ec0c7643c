"""The training forward as stages (K2 and K2-GRU at bf16 storage: the
input-projection and head GEMM of ``csrc/rnn_bwd_tc.cu`` and the walk of
``csrc/rnn_train_fwd_tc.cu``), through their plain versions on the CPU:
the plain composition against the JAX package's Pallas kernel
``_stash_fwd_call`` in interpret mode and against the single-pass plain
forward it replaced, the walk's tile and split pickers, the weight layouts
the walks read, and the wrappers' refusal of CPU tensors. The kernels
themselves run only on a card: tests/test_torch_kernel_cuda.py.
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
# bf16 storage: both round h (and the stashes) to bf16 at the same points,
# but an fp32 sum in another order can move a value across a rounding
# boundary (one bf16 step is 2^-8 relative), and that step travels through
# the recurrence; the card tests' tolerance for the same comparison
BF16_ATOL = 2e-2

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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers, dtype):
    """The training forward's operands in storage type ``dtype`` (numpy
    layers and states beside them for the JAX side), non-zero initial
    states: (layers, fc, x, states, (x, ws, bs, wfc, bfc, h0s[, c0s]))."""
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cell)
    per_layer = 2 if cell == "lstm" else 1
    x = _t(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(dtype)
    # h0 (, c0) of layer 0, then of layer 1, ..., in the storage type
    states = [_t(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(dtype)
              for _ in range(per_layer * num_layers)]
    tl = [{k: _t(v) for k, v in layer.items()} for layer in layers]
    ws, bs, wfc, bfc = ops.prep_weights(tl, {k: _t(v) for k, v in fc.items()}, dtype)
    args = (x, ws, bs, wfc, bfc, states[::per_layer])
    if cell == "lstm":
        args += (states[1::2],)
    return layers, fc, x, states, args


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_stages_match_pallas(cell, num_layers, dtype):
    """The plain stage composition (``plain_stash_forward``: the GEMM's and
    the walk's plain versions) against ``_stash_fwd_call`` in interpret
    mode from non-zero initial states: the head output and every layer's
    stashes (h and c; h for the GRU), fp32 and bf16 storage."""
    t, n, f_in, hidden, out_dim = 9, 16, 8, 16, 3
    rng = np.random.default_rng(10 * num_layers + (dtype == torch.bfloat16))
    layers, fc, x, states, args = _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers,
                                            dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out, stashes = _stash_fwd_call(
        jnp.asarray(np.swapaxes(x.float().numpy(), 1, 2)).astype(jdt),
        [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers],
        {k: jnp.asarray(v) for k, v in fc.items()},
        tuple(jnp.asarray(s.float().numpy()).astype(jdt) for s in states),
        row_tile=8, interpret=True,
    )
    got_out, *got = ops.plain_stash_forward(*args)
    atol = ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(got_out.numpy(), np.transpose(np.asarray(out), (1, 2, 0)),
                               atol=atol)
    per_layer = len(got)
    for li in range(num_layers):
        for k, stash in enumerate(got):  # h, then c
            assert stash[li].dtype == dtype
            want = np.asarray(stashes[per_layer * li + k].astype(jnp.float32))
            np.testing.assert_allclose(stash[li].float().numpy(), want, atol=atol)


def _single_pass_plain_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """K2's and K2-GRU's plain version as it stood before the forward was
    split into stages (one function, each layer's input projection and the
    cell inside one loop): the reference the stage composition is held to."""
    cdt = x.dtype
    seq = x.float()
    hs, cs = [], []
    for li, (w, b, h0) in enumerate(zip(ws, bs, h0s)):
        in_dim = seq.shape[-1]
        hidden = h0.shape[-1]
        wf = w.float()
        x_proj = seq @ wf[:in_dim] + (b if c0s is not None else b[0])
        w_hh = wf[in_dim:]
        h = h0.float()
        c = c0s[li].float() if c0s is not None else None
        h_steps, c_steps = [], []
        for step in range(x.shape[0]):
            if c0s is not None:
                i, f, g, o = (x_proj[step] + h @ w_hh).chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = (torch.sigmoid(o) * torch.tanh(c)).to(cdt).float()
                h_steps.append(h)
                c_steps.append(c)
            else:
                hw = h.to(cdt).float() @ w_hh + b[1]
                r, z = torch.sigmoid(x_proj[step, :, : 2 * hidden]
                                     + hw[:, : 2 * hidden]).chunk(2, -1)
                n = torch.tanh(x_proj[step, :, 2 * hidden :] + r * hw[:, 2 * hidden :])
                h = (1.0 - z) * n + z * h
                h_steps.append(h.to(cdt).float())
        seq = torch.stack(h_steps)
        hs.append(seq.to(cdt))
        cs.append(torch.stack(c_steps).to(cdt) if c0s is not None else None)
    out = seq @ wfc.float() + bfc
    return (out, hs, cs) if c0s is not None else (out, hs)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, n, f_in, hidden, out_dim, num_layers",
                         [(7, 37, 12, 40, 2, 2), (1, 5, 257, 16, 257, 3)])
def test_plain_stages_compose_to_single_pass_plain(cell, dtype, t, n, f_in, hidden, out_dim,
                                                   num_layers):
    """The plain training forward, now the composition of the GEMM's and
    the walks' plain versions, against the single function it replaced:
    every stash equal bit for bit (the same fp32 operations in the same
    order), the head output within 1e-6 (its product now runs over the
    zero-padded W_fc^T, which may block the sums otherwise)."""
    rng = np.random.default_rng(t * n + hidden)
    *_, args = _operands(rng, cell, t, n, f_in, hidden, out_dim, num_layers, dtype)
    got = ops.plain_stash_forward(*args)
    want = _single_pass_plain_stash_forward(*args)
    assert got[0].dtype == torch.float32 and got[0].shape == (t, n, out_dim)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0, atol=1e-6)
    for got_stashes, want_stashes in zip(got[1:], want[1:]):
        for g, w in zip(got_stashes, want_stashes):
            assert g.dtype == dtype and g.shape == (t, n, hidden)
            assert torch.equal(g, w)


def test_train_walk_tile_choice():
    """The training walk's pickers at the smoke's shapes: the sub-band
    stage (N = 4096, H = 384) streams W_hh^T with 32 rows a block (128
    blocks, one wave) and the deepest ring that fits beside the h and P
    tiles (3 slots for the LSTM, 5 for the GRU); the full-band stage
    (N = 32, H = 512) splits over one cluster of 16 CTAs. Every pick fits
    in the 227 KB a block may use."""
    assert ops.pick_train_walk_tile(4096, "lstm", 384) == (32, 3)
    assert ops.pick_train_walk_tile(4096, "gru", 384) == (32, 5)
    assert not ops.train_walk_splits(4096, 384)
    assert ops.train_walk_splits(32, 512) and ops.train_walk_splits(128, 256)
    assert not ops.train_walk_splits(129, 512) and not ops.train_walk_splits(32, 200)
    for n, hidden in ((4096, 384), (32, 512), (37, 40), (100_000, 512)):
        for cell in ("lstm", "gru"):
            rows, stages = ops.pick_train_walk_tile(n, cell, hidden)
            assert ops.train_walk_smem_bytes(rows, cell, hidden, stages) <= 232_448
            assert ops.train_walk_smem_bytes(rows, cell, hidden, stages + 1) > 232_448 or (
                stages == ops.TRAIN_MAX_STAGES)
    # few rows: 16 rows a block, the fewest blocks
    assert ops.pick_train_walk_tile(32, "lstm", 512)[0] == 16
    # a split CTA at the full-band LSTM: 512 x 128 of W_hh^T (128 KB), the
    # gathered h and its slices, within a block's 227 KB
    assert ops.train_split_smem_bytes("lstm", 512) == 167_936
    assert max(ops.train_split_smem_bytes(c, h) for c in ("lstm", "gru")
               for h in (128, 256, 384, 512)) <= 232_448


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [48, 256, 384])
def test_train_walk_weight_layouts(cell, hidden):
    """The regrouped W_hh^T that each walk reads holds W_hh^T's columns where
    ``rnn_train_fwd_tc.cu`` looks for them: streaming, column g 128 + u of
    chunk c and K row k is W_hh^T[k, g H + 128 c + u], zero past H; split,
    CTA k's column g H/16 + u is W_hh^T[:, g H + k H/16 + u], zero past
    G·H/16."""
    gates = GATES[cell]
    rng = np.random.default_rng(hidden)
    w = _t(rng.standard_normal((hidden, gates * hidden)).astype(np.float32)).to(torch.bfloat16)
    stream = ops._stream_hh_t(w, gates)
    chunks = -(-hidden // 128)
    kp = -(-hidden // 32) * 32
    assert stream.shape == (chunks, kp, gates, 128) and stream.is_contiguous()
    for c in range(chunks):
        units = min(128, hidden - 128 * c)
        for g in range(gates):
            cols = slice(g * hidden + 128 * c, g * hidden + 128 * c + units)
            assert torch.equal(stream[c, :hidden, g, :units], w[:, cols])
            assert not stream[c, :, g, units:].any() and not stream[c, hidden:].any()
    if hidden % 128 == 0:
        split = ops._split_hh_t(w, gates)
        hc = hidden // 16
        assert split.shape == (16, hidden, -(-gates * hc // 64) * 64)
        for k in range(16):
            for g in range(gates):
                cols = slice(g * hidden + k * hc, g * hidden + (k + 1) * hc)
                assert torch.equal(split[k, :, g * hc : (g + 1) * hc], w[:, cols])
            assert not split[k, :, gates * hc :].any()


def test_train_walks_refuse_cpu_tensors():
    """No fallback inside the walks' wrappers: a CPU tensor is an error
    there, and no launch is counted."""
    t, n, hidden = 3, 5, 8
    bf16 = torch.bfloat16
    h0 = torch.zeros(n, hidden, dtype=bf16)
    for kernel, gates, state in ((ops.lstm_train_walk, 4, (h0, h0)),
                                 (ops.gru_train_walk, 3, (torch.zeros(3 * hidden), h0))):
        kernel.reset_counts()
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(torch.zeros(t, n, gates * hidden), torch.zeros(hidden, gates * hidden,
                                                                  dtype=bf16), *state)
        assert kernel.launches == 0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_cpu_stash_forward_is_plain(cell):
    """``stash_forward`` on a CPU tensor at bf16 storage runs the plain
    composition and launches nothing."""
    rng = np.random.default_rng(3)
    *_, args = _operands(rng, cell, 4, 6, 5, 8, 2, 2, torch.bfloat16)
    kernels = (ops.tc_gemm, ops.lstm_train_walk, ops.gru_train_walk, ops.stash_fwd,
               ops.gru_stash_fwd)
    for kernel in kernels:
        kernel.reset_counts()
    got = ops.stash_forward(*args)
    want = ops.plain_stash_forward(*args)
    assert [k.launches for k in kernels] == [0] * len(kernels)
    for g, w in zip([got[0], *got[1], *(got[2] if cell == "lstm" else [])],
                    [want[0], *want[1], *(want[2] if cell == "lstm" else [])]):
        assert torch.equal(g, w)
