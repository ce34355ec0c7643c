"""The layer backward at fp32 storage as stages (K3 and K4 at fp32: the
GEMM of ``csrc/rnn_fwd.cu`` with its second K segment for the gate
recompute and for dx, around the walk of ``csrc/rnn_bwd_f32.cu``), through
their plain versions on the CPU: the plain composition against the JAX
package's Pallas kernel ``_pallas_layer_bwd`` in interpret mode and
against the tensor-core stages' plain composition at fp32 (whose roundings
are then no-ops), the GEMM's shifted K segment, the GRU weights packed in
PyTorch's layout, the walk's tile picker, and the wrappers' refusal of CPU
tensors. The kernels themselves run only on a card:
tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops import subband_lstm as jax_ops
from fullsubnet_tpu.ops.subband_lstm import _pallas_layer_bwd
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5

GATES = {"lstm": 4, "gru": 3}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layer_args(rng, cell, t, n, f_in, hidden):
    """One layer's fp32 backward operands (stashes from the plain forward,
    non-zero initial states and incoming carries), in the order of
    plain_layer_backward (LSTM) or plain_gru_layer_backward."""
    gh = GATES[cell] * hidden
    bound = 1.0 / np.sqrt(hidden)

    def u(*shape, b=bound):
        return _t(rng.uniform(-b, b, shape).astype(np.float32))

    layer = {"w_ih": u(gh, f_in), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh)}
    ws, bs, _, _ = ops.prep_weights([layer], {"weight": torch.zeros(1, hidden),
                                              "bias": torch.zeros(1)}, torch.float32)
    x = _t(rng.standard_normal((t, n, f_in)).astype(np.float32))
    h0, c0 = u(n, hidden, b=0.5), u(n, hidden, b=0.5)
    lstm = cell == "lstm"
    _, hs, *cs = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 1), torch.zeros(1),
                                         [h0], [c0] if lstm else None)
    dh = _t(rng.standard_normal((t, n, hidden)).astype(np.float32))
    wt = ws[0].t().contiguous()
    if lstm:
        return (dh, x, hs[0], cs[0][0], ws[0], wt, bs[0], h0, c0, u(n, hidden, b=0.5),
                u(n, hidden, b=0.5))
    return dh, x, hs[0], ws[0], wt, bs[0], h0, u(n, hidden, b=0.5)


class _EinsumRecorder:
    """``jax.numpy`` whose ``einsum`` records its operands by spec: how the
    test reads the cotangent streams ``_pallas_layer_bwd`` hands to its
    split-dW products (dxw to "tnf,tng->fg"; dhw[1:] and dhw[0] to
    "tnh,tng->hg" and "nh,ng->hg")."""

    def __init__(self):
        self.operands = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kwargs):
        self.operands[spec] = operands
        return jnp.einsum(spec, *operands, **kwargs)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t", [1, 5])
def test_plain_f32_stages_match_pallas(cell, t, monkeypatch):
    """The fp32 stages in their plain versions (plain_fwd_gemm with the
    shifted K segment, the walk, plain_fwd_gemm for dx), composed as the
    card runs them, against ``_pallas_layer_bwd`` in interpret mode at
    N = 37 (one row tile of 37) from non-zero initial states and incoming
    carries: dx, the cotangent streams and the carries, fp32, within
    ATOL = 1e-5."""
    n, f_in, hidden = 37, 12, 24
    rng = np.random.default_rng(70 + t)
    args = _layer_args(rng, cell, t, n, f_in, hidden)
    lstm = cell == "lstm"
    if lstm:
        dh, x, hs, cs, w, _, b, h0, c0, dh_in, dc_in = args
        dx, dg, dh0, dc0 = ops.plain_f32_layer_backward(*args)
        streams = (dg, dg)
    else:
        dh, x, hs, w, _, b, h0, dh_in = args
        dx, dxw, dhw, dh0 = ops.plain_f32_gru_layer_backward(*args)
        streams, dc0 = (dxw, dhw), None

    recorder = _EinsumRecorder()
    monkeypatch.setattr(jax_ops, "jnp", recorder)
    want = _pallas_layer_bwd(
        jnp.asarray(dh.numpy()), jnp.asarray(x.numpy()), jnp.asarray(hs.numpy()),
        jnp.asarray(cs.numpy()) if lstm else None, jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()).reshape(-1, w.shape[1]), h0=jnp.asarray(h0.numpy()),
        c0=jnp.asarray(c0.numpy()) if lstm else None, dh_init=jnp.asarray(dh_in.numpy()),
        dc_init=jnp.asarray(dc_in.numpy()) if lstm else None, hidden=hidden, cell=cell,
        row_tile=n, interpret=True, x_feature_major=False, split_dw=True,
    )
    rec = recorder.operands
    want_dhw = np.asarray(rec["nh,ng->hg"][1])[None]
    if t > 1:
        want_dhw = np.concatenate([want_dhw, np.asarray(rec["tnh,tng->hg"][1])])
    pairs = [("dx", dx, want[0]), ("dxw", streams[0], rec["tnf,tng->fg"][1]),
             ("dhw", streams[1], want_dhw), ("dh0", dh0, want[5]), ("dc0", dc0, want[6])]
    for name, g, w_ in pairs:
        if w_ is None:
            assert g is None
            continue
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden", [(5, 37, 8, 16), (1, 37, 20, 40), (7, 16, 32, 64)])
def test_f32_stages_equal_tc_composition_at_fp32(cell, t, n, f_in, hidden):
    """At fp32 storage the tensor-core stages' plain composition
    (plain_tc_gemm, B as [K, Ncols]) rounds nothing: the fp32 stages' plain
    composition (plain_fwd_gemm, B in PyTorch's layout) gives the same
    outputs up to the order of the sums (1e-6), with the same walk."""
    rng = np.random.default_rng(t * n + hidden)
    args = _layer_args(rng, cell, t, n, f_in, hidden)
    if cell == "lstm":
        got = ops.plain_f32_layer_backward(*args)
        want = ops.plain_layer_backward(*args)
    else:
        got = ops.plain_f32_gru_layer_backward(*args)
        want = ops.plain_gru_layer_backward(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("m, k0, k1, shift", [(37, 12, 24, 37), (5, 3, 7, 2), (64, 20, 0, 0)])
def test_plain_fwd_gemm_second_segment(m, k0, k1, shift):
    """plain_fwd_gemm with ``prev``/``head``: [a | a_prev] · bᵀ + bias with
    a_prev's row m = head[m] for m < S, else prev[m - S], against the
    explicit product; without them, exactly ``a @ b.t() + bias`` as
    before."""
    rng = np.random.default_rng(m + k1)
    a = _t(rng.standard_normal((m, k0)).astype(np.float32))
    bias = _t(rng.standard_normal(9).astype(np.float32))
    if k1 == 0:
        b = _t(rng.standard_normal((9, k0)).astype(np.float32))
        assert torch.equal(ops.plain_fwd_gemm(a, b, bias), a @ b.t() + bias)
        out = torch.zeros(m + 2, 9)
        ops.plain_fwd_gemm(a, b, out=out[1 : 1 + m])
        assert torch.equal(out[1 : 1 + m], a @ b.t()) and not out[0].any() and not out[-1].any()
        return
    b = _t(rng.standard_normal((9, k0 + k1)).astype(np.float32))
    prev = _t(rng.standard_normal((m, k1)).astype(np.float32))
    head = _t(rng.standard_normal((shift, k1)).astype(np.float32))
    a_prev = np.concatenate([head.numpy(), prev.numpy()[: m - shift]])
    want = np.concatenate([a.numpy(), a_prev], axis=1) @ b.numpy().T + bias.numpy()
    got = ops.plain_fwd_gemm(a, b, bias, prev=prev, head=head)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_gru_weights_packed_in_torch_layout():
    """pack_gru_weights_t writes the packed GRU weights in PyTorch's
    [out, in] layout straight from wt: the transpose of pack_gru_weights's
    [in, out] packing, bit for bit, with the same bias, and one product
    with it gives the four sums (r, z, n's x part, hn) the walk reads."""
    f_in, hidden, rows = 12, 24, 29
    rng = np.random.default_rng(13)
    dh, x, hs, w, wt, b, h0, dh_in = _layer_args(rng, "gru", 3, rows, f_in, hidden)
    wp, bp = ops.pack_gru_weights(w, b, f_in)
    wpt, bpt = ops.pack_gru_weights_t(wt, b, f_in)
    assert wpt.shape == (4 * hidden, f_in + hidden) and wpt.is_contiguous()
    assert torch.equal(wpt, wp.t()) and torch.equal(bpt, bp)
    xs, hp = x[0], hs[0]
    got = ops.plain_fwd_gemm(xs, wpt, bpt, prev=hp, head=hp[:0])
    want = torch.cat([xs, hp], 1) @ wp + bp
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    w_ih, w_hh = wt[:, :f_in], wt[:, f_in:]
    hn = hp @ w_hh[2 * hidden :].t() + b[1, 2 * hidden :]
    np.testing.assert_allclose(got[:, 3 * hidden :].numpy(), hn.numpy(), rtol=0, atol=ATOL)
    nx = xs @ w_ih[2 * hidden :].t() + b[0, 2 * hidden :]
    np.testing.assert_allclose(got[:, 2 * hidden : 3 * hidden].numpy(), nx.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bwd_f32_tile_choice(cell):
    """The fp32 walk's tile at the smoke's shapes, with 7 clusters in flight
    (the forward walk's count on an H100): the smallest tile that walks
    every row in one wave, else the largest that fits; KR = 8 rows of each
    K slice in registers only where W_hh's rows do not fit in shared
    memory (the LSTM at H = 512; the GRU never: its register-holding
    instances are not built). Every tile within a block's 227 KB."""
    pick = ops.pick_bwd_f32_tile
    assert pick(1, 512, cell, 7)[0] == 1 and pick(1, 384, cell, 7)[0] == 1
    # the full-band stage at B = 32: 4 clusters of 8 rows (8 of 4 would not fit 7)
    assert pick(32, 512, cell, 7) == (8, 8 if cell == "lstm" else 0)
    assert pick(32, 512, cell, 8)[0] == 4
    assert pick(37, 384, cell, 7) == (8, 0)
    # the sub-band stage: no tile walks 4096 rows in one wave, the largest fits
    assert pick(4096, 384, cell, 7) == (16, 0)
    assert pick(4096, 512, cell, 7) == (8, 8 if cell == "lstm" else 0)
    # the tile count may come from a function of (rows, KR)
    assert pick(32, 384, cell, lambda r, kr: 32 // r) == (1, 0)
    for hidden in (16, 48, 384, 512):
        for rows in ops.BWD_F32_ROWS:
            kr = ops.bwd_f32_kr(rows, hidden, cell)
            if kr is not None:
                assert ops.bwd_f32_smem_bytes(rows, hidden, cell, kr) <= 232_448
                assert kr == 0 or cell == "lstm"
    # the LSTM at H = 512: 128 rows of W_hh (256 KB) leave the registers 8
    # of each slice's 32, and 16 rows no longer fit
    assert ops.bwd_f32_smem_bytes(8, 512, "lstm", 8) == 4 * (4 * 24 * 512 + 8 * 128 + 8 * 512)
    assert ops.bwd_f32_kr(16, 512, "lstm") is None
    with pytest.raises(ValueError, match="multiple of 16"):
        pick(32, 40, cell, 7)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bwd_f32_form_choice(cell):
    """The fp32 walk streams W_hh (blocks of 16 rows, every unit, no
    cluster) where that form fits (H up to 384) and the cluster form needs
    more than one wave: the sub-band stage at N = 4096, not the full-band
    stage (H = 512) nor few rows. Its ring holds 2 slots, which fit beside
    the LSTM's 16 x 1536 cotangents."""
    assert ops.bwd_f32_streams(4096, 384, cell, 7)
    assert not ops.bwd_f32_streams(32, 384, cell, 7) and not ops.bwd_f32_streams(112, 384, cell, 7)
    assert ops.bwd_f32_streams(113, 384, cell, 7)
    assert not ops.bwd_f32_streams(4096, 512, cell, 7)
    assert not ops.bwd_f32_stream_fits(512, cell) and ops.bwd_f32_stream_fits(384, cell)
    assert ops.bwd_f32_stream_smem_bytes(384, cell) <= 232_448
    assert ops.bwd_f32_stream_smem_bytes(384, "lstm") == 4 * (16 * 1536 + 2 * 32 * 384)
    assert ops.bwd_f32_stream_smem_bytes(384, "gru") == 4 * (16 * 1152 + 2 * 32 * 384)
