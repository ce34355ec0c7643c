"""The port's training op, with the LSTM and the GRU cell, against the
JAX package on the CPU: the plain versions of K2 and K2-GRU (stash
forward) and of K3 and K4 (one layer's backward) against the Pallas
kernels ``_stash_fwd_call`` and ``_pallas_layer_bwd`` run in interpret
mode, and the gradients of the differentiable ``fused_subband_lstm``
(``RnnScanFunction`` over the plain versions) against
``jax.value_and_grad`` of ``fused_subband_lstm_train``, as
tests/test_pallas_subband.py runs it. Same numpy-seeded weights and
inputs on both sides; fp32.

The CUDA kernels themselves run only on a card: their tests are in
tests/test_torch_kernel_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops import subband_lstm as jax_ops
from fullsubnet_tpu.ops.subband_lstm import (
    _pallas_layer_bwd,
    _stash_fwd_call,
    fused_subband_lstm_train,
)
from fullsubnet_tpu_torch.nn.rnn import gru_forward, lstm_forward
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5
# gradients: the tolerance of the JAX package's own VJP-vs-scan test
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


GATES = {"lstm": 4, "gru": 3}


def _stack(rng, f_in, hidden, out_dim, num_layers=2, cell="lstm"):
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


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class _EinsumRecorder:
    """``jax.numpy`` whose ``einsum`` records its operands by spec: how a
    test reads the cotangent streams that ``_pallas_layer_bwd`` hands to
    its split-dW products (dxw to "tnf,tng->fg"; dhw[1:] and dhw[0] to
    "tnh,tng->hg" and "nh,ng->hg")."""

    def __init__(self):
        self.operands = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kwargs):
        self.operands[spec] = operands
        return jnp.einsum(spec, *operands, **kwargs)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("initial", ["zero", "random"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_plain_stash_forward_matches_pallas(initial, num_layers, cell):
    """K2's and K2-GRU's plain version: the head output and every layer's
    stashes (h and c; h for the GRU), from zero and from non-zero initial
    states."""
    t, n, f_in, hidden, out_dim = 16, 16, 8, 16, 3
    rng = np.random.default_rng(num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cell)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    per_layer = 2 if cell == "lstm" else 1
    states = [
        (rng.uniform(-0.5, 0.5, (n, hidden)) if initial == "random"
         else np.zeros((n, hidden))).astype(np.float32)
        for _ in range(per_layer * num_layers)
    ]  # h0 (, c0) of layer 0, then of layer 1, ...

    out, stashes = _stash_fwd_call(
        jnp.asarray(np.swapaxes(x, 1, 2)), _tree(layers, jnp.asarray), _tree(fc, jnp.asarray),
        tuple(jnp.asarray(s) for s in states), row_tile=8, interpret=True,
    )
    ws, bs, wfc, bfc = ops.prep_weights(_tree(layers, _t), _tree(fc, _t), torch.float32)
    c0s = [_t(s) for s in states[1::2]] if cell == "lstm" else None
    got_out, *got = ops.plain_stash_forward(
        _t(x), ws, bs, wfc, bfc, [_t(s) for s in states[::per_layer]], c0s
    )
    np.testing.assert_allclose(got_out.numpy(), np.transpose(np.asarray(out), (1, 2, 0)),
                               atol=ATOL)
    for li in range(num_layers):
        for k, stash in enumerate(got):  # h, then c
            np.testing.assert_allclose(stash[li].numpy(), np.asarray(stashes[per_layer * li + k]),
                                       atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("split_dw", [True, False])
@pytest.mark.parametrize("f_in, hidden", [(8, 16), (32, 48)])
def test_plain_layer_backward_matches_pallas(split_dw, f_in, hidden, cell, monkeypatch):
    """K3's and K4's plain versions and the dW stage's (``layer_weight_grads``):
    dx, dW_ih, dW_hh, the bias gradients and the dh0 (and dc0) carries,
    from non-zero initial states and incoming carries. The JAX kernel
    accumulates dW in-kernel with ``split_dw=False`` and streams the
    cotangents to einsums with ``True``; the port writes the streams and
    sums [x | h_prev | 1]^T over them in a stage of its own, as the fused
    form's body does, and is held to both forms. With ``True`` the
    streams themselves are held too: K3's dgates, and K4's dxw and dhw
    (for the GRU they differ, and so do the two bias gradients)."""
    t, n = 11, 16
    rng = np.random.default_rng(f_in)
    layers, _ = _stack(rng, f_in, hidden, 1, num_layers=1, cell=cell)
    tl = _tree(layers, _t)
    ws, bs, _, _ = ops.prep_weights(tl, {"weight": torch.zeros(1, hidden),
                                         "bias": torch.zeros(1)}, torch.float32)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    h0, c0, dh_in, dc_in = (rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)
                            for _ in range(4))
    lstm = cell == "lstm"
    _, hs, *cs = ops.plain_stash_forward(_t(x), ws, bs, torch.zeros(hidden, 1), torch.zeros(1),
                                         [_t(h0)], [_t(c0)] if lstm else None)
    dh = rng.standard_normal((t, n, hidden)).astype(np.float32)

    recorder = _EinsumRecorder()
    monkeypatch.setattr(jax_ops, "jnp", recorder)
    want = _pallas_layer_bwd(
        jnp.asarray(dh), jnp.asarray(x), jnp.asarray(hs[0].numpy()),
        jnp.asarray(cs[0][0].numpy()) if lstm else None,
        jnp.asarray(ws[0].numpy()), jnp.asarray(bs[0].numpy()).reshape(-1, ws[0].shape[1]),
        h0=jnp.asarray(h0), c0=jnp.asarray(c0) if lstm else None, dh_init=jnp.asarray(dh_in),
        dc_init=jnp.asarray(dc_in) if lstm else None, hidden=hidden, cell=cell, row_tile=8,
        interpret=True, x_feature_major=False, split_dw=split_dw,
    )
    wt = ws[0].t().contiguous()
    if lstm:
        dx, dg, dh0, dc0 = ops.plain_layer_backward(
            _t(dh), _t(x), hs[0], cs[0][0], ws[0], wt, bs[0], _t(h0), _t(c0), _t(dh_in),
            _t(dc_in),
        )
        dwih, dwhh, dbih, dbhh = ops.layer_weight_grads(_t(x), hs[0], _t(h0), dg)
        streams = (dg, dg)
    else:
        dx, dxw, dhw, dh0 = ops.plain_gru_layer_backward(
            _t(dh), _t(x), hs[0], ws[0], wt, bs[0], _t(h0), _t(dh_in),
        )
        dwih, dwhh, dbih, dbhh = ops.layer_weight_grads(_t(x), hs[0], _t(h0), dxw, dhw)
        streams = (dxw, dhw)
        dc0 = None
        assert not torch.allclose(dbih, dbhh) and not torch.allclose(dxw, dhw)
    if split_dw:
        rec = recorder.operands
        want_dhw = np.concatenate([np.asarray(rec["nh,ng->hg"][1])[None],
                                   np.asarray(rec["tnh,tng->hg"][1])])
        for name, g, w in zip(("dxw", "dhw"), streams, (rec["tnf,tng->fg"][1], want_dhw)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)
    got = (dx, dwih, dwhh, dbih, dbhh, dh0, dc0)
    names = ("dx", "dW_ih", "dW_hh", "db_ih", "db_hh", "dh0", "dc0")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden", [(13, 16, 32, 48), (11, 13, 8, 16)])
def test_lstm_scan_function_grads_match_jax(t, n, f_in, hidden, cell):
    """The gradients of ``fused_subband_lstm`` under torch autograd
    (``RnnScanFunction`` on the CPU) against ``jax.value_and_grad`` of
    the JAX package's custom VJP in interpret mode (for the GRU, what
    tests/test_pallas_subband.py's ``test_train_kernel_grad_parity_gru``
    holds), and against torch autograd of the plain ``lstm_forward`` or
    ``gru_forward``. The second case has N not a multiple of the row tile
    and T not a multiple of 8."""
    rng = np.random.default_rng(t)
    layers, fc = _stack(rng, f_in, hidden, 2, cell=cell)
    forward = lstm_forward if cell == "lstm" else gru_forward
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    target = rng.standard_normal((t, n, 2)).astype(np.float32)

    def jax_loss(params, xj):
        stack, head = params
        out = fused_subband_lstm_train(xj, *stack, head, row_tile=8, interpret=True)
        return jnp.mean(jnp.square(out - target))

    want_loss, (want_params, want_x) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        (_tree(layers, jnp.asarray), _tree(fc, jnp.asarray)), jnp.asarray(x)
    )

    def torch_loss(run):
        stack = _tree(layers, lambda a: _t(a).requires_grad_())
        head = _tree(fc, lambda a: _t(a).requires_grad_())
        xt = _t(x).requires_grad_()
        loss = torch.mean((run(xt, stack, head) - _t(target)) ** 2)
        leaves = [v for layer in stack for v in layer.values()] + list(head.values())
        return loss, torch.autograd.grad(loss, [*leaves, xt])

    got_loss, got = torch_loss(lambda xt, s, h: ops.fused_subband_lstm(xt, *s, h))
    plain_loss, plain = torch_loss(
        lambda xt, s, h: forward(s, xt) @ h["weight"].t() + h["bias"]
    )

    # by key: JAX hands dicts back with their keys sorted
    want = [layer[k] for layer in want_params[0] for k in layers[0]]
    want += [want_params[1][k] for k in fc] + [want_x]
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(plain_loss.detach()), float(want_loss), rtol=1e-5)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _single_pass_plain_layer_backward(dh, x, hs, cs, w, b, h0, c0, dh_in, dc_in):
    """K3's plain version as it stood before the layer backward was split
    into stages (one function, the gate recompute inside): the reference
    the stage composition is held to."""
    cdt = x.dtype
    t, _, f_in = x.shape
    wf = w.float()
    h_prev = torch.cat([h0[None], hs[:-1]]).float()
    c_prev = torch.cat([c0[None], cs[:-1]]).float()
    gates = x.float() @ wf[:f_in] + h_prev @ wf[f_in:] + b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(cs.float())
    dh_c, dc_c = dh_in.float(), dc_in.float()
    w_hh_t = wf[f_in:].t()
    dgs = [None] * t
    for step in reversed(range(t)):
        dh_tot = dh[step].float() + dh_c
        do = dh_tot * tanh_c[step]
        dc = dc_c + dh_tot * o[step] * (1.0 - tanh_c[step] * tanh_c[step])
        dgates = torch.cat([
            (dc * g[step]) * i[step] * (1.0 - i[step]),
            (dc * c_prev[step]) * f[step] * (1.0 - f[step]),
            (dc * i[step]) * (1.0 - g[step] * g[step]),
            do * o[step] * (1.0 - o[step]),
        ], dim=-1)
        dgs[step] = dgates.to(cdt).float()
        dh_c = dgs[step] @ w_hh_t
        dc_c = dc * f[step]
    dg = torch.stack(dgs)
    return (dg @ wf[:f_in].t()).to(cdt), dg.to(cdt), dh_c, dc_c


def _single_pass_plain_gru_layer_backward(dh, x, hs, w, b, h0, dh_in):
    """K4's plain version before the split into stages (see above)."""
    cdt = x.dtype
    t, _, f_in = x.shape
    hidden = hs.shape[-1]
    wf = w.float()
    h_prev = torch.cat([h0[None], hs[:-1]]).float()
    xw = x.float() @ wf[:f_in] + b[0]
    hw = h_prev @ wf[f_in:] + b[1]
    r = torch.sigmoid(xw[..., :hidden] + hw[..., :hidden])
    z = torch.sigmoid(xw[..., hidden : 2 * hidden] + hw[..., hidden : 2 * hidden])
    hn_pre = hw[..., 2 * hidden :]
    n = torch.tanh(xw[..., 2 * hidden :] + r * hn_pre)
    dh_c = dh_in.float()
    w_hh_t = wf[f_in:].t()
    dxws, dhws = [None] * t, [None] * t
    for step in reversed(range(t)):
        dh_tot = dh[step].float() + dh_c
        dz = dh_tot * (h_prev[step] - n[step])
        dn = (dh_tot * (1.0 - z[step])) * (1.0 - n[step] * n[step])
        dr = (dn * hn_pre[step]) * r[step] * (1.0 - r[step])
        dz = dz * z[step] * (1.0 - z[step])
        dxws[step] = torch.cat([dr, dz, dn], dim=-1).to(cdt).float()
        dhws[step] = torch.cat([dr, dz, dn * r[step]], dim=-1).to(cdt).float()
        dh_c = dh_tot * z[step] + dhws[step] @ w_hh_t
    dxw, dhw = torch.stack(dxws), torch.stack(dhws)
    return (dxw @ wf[:f_in].t()).to(cdt), dxw.to(cdt), dhw.to(cdt), dh_c


def _layer_args(rng, cell, t, n, f_in, hidden, dtype):
    """One layer's backward operands in storage type ``dtype`` (stashes
    from the plain forward, non-zero initial states and carries), in the
    order of plain_layer_backward (LSTM) or plain_gru_layer_backward."""
    layers, _ = _stack(rng, f_in, hidden, 1, num_layers=1, cell=cell)
    ws, bs, _, _ = ops.prep_weights(_tree(layers, _t), {"weight": torch.zeros(1, hidden),
                                                        "bias": torch.zeros(1)}, dtype)

    def draw(*shape):
        return _t(rng.uniform(-0.5, 0.5, shape).astype(np.float32))

    x = _t(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(dtype)
    h0, c0 = draw(n, hidden).to(dtype), draw(n, hidden).to(dtype)
    lstm = cell == "lstm"
    _, hs, *cs = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 1, dtype=dtype),
                                         torch.zeros(1), [h0], [c0] if lstm else None)
    dh = _t(rng.standard_normal((t, n, hidden)).astype(np.float32)).to(dtype)
    wt = ws[0].t().contiguous()
    if lstm:
        return dh, x, hs[0], cs[0][0], ws[0], wt, bs[0], h0, c0, draw(n, hidden), draw(n, hidden)
    return dh, x, hs[0], ws[0], wt, bs[0], h0, draw(n, hidden)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t, n, f_in, hidden", [(5, 37, 8, 16), (1, 37, 20, 40), (11, 16, 32, 48)])
def test_plain_stages_compose_to_single_pass_plain(cell, dtype, t, n, f_in, hidden):
    """The plain layer backward, now the composition of the GEMM's and the
    walk's plain versions, against the single function it replaced: at
    fp32 within 1e-6; at bf16 the bf16 outputs (dx, the cotangent streams)
    equal bit for bit and the fp32 carries within 1e-6. (The GRU's packed
    pre-activations add its two biases in another order, so its fp32
    values may differ in the last bit.)"""
    rng = np.random.default_rng(t * n + hidden)
    args = _layer_args(rng, cell, t, n, f_in, hidden, dtype)
    if cell == "lstm":
        got = ops.plain_layer_backward(*args)
        dh, x, hs, cs, w, _, b, h0, c0, dh_in, dc_in = args
        want = _single_pass_plain_layer_backward(dh, x, hs, cs, w, b, h0, c0, dh_in, dc_in)
    else:
        got = ops.plain_gru_layer_backward(*args)
        dh, x, hs, w, _, b, h0, dh_in = args
        want = _single_pass_plain_gru_layer_backward(dh, x, hs, w, b, h0, dh_in)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.bfloat16:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t", [1, 5])
def test_plain_stages_match_pallas(cell, t, monkeypatch):
    """The three stages in their plain versions (the pre-activation GEMM,
    the walk, the dx GEMM), run one by one, against the JAX
    ``_pallas_layer_bwd`` in interpret mode at N = 37 (one row tile of 37)
    from non-zero initial states and incoming carries: dx, the cotangent
    streams and the carries, fp32, to the tolerance of the JAX package's
    own VJP test."""
    n, f_in, hidden = 37, 12, 24
    rng = np.random.default_rng(40 + t)
    args = _layer_args(rng, cell, t, n, f_in, hidden, torch.float32)
    lstm = cell == "lstm"
    if lstm:
        dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in = args
        p = ops.plain_tc_gemm(x.reshape(-1, f_in), w, bias=b, prev=hs.reshape(-1, hidden),
                              head=h0)
        dg, dh0, dc0 = ops.plain_lstm_walk(p.view(t, n, -1), dh, cs, c0, wt[:, f_in:], dh_in,
                                           dc_in)
        streams = (dg, dg)
    else:
        dh, x, hs, w, wt, b, h0, dh_in = args
        wp, bp = ops.pack_gru_weights(w, b, f_in)
        p = ops.plain_tc_gemm(x.reshape(-1, f_in), wp, bias=bp, prev=hs.reshape(-1, hidden),
                              head=h0)
        dxw, dhw, dh0 = ops.plain_gru_walk(p.view(t, n, -1), dh, hs, h0, wt[:, f_in:], dh_in)
        streams, dc0 = (dxw, dhw), None
    dx = ops.plain_tc_gemm(streams[0].reshape(t * n, -1), wt[:, :f_in]).view(t, n, f_in)

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
    for name, g, w in pairs:
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_gru_weight_packing_matches_jax_sums():
    """One product [x | h] · w' + b' of the packed GRU weights gives the
    four sums ``_gru_layer_bwd_kernel`` forms (:670-684), written here with
    jnp on the same arrays: r and z (x and h parts, b_ih and b_hh), n's x
    part with b_in, and n's h part W_hn h + b_hn. fp32."""
    f_in, hidden, rows = 12, 24, 29
    rng = np.random.default_rng(11)
    layers, _ = _stack(rng, f_in, hidden, 1, num_layers=1, cell="gru")
    ws, bs, _, _ = ops.prep_weights(_tree(layers, _t), {"weight": torch.zeros(1, hidden),
                                                        "bias": torch.zeros(1)})
    w, b = ws[0], bs[0]
    x = rng.standard_normal((rows, f_in)).astype(np.float32)
    h = rng.standard_normal((rows, hidden)).astype(np.float32)
    wj, bj = jnp.asarray(w.numpy()), jnp.asarray(b.numpy())
    xw = jnp.dot(jnp.asarray(x), wj[:f_in], preferred_element_type=jnp.float32) + bj[0]
    hw = jnp.dot(jnp.asarray(h), wj[f_in:], preferred_element_type=jnp.float32)
    b_hh = bj[1]
    want = jnp.concatenate([
        xw[:, :hidden] + hw[:, :hidden] + b_hh[:hidden],                          # r
        xw[:, hidden : 2 * hidden] + hw[:, hidden : 2 * hidden]
        + b_hh[hidden : 2 * hidden],                                              # z
        xw[:, 2 * hidden :],                                                      # n, x part
        hw[:, 2 * hidden :] + b_hh[2 * hidden :],                                 # hn
    ], axis=-1)
    wp, bp = ops.pack_gru_weights(w, b, f_in)
    assert wp.shape == (f_in + hidden, 4 * hidden) and bp.dtype == torch.float32
    got = ops.plain_tc_gemm(_t(x), wp, bias=bp, prev=_t(h), head=_t(h[:0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the zero blocks keep n's x and h parts apart
    assert not wp[f_in:, 2 * hidden : 3 * hidden].any() and not wp[:f_in, 3 * hidden :].any()


def test_walk_tile_choice():
    """The walk's tile: the smallest row tile that still runs every block
    at once on 132 SMs, and the deepest ring (at most 4 slots) that fits in
    shared memory, both checked against the 227 KB a block may use."""
    # the sub-band stage (N = 4096, H = 384): 32 rows, 128 blocks
    assert ops.pick_walk_tile(4096, 4 * 384, 384) == (32, 4)
    assert ops.pick_walk_tile(4096, 3 * 384, 384) == (32, 4)
    # the full-band stage (N = 32, H = 512): 16 rows, two blocks, 4 slots
    assert ops.pick_walk_tile(32, 4 * 512, 512) == (16, 4)
    for n, hidden in ((4096, 384), (32, 512), (37, 40), (100_000, 256)):
        for gates in (4 * hidden, 3 * hidden):
            rows, stages = ops.pick_walk_tile(n, gates, hidden)
            assert ops.walk_smem_bytes(rows, gates, hidden, stages) <= 232_448
    # 64 rows of the LSTM's 4H = 2048 dgates do not fit beside any ring
    assert ops.walk_smem_bytes(64, 2048, 512, 2) > 232_448
    assert ops.walk_widths(3 * 40, 40) == (128, 128)
    # few rows at H = 256 or 512 split over clusters of 16 CTAs (at most 4
    # clusters of 32 rows): the full-band stage at B = 32 does, the
    # sub-band stage does not
    assert ops.walk_splits(32, 512) and ops.walk_splits(128, 256)
    assert not ops.walk_splits(129, 512)
    assert not ops.walk_splits(4096, 384) and not ops.walk_splits(32, 384)
    # a split CTA at the full-band LSTM: 128 rows of W_hh^T (128 KB), its
    # dgates tile and the fp32 partials, within a block's 227 KB
    assert ops.split_smem_bytes(4 * 512, 512) == 205_824 <= 232_448
    assert max(ops.split_smem_bytes(g * h, h) for g in (3, 4) for h in (256, 512)) <= 232_448


KERNELS = ("lstm_scan", "stash_fwd", "layer_bwd", "gru_scan", "gru_stash_fwd", "gru_layer_bwd",
           "tc_gemm", "lstm_walk", "gru_walk", "lstm_train_walk", "gru_train_walk", "fwd_gemm",
           "lstm_fwd_walk", "gru_fwd_walk", "lstm_walk_f32", "gru_walk_f32",
           "lstm_train_walk_f32", "gru_train_walk_f32")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_training_counts_no_launch(cell):
    """On the CPU the differentiable op runs the plain versions and no
    kernel wrapper counts a launch; under no_grad it runs K1's or
    K1-GRU's plain version."""
    rng = np.random.default_rng(0)
    layers, fc = _stack(rng, 4, 8, 2, cell=cell)
    stack = _tree(layers, lambda a: _t(a).requires_grad_())
    head = _tree(fc, _t)
    x = _t(rng.standard_normal((5, 3, 4)).astype(np.float32))
    for name in KERNELS:
        getattr(ops, name).reset_counts()
    ops.fused_subband_lstm(x, *stack, head).sum().backward()
    with torch.no_grad():
        ops.fused_subband_lstm(x, *stack, head)
    assert all(layer["w_ih"].grad is not None for layer in stack)
    assert [getattr(ops, name).launches for name in KERNELS] == [0] * len(KERNELS)


def test_training_wrappers_refuse_cpu_tensors():
    """No fallback inside the wrappers: a CPU tensor is an error there."""
    rng = np.random.default_rng(1)
    layers, fc = _stack(rng, 4, 8, 2)
    ws, bs, wfc, bfc = ops.prep_weights(_tree(layers, _t), _tree(fc, _t), torch.float32)
    zeros = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.stash_fwd(torch.zeros(5, 3, 4), ws, bs, wfc, bfc, [zeros] * 2, [zeros] * 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.layer_bwd(torch.zeros(5, 3, 8), torch.zeros(5, 3, 4), torch.zeros(5, 3, 8),
                      torch.zeros(5, 3, 8), ws[0], ws[0].t(), bs[0], zeros, zeros, zeros, zeros)
    layers, fc = _stack(rng, 4, 8, 2, cell="gru")
    ws, bs, wfc, bfc = ops.prep_weights(_tree(layers, _t), _tree(fc, _t), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_stash_fwd(torch.zeros(5, 3, 4), ws, bs, wfc, bfc, [zeros] * 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_layer_bwd(torch.zeros(5, 3, 8), torch.zeros(5, 3, 4), torch.zeros(5, 3, 8),
                          ws[0], ws[0].t(), bs[0], zeros, zeros)
    bf16 = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.tc_gemm(torch.zeros(4, 8, dtype=bf16), torch.zeros(8, 16, dtype=bf16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_walk(torch.zeros(5, 3, 32), *(torch.zeros(5, 3, 8, dtype=bf16),) * 2,
                      zeros.to(bf16), torch.zeros(32, 8, dtype=bf16), zeros, zeros)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_walk(torch.zeros(5, 3, 32), *(torch.zeros(5, 3, 8, dtype=bf16),) * 2,
                     zeros.to(bf16), torch.zeros(24, 8, dtype=bf16), zeros)
    # the fp32 stages: the GEMM with its second K segment, and the walks
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fwd_gemm(torch.zeros(15, 4), torch.zeros(32, 12), prev=torch.zeros(15, 8),
                     head=zeros)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_walk_f32(torch.zeros(5, 3, 32), *(torch.zeros(5, 3, 8),) * 2, zeros,
                          torch.zeros(32, 8), zeros, zeros)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gru_walk_f32(torch.zeros(5, 3, 32), *(torch.zeros(5, 3, 8),) * 2, zeros,
                         torch.zeros(24, 8), zeros)


def test_gru_biases_stay_apart():
    """prep_weights keeps a GRU's b_ih and b_hh as a [2, 3H] pair (the
    reset gate scales W_hn h + b_hn) and fuses an LSTM's."""
    rng = np.random.default_rng(2)
    for cell, shape in (("lstm", (32,)), ("gru", (2, 24))):
        layers, fc = _stack(rng, 4, 8, 2, cell=cell)
        _, bs, _, _ = ops.prep_weights(_tree(layers, _t), _tree(fc, _t), torch.bfloat16)
        assert bs[0].shape == shape and bs[0].dtype == torch.float32
    np.testing.assert_array_equal(bs[1].numpy(), np.stack([layers[1]["b_ih"], layers[1]["b_hh"]]))


def test_bwd_rows_per_block_choice():
    # the flagship sub-band stage (N = 32 * 128): the widest tile
    assert ops.pick_bwd_rows_per_block(4096, 32, 384) == 8
    # the full-band stage (N = 32): two rows per block
    assert ops.pick_bwd_rows_per_block(32, 257, 512) == 2
    for n, f_in, hidden in ((4096, 32, 384), (4096, 384, 384), (32, 257, 512), (32, 512, 512)):
        for cell in ("lstm", "gru"):
            rows = ops.pick_bwd_rows_per_block(n, f_in, hidden, cell)
            assert rows == ops.pick_bwd_rows_per_block(n, f_in, hidden)
            assert ops.bwd_smem_bytes(f_in, hidden, rows, cell) <= 232_448
    # K4 holds dxw [3H] and dhw's n part [H] where K3 holds dgates [4H] and dc
    assert ops.bwd_smem_bytes(32, 384, 8, "gru") == 4 * 8 * (32 + 6 * 384)
