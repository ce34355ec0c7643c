"""The port's LSTM training op against the JAX package on the CPU: the
plain versions of K2 (stash forward) and K3 (one layer's backward)
against the Pallas kernels ``_stash_fwd_call`` and ``_pallas_layer_bwd``
run in interpret mode, and the gradients of the differentiable
``fused_subband_lstm`` (``LstmScanFunction`` over the plain versions)
against ``jax.value_and_grad`` of ``fused_subband_lstm_train``, as
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

from fullsubnet_tpu.ops.subband_lstm import (
    _pallas_layer_bwd,
    _stash_fwd_call,
    fused_subband_lstm_train,
)
from fullsubnet_tpu_torch.nn.rnn import lstm_forward
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# fp32 on both sides; only the order of the sums differs
ATOL = 1e-5
# gradients: the tolerance of the JAX package's own VJP-vs-scan test
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _stack(rng, f_in, hidden, out_dim, num_layers=2):
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


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("initial", ["zero", "random"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_plain_stash_forward_matches_pallas(initial, num_layers):
    """K2's plain version: the head output and every layer's h and c
    stash, from zero and from non-zero initial states."""
    t, n, f_in, hidden, out_dim = 16, 16, 8, 16, 3
    rng = np.random.default_rng(num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    states = [
        (rng.uniform(-0.5, 0.5, (n, hidden)) if initial == "random"
         else np.zeros((n, hidden))).astype(np.float32)
        for _ in range(2 * num_layers)
    ]  # h0, c0 of layer 0, then of layer 1, ...

    out, stashes = _stash_fwd_call(
        jnp.asarray(np.swapaxes(x, 1, 2)), _tree(layers, jnp.asarray), _tree(fc, jnp.asarray),
        tuple(jnp.asarray(s) for s in states), row_tile=8, interpret=True,
    )
    ws, bs, wfc, bfc = ops.prep_weights(_tree(layers, _t), _tree(fc, _t), torch.float32)
    got_out, hs, cs = ops.plain_stash_forward(
        _t(x), ws, bs, wfc, bfc, [_t(s) for s in states[0::2]], [_t(s) for s in states[1::2]]
    )
    np.testing.assert_allclose(got_out.numpy(), np.transpose(np.asarray(out), (1, 2, 0)),
                               atol=ATOL)
    for li in range(num_layers):
        np.testing.assert_allclose(hs[li].numpy(), np.asarray(stashes[2 * li]), atol=ATOL)
        np.testing.assert_allclose(cs[li].numpy(), np.asarray(stashes[2 * li + 1]), atol=ATOL)


@pytest.mark.parametrize("split_dw", [True, False])
@pytest.mark.parametrize("f_in, hidden", [(8, 16), (32, 48)])
def test_plain_layer_backward_matches_pallas(split_dw, f_in, hidden):
    """K3's plain version and the split-dW products: dx, dW_ih, dW_hh,
    the bias gradients and the dh0/dc0 carries, from non-zero initial
    states and incoming carries. The JAX kernel accumulates dW in-kernel
    with ``split_dw=False`` and streams dgates with ``True``; the port
    always streams."""
    t, n = 11, 16
    rng = np.random.default_rng(f_in)
    layers, _ = _stack(rng, f_in, hidden, 1, num_layers=1)
    tl = _tree(layers, _t)
    ws, bs, _, _ = ops.prep_weights(tl, {"weight": torch.zeros(1, hidden),
                                         "bias": torch.zeros(1)}, torch.float32)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    h0, c0, dh_in, dc_in = (rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)
                            for _ in range(4))
    _, hs, cs = ops.plain_stash_forward(_t(x), ws, bs, torch.zeros(hidden, 1), torch.zeros(1),
                                        [_t(h0)], [_t(c0)])
    dh = rng.standard_normal((t, n, hidden)).astype(np.float32)

    want = _pallas_layer_bwd(
        jnp.asarray(dh), jnp.asarray(x), jnp.asarray(hs[0].numpy()), jnp.asarray(cs[0].numpy()),
        jnp.asarray(ws[0].numpy()), jnp.asarray(bs[0].numpy())[None],
        h0=jnp.asarray(h0), c0=jnp.asarray(c0), dh_init=jnp.asarray(dh_in),
        dc_init=jnp.asarray(dc_in), hidden=hidden, cell="lstm", row_tile=8,
        interpret=True, x_feature_major=False, split_dw=split_dw,
    )
    dx, dg, dh0, dc0 = ops.plain_layer_backward(
        _t(dh), _t(x), hs[0], cs[0], ws[0], ws[0].t().contiguous(), bs[0], _t(h0), _t(c0),
        _t(dh_in), _t(dc_in),
    )
    dwih, dwhh, db = ops.layer_weight_grads(_t(x), hs[0], _t(h0), dg)
    got = (dx, dwih, dwhh, db, db, dh0, dc0)
    names = ("dx", "dW_ih", "dW_hh", "db_ih", "db_hh", "dh0", "dc0")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("t, n, f_in, hidden", [(13, 16, 32, 48), (11, 13, 8, 16)])
def test_lstm_scan_function_grads_match_jax(t, n, f_in, hidden):
    """The gradients of ``fused_subband_lstm`` under torch autograd
    (``LstmScanFunction`` on the CPU) against ``jax.value_and_grad`` of
    the JAX package's custom VJP in interpret mode, and against torch
    autograd of the plain ``lstm_forward``. The second case has N not a
    multiple of the row tile and T not a multiple of 8."""
    rng = np.random.default_rng(t)
    layers, fc = _stack(rng, f_in, hidden, 2)
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
        lambda xt, s, h: lstm_forward(s, xt) @ h["weight"].t() + h["bias"]
    )

    # by key: JAX hands dicts back with their keys sorted
    want = [layer[k] for layer in want_params[0] for k in layers[0]]
    want += [want_params[1][k] for k in fc] + [want_x]
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(plain_loss.detach()), float(want_loss), rtol=1e-5)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_cpu_training_counts_no_launch():
    """On the CPU the differentiable op runs the plain versions and no
    kernel wrapper counts a launch; under no_grad it runs K1's plain
    version."""
    rng = np.random.default_rng(0)
    layers, fc = _stack(rng, 4, 8, 2)
    stack = _tree(layers, lambda a: _t(a).requires_grad_())
    head = _tree(fc, _t)
    x = _t(rng.standard_normal((5, 3, 4)).astype(np.float32))
    for kernel in (ops.lstm_scan, ops.stash_fwd, ops.layer_bwd):
        kernel.reset_counts()
    ops.fused_subband_lstm(x, *stack, head).sum().backward()
    assert all(layer["w_ih"].grad is not None for layer in stack)
    assert (ops.lstm_scan.launches, ops.stash_fwd.launches, ops.layer_bwd.launches) == (0, 0, 0)


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


def test_bwd_rows_per_block_choice():
    # the flagship sub-band stage (N = 32 * 128): the widest tile
    assert ops.pick_bwd_rows_per_block(4096, 32, 384) == 8
    # the full-band stage (N = 32): two rows per block
    assert ops.pick_bwd_rows_per_block(32, 257, 512) == 2
    for n, f_in, hidden in ((4096, 32, 384), (4096, 384, 384), (32, 257, 512), (32, 512, 512)):
        rows = ops.pick_bwd_rows_per_block(n, f_in, hidden)
        assert ops.bwd_smem_bytes(f_in, hidden, rows) <= 232_448
