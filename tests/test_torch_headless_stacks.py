"""The port's head-less stacks and stacks of a width the card's walks do
not take (H = 257, Fast FullSubNet's), against the JAX package on the same
weights: ``SequenceModel(output_size=0)`` and ``SequenceModel(hidden_size=
257)``, forward and the gradients of a fixed loss (JAX: its scan, under
``jax.grad``; the port: ``RnnScanFunction`` over the plain versions). Then
the glue the card runs for them, on the CPU through the plain versions:
``pad_stack`` (H zero-padded to the walks' width, exact), ``pad_input``
(the bf16 input width padded to the tensor-core GEMM's, exact), the head-less
inference stages (``plain_fused_forward`` with no head) and the head-less
training stages (``plain_stash_forward``, no head GEMM)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.nn.sequence_model import SequenceModel as JaxSequenceModel
from fullsubnet_tpu_torch.ops import subband_lstm as ops
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel

from test_torch_sequence_model import _params, _state_dict

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 forward on both sides; only the order of the sums differs
ATOL = 1e-5
# gradients of a fixed loss, each tensor within this share of its largest
# magnitude (tests/test_torch_train.py's fp32 tolerance)
FP32_GRAD_RTOL = 1e-3


def _jax_tree(params):
    return jax.tree.map(jnp.asarray, params)


def _by_key(params) -> dict:
    """A JAX SequenceModel tree, with a head or head-less, -> numpy arrays
    under the port's state-dict keys."""
    head = "fc" in params
    fc = params["fc"] if head else {"weight": np.zeros(1), "bias": np.zeros(1)}
    return {k: np.asarray(v) for k, v in _state_dict({**params, "fc": fc}).items()
            if head or not k.startswith("fc_output_layer")}


def _close(got: dict, want: dict, rtol: float):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = float(np.max(np.abs(w))) or 1.0
        np.testing.assert_allclose(got[key], w, atol=rtol * scale, rtol=0, err_msg=key)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("hidden, out_dim, act", [(24, 0, None), (257, 12, "ReLU"),
                                                  (257, 0, None)])
def test_stack_matches_jax_forward_and_grads(cell, hidden, out_dim, act):
    """A head-less stack (out_dim 0: no fc_output_layer, the top layer's h
    comes out) and a 257-unit stack, 2 layers, B = 3, T = 11."""
    b, f_in, t, layers = 3, 10, 11, 2
    rng = np.random.default_rng(hidden + out_dim)
    params = _params(rng, f_in, hidden, max(out_dim, 1), layers, cell)
    if not out_dim:
        params = {"rnn": params["rnn"]}
    x = rng.standard_normal((b, f_in, t)).astype(np.float32)
    out_width = out_dim or hidden
    probe = rng.standard_normal((b, out_width, t)).astype(np.float32)
    kwargs = dict(input_size=f_in, output_size=out_dim, hidden_size=hidden, num_layers=layers,
                  bidirectional=False, sequence_model=cell, output_activate_function=act)

    jax_model = JaxSequenceModel(**kwargs)

    def loss(p, xs):
        return jnp.sum(jax_model(p, xs, training=True) * probe)

    # jitted: one XLA program compiles faster than the scan's eager dispatch
    want_out = np.asarray(jax.jit(jax_model)(_jax_tree(params), jnp.asarray(x)))
    want_loss, (want_grads, want_dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        _jax_tree(params), jnp.asarray(x))

    model = SequenceModel(**kwargs)
    assert hasattr(model, "fc_output_layer") == bool(out_dim)
    # strict: the reference keys, no head for out_dim 0
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _by_key(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    assert out.shape == (b, out_width, t)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL)
    got_loss = torch.sum(out * torch.from_numpy(probe))
    got_loss.backward()
    # each output within ATOL: the sum within ATOL of each probe weight
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               atol=ATOL * float(np.abs(probe).sum()), rtol=0)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    _close(got, _by_key(jax.device_get(want_grads)), FP32_GRAD_RTOL)
    _close({"x": xt.grad.numpy()}, {"x": np.asarray(want_dx)}, FP32_GRAD_RTOL)


def _torch_stack(rng, f_in, hidden, out_dim, layers, cell):
    params = _params(rng, f_in, hidden, max(out_dim, 1), layers, cell)
    stack = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in layer.items()}
             for (layer,) in params["rnn"]]
    fc = None
    if out_dim:
        fc = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params["fc"].items()}
    return stack, fc


def _leaves(stack, fc):
    return [v for layer in stack for v in layer.values()] + ([] if fc is None
                                                             else list(fc.values()))


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("out_dim", [0, 5])
def test_padded_stack_is_exact(cell, out_dim):
    """``pad_stack`` to the walks' width (257 -> 272): the padded stack's real
    units and head equal the unpadded stack's, forward and through
    ``RnnScanFunction`` (the plain stages on the CPU) the gradients of every
    weight, which reach the real entries only."""
    t, n, f_in, hidden, layers = 6, 4, 9, 257, 2
    width = ops.padded_hidden(hidden)
    assert width == 272 and ops.padded_hidden(384) == 384 and ops.padded_hidden(320) == 320
    rng = np.random.default_rng(out_dim)
    stack, fc = _torch_stack(rng, f_in, hidden, out_dim, layers, cell)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    padded, pfc = ops.pad_stack(stack, fc, width)
    assert padded[1]["w_ih"].shape == padded[1]["w_hh"].shape == (ops._GATES[cell.lower()] * width,
                                                                  width)
    assert padded[0]["w_ih"].shape[1] == f_in

    want = ops.fused_subband_lstm(x, *stack, fc)
    got = ops.fused_subband_lstm(x, *padded, pfc)
    assert got.shape == (t, n, out_dim or width)
    np.testing.assert_allclose(got[..., : out_dim or hidden].detach().numpy(),
                               want.detach().numpy(), atol=1e-6)
    if not out_dim:
        assert torch.count_nonzero(got[..., hidden:]) == 0  # padded units stay 0

    probe = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    leaves = _leaves(stack, fc)
    want_grads = torch.autograd.grad(torch.sum(want * probe), leaves)
    got_grads = torch.autograd.grad(torch.sum(got[..., : out_dim or hidden] * probe), leaves)
    for g, w in zip(got_grads, want_grads):
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * scale, rtol=0)


def test_padded_copies_are_built_once_per_weight_version():
    """The inference forward pads a stack's weights once per version of
    them: the same copies while no weight changes, new ones after an
    in-place update (an optimizer step, ``load_state_dict``)."""
    stack, fc = _torch_stack(np.random.default_rng(7), 6, 257, 3, 1, "LSTM")
    with torch.no_grad():
        first = ops._cached_pad(stack, fc, 272)
        assert ops._cached_pad(stack, fc, 272) is first
        stack[0]["w_hh"].add_(1.0)
        second = ops._cached_pad(stack, fc, 272)
    assert second is not first
    np.testing.assert_array_equal(second[0][0]["w_hh"][:257, :257].numpy(),
                                  stack[0]["w_hh"][:257].detach().numpy())


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("f_in", [31, 12, 257])
def test_padded_input_is_exact(cell, f_in):
    """``pad_input`` to the tensor-core GEMM's width (31 -> 32, 12 -> 16,
    257 -> 264): the same output and, through ``RnnScanFunction`` at bf16
    storage (the plain stages on the CPU), the same gradients of x and
    every weight, the padded entries' dropped."""
    t, n, hidden = 5, 3, 16
    rng = np.random.default_rng(f_in)
    stack, fc = _torch_stack(rng, f_in, hidden, 2, 2, cell)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    x = x.to(torch.bfloat16).requires_grad_(True)
    xp, padded = ops.pad_input(x, stack, ops.TC_INPUT_MULTIPLE)
    assert xp.shape[2] == padded[0]["w_ih"].shape[1] == -(-f_in // 8) * 8
    assert padded[1] is stack[1]
    want = ops.fused_subband_lstm(x, *stack, fc)
    got = ops.fused_subband_lstm(xp, *padded, fc)
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())
    probe = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    leaves = [x, *_leaves(stack, fc)]
    want_grads = torch.autograd.grad(torch.sum(want * probe), leaves)
    got_grads = torch.autograd.grad(torch.sum(got * probe), leaves)
    for g, w in zip(got_grads, want_grads):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.float().numpy(), w.float().numpy())


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_headless_inference_stages(cell):
    """``plain_fused_forward`` (the stages the card composes, plain) with no
    head: the top layer's h, in one pass and in chunks of 2 steps, equal to
    the plain stacked forward."""
    t, n, f_in, hidden = 7, 5, 6, 16
    stack, _ = _torch_stack(np.random.default_rng(1), f_in, hidden, 0, 2, cell)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((t, n, f_in)).astype(np.float32))
    with torch.no_grad():
        plain = (ops.plain_fused_subband_lstm if cell == "LSTM" else ops.plain_fused_subband_gru)
        want = plain(x, stack, None)
        assert want.shape == (t, n, hidden)
        for chunk in (None, 2):
            got = ops.plain_fused_forward(x, stack, None, chunk=chunk)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_headless_training_forward_and_backward(cell, dtype):
    """``RnnScanFunction`` on a head-less stack: the training stages with no
    head GEMM return the top layer's h stash in fp32, and the backward takes
    the incoming gradient, cast to the storage type, as the top layer's dh:
    equal to autograd of the plain stacked forward on the same stored
    values (fp32; at bf16 within the rounding of the stashes and dgates)."""
    t, n, f_in, hidden, layers = 5, 4, 6, 16, 2
    rng = np.random.default_rng(3)
    stack, _ = _torch_stack(rng, f_in, hidden, 0, layers, cell)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(dtype)
    probe = torch.from_numpy(rng.standard_normal((t, n, hidden)).astype(np.float32))
    stored = [{k: v.detach().to(dtype).float().requires_grad_(True) for k, v in l.items()}
              for l in stack]
    xs = x.float().requires_grad_(True)
    ref_out = (ops.plain_fused_subband_lstm if cell == "LSTM" else ops.plain_fused_subband_gru)(
        xs, stored, None)
    ref = torch.autograd.grad(torch.sum(ref_out * probe), [xs, *_leaves(stored, None)])

    xg = x.clone().requires_grad_(True)
    out = ops.RnnScanFunction.apply(xg, layers, *_leaves(stack, None))
    assert out.dtype == torch.float32 and out.shape == (t, n, hidden)
    got = torch.autograd.grad(torch.sum(out * probe), [xg, *_leaves(stack, None)])
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(out.detach().numpy(), ref_out.detach().numpy(), atol=tol)
    for g, w in zip(got, ref):
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=tol * scale, rtol=0)
