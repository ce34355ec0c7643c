"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: K1 (the LSTM-scan inference forward), K2 (the training forward
with state stashes) and K3 (one layer's backward), and the gradients of
the differentiable op that joins K2 and K3. Every test here carries the
``cuda`` marker and skips without a card; the file imports no JAX, so a
machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py -q

(tests/conftest.py configures JAX, hence ``--noconftest``).
"""

import numpy as np
import pytest
import torch

from fullsubnet_tpu_torch.models import FullSubNet
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# fp32 kernel vs fp32 plain PyTorch: only the order of the sums differs
ATOL = 1e-5
# bf16 storage: the kernel and the plain version round h, c and the gate
# cotangents to bf16 at the same points, but a different order of the
# fp32 sums can move a value across a rounding boundary (one bf16 step is
# 2^-8 relative), and that step then travels through the recurrence
BF16_ATOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stack(rng, f_in, hidden, out_dim, num_layers, device):
    b = 1.0 / np.sqrt(hidden)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).to(device)

    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({
            "w_ih": u(4 * hidden, in_dim), "w_hh": u(4 * hidden, hidden),
            "b_ih": u(4 * hidden), "b_hh": u(4 * hidden),
        })
        in_dim = hidden
    return layers, {"weight": u(out_dim, hidden), "bias": u(out_dim)}


def _close(got, want, dtype):
    atol = ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol)


@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("num_layers, hidden", [(1, 48), (2, 40), (3, 64)])
def test_kernel_matches_plain(cuda, rows_per_block, num_layers, hidden):
    """N = 37 leaves a ragged last block at every tile size; H = 40 and 48
    are not multiples of the warp width."""
    t, n, f_in, out_dim = 23, 37, 20, 5
    rng = np.random.default_rng(hidden)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cuda)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(cuda)
    before = ops.lstm_scan.launches
    with torch.no_grad():
        got = ops.fused_subband_lstm(x, *layers, fc, rows_per_block=rows_per_block)
        torch.cuda.synchronize()
        want = ops.plain_fused_subband_lstm(x, layers, fc)
    assert ops.lstm_scan.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)


def test_feature_major_layout(cuda):
    rng = np.random.default_rng(7)
    layers, fc = _stack(rng, 12, 32, 2, 2, cuda)
    x = torch.from_numpy(rng.standard_normal((9, 21, 12)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        a = ops.fused_subband_lstm(x, *layers, fc)
        b = ops.fused_subband_lstm(x.transpose(1, 2).contiguous(), *layers, fc,
                                   time_major_features=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_both_fullsubnet_stages_launch_the_kernel(cuda):
    model = FullSubNet(num_freqs=65, sb_num_neighbors=3, fb_model_hidden_size=48,
                       sb_model_hidden_size=32)
    mag = torch.from_numpy(
        np.abs(np.random.default_rng(8).standard_normal((2, 1, 65, 30))).astype(np.float32))
    with torch.inference_mode():
        want = model(mag)
        ops.lstm_scan.reset_counts()
        got = model.to(cuda)(mag.to(cuda)).cpu()
    assert ops.lstm_scan.launches == 2
    assert dict(ops.lstm_scan.launches_by_shape) == {(65, 48, 65): 1, (8, 32, 2): 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def _train_operands(rng, t, n, f_in, hidden, out_dim, num_layers, dtype, device):
    """K2's operands with non-zero initial states, in storage type ``dtype``."""
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, device)
    ws, bs, wfc, bfc = ops.prep_weights(layers, fc, dtype)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(device)

    def state():
        return torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(device)

    h0s = [state().to(dtype) for _ in range(num_layers)]
    c0s = [state().to(dtype) for _ in range(num_layers)]
    return x.to(dtype), ws, bs, wfc, bfc, h0s, c0s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("num_layers, hidden", [(1, 48), (2, 40), (3, 64)])
def test_stash_forward_matches_plain(cuda, dtype, rows_per_block, num_layers, hidden):
    """K2: the head output and every layer's h and c stash."""
    rng = np.random.default_rng(100 + hidden)
    args = _train_operands(rng, 19, 37, 20, hidden, 5, num_layers, dtype, cuda)
    before = ops.stash_fwd.launches
    out, hs, cs = ops.stash_fwd(*args, rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    want_out, want_hs, want_cs = ops.plain_stash_forward(*args)
    assert ops.stash_fwd.launches == before + 1
    assert out.dtype == torch.float32 and all(s.dtype == dtype for s in [*hs, *cs])
    _close(out, want_out, dtype)
    for got, want in zip([*hs, *cs], [*want_hs, *want_cs]):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("f_in, hidden", [(20, 40), (64, 48)])
def test_layer_backward_matches_plain(cuda, dtype, rows_per_block, f_in, hidden):
    """K3 from non-zero initial states and incoming carries: dx, the
    dgates stream and the carries into the initial state."""
    t, n = 17, 37
    rng = np.random.default_rng(200 + hidden)
    x, ws, bs, _, _, h0s, c0s = _train_operands(rng, t, n, f_in, hidden, 3, 1, dtype, cuda)
    _, hs, cs = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 3, device=cuda,
                                        dtype=dtype), torch.zeros(3, device=cuda), h0s, c0s)
    dh = torch.from_numpy(rng.standard_normal((t, n, hidden)).astype(np.float32)).to(cuda)
    carries = [torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(cuda)
               for _ in range(2)]
    args = (dh.to(dtype), x, hs[0], cs[0], ws[0], ws[0].t().contiguous(), bs[0], h0s[0],
            c0s[0], *carries)
    before = ops.layer_bwd.launches
    got = ops.layer_bwd(*args, rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    want = ops.plain_layer_backward(*args)
    assert ops.layer_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_match_plain(cuda, dtype):
    """The differentiable op on the card (K2 + K3) against the same op on
    the CPU (their plain versions): the loss, and the gradients of x and
    of every weight. N = 13 and T = 11 are ragged against every tile."""
    t, n, f_in, hidden, out_dim = 11, 13, 8, 48, 3
    rng = np.random.default_rng(5)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, torch.device("cpu"))
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((t, n, out_dim)).astype(np.float32))

    def loss_and_grads(device):
        params = [v.to(device, dtype).requires_grad_()
                  for l in layers for v in l.values()]
        head = [fc["weight"].to(device, dtype).requires_grad_(),
                fc["bias"].to(device, dtype).requires_grad_()]
        xd = x.to(device, dtype).requires_grad_()
        stack = [dict(zip(layers[0], params[4 * k : 4 * k + 4])) for k in range(2)]
        out = ops.fused_subband_lstm(xd, *stack, dict(zip(("weight", "bias"), head)))
        loss = torch.mean((out - target.to(device)) ** 2)
        return loss, torch.autograd.grad(loss, [xd, *params, *head])

    ops.stash_fwd.reset_counts()
    ops.layer_bwd.reset_counts()
    ops.lstm_scan.reset_counts()
    loss, grads = loss_and_grads(cuda)
    torch.cuda.synchronize()
    assert (ops.stash_fwd.launches, ops.layer_bwd.launches, ops.lstm_scan.launches) == (1, 2, 0)
    want_loss, want_grads = loss_and_grads(torch.device("cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()), rtol=1e-5 if dtype == torch.float32
                               else 1e-2)
    for got, want in zip(grads, want_grads):
        assert got.dtype == dtype and got.shape == want.shape
        # gradients are about 1e-2 here; bf16 is held to 2% of the largest
        atol = ATOL if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=atol)


def test_kernel_dtype_rules(cuda):
    """K1 takes fp32 only; K2 and K3 take fp32 and bf16 storage."""
    rng = np.random.default_rng(4)
    layers, fc = _stack(rng, 4, 8, 2, 2, cuda)
    with torch.no_grad(), pytest.raises(TypeError, match="float32"):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.bfloat16),
                               *layers, fc)
    for dtype in (torch.float32, torch.bfloat16):
        args = _train_operands(rng, 5, 3, 4, 8, 2, 2, dtype, cuda)
        out, hs, _ = ops.stash_fwd(*args)
        assert out.dtype == torch.float32 and hs[0].dtype == dtype
    args = _train_operands(rng, 5, 3, 4, 8, 2, 2, torch.float16, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.stash_fwd(*args)
    mixed = list(_train_operands(rng, 5, 3, 4, 8, 2, 2, torch.bfloat16, cuda))
    mixed[1] = [w.float() for w in mixed[1]]
    with pytest.raises(TypeError, match="w0"):
        ops.stash_fwd(*mixed)
