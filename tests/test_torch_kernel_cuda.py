"""The hand-written CUDA LSTM-scan kernel against its plain PyTorch
version, on the card. Every test here carries the ``cuda`` marker and
skips without a card; the file imports no JAX, so a machine without JAX
runs it with

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


def test_kernel_refuses_autograd(cuda):
    rng = np.random.default_rng(3)
    layers, fc = _stack(rng, 4, 8, 2, 2, cuda)
    layers[0]["w_ih"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda), *layers, fc)


def test_kernel_refuses_other_dtypes(cuda):
    rng = np.random.default_rng(4)
    layers, fc = _stack(rng, 4, 8, 2, 2, cuda)
    with torch.no_grad(), pytest.raises(TypeError, match="float32"):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.bfloat16),
                               *layers, fc)
