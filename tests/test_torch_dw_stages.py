"""The layer backward's dW stage (K3's and K4's weight gradients, the
split-K GEMM of ``csrc/rnn_dw.cu``) through its plain version on the CPU:
``plain_dw_gemm`` composed as ``RnnScanFunction`` composes it
(``weight_grads`` over the cotangent streams of the plain layer backward)
against the JAX package's ``_pallas_layer_bwd`` in interpret mode with
``split_dw=False``, the form whose kernel body sums the weight gradients
itself; the split of K into slices summed in order against one pass; the
pick of the slices at the flagship shapes; the wrapper's refusal of CPU
tensors; and no dW launch on the CPU training path. The kernel itself runs
only on a card: tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops.subband_lstm import _pallas_layer_bwd
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32: both sides sum the same fp32 products in another order
F32_RTOL_OF_MAX = 1e-6
# bf16: the plain walk and the Pallas kernel round each cotangent to bf16
# at the same point, from fp32 values summed in another order, so one may
# land a bf16 step (2^-8 of itself) away; a dW entry sums such products
BF16_RTOL_OF_MAX = 2.0**-8

GATES = {"lstm": 4, "gru": 3}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layer_args(rng, cell, t, n, f_in, hidden, dtype):
    """One layer's backward operands in storage type ``dtype`` (stashes from
    the plain forward, non-zero initial states and incoming carries), in the
    order of plain_layer_backward (LSTM) or plain_gru_layer_backward."""
    gh = GATES[cell] * hidden
    bound = 1.0 / np.sqrt(hidden)

    def u(*shape, b=bound):
        return _t(rng.uniform(-b, b, shape).astype(np.float32))

    layer = {"w_ih": u(gh, f_in), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh)}
    ws, bs, _, _ = ops.prep_weights([layer], {"weight": torch.zeros(1, hidden),
                                              "bias": torch.zeros(1)}, dtype)
    x = _t(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(dtype)
    h0, c0 = u(n, hidden, b=0.5).to(dtype), u(n, hidden, b=0.5).to(dtype)
    lstm = cell == "lstm"
    _, hs, *cs = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 1, dtype=dtype),
                                         torch.zeros(1), [h0], [c0] if lstm else None)
    dh = _t(rng.standard_normal((t, n, hidden)).astype(np.float32)).to(dtype)
    wt = ws[0].t().contiguous()
    if lstm:
        return (dh, x, hs[0], cs[0][0], ws[0], wt, bs[0], h0, c0, u(n, hidden, b=0.5),
                u(n, hidden, b=0.5))
    return dh, x, hs[0], ws[0], wt, bs[0], h0, u(n, hidden, b=0.5)


def _jax(v: torch.Tensor):
    """The same stored values as a JAX array of the same type."""
    a = jnp.asarray(v.float().numpy())
    return a.astype(jnp.bfloat16) if v.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("f_in, hidden", [(8, 16), (32, 48)])
def test_plain_dw_stage_matches_fused_pallas(cell, dtype, t, f_in, hidden):
    """dW_ih, dW_hh, db_ih and db_hh of one layer at N = 37 (one row tile
    of 37) from non-zero initial states and incoming carries: the plain
    layer backward's cotangent streams through ``weight_grads`` (on the
    CPU, ``plain_dw_gemm``), against ``_pallas_layer_bwd`` with
    ``split_dw=False``, whose kernel body sums [x | 1]^T · dgates and
    [h_prev | 1]^T · dgates over its row tiles, at the storage type of the
    operands; each held to F32_RTOL_OF_MAX or BF16_RTOL_OF_MAX of its
    largest value."""
    n = 37
    rng = np.random.default_rng(100 * t + f_in)
    args = _layer_args(rng, cell, t, n, f_in, hidden, dtype)
    lstm = cell == "lstm"
    if lstm:
        dh, x, hs, cs, w, _, b, h0, c0, dh_in, dc_in = args
        _, dg, _, _ = ops.plain_layer_backward(*args)
        got = ops.weight_grads(x, hs, h0, dg)
    else:
        dh, x, hs, w, _, b, h0, dh_in = args
        _, dxw, dhw, _ = ops.plain_gru_layer_backward(*args)
        got = ops.weight_grads(x, hs, h0, dxw, dhw)
    want = _pallas_layer_bwd(
        _jax(dh), _jax(x), _jax(hs), _jax(cs) if lstm else None, _jax(w),
        jnp.asarray(b.numpy()).reshape(-1, w.shape[1]), h0=_jax(h0),
        c0=_jax(c0) if lstm else None, dh_init=jnp.asarray(dh_in.numpy()),
        dc_init=jnp.asarray(dc_in.numpy()) if lstm else None, hidden=hidden, cell=cell,
        row_tile=n, interpret=True, x_feature_major=False, split_dw=False,
    )
    rtol = F32_RTOL_OF_MAX if dtype == torch.float32 else BF16_RTOL_OF_MAX
    gh = GATES[cell] * hidden
    for name, g, w_, shape in zip(("dW_ih", "dW_hh", "db_ih", "db_hh"), got, want[1:5],
                                  ((f_in, gh), (hidden, gh), (gh,), (gh,))):
        w_ = np.asarray(w_)
        assert g.dtype == torch.float32 and tuple(g.shape) == shape == w_.shape, name
        np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=rtol * np.abs(w_).max(),
                                   err_msg=name)
    if not lstm:  # the GRU's two bias gradients stay apart
        assert not torch.allclose(got[2], got[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("problem", ["lstm", "gru x", "gru h"])
@pytest.mark.parametrize("k, splits", [(185, 3), (1073, 5), (999, 64)])
def test_split_k_matches_single_pass(dtype, problem, k, splits):
    """The split-K composition the kernel runs (K cut by dw_slice_rows into
    slices of whole 32-row tiles, the last one shorter, their products
    summed in slice order) against one pass over K, for each problem shape
    (the LSTM's [x | h_prev | 1], the GRU's [x | 1] and [h_prev | 1]):
    fp32 sums of the same products in another order, F32_RTOL_OF_MAX of
    the largest value. 64 slices of 999 rows leave 32 of 32 rows."""
    rng = np.random.default_rng(k + splits)
    shift, f_in, hidden, ncols = 37, 20, 24, 72

    def draw(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    b = draw(k, ncols)
    kwargs = {}
    if problem != "gru h":
        kwargs["a"] = draw(k, f_in)
    if problem != "gru x":
        kwargs.update(prev=draw(k, hidden), head=draw(shift, hidden))
    rows = ops.dw_slice_rows(k, splits)
    slices = -(-k // rows)
    assert rows % ops.DW_SLICE_GRAIN == 0 and (slices - 1) * rows < k <= slices * rows
    assert k % rows != 0  # the last slice is shorter
    kwargs.setdefault("a", None)
    got = ops.plain_dw_gemm(b=b, splits=splits, **kwargs)
    want = ops.plain_dw_gemm(b=b, **kwargs)
    m = (f_in if problem != "gru h" else 0) + (hidden if problem != "gru x" else 0) + 1
    assert got.shape == want.shape == (m, ncols) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_RTOL_OF_MAX * float(want.abs().max()))
    # the last row is the column sums of b, the first columns' rows a's
    np.testing.assert_allclose(want[-1].numpy(), b.float().sum(0).numpy(), rtol=0,
                               atol=F32_RTOL_OF_MAX * float(want[-1].abs().max()))


@pytest.mark.parametrize("m, ncols, k", [
    (417, 1536, 798_720),  # sub-band LSTM layer 1, B = 32 x 3.072 s
    (769, 1536, 798_720),  # sub-band LSTM layer 2
    (33, 1152, 798_720),   # sub-band GRU layer 1, [x | 1]
    (1025, 2048, 6_240),   # full-band LSTM layer 2
    (770, 2048, 6_240),    # full-band LSTM layer 1 (F = 257)
    (513, 1536, 124),      # a short K: one slice
])
def test_dw_split_pick(m, ncols, k):
    """pick_dw_splits on a card of 132 SMs: no slice empty, every slice
    at least DW_MIN_SLICE_TILES tiles where K has them, and the CTAs (two
    an SM, over the tiles of C's rows but the bias row) in about DW_WAVES
    waves where K allows as many slices."""
    sms = 132
    splits = ops.pick_dw_splits(m, ncols, k, sms)
    rows = ops.dw_slice_rows(k, splits)
    assert splits >= 1 and -(-k // rows) == splits and (splits - 1) * rows < k
    k_tiles = -(-k // ops.DW_SLICE_GRAIN)
    if splits > 1:
        assert rows >= ops.DW_MIN_SLICE_TILES * ops.DW_SLICE_GRAIN
    tiles = -(-(m - 1) // ops.DW_TILE) * -(-ncols // ops.DW_TILE)
    if k_tiles // ops.DW_MIN_SLICE_TILES >= ops.DW_WAVES * 2 * sms // tiles + 1:
        waves = tiles * splits / (2 * sms)
        assert ops.DW_WAVES - 1 < waves < ops.DW_WAVES + 1
    assert ops.pick_dw_splits(m, ncols, 124, sms) == 1


def test_dw_wrapper_refuses_cpu_tensors():
    """No fallback inside the wrapper: a CPU tensor is an error there."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ops.dw_gemm(torch.zeros(40, 8, dtype=dtype), torch.zeros(40, 32, dtype=dtype),
                        prev=torch.zeros(40, 8, dtype=dtype), head=torch.zeros(5, 8, dtype=dtype))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cpu_training_makes_no_dw_launch(cell):
    """The differentiable op's backward on the CPU takes the dW stage's
    plain version: every weight gets a gradient, and the wrapper counts no
    launch."""
    rng = np.random.default_rng(3)
    gh, f_in, hidden = GATES[cell] * 8, 4, 8
    stack = [{k: _t(rng.uniform(-0.3, 0.3, shape).astype(np.float32)).requires_grad_()
              for k, shape in (("w_ih", (gh, f_in)), ("w_hh", (gh, hidden)), ("b_ih", (gh,)),
                               ("b_hh", (gh,)))}]
    head = {"weight": _t(rng.uniform(-0.3, 0.3, (2, hidden)).astype(np.float32)),
            "bias": torch.zeros(2)}
    x = _t(rng.standard_normal((5, 3, f_in)).astype(np.float32))
    ops.dw_gemm.reset_counts()
    ops.fused_subband_lstm(x, *stack, head).square().sum().backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all())
               for v in stack[0].values())
    assert ops.dw_gemm.launches == 0 and not ops.dw_gemm.launches_by_shape
