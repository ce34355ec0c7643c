"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: K1 and K1-GRU (the inference forwards: the GEMM and cluster walk
stages of the main path, and the kernels of the earlier design), K2 and
K2-GRU (the training forwards with state stashes: at fp32 the GEMM and the
cluster walk with its c stream or the streaming walk, and the fp32 kernels
of the earlier design; at bf16 the tensor-core GEMM and training walks), K3
and K4 (one layer's backward: the fp32 GEMM and walks, the fp32 kernels of
the earlier design, at bf16 the tensor-core GEMM and walks, and at either
type the dW stage: the persistent TMA-fed GEMM on the path and the split-K
GEMM of the earlier design),
and the gradients of the differentiable op that joins a training forward
and a layer backward. Every test here carries the
``cuda`` marker and skips without a card; the file imports no JAX, so a
machine without JAX runs it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py -q

(tests/conftest.py configures JAX, hence ``--noconftest``).
"""

import numpy as np
import pytest
import torch

from fullsubnet_tpu_torch.models import FullSubNet
from fullsubnet_tpu_torch.nn.rnn import gru_forward
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


def _stack(rng, f_in, hidden, out_dim, num_layers, device, cell="lstm"):
    b = 1.0 / np.sqrt(hidden)
    gh = (4 if cell == "lstm" else 3) * hidden

    def u(*shape):
        return torch.from_numpy(rng.uniform(-b, b, shape).astype(np.float32)).to(device)

    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({
            "w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh),
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
        got = ops.lstm_scan(x, layers, fc, rows_per_block=rows_per_block)
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


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_both_fullsubnet_stages_launch_the_kernel(cuda, cell):
    model = FullSubNet(num_freqs=65, sb_num_neighbors=3, fb_model_hidden_size=48,
                       sb_model_hidden_size=32, sequence_model=cell)
    mag = torch.from_numpy(
        np.abs(np.random.default_rng(8).standard_normal((2, 1, 65, 30))).astype(np.float32))
    walk, other = ((ops.lstm_fwd_walk, ops.gru_fwd_walk) if cell == "LSTM"
                   else (ops.gru_fwd_walk, ops.lstm_fwd_walk))
    kernels = (ops.fwd_gemm, walk, other, ops.lstm_scan, ops.gru_scan)
    g = 4 if cell == "LSTM" else 3
    with torch.inference_mode():
        want = model(mag)
        for kernel in kernels:
            kernel.reset_counts()
        got = model.to(cuda)(mag.to(cuda)).cpu()
    # the stages of K1 / K1-GRU only: per stage a GEMM for each layer's
    # input projection and for the head, a walk for each layer
    assert [kernel.launches for kernel in kernels] == [6, 4, 0, 0, 0]
    assert dict(ops.fwd_gemm.launches_by_shape) == {
        (65, g * 48): 1, (48, g * 48): 1, (48, 65): 1, (8, g * 32): 1, (32, g * 32): 1,
        (32, 2): 1}
    assert dict(walk.launches_by_shape) == {(2, 48): 2, (2 * 65, 32): 2}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("form", ["fp32", "bf16", "bucketed"])
def test_parallel_enhancer_matches_the_one_card_path(cuda, form):
    """The multi-card enhancer (``parallel/inference.py``) on a mesh of every
    visible card, or of the one card twice, against the one-card path (the
    model with ``full_band_crm_mask`` or ``bucketed_enhance``) on the same
    batch; K1's (K1-bf16's) GEMM launches split by card as the slices run."""
    from fullsubnet_tpu_torch.infer.inferencer import bucketed_enhance, full_band_crm_mask
    from fullsubnet_tpu_torch.parallel import make_mesh
    from fullsubnet_tpu_torch.parallel.inference import make_parallel_enhancer

    model = FullSubNet(num_freqs=65, sb_num_neighbors=3, fb_model_hidden_size=48,
                       sb_model_hidden_size=32).eval()
    state = model.state_dict()
    acoustics = {"n_fft": 128, "hop_length": 64, "win_length": 128}
    cards = torch.cuda.device_count()
    devices = list(range(cards)) if cards > 1 else [0, 0]
    rng = np.random.default_rng(9)
    noisy = torch.from_numpy(rng.standard_normal((2 * len(devices), 2000)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(800, 1900, noisy.shape[0]))
    kwargs = {"bf16": {"compute_dtype": torch.bfloat16}, "bucketed": {"bucketed": True}}
    fn = make_parallel_enhancer(model, make_mesh(devices=[f"cuda:{i}" for i in devices]),
                                **acoustics, **kwargs.get(form, {}))
    args = (noisy, lengths) if form == "bucketed" else (noisy,)
    gemm = ops.tc_gemm if form == "bf16" else ops.fwd_gemm
    gemm.reset_counts()
    got = fn(state, *args)
    by_card = dict(gemm.launches_by_device)
    one = model.to(cuda)
    with torch.inference_mode():
        if form == "bucketed":
            want = bucketed_enhance(one, acoustics, noisy.to(cuda), lengths.to(cuda))
        else:
            want = full_band_crm_mask(one, acoustics, noisy.to(cuda),
                                      torch.bfloat16 if form == "bf16" else None)
    assert got.device == want.device and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)
    slices = {i: devices.count(i) for i in set(devices)}
    assert by_card == {i: 6 * k for i, k in slices.items()}


def _train_operands(rng, t, n, f_in, hidden, out_dim, num_layers, dtype, device, cell="lstm"):
    """K2's (K2-GRU's) operands with non-zero initial states, in storage
    type ``dtype``; the GRU's have no c0s."""
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, device, cell)
    ws, bs, wfc, bfc = ops.prep_weights(layers, fc, dtype)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(device)

    def state():
        return torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(device)

    h0s = [state().to(dtype) for _ in range(num_layers)]
    if cell == "gru":
        return x.to(dtype), ws, bs, wfc, bfc, h0s
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


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_match_plain(cuda, dtype, cell):
    """The differentiable op on the card (K2 + K3, or K2-GRU + K4) against
    the same op on the CPU (their plain versions): the loss, and the
    gradients of x and of every weight. N = 13 and T = 11 are ragged
    against every tile."""
    t, n, f_in, hidden, out_dim = 11, 13, 8, 48, 3
    rng = np.random.default_rng(5)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, torch.device("cpu"), cell)
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

    kernels = (ops.stash_fwd, ops.layer_bwd, ops.lstm_scan, ops.gru_stash_fwd,
               ops.gru_layer_bwd, ops.gru_scan, ops.tc_gemm, ops.lstm_walk, ops.gru_walk,
               ops.lstm_train_walk, ops.gru_train_walk, ops.fwd_gemm, ops.lstm_walk_f32,
               ops.gru_walk_f32, ops.lstm_train_walk_f32, ops.gru_train_walk_f32, ops.dw_tma,
               ops.dw_gemm)
    for kernel in kernels:
        kernel.reset_counts()
    loss, grads = loss_and_grads(cuda)
    torch.cuda.synchronize()
    # fp32 storage takes the fp32 training forward's stages (a GEMM and a
    # walk per layer and the head's GEMM) and the fp32 layer backward's
    # stages (2 GEMMs and a walk per layer), never the earlier fp32 kernels;
    # bf16 the tensor-core stages: forward a GEMM and a walk per layer and
    # the head's GEMM, backward 2 GEMMs and a walk per layer; at either the
    # dW stage (dw_tma; the earlier dw_gemm none), one GEMM per LSTM layer
    # and two per GRU layer
    want_launches = {
        ("lstm", torch.float32): (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7, 2, 0, 2, 0, 2, 0),
        ("gru", torch.float32): (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 7, 0, 2, 0, 2, 4, 0),
        ("lstm", torch.bfloat16): (0, 0, 0, 0, 0, 0, 7, 2, 0, 2, 0, 0, 0, 0, 0, 0, 2, 0),
        ("gru", torch.bfloat16): (0, 0, 0, 0, 0, 0, 7, 0, 2, 0, 2, 0, 0, 0, 0, 0, 4, 0),
    }[cell, dtype]
    assert tuple(kernel.launches for kernel in kernels) == want_launches
    want_loss, want_grads = loss_and_grads(torch.device("cpu"))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()), rtol=1e-5 if dtype == torch.float32
                               else 1e-2)
    for got, want in zip(grads, want_grads):
        assert got.dtype == dtype and got.shape == want.shape
        # gradients are about 1e-2 here; bf16 is held to 2% of the largest
        atol = ATOL if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=atol)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_gradients_match_unchunked(cuda, dtype, cell):
    """The time-chunked stash on the card (``time_chunk`` = 8 over T = 29:
    chunks of 8, 8, 8 and 5 steps): K1's stages forward chunk by chunk (K1-bf16
    at bf16), then per chunk K2 re-run from its boundary states, K3/K4 with
    the carries chained and the dW stage. The loss equals the unchunked op's
    on the card (the forward is one pass either way, K1's stages against
    K2's), and the gradients match it and the chunked op on the CPU (its
    plain versions); the launches are the chunks' count times a chunk's."""
    t, n, f_in, hidden, out_dim = 29, 13, 8, 48, 3
    rng = np.random.default_rng(6)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, torch.device("cpu"), cell)
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((t, n, out_dim)).astype(np.float32))

    def loss_and_grads(device, time_chunk):
        params = [v.to(device, dtype).requires_grad_() for l in layers for v in l.values()]
        head = [fc["weight"].to(device, dtype).requires_grad_(),
                fc["bias"].to(device, dtype).requires_grad_()]
        xd = x.to(device, dtype).requires_grad_()
        stack = [dict(zip(layers[0], params[4 * k : 4 * k + 4])) for k in range(2)]
        out = ops.fused_subband_lstm(xd, *stack, dict(zip(("weight", "bias"), head)),
                                     time_chunk=time_chunk)
        loss = torch.mean((out - target.to(device)) ** 2)
        return loss, torch.autograd.grad(loss, [xd, *params, *head])

    bf16 = dtype == torch.bfloat16
    kernels = {
        "gemm": ops.tc_gemm if bf16 else ops.fwd_gemm,
        "fwd_walk": {("lstm", True): ops.lstm_fwd_walk_bf16, ("lstm", False): ops.lstm_fwd_walk,
                     ("gru", True): ops.gru_fwd_walk_bf16, ("gru", False): ops.gru_fwd_walk}[
                         cell, bf16],
        "train_walk": {("lstm", True): ops.lstm_train_walk, ("gru", True): ops.gru_train_walk,
                       ("lstm", False): ops.lstm_train_walk_f32,
                       ("gru", False): ops.gru_train_walk_f32}[cell, bf16],
        "walk": {("lstm", True): ops.lstm_walk, ("gru", True): ops.gru_walk,
                 ("lstm", False): ops.lstm_walk_f32, ("gru", False): ops.gru_walk_f32}[
                     cell, bf16],
        "dw": ops.dw_tma,
    }
    for kernel in kernels.values():
        kernel.reset_counts()
    loss, grads = loss_and_grads(cuda, 8)
    torch.cuda.synchronize()
    # 4 chunks, each: K1's 3 GEMMs and 2 walks forward; K2's 3 GEMMs and 2
    # walks re-run, 2 GEMMs and a walk a layer back, the dW stage a layer
    dw = 2 if cell == "lstm" else 4
    assert {k: v.launches for k, v in kernels.items()} == {
        "gemm": 4 * 10, "fwd_walk": 4 * 2, "train_walk": 4 * 2, "walk": 4 * 2, "dw": 4 * dw}
    full_loss, full_grads = loss_and_grads(cuda, 0)
    cpu_loss, cpu_grads = loss_and_grads(torch.device("cpu"), 8)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(float(loss.detach()), float(full_loss.detach()), rtol=rtol)
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=rtol)
    for got, full, want in zip(grads, full_grads, cpu_grads):
        assert got.dtype == dtype and got.shape == want.shape
        # as test_gradients_match_plain: bf16 held to 2% of the largest
        atol = ATOL if dtype == torch.float32 else 2e-2 * float(want.float().abs().max())
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=atol)
        np.testing.assert_allclose(got.float().cpu().numpy(), full.float().cpu().numpy(),
                                   atol=atol)


def test_kernel_dtype_rules(cuda):
    """K1 takes fp32 and, as K1-bf16, bf16 (an fp32 output either way) and
    raises on another type; K2 and K3 take fp32 and bf16 storage."""
    rng = np.random.default_rng(4)
    layers, fc = _stack(rng, 4, 8, 2, 2, cuda)
    with torch.no_grad():
        out = ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.bfloat16),
                                     *layers, fc)
        assert out.dtype == torch.float32 and out.shape == (5, 3, 2)
    with torch.no_grad(), pytest.raises(TypeError, match="float32"):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.float16),
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


# ---------------------------------------------------------------------------
# the GRU kernels: K1-GRU, K2-GRU, K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("num_layers, hidden", [(2, 40), (3, 64)])
def test_gru_kernel_matches_plain(cuda, rows_per_block, num_layers, hidden):
    """K1-GRU (fp32). N = 37 leaves a ragged last block at every tile
    size; H = 40 is not a multiple of the warp width."""
    t, n, f_in, out_dim = 23, 37, 20, 5
    rng = np.random.default_rng(300 + hidden)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cuda, "gru")
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(cuda)
    ops.gru_scan.reset_counts()
    ops.lstm_scan.reset_counts()
    with torch.no_grad():
        got = ops.gru_scan(x, layers, fc, rows_per_block=rows_per_block)
        torch.cuda.synchronize()
        want = ops.plain_fused_subband_gru(x, layers, fc)
    assert (ops.gru_scan.launches, ops.lstm_scan.launches) == (1, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("num_layers, hidden", [(2, 40), (3, 64)])
def test_gru_stash_forward_matches_plain(cuda, dtype, rows_per_block, num_layers, hidden):
    """K2-GRU: the head output and every layer's h stash, from non-zero
    initial states."""
    rng = np.random.default_rng(400 + hidden)
    args = _train_operands(rng, 19, 37, 20, hidden, 5, num_layers, dtype, cuda, "gru")
    before = ops.gru_stash_fwd.launches
    out, hs = ops.gru_stash_fwd(*args, rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    want_out, want_hs = ops.plain_stash_forward(*args)
    assert ops.gru_stash_fwd.launches == before + 1
    assert out.dtype == torch.float32 and all(h.dtype == dtype for h in hs)
    _close(out, want_out, dtype)
    for got, want in zip(hs, want_hs):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_per_block", ops.ROWS_PER_BLOCK)
@pytest.mark.parametrize("f_in, hidden", [(20, 40), (64, 48)])
def test_gru_layer_backward_matches_plain(cuda, dtype, rows_per_block, f_in, hidden):
    """K4 from a non-zero initial state and incoming carry: dx, the dxw
    and dhw streams and the carry into the initial state."""
    t, n = 17, 37
    rng = np.random.default_rng(500 + hidden)
    x, ws, bs, _, _, h0s = _train_operands(rng, t, n, f_in, hidden, 3, 1, dtype, cuda, "gru")
    _, hs = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 3, device=cuda, dtype=dtype),
                                    torch.zeros(3, device=cuda), h0s)
    dh = torch.from_numpy(rng.standard_normal((t, n, hidden)).astype(np.float32)).to(cuda)
    dh_in = torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(cuda)
    args = (dh.to(dtype), x, hs[0], ws[0], ws[0].t().contiguous(), bs[0], h0s[0], dh_in)
    before = ops.gru_layer_bwd.launches
    got = ops.gru_layer_bwd(*args, rows_per_block=rows_per_block)
    torch.cuda.synchronize()
    want = ops.plain_gru_layer_backward(*args)
    assert ops.gru_layer_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, dtype)


def test_gru_gradients_match_plain_autograd(cuda):
    """fp32: the op on the card (K2-GRU + K4) against torch autograd of
    the plain ``gru_forward`` + head, on the card."""
    t, n, f_in, hidden, out_dim = 11, 13, 8, 48, 3
    rng = np.random.default_rng(6)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 3, cuda, "gru")
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).to(cuda)
    target = torch.from_numpy(rng.standard_normal((t, n, out_dim)).astype(np.float32)).to(cuda)

    def loss_and_grads(run):
        stack = [{k: v.clone().requires_grad_() for k, v in l.items()} for l in layers]
        head = {k: v.clone().requires_grad_() for k, v in fc.items()}
        xd = x.clone().requires_grad_()
        loss = torch.mean((run(xd, stack, head) - target) ** 2)
        leaves = [xd, *(v for l in stack for v in l.values()), *head.values()]
        return loss, torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads(lambda xd, s, h: ops.fused_subband_lstm(xd, *s, h))
    want_loss, want_grads = loss_and_grads(
        lambda xd, s, h: gru_forward(s, xd) @ h["weight"].t() + h["bias"])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()), rtol=1e-5)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)


def test_gru_wrappers_refuse_bad_operands(cuda):
    """K1-GRU takes fp32 and, as K1-GRU-bf16, bf16 (an fp32 output either
    way) and raises on another type; K2-GRU and K4 take fp32 and bf16
    storage with fp32 biases and carries; every wrapper checks its shapes,
    and a kernel refuses the other cell's stack."""
    rng = np.random.default_rng(9)
    layers, fc = _stack(rng, 4, 8, 2, 2, cuda, "gru")
    with torch.no_grad():
        out = ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.bfloat16),
                                     *layers, fc)
        assert out.dtype == torch.float32 and out.shape == (5, 3, 2)
    with torch.no_grad(), pytest.raises(TypeError, match="float32"):
        ops.fused_subband_lstm(torch.zeros(5, 3, 4, device=cuda, dtype=torch.float16),
                               *layers, fc)
    x = torch.zeros(5, 3, 4, device=cuda)
    lstm_layers, _ = _stack(rng, 4, 8, 2, 2, cuda)
    with pytest.raises(ValueError, match="GRU stack"):
        ops.gru_scan(x, lstm_layers, fc)
    with pytest.raises(ValueError, match="LSTM stack"):
        ops.lstm_scan(x, layers, fc)

    args = _train_operands(rng, 5, 3, 4, 8, 2, 2, torch.float16, cuda, "gru")
    with pytest.raises(TypeError, match="bfloat16"):
        ops.gru_stash_fwd(*args)
    mixed = list(_train_operands(rng, 5, 3, 4, 8, 2, 2, torch.bfloat16, cuda, "gru"))
    mixed[1] = [w.float() for w in mixed[1]]
    with pytest.raises(TypeError, match="w0"):
        ops.gru_stash_fwd(*mixed)
    fused = list(_train_operands(rng, 5, 3, 4, 8, 2, 2, torch.float32, cuda, "gru"))
    fused[2] = [b.sum(0) for b in fused[2]]  # b_ih + b_hh fused, as an LSTM's
    with pytest.raises(ValueError, match=r"\[2, 3H\]"):
        ops.gru_stash_fwd(*fused)
    short = list(_train_operands(rng, 5, 3, 4, 8, 2, 2, torch.float32, cuda, "gru"))
    short[5] = short[5][:1]
    with pytest.raises(ValueError, match="h0"):
        ops.gru_stash_fwd(*short)

    x, ws, bs, _, _, h0s = _train_operands(rng, 5, 3, 4, 8, 2, 1, torch.bfloat16, cuda, "gru")
    hs = torch.zeros(5, 3, 8, device=cuda, dtype=torch.bfloat16)
    dh_in = torch.zeros(3, 8, device=cuda)
    good = [hs, x, hs, ws[0], ws[0].t().contiguous(), bs[0], h0s[0], dh_in]
    out = ops.gru_layer_bwd(*good)
    assert [v.dtype for v in out] == [torch.bfloat16] * 3 + [torch.float32]
    for index, bad, match in ((7, dh_in.to(torch.bfloat16), "dh_in"),
                              (4, ws[0], "wt"),
                              (5, bs[0][0], "b must"),
                              (1, x.float(), "float32|bfloat16|x")):
        args = list(good)
        args[index] = bad
        with pytest.raises((TypeError, ValueError), match=match):
            ops.gru_layer_bwd(*args)


# ---------------------------------------------------------------------------
# the bf16 layer backward on the tensor cores: tc_gemm, lstm_walk, gru_walk
# ---------------------------------------------------------------------------

# bf16 storage, the kernels against their plain versions: every output
# within this share of its largest magnitude (the smoke's GRAD_RTOL_BF16:
# a dgates value that lands on the other side of a bf16 rounding boundary
# moves the carry, and that step travels through the walk)
BF16_RTOL_OF_MAX = 5e-2


def _bf16(rng, *shape, device, scale=1.0):
    v = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(v).to(device, torch.bfloat16)


def _close_of_max(got, want, rtol, name=""):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    want = want.float()
    atol = rtol * float(want.abs().max())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(), rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m, k0, k1, ncols, extra", [
    (1000, 32, 384, 1536, 8),  # the sub-band recompute's widths: 16-byte loads
    (517, 257, 512, 2048, 0),  # the full-band recompute: an odd K0, element loads
    (300, 1536, 0, 384, 32),   # the sub-band dx: one segment, B a column slice
    (229, 2048, 0, 257, 512),  # the full-band dx: odd Ncols and row stride
    (77, 20, 40, 160, 3),      # ragged M, K and Ncols
])
def test_tc_gemm_matches_plain(cuda, out_dtype, m, k0, k1, ncols, extra):
    """The GEMM of the bf16 layer backward, with the recompute's second K
    segment read one block of rows back (h_{t-1} from the h stash, h0
    first) and a bias, or the dx product's single segment against a
    column slice of W^T. fp32 accumulators on both sides: fp32 output is
    held to 1e-5 of its largest value, bf16 to one rounding step at the
    largest value (2^-7 of it)."""
    rng = np.random.default_rng(m + k0)
    a = _bf16(rng, m, k0, device=cuda)
    b = _bf16(rng, k0 + k1, ncols + extra, device=cuda, scale=0.1)[:, :ncols]
    kwargs = {"out_dtype": out_dtype}
    if k1:
        shift = 37
        kwargs.update(prev=_bf16(rng, m, k1, device=cuda), head=_bf16(rng, shift, k1, device=cuda),
                      bias=torch.from_numpy(rng.standard_normal(ncols).astype(np.float32)).to(cuda))
    before = ops.tc_gemm.launches
    got = ops.tc_gemm(a, b, **kwargs)
    torch.cuda.synchronize()
    want = ops.plain_tc_gemm(a, b, **kwargs)
    assert ops.tc_gemm.launches == before + 1
    _close_of_max(got, want, 1e-5 if out_dtype == torch.float32 else 2.0**-7)


def _layer_operands(rng, cell, t, n, f_in, hidden, device):
    """bf16 operands of one layer's backward, from non-zero initial states
    and incoming carries, the stashes from the plain training forward."""
    bf16 = torch.bfloat16
    ops_in = _train_operands(rng, t, n, f_in, hidden, 3, 1, bf16, device, cell)
    x, ws, bs, _, _, h0s = ops_in[:6]
    zeros_fc = (torch.zeros(hidden, 3, device=device, dtype=bf16), torch.zeros(3, device=device))
    dh = _bf16(rng, t, n, hidden, device=device)
    dh_in = torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(device)
    wt = ws[0].t().contiguous()
    if cell == "gru":
        _, hs = ops.plain_stash_forward(x, ws, bs, *zeros_fc, h0s)
        return (dh, x, hs[0], ws[0], wt, bs[0], h0s[0], dh_in)
    c0s = ops_in[6]
    _, hs, cs = ops.plain_stash_forward(x, ws, bs, *zeros_fc, h0s, c0s)
    dc_in = torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(device)
    return (dh, x, hs[0], cs[0], ws[0], wt, bs[0], h0s[0], c0s[0], dh_in, dc_in)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden", [
    (195, 4099, 32, 384),  # the sub-band training shape, N ragged against every tile
    (195, 33, 257, 512),   # the full-band training shape
    (1, 37, 20, 40),       # one step
    (9, 70, 64, 200),      # two mma tiles of units per warp
])
def test_tc_layer_backward_matches_plain(cuda, cell, t, n, f_in, hidden):
    """K3 and K4 at bf16 through layer_backward / gru_layer_backward on the
    card (the tensor-core GEMM, the walk, the GEMM again) against their
    plain versions: dx, the cotangent streams and the fp32 carries."""
    rng = np.random.default_rng(600 + hidden)
    args = _layer_operands(rng, cell, t, n, f_in, hidden, cuda)
    walk, fp32_kernel = ((ops.lstm_walk, ops.layer_bwd) if cell == "lstm"
                         else (ops.gru_walk, ops.gru_layer_bwd))
    for kernel in (ops.tc_gemm, walk, fp32_kernel):
        kernel.reset_counts()
    backward, plain = ((ops.layer_backward, ops.plain_layer_backward) if cell == "lstm"
                       else (ops.gru_layer_backward, ops.plain_gru_layer_backward))
    got = backward(*args)
    torch.cuda.synchronize()
    assert (ops.tc_gemm.launches, walk.launches, fp32_kernel.launches) == (2, 1, 0)
    want = plain(*args)
    names = ("dx", "dgates", "dh0", "dc0") if cell == "lstm" else ("dx", "dxw", "dhw", "dh0")
    for name, g, w in zip(names, got, want):
        _close_of_max(g, w, BF16_RTOL_OF_MAX, name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("rows_per_block", ops.WALK_ROWS)
@pytest.mark.parametrize("stages", [2, 4])
def test_walk_tiles_match_plain(cuda, cell, rows_per_block, stages):
    """Every row tile and ring depth of the walk on the same pre-activations
    as its plain version, at N = 37 (ragged against every tile) and H = 48
    (padding units in the last warps)."""
    t, n, hidden = 6, 37, 48
    rng = np.random.default_rng(rows_per_block + stages)
    gates = (4 if cell == "lstm" else 3) * hidden
    p = torch.from_numpy(rng.standard_normal((t, n, 4 * hidden)).astype(np.float32)).to(cuda)
    dh, stash = _bf16(rng, t, n, hidden, device=cuda), _bf16(rng, t, n, hidden, device=cuda)
    init = _bf16(rng, n, hidden, device=cuda)
    w_hh_t = _bf16(rng, gates, hidden, device=cuda, scale=hidden**-0.5)
    carries = [torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(cuda)
               for _ in range(2)]
    if cell == "lstm":
        args = (p, dh, stash, init, w_hh_t, *carries)
        kernel, plain = ops.lstm_walk, ops.plain_lstm_walk
    else:
        args = (p, dh, stash, init, w_hh_t, carries[0])
        kernel, plain = ops.gru_walk, ops.plain_gru_walk
    clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = kernel(*args, rows_per_block=rows_per_block, stages=stages, clocks=clocks)
    torch.cuda.synchronize()
    for g, w in zip(got, plain(*args)):
        _close_of_max(g, w, BF16_RTOL_OF_MAX)
    # block 0's cycles: the cell backward and the product; no cluster exchange
    assert clocks[0] > 0 and clocks[1] > 0 and clocks[2] == 0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [256, 512])
@pytest.mark.parametrize("t, n", [(1, 37), (7, 70)])
def test_split_walk_matches_plain(cuda, cell, hidden, t, n):
    """The split walk (clusters of 16 CTAs with W_hh^T resident, partial
    carries reduce-scattered through distributed shared memory) on the same
    pre-activations as the plain walk, and as the streaming walk: N = 37
    and 70 leave a ragged last cluster (two and three clusters)."""
    rng = np.random.default_rng(hidden + n)
    gates = (4 if cell == "lstm" else 3) * hidden
    p = torch.from_numpy(rng.standard_normal((t, n, 4 * hidden)).astype(np.float32)).to(cuda)
    dh, stash = _bf16(rng, t, n, hidden, device=cuda), _bf16(rng, t, n, hidden, device=cuda)
    init = _bf16(rng, n, hidden, device=cuda)
    w_hh_t = _bf16(rng, gates, hidden, device=cuda, scale=hidden**-0.5)
    carries = [torch.from_numpy(rng.standard_normal((n, hidden)).astype(np.float32)).to(cuda)
               for _ in range(2)]
    if cell == "lstm":
        args = (p, dh, stash, init, w_hh_t, *carries)
        kernel, plain = ops.lstm_walk, ops.plain_lstm_walk
    else:
        args = (p, dh, stash, init, w_hh_t, carries[0])
        kernel, plain = ops.gru_walk, ops.plain_gru_walk
    assert ops.walk_splits(n, hidden)
    clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = kernel(*args, clocks=clocks)
    streaming = kernel(*args, split=False)
    torch.cuda.synchronize()
    assert bool((clocks > 0).all())  # the cell backward, the product, the exchange
    for g, s, w in zip(got, streaming, plain(*args)):
        _close_of_max(g, w, BF16_RTOL_OF_MAX)
        _close_of_max(g, s, BF16_RTOL_OF_MAX)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_bf16_train_step_launches_tensor_core_stages(cuda, cell):
    """The model's bf16 training forward and backward, as the Trainer runs
    it (bf16 copies of the weights through functional_call, drop_band on):
    both stages' layers go through the tensor-core GEMM and the walks, the
    training forward's and the backward's, none through the fp32-storage
    kernels (the earlier training forward, the layer backward)."""
    model = FullSubNet(num_freqs=65, sb_num_neighbors=3, fb_model_hidden_size=48,
                       sb_model_hidden_size=32, sequence_model=cell).to(cuda)
    params = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    mag = torch.from_numpy(np.abs(np.random.default_rng(10).standard_normal(
        (4, 1, 65, 30))).astype(np.float32)).to(cuda, torch.bfloat16)
    walk, train_walk = ((ops.lstm_walk, ops.lstm_train_walk) if cell == "LSTM"
                        else (ops.gru_walk, ops.gru_train_walk))
    kernels = (ops.tc_gemm, walk, train_walk, ops.dw_tma, ops.layer_bwd, ops.gru_layer_bwd,
               ops.stash_fwd, ops.gru_stash_fwd, ops.dw_gemm)
    for kernel in kernels:
        kernel.reset_counts()
    out = torch.func.functional_call(model, params, (mag,), {"dropping_band": True})
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    # per stage: forward 2 + 1 GEMMs and 2 walks, backward 4 GEMMs and 2
    # walks, and the dW stage 2 (LSTM) or 4 (GRU) GEMMs
    dw = 4 if cell == "LSTM" else 8
    assert [kernel.launches for kernel in kernels] == [14, 4, 4, dw, 0, 0, 0, 0, 0]
    assert ops.dw_tma.launches_by_form == {"tma": dw}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_tc_wrappers_refuse_bad_operands(cuda):
    """The GEMM takes bf16 operands and a unit-stride B; the walk its
    storage types, shapes and tile sizes; neither runs short."""
    a = torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(16, 24, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="a must be"):
        ops.tc_gemm(a.float(), b)
    with pytest.raises(ValueError, match="unit"):
        ops.tc_gemm(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="head"):
        ops.tc_gemm(a, torch.zeros(24, 24, device=cuda, dtype=torch.bfloat16),
                    prev=torch.zeros(8, 8, device=cuda, dtype=torch.bfloat16))
    t, n, hidden = 3, 5, 8
    p = torch.zeros(t, n, 4 * hidden, device=cuda)
    dh = torch.zeros(t, n, hidden, device=cuda, dtype=torch.bfloat16)
    init = torch.zeros(n, hidden, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(4 * hidden, hidden, device=cuda, dtype=torch.bfloat16)
    dh_in = torch.zeros(n, hidden, device=cuda)
    good = [p, dh, dh, init, w, dh_in, dh_in]
    out = ops.lstm_walk(*good)
    assert [v.dtype for v in out] == [torch.bfloat16, torch.float32, torch.float32]
    for index, bad, match in ((0, p.to(torch.bfloat16), "p must"),
                              (5, dh_in.to(torch.bfloat16), "dh_in"),
                              (4, w[:, :4], "w_hh_t")):
        args = list(good)
        args[index] = bad
        with pytest.raises((TypeError, ValueError), match=match):
            ops.lstm_walk(*args)
    with pytest.raises(ValueError, match="dc_in"):
        ops.gru_walk(*good)
    with pytest.raises(ValueError, match="rows_per_block"):
        ops.lstm_walk(*good, rows_per_block=8)
    with pytest.raises(ValueError, match="shared memory"):
        big = 512
        ops.lstm_walk(torch.zeros(1, 64, 4 * big, device=cuda),
                      *(torch.zeros(1, 64, big, device=cuda, dtype=torch.bfloat16),) * 2,
                      torch.zeros(64, big, device=cuda, dtype=torch.bfloat16),
                      torch.zeros(4 * big, big, device=cuda, dtype=torch.bfloat16),
                      *(torch.zeros(64, big, device=cuda),) * 2, rows_per_block=64)


# ---------------------------------------------------------------------------
# the bf16 training forward as stages (K2, K2-GRU): tc_gemm and the walks
# ---------------------------------------------------------------------------


def _train_walk_operands(rng, cell, t, n, hidden, device):
    """p [T, N, G·H] fp32, W_hh^T [H, G·H] bf16 and a non-zero initial state
    in bf16: the training walk's operands as the plain walk takes them
    (LSTM: h0, c0; GRU: b_hh, h0)."""
    gh = (4 if cell == "lstm" else 3) * hidden
    p = torch.from_numpy(rng.standard_normal((t, n, gh)).astype(np.float32)).to(device)
    w_hh_t = torch.from_numpy(
        rng.uniform(-1, 1, (hidden, gh)).astype(np.float32) / hidden**0.5).to(device, torch.bfloat16)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(
        device, torch.bfloat16)
    if cell == "lstm":
        return p, w_hh_t, (h0, _bf16(rng, n, hidden, device=device, scale=0.5))
    b_hh = torch.from_numpy(rng.standard_normal(gh).astype(np.float32) * 0.3).to(device)
    return p, w_hh_t, (b_hh, h0)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [384, 512])
@pytest.mark.parametrize("n", [16, 32, 37, 4096])
@pytest.mark.parametrize("form", ["split", 16, 32])
def test_train_walk_matches_plain(cuda, cell, hidden, n, form):
    """Each form of the training walk at the flagship widths, from non-zero
    initial states, against its plain version: the split walk (clusters of
    16 CTAs, N = 37 and 4096 ragged against 32 rows) and the streaming walk
    at each row tile with the deepest ring and with 2 slots; the h stash
    and (LSTM) the c stash, each within one bf16 step's travel."""
    t = 9
    rng = np.random.default_rng(hidden + n)
    p, w_hh_t, state = _train_walk_operands(rng, cell, t, n, hidden, cuda)
    kernel, plain = ((ops.lstm_train_walk, ops.plain_lstm_train_walk) if cell == "lstm"
                     else (ops.gru_train_walk, ops.plain_gru_train_walk))
    want = plain(p, w_hh_t, *state)
    want = want if cell == "lstm" else (want,)
    kernel.reset_counts()
    clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
    if form == "split":
        runs = [kernel(p, w_hh_t, *state, split=True, clocks=clocks)]
    else:
        runs = [kernel(p, w_hh_t, *state, rows_per_block=form, clocks=clocks),
                kernel(p, w_hh_t, *state, rows_per_block=form, stages=2)]
    torch.cuda.synchronize()
    assert dict(kernel.launches_by_shape) == {(n, hidden): len(runs)}
    # block 0's cycles: the product and the cell; the exchange only split
    assert clocks[0] > 0 and clocks[1] > 0 and bool(clocks[2] > 0) == (form == "split")
    for got in runs:
        got = got if cell == "lstm" else (got,)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and g.shape == (t, n, hidden)
            _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [40, 128])
def test_train_walk_odd_widths(cuda, cell, hidden):
    """The streaming walk where H is not a multiple of 128 (padding units
    and K rows) and the split walk's smallest H, against the plain walk."""
    t, n = 6, 37
    rng = np.random.default_rng(hidden)
    p, w_hh_t, state = _train_walk_operands(rng, cell, t, n, hidden, cuda)
    kernel, plain = ((ops.lstm_train_walk, ops.plain_lstm_train_walk) if cell == "lstm"
                     else (ops.gru_train_walk, ops.plain_gru_train_walk))
    want = plain(p, w_hh_t, *state)
    forms = [{"rows_per_block": 16}, {"split": True}] if hidden % 128 == 0 else [{}]
    for kwargs in forms:
        got = kernel(p, w_hh_t, *state, **kwargs)
        torch.cuda.synchronize()
        for g, w in zip(got if cell == "lstm" else (got,), want if cell == "lstm" else (want,)):
            _close(g, w, torch.bfloat16)


@pytest.mark.parametrize("out_dim, m", [(2, 4096 * 9), (257, 32 * 195)])
def test_train_head_gemm_matches_plain(cuda, out_dim, m):
    """The training forward's head on the tensor-core GEMM, W_fc^T
    zero-padded to a multiple of 8 columns (the sub-band OUT = 2, the
    full-band 257): within 1e-5 of the largest value of the plain product
    on the same bf16 values, contiguous, [M, OUT]."""
    rng = np.random.default_rng(out_dim)
    hidden = 384 if out_dim == 2 else 512
    seq = _bf16(rng, m, hidden, device=cuda, scale=0.5)
    wfc = _bf16(rng, hidden, out_dim, device=cuda, scale=hidden**-0.5)
    bfc = torch.from_numpy(rng.standard_normal(out_dim).astype(np.float32)).to(cuda)
    ops.tc_gemm.reset_counts()
    got = ops._head(ops.tc_gemm, seq, wfc, bfc)
    torch.cuda.synchronize()
    assert dict(ops.tc_gemm.launches_by_shape) == {(hidden, 0, -(-out_dim // 8) * 8): 1}
    assert got.shape == (m, out_dim) and got.is_contiguous() and got.dtype == torch.float32
    _close_of_max(got, seq.float() @ wfc.float() + bfc, 1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers, hidden", [(1, 40), (2, 128), (3, 64)])
def test_bf16_stages_match_earlier_kernel(cuda, cell, num_layers, hidden):
    """``stash_forward`` on a CUDA tensor at bf16 storage: the stages
    (tc_gemm for each layer's input projection and the head, the training
    walk for each layer), never the earlier kernel; against the earlier
    kernel's bf16 instance (stash_fwd, gru_stash_fwd) and the plain
    version, from non-zero initial states: the head output and every
    stash."""
    rng = np.random.default_rng(700 + hidden)
    args = _train_operands(rng, 19, 37, 20, hidden, 5, num_layers, torch.bfloat16, cuda, cell)
    old, walk = ((ops.stash_fwd, ops.lstm_train_walk) if cell == "lstm"
                 else (ops.gru_stash_fwd, ops.gru_train_walk))
    for kernel in (ops.tc_gemm, walk, old):
        kernel.reset_counts()
    got = ops.stash_forward(*args)
    torch.cuda.synchronize()
    assert (ops.tc_gemm.launches, walk.launches, old.launches) == (num_layers + 1, num_layers, 0)
    earlier = old(*args)
    want = ops.plain_stash_forward(*args)
    for results in (earlier, want):
        assert len(got) == len(results)
        for g, w in zip([got[0], *(v for s in got[1:] for v in s)],
                        [results[0], *(v for s in results[1:] for v in s)]):
            assert g.dtype == w.dtype and g.shape == w.shape
            _close(g, w, torch.bfloat16)


def test_train_walk_refuses_bad_operands(cuda):
    """The training walk takes fp32 P, bf16 states and W_hh^T, fp32 b_hh,
    its shapes and tiles; the split walk H a multiple of 128; nothing
    falls back."""
    t, n, hidden = 3, 5, 32
    bf16 = torch.bfloat16
    p = torch.zeros(t, n, 4 * hidden, device=cuda)
    w = torch.zeros(hidden, 4 * hidden, device=cuda, dtype=bf16)
    h0 = torch.zeros(n, hidden, device=cuda, dtype=bf16)
    hs, cs = ops.lstm_train_walk(p, w, h0, h0)
    assert hs.shape == cs.shape == (t, n, hidden) and hs.dtype == cs.dtype == bf16
    for args, error, match in (((p.to(bf16), w, h0, h0), TypeError, "p must"),
                               ((p, w.float(), h0, h0), TypeError, "w_hh_t"),
                               ((p, w, h0.float(), h0), TypeError, "h0"),
                               ((p, w, h0, h0[:, :-2]), ValueError, "c0"),
                               ((p[..., :-1], w, h0, h0), ValueError, "p must")):
        with pytest.raises(error, match=match):
            ops.lstm_train_walk(*args)
    with pytest.raises(ValueError, match="b_hh"):
        ops.gru_train_walk(p[..., : 3 * hidden], w[:, : 3 * hidden],
                           torch.zeros(4, device=cuda), h0)
    with pytest.raises(ValueError, match="rows_per_block"):
        ops.lstm_train_walk(p, w, h0, h0, rows_per_block=8)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.lstm_train_walk(p, w, h0, h0, split=True)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.lstm_train_walk(torch.zeros(t, n, 4 * 514, device=cuda),
                            torch.zeros(514, 4 * 514, device=cuda, dtype=bf16),
                            *(torch.zeros(n, 514, device=cuda, dtype=bf16),) * 2)


# ---------------------------------------------------------------------------
# the inference forward as stages (K1, K1-GRU): fwd_gemm and the cluster walk
# ---------------------------------------------------------------------------


def _f32(rng, *shape, device, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(device)


@pytest.mark.parametrize("m, k, ncols, lda", [
    (400, 257, 2048, 257),    # the full-band input projection at B = 1: odd K
    (1285, 32, 1536, 32),     # the sub-band input projection
    (1000, 384, 2, 384),      # the sub-band head: two columns
    (129, 512, 257, 512),     # the full-band head: odd Ncols
    (37, 20, 130, 23),        # ragged everything; a a column slice
])
def test_fwd_gemm_matches_plain(cuda, m, k, ncols, lda):
    """The forward's fp32 GEMM against its plain version (fp32 on both
    sides, TF32 off), with a bias, and written into a slice of a larger
    output as the head writes into the forward's output."""
    rng = np.random.default_rng(m + k)
    a = _f32(rng, m, lda, device=cuda)[:, :k]
    b = _f32(rng, ncols, k, device=cuda, scale=k**-0.5)
    bias = _f32(rng, ncols, device=cuda)
    before = ops.fwd_gemm.launches
    got = ops.fwd_gemm(a, b, bias)
    full = torch.zeros(m + 3, ncols, device=cuda)
    into = ops.fwd_gemm(a, b, out=full[2 : 2 + m])
    torch.cuda.synchronize()
    assert ops.fwd_gemm.launches == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), ops.plain_fwd_gemm(a, b, bias).cpu().numpy(),
                               atol=ATOL)
    assert into.data_ptr() == full[2].data_ptr()
    np.testing.assert_allclose(full[2 : 2 + m].cpu().numpy(), (a @ b.t()).cpu().numpy(), atol=ATOL)
    assert bool((full[:2] == 0).all()) and bool((full[2 + m :] == 0).all())


def _walk_operands(rng, cell, t, n, hidden, device):
    """p [T, N, G·H], W_hh and a non-zero initial state: the walk's
    operands as the plain walk takes them (LSTM: h0, c0; GRU: b_hh, h0)."""
    gh = (4 if cell == "lstm" else 3) * hidden
    p = _f32(rng, t, n, gh, device=device)
    w = torch.from_numpy(rng.uniform(-1, 1, (gh, hidden)).astype(np.float32) / hidden**0.5).to(device)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(device)
    if cell == "lstm":
        return p, w, (h0, _f32(rng, n, hidden, device=device, scale=0.5))
    return p, w, (_f32(rng, gh, device=device, scale=0.3), h0)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [384, 512])
@pytest.mark.parametrize("n", [1, 8, 37, 257])
def test_fwd_walk_matches_plain(cuda, cell, hidden, n):
    """The walk at the flagship widths, as two chunks of 4 and 5 steps, the
    second from the first's state, against the plain walk over all 9: the h
    stream and the last state. N = 37 and 257 leave a ragged last tile."""
    rng = np.random.default_rng(hidden + n)
    p, w, state = _walk_operands(rng, cell, 9, n, hidden, cuda)
    kernel, plain = ((ops.lstm_fwd_walk, ops.plain_lstm_fwd_walk) if cell == "lstm"
                     else (ops.gru_fwd_walk, ops.plain_gru_fwd_walk))
    kernel.reset_counts()
    first = kernel(p[:4], w, *state)
    nxt = first[1:] if cell == "lstm" else (state[0], first[1])
    second = kernel(p[4:], w, *nxt)
    torch.cuda.synchronize()
    assert dict(kernel.launches_by_shape) == {(n, hidden): 2}
    want = plain(p, w, *state)
    np.testing.assert_allclose(torch.cat([first[0], second[0]]).cpu().numpy(),
                               want[0].cpu().numpy(), atol=ATOL)
    for got, w_ in zip(second[1:], want[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), w_.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("cell, rows, hidden", [
    (cell, rows, hidden) for cell in ("lstm", "gru") for rows in ops.FWD_ROWS
    for hidden in (16, 64, 512) if ops.fwd_walk_kr(rows, hidden, cell) is not None
])
def test_fwd_walk_tiles_match_plain(cuda, cell, rows, hidden):
    """Every tile of the walk, at N = 37 (ragged against each), at H = 16
    (one unit a CTA: scalar gathers), 64 and 512 (the tiles that fit), with
    block 0's cycle counters."""
    rng = np.random.default_rng(rows + hidden)
    p, w, state = _walk_operands(rng, cell, 5, 37, hidden, cuda)
    kernel, plain = ((ops.lstm_fwd_walk, ops.plain_lstm_fwd_walk) if cell == "lstm"
                     else (ops.gru_fwd_walk, ops.plain_gru_fwd_walk))
    clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = kernel(p, w, *state, rows=rows, clocks=clocks)
    torch.cuda.synchronize()
    for g, w_ in zip(got, plain(p, w, *state)):
        np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(), atol=ATOL)
    assert bool((clocks > 0).all())  # the exchange, the product, the cell


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("n, chunk", [(1, None), (8, 4), (37, 3)])
def test_fused_forward_matches_plain(cuda, cell, num_layers, n, chunk):
    """fused_subband_lstm on a CUDA tensor without autograd: the stages of
    K1 / K1-GRU only, chunk by chunk, against the plain one-pass forward
    and the plain stages; never lstm_scan or gru_scan."""
    t, f_in, hidden, out_dim = 11, 20, 48, 5
    rng = np.random.default_rng(num_layers + n)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cuda, cell.lower())
    x = _f32(rng, t, n, f_in, device=cuda)
    walk, other = ((ops.lstm_fwd_walk, ops.gru_fwd_walk) if cell == "LSTM"
                   else (ops.gru_fwd_walk, ops.lstm_fwd_walk))
    kernels = (ops.fwd_gemm, walk, other, ops.lstm_scan, ops.gru_scan)
    for kernel in kernels:
        kernel.reset_counts()
    with torch.no_grad():
        got = (ops.fused_forward(x, layers, fc, chunk) if chunk
               else ops.fused_subband_lstm(x, *layers, fc))
        torch.cuda.synchronize()
        chunks = -(-t // (chunk or t))
        assert [k.launches for k in kernels] == [chunks * (num_layers + 1), chunks * num_layers,
                                                 0, 0, 0]
        plain = ops.plain_fused_subband_lstm if cell == "LSTM" else ops.plain_fused_subband_gru
        want = plain(x, layers, fc)
        stages = ops.plain_fused_forward(x, layers, fc, chunk)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(got.cpu().numpy(), stages.cpu().numpy(), atol=ATOL)


def test_fwd_wrappers_refuse_bad_operands(cuda):
    """The GEMM takes fp32 with unit column stride; the walk its shapes,
    H a multiple of 16 and its tiles; nothing falls back."""
    a = torch.zeros(8, 16, device=cuda)
    b = torch.zeros(24, 16, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.fwd_gemm(a.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="unit column"):
        ops.fwd_gemm(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="bias"):
        ops.fwd_gemm(a, b, torch.zeros(23, device=cuda))
    with pytest.raises(ValueError, match="out"):
        ops.fwd_gemm(a, b, out=torch.zeros(8, 23, device=cuda))
    t, n, hidden = 3, 5, 32
    p = torch.zeros(t, n, 4 * hidden, device=cuda)
    w = torch.zeros(4 * hidden, hidden, device=cuda)
    h0 = torch.zeros(n, hidden, device=cuda)
    hseq, h_t, c_t = ops.lstm_fwd_walk(p, w, h0, h0)
    assert hseq.shape == (t, n, hidden) and h_t.shape == c_t.shape == (n, hidden)
    with pytest.raises(ValueError, match="c0"):
        ops.lstm_fwd_walk(p, w, h0, h0[:, :-1])
    with pytest.raises(ValueError, match="b_hh"):
        ops.gru_fwd_walk(p[..., : 3 * hidden], w[: 3 * hidden], torch.zeros(4, device=cuda), h0)
    with pytest.raises(ValueError, match="rows"):
        ops.lstm_fwd_walk(p, w, h0, h0, rows=3)
    with pytest.raises(ValueError, match="multiple of 16"):
        h40 = torch.zeros(n, 40, device=cuda)
        ops.lstm_fwd_walk(torch.zeros(t, n, 160, device=cuda), torch.zeros(160, 40, device=cuda),
                          h40, h40)
    with pytest.raises(TypeError, match="float32"):
        ops.lstm_fwd_walk(p, w, h0.to(torch.bfloat16), h0)


# ---------------------------------------------------------------------------
# the layer backward at fp32 as stages (K3, K4 at fp32): fwd_gemm and the
# fp32 cluster walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m, k0, k1, shift, ncols", [
    (37 * 5, 12, 24, 37, 96),      # a recompute: N = 37, T = 5, F = 12, H = 24
    (32 * 3, 257, 512, 32, 2048),  # the full-band layer 0: odd K0
    (101, 3, 7, 4, 9),             # ragged everything
    (7, 33, 5, 9, 130),            # more head rows than M
])
def test_fwd_gemm_shifted_segment_matches_plain(cuda, m, k0, k1, shift, ncols):
    """The fp32 GEMM with A's second K segment read one block of rows back
    (head rows first) against its plain version and the explicit
    [a | a_prev] product, with a bias; and the same call without it still
    the GEMM K1 runs."""
    rng = np.random.default_rng(m + k0)
    a = _f32(rng, m, k0, device=cuda)
    prev = _f32(rng, m, k1, device=cuda)
    head = _f32(rng, shift, k1, device=cuda)
    b = _f32(rng, ncols, k0 + k1, device=cuda, scale=(k0 + k1) ** -0.5)
    bias = _f32(rng, ncols, device=cuda)
    before = ops.fwd_gemm.launches
    got = ops.fwd_gemm(a, b, bias, prev=prev, head=head)
    torch.cuda.synchronize()
    assert ops.fwd_gemm.launches == before + 1
    assert dict(ops.fwd_gemm.launches_by_shape)[(k0 + k1, ncols)] >= 1
    want = ops.plain_fwd_gemm(a, b, bias, prev=prev, head=head)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL)
    a_prev = torch.cat([head, prev])[:m]
    explicit = torch.cat([a, a_prev], 1) @ b.t() + bias
    np.testing.assert_allclose(got.cpu().numpy(), explicit.cpu().numpy(), atol=ATOL)
    one = ops.fwd_gemm(a, b[:, :k0].contiguous(), bias)
    np.testing.assert_allclose(one.cpu().numpy(), (a @ b[:, :k0].t() + bias).cpu().numpy(),
                               atol=ATOL)


def _f32_walk_operands(rng, cell, t, n, hidden, device):
    """The fp32 walk's operands as plain_lstm_walk / plain_gru_walk take
    them, with non-zero initial states and incoming carries; W_hh as a
    column slice of a wider wt, as the layer backward hands it over."""
    g = 4 if cell == "lstm" else 3
    p = _f32(rng, t, n, 4 * hidden, device=device)
    dh = _f32(rng, t, n, hidden, device=device)
    stash = _f32(rng, t, n, hidden, device=device, scale=0.5)
    init = _f32(rng, n, hidden, device=device, scale=0.5)
    wt = torch.from_numpy(rng.uniform(-1, 1, (g * hidden, 7 + hidden)).astype(np.float32)
                          / hidden**0.5).to(device)
    carries = [_f32(rng, n, hidden, device=device, scale=0.5) for _ in range(2 if g == 4 else 1)]
    return p, dh, stash, init, wt[:, 7:], *carries


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [384, 512])
@pytest.mark.parametrize("n", [1, 8, 32, 37, 257, 4096])
def test_f32_walk_matches_plain(cuda, cell, hidden, n):
    """The fp32 walk at the flagship widths against its plain version (the
    bf16 walk's, whose roundings are no-ops at fp32), in every form built
    for the shape (the cluster form at each tile, the streaming form) and
    the picked one, from non-zero incoming carries: the cotangent
    streams and the carries into the initial state. N = 37 and 257 leave a
    ragged last tile; N = 4096 is the sub-band stage's."""
    t = 3 if n == 4096 else 5
    rng = np.random.default_rng(hidden + n)
    args = _f32_walk_operands(rng, cell, t, n, hidden, cuda)
    kernel, plain = ((ops.lstm_walk_f32, ops.plain_lstm_walk) if cell == "lstm"
                     else (ops.gru_walk_f32, ops.plain_gru_walk))
    want = plain(*args)
    forms = [{}] + [{"rows": r} for r in ops.BWD_F32_ROWS
                    if ops.bwd_f32_kr(r, hidden, cell) is not None]
    if ops.bwd_f32_stream_fits(hidden, cell):
        forms.append({"stream": True})
    kernel.reset_counts()
    n_stream = 0
    for form in forms:
        clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
        got = kernel(*args, clocks=clocks, **form)
        torch.cuda.synchronize()
        for name, g, w in zip(("out0", "out1 or dh0", "dh0 or dc0"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=ATOL,
                                       err_msg=f"{name}, {form}")
        # the cell backward, the product, and the cluster form's exchange
        streamed = form.get("stream", not form and ops.bwd_f32_streams(
            n, hidden, cell, lambda r, k: kernel.max_clusters(hidden, r, k, cuda)))
        assert bool((clocks[:2] > 0).all()) and (streamed or bool(clocks[2] > 0))
        n_stream += bool(streamed)
    assert dict(kernel.launches_by_shape) == {(n, hidden): len(forms)}
    by_form = {"streaming": n_stream, "cluster": len(forms) - n_stream}
    assert dict(kernel.forms_by_shape) == {((n, hidden), k): v for k, v in by_form.items() if v}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [16, 48, 96])
def test_f32_walk_narrow_widths(cuda, cell, hidden):
    """Narrow H (one to six units a CTA, zero-padded cotangent tiles; 16
    and 48 leave lanes of the last warp without columns), the cluster form
    at every tile and the streaming form, N = 37, against the plain walk."""
    rng = np.random.default_rng(hidden)
    args = _f32_walk_operands(rng, cell, 6, 37, hidden, cuda)
    kernel, plain = ((ops.lstm_walk_f32, ops.plain_lstm_walk) if cell == "lstm"
                     else (ops.gru_walk_f32, ops.plain_gru_walk))
    want = plain(*args)
    forms = [{"rows": r} for r in ops.BWD_F32_ROWS] + [{"stream": True}]
    for form in forms:
        got = kernel(*args, **form)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=ATOL,
                                       err_msg=str(form))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden", [(5, 37, 20, 64), (1, 37, 257, 512), (9, 70, 32, 384)])
def test_f32_layer_backward_runs_the_stages(cuda, cell, t, n, f_in, hidden):
    """layer_backward / gru_layer_backward on a CUDA fp32 tensor: the fp32
    stages (fwd_gemm twice, the fp32 walk once) and never the earlier fp32
    kernel, against the plain composition of the same stages and against
    the earlier kernel's plain version."""
    rng = np.random.default_rng(t + n + hidden)
    lstm = cell == "lstm"
    x, ws, bs, _, _, h0s, *c0s = _train_operands(rng, t, n, f_in, hidden, 3, 1, torch.float32,
                                                 cuda, cell)
    out = ops.plain_stash_forward(x, ws, bs, torch.zeros(hidden, 3, device=cuda),
                                  torch.zeros(3, device=cuda), h0s, *c0s)
    hs = out[1]
    dh = _f32(rng, t, n, hidden, device=cuda)
    carries = [_f32(rng, n, hidden, device=cuda, scale=0.5) for _ in range(2 if lstm else 1)]
    wt = ws[0].t().contiguous()
    if lstm:
        args = (dh, x, hs[0], out[2][0], ws[0], wt, bs[0], h0s[0], c0s[0][0], *carries)
        dispatch, plain, old = (ops.layer_backward, ops.plain_f32_layer_backward,
                                ops.plain_layer_backward)
    else:
        args = (dh, x, hs[0], ws[0], wt, bs[0], h0s[0], *carries)
        dispatch, plain, old = (ops.gru_layer_backward, ops.plain_f32_gru_layer_backward,
                                ops.plain_gru_layer_backward)
    walk = ops.lstm_walk_f32 if lstm else ops.gru_walk_f32
    kernels = (ops.fwd_gemm, walk, ops.layer_bwd, ops.gru_layer_bwd, ops.tc_gemm)
    for kernel in kernels:
        kernel.reset_counts()
    got = dispatch(*args)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [2, 1, 0, 0, 0]
    g = 4 * hidden if lstm else 3 * hidden
    assert dict(ops.fwd_gemm.launches_by_shape) == {(f_in + hidden, 4 * hidden): 1, (g, f_in): 1}
    for want in (plain(*args), old(*args)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=ATOL)


def test_f32_walk_refuses_bad_operands(cuda):
    """The fp32 walk takes fp32, H a multiple of 16 up to 512, its tiles,
    dc_in for the LSTM only; nothing falls back."""
    t, n, hidden = 3, 5, 32
    p = torch.zeros(t, n, 4 * hidden, device=cuda)
    d = torch.zeros(t, n, hidden, device=cuda)
    s = torch.zeros(n, hidden, device=cuda)
    w = torch.zeros(4 * hidden, hidden, device=cuda)
    dg, dh0, dc0 = ops.lstm_walk_f32(p, d, d, s, w, s, s)
    assert dg.shape == (t, n, 4 * hidden) and dh0.shape == dc0.shape == (n, hidden)
    with pytest.raises(ValueError, match="dc_in"):
        ops.lstm_walk_f32(p, d, d, s, w, s)
    with pytest.raises(ValueError, match="dc_in"):
        ops.gru_walk_f32(p, d, d, s, w[: 3 * hidden], s, s)
    with pytest.raises(ValueError, match="w_hh"):
        ops.gru_walk_f32(p, d, d, s, w, s)
    with pytest.raises(ValueError, match="rows"):
        ops.lstm_walk_f32(p, d, d, s, w, s, s, rows=3)
    with pytest.raises(ValueError, match="16 rows"):
        ops.lstm_walk_f32(p, d, d, s, w, s, s, rows=8, stream=True)
    unaligned = torch.zeros(n * hidden + 1, device=cuda)[1:].view(n, hidden)
    with pytest.raises(ValueError, match="16-byte"):
        ops.lstm_walk_f32(p, d, d, s, w, s, unaligned, stream=True)
    # where the pick is the streaming form (many rows), an unaligned operand
    # raises too: no quiet switch to the slower cluster form
    big = 1 << 15
    assert ops.bwd_f32_streams(big, 16, "lstm",
                               lambda r, k: ops.lstm_walk_f32.max_clusters(16, r, k, p.device))
    with pytest.raises(ValueError, match="16-byte"):
        ops.lstm_walk_f32(torch.zeros(2, big, 64, device=cuda), torch.zeros(2, big, 16, device=cuda),
                          torch.zeros(2, big, 16, device=cuda), torch.zeros(big, 16, device=cuda),
                          torch.zeros(64, 16, device=cuda), torch.zeros(big, 16, device=cuda),
                          torch.zeros(big * 16 + 1, device=cuda)[1:].view(big, 16))
    h512 = torch.zeros(n, 512, device=cuda)
    with pytest.raises(ValueError, match="H up to 384"):
        ops.gru_walk_f32(torch.zeros(t, n, 2048, device=cuda), torch.zeros(t, n, 512, device=cuda),
                         torch.zeros(t, n, 512, device=cuda), h512,
                         torch.zeros(1536, 512, device=cuda), h512, stream=True)
    with pytest.raises(TypeError, match="float32"):
        ops.lstm_walk_f32(p, d.to(torch.bfloat16), d, s, w, s, s)
    with pytest.raises(TypeError, match="w_hh"):
        ops.lstm_walk_f32(p, d, d, s, w.t().contiguous().t(), s, s)
    with pytest.raises(ValueError, match="multiple of 16"):
        h = torch.zeros(n, 40, device=cuda)
        ops.lstm_walk_f32(torch.zeros(t, n, 160, device=cuda), torch.zeros(t, n, 40, device=cuda),
                          torch.zeros(t, n, 40, device=cuda), h, torch.zeros(160, 40, device=cuda),
                          h, h)
    with pytest.raises(ValueError, match="prev"):
        ops.fwd_gemm(torch.zeros(8, 4, device=cuda), torch.zeros(16, 12, device=cuda),
                     prev=torch.zeros(8, 8, device=cuda))
    with pytest.raises(ValueError, match="K0 \\+ K1"):
        ops.fwd_gemm(torch.zeros(8, 4, device=cuda), torch.zeros(16, 11, device=cuda),
                     prev=torch.zeros(8, 8, device=cuda), head=torch.zeros(2, 8, device=cuda))


# ---------------------------------------------------------------------------
# the training forward at fp32 as stages (K2, K2-GRU at fp32): fwd_gemm, and
# the cluster walk with its c stream or the streaming walk
# ---------------------------------------------------------------------------


def _train_f32_walk_operands(rng, cell, t, n, hidden, device):
    """The fp32 training walk's operands as the plain forward walks take
    them (LSTM: h0, c0; GRU: b_hh, h0), non-zero initial states; W_hh
    [G·H, H]."""
    gh = (4 if cell == "lstm" else 3) * hidden
    p = _f32(rng, t, n, gh, device=device)
    w = torch.from_numpy(rng.uniform(-1, 1, (gh, hidden)).astype(np.float32)
                         / hidden**0.5).to(device)
    h0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)).to(device)
    if cell == "lstm":
        return p, w, (h0, _f32(rng, n, hidden, device=device, scale=0.5))
    return p, w, (_f32(rng, gh, device=device, scale=0.3), h0)


def _train_f32_forms(cell, hidden):
    """Every form of the fp32 training walk built for H: the cluster form
    at each tile that fits, the streaming form."""
    forms = []
    if ops._fwd_walk_takes(hidden, cell):
        forms += [{"rows": r} for r in ops.FWD_ROWS if ops.fwd_walk_kr(r, hidden, cell) is not None]
    if ops.train_f32_stream_fits(hidden, cell):
        forms.append({"stream": True})
    return forms


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [384, 512])
@pytest.mark.parametrize("n", [1, 8, 32, 37, 257, 281, 4096])
def test_train_f32_walk_matches_plain(cuda, cell, hidden, n):
    """The fp32 training walk at the flagship widths against its plain
    version (the forward walk's stash form), in the form it picks and in
    every form built for the shape (the cluster form at each tile with its c
    stream, the streaming form from W_hh and from the regrouped weights),
    from non-zero initial states: the stashes. N = 37, 257 and 281 leave
    ragged last tiles and blocks; N = 281 is the first the cluster form
    cannot walk in one wave at H = 384; N = 4096 is the sub-band stage's."""
    t = 3 if n == 4096 else 5
    rng = np.random.default_rng(hidden + n)
    p, w, state = _train_f32_walk_operands(rng, cell, t, n, hidden, cuda)
    kernel, plain = ((ops.lstm_train_walk_f32, ops.plain_lstm_fwd_walk) if cell == "lstm"
                     else (ops.gru_train_walk_f32, ops.plain_gru_fwd_walk))
    want = plain(p, w, *state, stash=True)
    streams = kernel.streams(n, hidden, cuda)
    grouped = ops._group_hh(w, 4 if cell == "lstm" else 3)
    forms = [{}] + _train_f32_forms(cell, hidden) + [{"grouped": True}]
    kernel.reset_counts()
    for form in forms:
        clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
        got = kernel(p, grouped if form.get("grouped") else w, *state, clocks=clocks,
                     **{k: v for k, v in form.items() if k != "grouped"})
        torch.cuda.synchronize()
        got = got if cell == "lstm" else (got,)
        want_ = want if cell == "lstm" else (want,)
        for name, g, w_ in zip(("h stash", "c stash"), got, want_):
            assert g.dtype == torch.float32 and g.shape == (t, n, hidden)
            np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(), atol=ATOL,
                                       err_msg=f"{name}, {form}")
        # the exchange or ring wait, the product, the cell update
        assert bool((clocks[1:] > 0).all()), form
    assert dict(kernel.launches_by_shape) == {(n, hidden): len(forms)}
    n_stream = sum(1 for f in forms if f.get("stream", f.get("grouped", not f and streams)))
    assert dict(kernel.launches_by_form) == {
        k: v for k, v in (("streaming", n_stream), ("cluster", len(forms) - n_stream)) if v}
    assert kernel.weights(w, n).shape == (grouped.shape if streams else w.shape)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [16, 40, 48, 100, 200])
def test_train_f32_walk_narrow_widths(cuda, cell, hidden):
    """Narrow and odd H (40, 100 and 200 only in the streaming form: not a
    multiple of 16; a unit group partly or mostly empty; K rows past H zero),
    every form built, N = 37, against the plain walk."""
    rng = np.random.default_rng(hidden)
    p, w, state = _train_f32_walk_operands(rng, cell, 6, 37, hidden, cuda)
    kernel, plain = ((ops.lstm_train_walk_f32, ops.plain_lstm_fwd_walk) if cell == "lstm"
                     else (ops.gru_train_walk_f32, ops.plain_gru_fwd_walk))
    want = plain(p, w, *state, stash=True)
    forms = _train_f32_forms(cell, hidden)
    assert {"stream": True} in forms
    for form in forms:
        got = kernel(p, w, *state, **form)
        torch.cuda.synchronize()
        for g, w_ in zip(got if cell == "lstm" else (got,), want if cell == "lstm" else (want,)):
            np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(), atol=ATOL,
                                       err_msg=str(form))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t, n, f_in, hidden, out_dim, num_layers", [
    (9, 37, 20, 64, 3, 2),      # few rows: the cluster form
    (5, 300, 32, 384, 2, 2),    # the sub-band widths past one wave of clusters: streaming
    (3, 37, 257, 512, 257, 1),  # the full-band widths
    (4, 70, 12, 40, 5, 3),      # H = 40: the streaming form alone
])
def test_f32_stash_forward_runs_the_stages(cuda, cell, t, n, f_in, hidden, out_dim, num_layers):
    """stash_forward on a CUDA fp32 tensor: fwd_gemm for each layer's input
    projection and the head, the fp32 training walk once a layer (in the
    form it picks), and never the earlier fp32 kernels (stash_fwd,
    gru_stash_fwd), the inference walks or a tensor-core stage; the head
    output and every stash against the plain composition of the same
    stages, against the bf16 stages' plain composition at fp32, and against
    the earlier kernel."""
    rng = np.random.default_rng(t + n + hidden)
    args = _train_operands(rng, t, n, f_in, hidden, out_dim, num_layers, torch.float32, cuda,
                           cell)
    lstm = cell == "lstm"
    walk, old = ((ops.lstm_train_walk_f32, ops.stash_fwd) if lstm
                 else (ops.gru_train_walk_f32, ops.gru_stash_fwd))
    kernels = (ops.fwd_gemm, walk, ops.stash_fwd, ops.gru_stash_fwd, ops.lstm_fwd_walk,
               ops.gru_fwd_walk, ops.tc_gemm, ops.lstm_train_walk, ops.gru_train_walk)
    for kernel in kernels:
        kernel.reset_counts()
    got = ops.stash_forward(*args)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [num_layers + 1, num_layers] + [0] * 7
    gh = (4 if lstm else 3) * hidden
    want_gemm = {(f_in, gh): 1, (hidden, out_dim): 1}
    if num_layers > 1:
        want_gemm[(hidden, gh)] = num_layers - 1
    assert dict(ops.fwd_gemm.launches_by_shape) == want_gemm
    form = "streaming" if walk.streams(n, hidden, cuda) else "cluster"
    assert dict(walk.launches_by_form) == {form: num_layers}
    old_out = old(*args)
    torch.cuda.synchronize()
    flat = lambda r: [r[0], *(v for stash in r[1:] for v in stash)]  # noqa: E731
    assert [tuple(v.shape) for v in flat(got)] == (
        [(t, n, out_dim)] + [(t, n, hidden)] * (num_layers * (2 if lstm else 1)))
    for want in (ops.plain_f32_stash_forward(*args), ops.plain_stash_forward(*args), old_out):
        for a, b in zip(flat(got), flat(want)):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_inference_launches_no_training_walk(cuda, cell):
    """The inference forward's launches are K1's as before: fwd_gemm and the
    cell's forward walk, never the fp32 training walk of either form, even
    at the sub-band widths where the training walk would stream."""
    t, n, f_in, hidden, out_dim = 4, 600, 32, 384, 2
    rng = np.random.default_rng(11)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, cuda, cell.lower())
    x = _f32(rng, t, n, f_in, device=cuda)
    walk = ops.lstm_fwd_walk if cell == "LSTM" else ops.gru_fwd_walk
    kernels = (ops.fwd_gemm, walk, ops.lstm_train_walk_f32, ops.gru_train_walk_f32)
    for kernel in kernels:
        kernel.reset_counts()
    with torch.no_grad():
        got = ops.fused_subband_lstm(x, *layers, fc)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [3, 2, 0, 0]
    plain = ops.plain_fused_subband_lstm if cell == "LSTM" else ops.plain_fused_subband_gru
    np.testing.assert_allclose(got.cpu().numpy(), plain(x, layers, fc).cpu().numpy(), atol=ATOL)


def test_train_f32_walk_refuses_bad_operands(cuda):
    """The fp32 training walk takes fp32, W_hh contiguous [G·H, H] or
    regrouped (the streaming form's alone), the cluster form's tiles, the
    streaming form without a tile and H up to 512; a width neither form
    takes raises; nothing falls back. fwd_gemm takes B contiguous."""
    t, n, hidden = 3, 5, 32
    p = torch.zeros(t, n, 4 * hidden, device=cuda)
    w = torch.zeros(4 * hidden, hidden, device=cuda)
    h0 = torch.zeros(n, hidden, device=cuda)
    hs, cs = ops.lstm_train_walk_f32(p, w, h0, h0)
    assert hs.shape == cs.shape == (t, n, hidden)
    with pytest.raises(ValueError, match="c0"):
        ops.lstm_train_walk_f32(p, w, h0, h0[:, :-1])
    with pytest.raises(ValueError, match="b_hh"):
        ops.gru_train_walk_f32(p[..., : 3 * hidden], w[: 3 * hidden], torch.zeros(4, device=cuda),
                               h0)
    with pytest.raises(ValueError, match="rows"):
        ops.lstm_train_walk_f32(p, w, h0, h0, rows=3)
    with pytest.raises(ValueError, match="32 rows"):
        ops.lstm_train_walk_f32(p, w, h0, h0, rows=8, stream=True)
    with pytest.raises(ValueError, match="w_hh must be contiguous"):
        ops.lstm_train_walk_f32(p, w.t().contiguous().t(), h0, h0)
    grouped = ops._group_hh(w, 4)
    with pytest.raises(ValueError, match="cluster form takes w_hh"):
        ops.lstm_train_walk_f32(p, grouped, h0, h0, stream=False)
    with pytest.raises(ValueError, match="w_hh must be"):
        ops.lstm_train_walk_f32(p, grouped[:, :-1], h0, h0)
    with pytest.raises(TypeError, match="float32"):
        ops.lstm_train_walk_f32(p, w, h0.to(torch.bfloat16), h0)
    h600 = torch.zeros(n, 600, device=cuda)
    with pytest.raises(ValueError, match="up to 512"):
        ops.gru_train_walk_f32(torch.zeros(t, n, 1800, device=cuda),
                               torch.zeros(1800, 600, device=cuda), torch.zeros(1800, device=cuda),
                               h600)
    with pytest.raises(ValueError, match="multiple of 16"):
        h40 = torch.zeros(n, 40, device=cuda)
        ops.lstm_train_walk_f32(torch.zeros(t, n, 160, device=cuda),
                                torch.zeros(160, 40, device=cuda), h40, h40, stream=False)
    with pytest.raises(ValueError, match="b must be contiguous"):
        ops.fwd_gemm(torch.zeros(8, 4, device=cuda), torch.zeros(4, 16, device=cuda).t())


# ---------------------------------------------------------------------------
# the layer backward's dW stage (K3, K4): the persistent GEMM of
# rnn_dw_tma.cu on the path, the split-K GEMM of rnn_dw.cu beside it
# ---------------------------------------------------------------------------

# both sides sum the same fp32 products (bf16 x bf16 is exact in fp32) in
# another order: held to this share of the largest value
DW_RTOL_OF_MAX = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f_in, hidden, gates, shift, k", [
    (32, 0, 3, 0, 2_047),      # M = 33: the sub-band GRU's [x | 1]^T . dxw
    (0, 384, 3, 37, 2_047),    # M = 385: the sub-band GRU's [h_prev | 1]^T . dhw
    (32, 384, 4, 37, 2_047),   # M = 417: sub-band LSTM layer 1
    (384, 384, 4, 37, 1_073),  # M = 769: sub-band LSTM layer 2
    (257, 512, 4, 4, 1_001),   # M = 770: full-band LSTM layer 1 (element loads of h_prev)
    (512, 512, 4, 4, 1_001),   # M = 1025: full-band LSTM layer 2
    (20, 44, 3, 37, 777),      # ragged: M = 65, Ncols = 132 (B by element loads)
])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_dw_gemm_matches_plain(cuda, dtype, f_in, hidden, gates, shift, k, splits):
    """The dW GEMM ([a | a_prev | 1]^T . b, a_prev read `shift` rows back
    with a head block first) against plain_dw_gemm on the same stored
    values, K ragged against every tile, at the slices it picks, in one
    slice and in 5 uneven ones; one launch, and the same bits on a second
    call."""
    rng = np.random.default_rng(k + f_in + hidden)
    width = gates * (hidden or 384)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
            cuda, dtype)

    kwargs = {"a": draw(k, f_in) if f_in else None}
    if hidden:
        kwargs.update(prev=draw(k, hidden), head=draw(max(shift, 1), hidden)[:shift])
    b = draw(k, width, scale=0.1)
    before = ops.dw_gemm.launches
    got = ops.dw_gemm(b=b, splits=splits, **kwargs)
    again = ops.dw_gemm(b=b, splits=splits, **kwargs)
    torch.cuda.synchronize()
    assert ops.dw_gemm.launches == before + 2
    want = ops.plain_dw_gemm(b=b, **kwargs)
    assert got.dtype == torch.float32 and got.shape == (f_in + hidden + 1, width)
    assert torch.equal(got, again)
    _close_of_max(got, want, DW_RTOL_OF_MAX)


# the redesigned dW stage (rnn_dw_tma.cu) on the cases of the earlier one,
# and on the edges of its plan: (F, H, gates, shift, K)
DW_TMA_CASES = [
    (32, 0, 3, 0, 2_047),      # M = 33: the sub-band GRU's [x | 1]^T . dxw
    (0, 384, 3, 37, 2_047),    # M = 385: [h_prev | 1]^T . dhw (three pairs: no cluster)
    (32, 384, 4, 37, 2_047),   # M = 417: sub-band LSTM layer 1 (x's slot half full)
    (384, 384, 4, 37, 1_073),  # M = 769: sub-band LSTM layer 2
    (257, 512, 4, 4, 1_001),   # M = 770: full-band layer 1 (x by cp.async at fp32)
    (512, 512, 4, 4, 1_001),   # M = 1025: full-band LSTM layer 2
    (20, 44, 3, 37, 777),      # ragged: M = 65, Ncols = 132 (B by cp.async)
    (32, 384, 4, 0, 2_047),    # shift 0: no head unit
    (20, 44, 3, 150, 777),     # shift over two k-tiles of either type
    (20, 44, 3, 5, 40),        # K under one k-tile
    (64, 64, 4, 9, 1_000),     # K off every tile; one pair: no cluster
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f_in, hidden, gates, shift, k", DW_TMA_CASES)
def test_dw_tma_matches_plain(cuda, dtype, f_in, hidden, gates, shift, k):
    """The persistent dW GEMM ([a | a_prev | 1]^T . b, a_prev read `shift`
    rows back with a head block first) against plain_dw_gemm on the same
    stored values, at DW_RTOL_OF_MAX of the largest value; one launch, and
    the same bits on a second call; the load path counted by form: TMA
    where every operand's base and row stride are 16-byte multiples, else
    cp.async (the fp32 x of 257 columns, rows of 1,028 bytes; the ragged
    bf16 operands; at bf16 F = 257 gathers, an odd row stride)."""
    rng = np.random.default_rng(k + f_in + hidden)
    width = gates * (hidden or 384)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
            cuda, dtype)

    kwargs = {"a": draw(k, f_in) if f_in else None}
    if hidden:
        kwargs.update(prev=draw(k, hidden), head=draw(max(shift, 1), hidden)[:shift])
    b = draw(k, width, scale=0.1)
    ops.dw_tma.reset_counts()
    got = ops.dw_tma(b=b, **kwargs)
    again = ops.dw_tma(b=b, **kwargs)
    torch.cuda.synchronize()
    paths = {ops.dw_load_path(t) for t in (*kwargs.values(), b) if t is not None and t.numel()}
    form = "tma" if paths == {"tma"} else "cp.async"
    assert ops.dw_tma.launches_by_form == {form: 2}
    assert dict(ops.dw_tma.launches_by_shape) == {(f_in, hidden, width): 2}
    if dtype == torch.float32 and f_in == 257:
        assert ops.dw_load_path(kwargs["a"]) == "cp.async"  # no synchronous loads on the ring
    want = ops.plain_dw_gemm(b=b, **kwargs)
    assert got.dtype == torch.float32 and got.shape == (f_in + hidden + 1, width)
    assert torch.equal(got, again)
    _close_of_max(got, want, DW_RTOL_OF_MAX)


# the bf16 instance on operands of one sign: its units' tensor-core sums
# round toward zero, so the error grows with the rows a unit sums (on an
# H100, chip_smoke.py --dw: 1.6e-5 of the largest value at 8,192 rows,
# 3.0e-5 at 16,384, 6.7e-5 at 32,768, K = 24,576); held to this at the
# cap's unit length
DW_SIGN_RTOL_OF_MAX = 4e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_tma_one_sign_operands(cuda, dtype):
    """a and b of one sign (uniform in [0, 1)), K = 3 x 8,192 rows, against
    plain_dw_gemm: fp32 at DW_RTOL_OF_MAX; bf16 at DW_SIGN_RTOL_OF_MAX, on
    the plan's units and on units of DW_MAX_UNIT_ROWS rows (the cap: a cap
    of 32k rows fails it)."""
    rng = np.random.default_rng(24_576)
    k = 3 * 8_192

    def draw(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda, dtype)

    a, b = draw(k, 384), draw(k, 1_536)
    want = ops.plain_dw_gemm(a, b)
    tol = DW_RTOL_OF_MAX if dtype == torch.float32 else DW_SIGN_RTOL_OF_MAX
    _close_of_max(ops.dw_tma(a, b), want, tol)
    plan = ops.dw_tma.plan(a, b)
    capped = ops._dw_plan(384, 0, 0, 1_536, k, ops.dw_tma.sms(b.device), dtype,
                          -(-k // ops.DW_MAX_UNIT_ROWS[dtype]), plan.cs)
    assert -(-k // capped.slabs) <= ops.DW_MAX_UNIT_ROWS[dtype]
    _close_of_max(ops.dw_tma(a, b, plan=capped), want, tol)


def test_dw_tma_refuses_bad_operands(cuda):
    """One storage type for A and B, fp32 or bf16; B with a unit column
    stride; a shifted segment needs its head block; a or prev is needed;
    a needs K rows; operands on one device."""
    k = 64
    bf = torch.zeros(k, 32, device=cuda, dtype=torch.bfloat16)
    a = torch.zeros(k, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="a must be"):
        ops.dw_tma(a.float(), bf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.dw_tma(a.half(), bf.half())
    with pytest.raises(ValueError, match="unit column stride"):
        ops.dw_tma(a, bf.t().contiguous().t())
    with pytest.raises(ValueError, match="head"):
        ops.dw_tma(a, bf, prev=a)
    with pytest.raises(ValueError, match="a must be"):
        ops.dw_tma(a[:-1], bf)
    with pytest.raises(ValueError, match="needs a or prev"):
        ops.dw_tma(None, bf)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.dw_tma(a.cpu(), bf)
    assert ops.dw_tma.launches_by_shape.get((8, 0, 32), 0) == 0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_grads_launch_the_dw_stage(cuda, cell, dtype):
    """weight_grads on the card: one launch of the redesigned dW GEMM for
    an LSTM layer, two for a GRU layer, none of the earlier one, and the
    plain composition's results on the same streams."""
    t, n, f_in, hidden = 7, 37, 20, 48
    rng = np.random.default_rng(11)
    gh = (4 if cell == "lstm" else 3) * hidden

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)

    x, hs, h0 = draw(t, n, f_in), draw(t, n, hidden), draw(n, hidden)
    streams = (draw(t, n, gh),) if cell == "lstm" else (draw(t, n, gh), draw(t, n, gh))
    ops.dw_gemm.reset_counts()
    ops.dw_tma.reset_counts()
    got = ops.weight_grads(x, hs, h0, *streams)
    torch.cuda.synchronize()
    assert ops.dw_tma.launches == len(streams) and ops.dw_gemm.launches == 0
    want = ops.layer_weight_grads(x, hs, h0, *streams)
    for g, w in zip(got, want):
        _close_of_max(g, w, DW_RTOL_OF_MAX)


def test_dw_gemm_refuses_bad_operands(cuda):
    """One storage type for A and B, fp32 or bf16; B with a unit column
    stride; a shifted segment needs its head block; a or prev is needed."""
    k = 64
    bf = torch.zeros(k, 32, device=cuda, dtype=torch.bfloat16)
    a = torch.zeros(k, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="a must be"):
        ops.dw_gemm(a.float(), bf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.dw_gemm(a.half(), bf.half())
    with pytest.raises(ValueError, match="unit column stride"):
        ops.dw_gemm(a, bf.t().contiguous().t())
    with pytest.raises(ValueError, match="head"):
        ops.dw_gemm(a, bf, prev=a)
    with pytest.raises(ValueError, match="a must be"):
        ops.dw_gemm(a[:-1], bf)
    with pytest.raises(ValueError, match="needs a or prev"):
        ops.dw_gemm(None, bf)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f_in, hidden, out_dim", [(31, 48, 0), (12, 257, 3), (20, 320, 2),
                                                   (257, 272, 0)])
def test_baseline_stack_shapes_match_the_cpu(cuda, cell, dtype, f_in, hidden, out_dim):
    """The stacks of the baseline families: head-less (out_dim 0: no head
    GEMM, the top layer's h out), H = 257 (run zero-padded to 272 units),
    H = 320, and input widths that are not a multiple of 8 (run padded to
    one at bf16): ``fused_subband_lstm`` under autograd on the card against
    the same op on the CPU, the loss and every gradient; and without
    autograd (fp32) the inference forward. The walks run at the padded
    width, the bf16 GEMMs at the padded input width."""
    t, n, num_layers = 9, 13, 2
    rng = np.random.default_rng(f_in + hidden)
    layers, fc = _stack(rng, f_in, hidden, max(out_dim, 1), num_layers, torch.device("cpu"), cell)
    if not out_dim:
        fc = None
    x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal((t, n, out_dim or hidden)).astype(np.float32))

    def loss_and_grads(device):
        stack = [{k: v.to(device, dtype).requires_grad_() for k, v in l.items()} for l in layers]
        head = None if fc is None else {k: v.to(device, dtype).requires_grad_()
                                        for k, v in fc.items()}
        xd = x.to(device, dtype).requires_grad_()
        out = ops.fused_subband_lstm(xd, *stack, head)
        loss = torch.sum(out * probe.to(device))
        leaves = [xd, *(v for l in stack for v in l.values()),
                  *(() if head is None else head.values())]
        return out, loss, torch.autograd.grad(loss, leaves)

    for kernel in (ops.tc_gemm, ops.fwd_gemm, ops.lstm_walk, ops.gru_walk, ops.lstm_walk_f32,
                   ops.gru_walk_f32, ops.lstm_fwd_walk, ops.gru_fwd_walk):
        kernel.reset_counts()
    out, loss, grads = loss_and_grads(cuda)
    torch.cuda.synchronize()
    width = ops.padded_hidden(hidden)
    walk = {("lstm", torch.float32): ops.lstm_walk_f32, ("gru", torch.float32): ops.gru_walk_f32,
            ("lstm", torch.bfloat16): ops.lstm_walk, ("gru", torch.bfloat16): ops.gru_walk}
    assert dict(walk[cell, dtype].launches_by_shape) == {(n, width): num_layers}
    if dtype == torch.bfloat16:
        f_pad = -(-f_in // 8) * 8
        keys = set(ops.tc_gemm.launches_by_shape)
        assert (f_pad, 0, (4 if cell == "lstm" else 3) * width) in keys
        heads = {k for k in keys if k[0] == width and k[1] == 0 and k[2] < width}
        assert heads == (set() if fc is None else {(width, 0, 8)})
    assert out.shape == (t, n, out_dim or hidden)
    want_out, want_loss, want_grads = loss_and_grads(torch.device("cpu"))
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    scale = float(want_out.detach().float().abs().max())
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               want_out.detach().float().numpy(), atol=rtol * scale)
    for got, want in zip(grads, want_grads):
        assert got.dtype == dtype and got.shape == want.shape
        atol = (ATOL if dtype == torch.float32 else BF16_ATOL) * max(
            1.0, float(want.float().abs().max()))
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), atol=atol)

    if dtype == torch.float32:
        with torch.no_grad():
            got = ops.fused_subband_lstm(x.to(cuda), *[{k: v.to(cuda) for k, v in l.items()}
                                                      for l in layers],
                                         None if fc is None else {k: v.to(cuda)
                                                                  for k, v in fc.items()})
            want = ops.fused_subband_lstm(x, *layers, fc)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


# Improved FullSubNet's stacks at its recipes' shapes: (F_in, H, OUT, rows
# of a B=16 step): the sections' units of (c + 30)·2 with a head of 2c at
# 16 kHz (c = 1, 4, 8) and 48 kHz (c = 1, 4, 20, 60), the full-band stacks
# over F = 256 and 480 bins
IMPROVED_STACKS = [(62, 384, 2, 320), (68, 384, 8, 240), (76, 384, 16, 352), (68, 384, 8, 400),
                   (100, 384, 40, 96), (180, 384, 120, 64), (256, 512, 256, 16),
                   (480, 512, 480, 16)]


@pytest.mark.parametrize("f_in, hidden, out_dim, rows", IMPROVED_STACKS)
def test_improved_stack_shapes_match_the_cpu(cuda, f_in, hidden, out_dim, rows):
    """Each stack as the recipe step runs it under ``use_amp``: bf16 weights
    over an fp32 input, so the fp32 stages (fwd_gemm, the fp32 training
    walk, the fp32 backward walk, the dW stage) and no tensor-core stage;
    the loss and every gradient on the card against the same op on the CPU.
    Then the inference forward (K1) at a B=1 step's rows (rows / 16) and at
    the step's rows, against the CPU."""
    t = 7
    rng = np.random.default_rng(f_in + out_dim)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, torch.device("cpu"))
    x = torch.from_numpy(rng.standard_normal((t, rows, f_in)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal((t, rows, out_dim)).astype(np.float32))

    def loss_and_grads(device):
        stack = [{k: v.to(device, torch.bfloat16).requires_grad_() for k, v in l.items()}
                 for l in layers]
        head = {k: v.to(device, torch.bfloat16).requires_grad_() for k, v in fc.items()}
        out = ops.fused_subband_lstm(x.to(device), *stack, head)
        loss = torch.sum(out * probe.to(device))
        leaves = [*(v for l in stack for v in l.values()), *head.values()]
        return out, torch.autograd.grad(loss, leaves)

    for kernel in (ops.tc_gemm, ops.fwd_gemm, ops.lstm_walk, ops.lstm_train_walk,
                   ops.lstm_walk_f32, ops.lstm_train_walk_f32, ops.dw_tma, ops.dw_gemm):
        kernel.reset_counts()
    out, grads = loss_and_grads(cuda)
    torch.cuda.synchronize()
    assert ops.tc_gemm.launches == ops.lstm_walk.launches == ops.lstm_train_walk.launches == 0
    assert dict(ops.lstm_train_walk_f32.launches_by_shape) == {(rows, hidden): 2}
    assert dict(ops.lstm_walk_f32.launches_by_shape) == {(rows, hidden): 2}
    assert ops.dw_tma.launches == 2 and ops.dw_gemm.launches == 0
    assert ops.fwd_gemm.launches_by_shape[(hidden, out_dim)] == 1
    want_out, want_grads = loss_and_grads(torch.device("cpu"))
    scale = float(want_out.abs().max())
    np.testing.assert_allclose(out.detach().cpu().numpy(), want_out.detach().numpy(),
                               atol=1e-5 * scale)
    for got, want in zip(grads, want_grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        # fp32 gradients an order of sums apart, each rounded to bf16: one
        # bf16 step (2^-8 of a value) apart at most
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(),
                                   atol=(2.0**-8 + 1e-5) * float(want.float().abs().max()))

    for n in (max(1, rows // 16), rows):
        xs = x[:, :n]
        with torch.no_grad():
            ops.lstm_fwd_walk.reset_counts()
            got = ops.fused_subband_lstm(xs.to(cuda), *[{k: v.to(cuda) for k, v in l.items()}
                                                       for l in layers],
                                         {k: v.to(cuda) for k, v in fc.items()})
            assert dict(ops.lstm_fwd_walk.launches_by_shape) == {(n, hidden): 2}
            want = ops.fused_subband_lstm(xs, *layers, fc)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("f_in, hidden, out_dim, n", [(257, 512, 257, 1), (32, 384, 2, 3 * 257),
                                                      (384, 257, 64, 2), (40, 64, 0, 5)])
def test_stateful_stack_step_matches_the_cpu(cuda, cell, f_in, hidden, out_dim, n):
    """The streaming engines' stack step (``fused_subband_lstm_step``) from
    random non-zero states, one frame and then a block of three, the state
    carried: the card (fwd_gemm and the cell's walk, H = 257 run at 272 with
    the state cut back to 257) against the CPU's plain stages, outputs and
    final states; the launches by shape."""
    rng = np.random.default_rng(f_in + n)
    layers, fc = _stack(rng, f_in, hidden, max(out_dim, 1), 2, torch.device("cpu"), cell)
    fc = fc if out_dim else None
    lstm = cell == "lstm"
    states = [(torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)),
               torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32)))
              for _ in range(2)]
    states = states if lstm else [h for h, _ in states]
    x = torch.from_numpy(np.abs(rng.standard_normal((4, n, f_in))).astype(np.float32))

    def run(device):
        stack = [{k: v.to(device) for k, v in l.items()} for l in layers]
        head = None if fc is None else {k: v.to(device) for k, v in fc.items()}
        st = [tuple(v.to(device) for v in s) if lstm else s.to(device) for s in states]
        outs = []
        with torch.inference_mode():
            for part in (x[:1], x[1:]):
                out, st = ops.fused_subband_lstm_step(part.to(device), *stack, head, states=st)
                outs.append(out)
        flat = [v for s in st for v in (s if lstm else (s,))]
        return [v.cpu() for v in (torch.cat(outs), *flat)]

    walk = ops.lstm_fwd_walk if lstm else ops.gru_fwd_walk
    for kernel in (ops.fwd_gemm, walk):
        kernel.reset_counts()
    got = run(cuda)
    torch.cuda.synchronize()
    want = run(torch.device("cpu"))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    width = ops.padded_hidden(hidden)
    assert dict(walk.launches_by_shape) == {(n, width): 4}
    assert ops.fwd_gemm.launches == 2 * (2 + (1 if out_dim else 0))


# -- K1-bf16: the inference forward on a bf16 x ------------------------------------------------

# K1-bf16 against its plain version: both round h to bf16 before each
# product and keep the sums and the state in fp32, but the sums run in
# another order, so an h value can land one bf16 step (2^-8 relative) away
# and the recurrence carries it on (measured at T = 200 on an H100: 4e-4)
K1_BF16_ATOL = 1e-2


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("form", ["cluster", "streaming", "tc"])
@pytest.mark.parametrize("hidden, n", [(512, 1), (512, 16), (384, 20), (384, 352), (384, 257)])
def test_k1_bf16_walk_matches_plain(cuda, cell, form, hidden, n):
    """The three forms of K1-bf16's walk at Improved FullSubNet's widths (the
    full-band stack at B = 1 and 16, a section at B = 1 and 16) and the
    flagship sub-band N = 257, as two chunks of 4 and 5 steps, the second
    from the first's fp32 state, against the plain walk over all 9: the
    bf16 h stream and the fp32 state after the last step."""
    rng = np.random.default_rng(hidden + n)
    p, w, state = _walk_operands(rng, cell, 9, n, hidden, cuda)
    w = w.to(torch.bfloat16)
    kernel, plain = ((ops.lstm_fwd_walk_bf16, ops.plain_lstm_fwd_walk_bf16) if cell == "lstm"
                     else (ops.gru_fwd_walk_bf16, ops.plain_gru_fwd_walk_bf16))
    kernel.reset_counts()
    first = kernel(p[:4], w, *state, form=form)
    nxt = first[1:] if cell == "lstm" else (state[0], first[1])
    second = kernel(p[4:], w, *nxt, form=form)
    torch.cuda.synchronize()
    assert dict(kernel.forms_by_shape) == {((n, hidden), form): 2}
    assert first[0].dtype == torch.bfloat16 and second[1].dtype == torch.float32
    want = plain(p, w, *state)
    _close(torch.cat([first[0], second[0]]), want[0], torch.bfloat16)
    for got, w_ in zip(second[1:], want[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), w_.cpu().numpy(), atol=K1_BF16_ATOL)


def _k1_bf16_walk(cell):
    return ((ops.lstm_fwd_walk_bf16, ops.plain_lstm_fwd_walk_bf16) if cell == "lstm"
            else (ops.gru_fwd_walk_bf16, ops.plain_gru_fwd_walk_bf16))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden", [384, 512])
@pytest.mark.parametrize("n", [1, 20, 130, 257, 1000])
def test_k1_bf16_tc_walk_matches_plain(cuda, cell, hidden, n):
    """The tensor-core walk (csrc/rnn_fwd_tc.cu) at its picked tiles, from a
    non-zero (h0, c0): N = 1 and 20 (one 16-row tile), 130 and 257 (ragged
    last tiles), 1000 (several tiles a cluster at H = 384, both cells, and
    at H = 512 for the GRU). Two chunks of 4 and 5 steps, the second from the
    first's fp32 state, against the plain walk over all 9 in one call: the
    bf16 h stream and the fp32 state; block 0's cycle counters filled."""
    rng = np.random.default_rng(3 * hidden + n)
    p, w, state = _walk_operands(rng, cell, 9, n, hidden, cuda)
    w = w.to(torch.bfloat16)
    kernel, plain = _k1_bf16_walk(cell)
    kernel.reset_counts()
    clocks = torch.zeros(3, dtype=torch.int64, device=cuda)
    first = kernel(p[:4], w, *state, form="tc", clocks=clocks)
    nxt = first[1:] if cell == "lstm" else (state[0], first[1])
    second = kernel(p[4:], w, *nxt, form="tc")
    torch.cuda.synchronize()
    assert dict(kernel.forms_by_shape) == {((n, hidden), "tc"): 2}
    assert bool((clocks > 0).all())  # the exchange, the product, the cell
    assert first[0].dtype == torch.bfloat16 and second[1].dtype == torch.float32
    want = plain(p, w, *state)
    got = torch.cat([first[0], second[0]])
    np.testing.assert_allclose(got.float().cpu().numpy(), want[0].float().cpu().numpy(),
                               atol=K1_BF16_ATOL)
    for g, w_ in zip(second[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w_.cpu().numpy(), atol=K1_BF16_ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden, rows, tiles", [
    (384, 16, 3), (384, 48, 2), (384, 80, 1), (512, 16, 3), (512, 32, 1), (128, 128, 3),
    (256, 48, 2), (256, 128, 1)])
def test_k1_bf16_tc_walk_tiles_match_plain(cuda, cell, hidden, rows, tiles):
    """The tensor-core walk at forced tiles at N = 130: bands of several
    tiles (one cluster's band cut short where the tiles run out: 48 rows x
    2 gives 3 tiles over 2 clusters), the largest tile that fits one to a
    cluster, and the narrow instances (H = 128, 256), against the plain walk
    over 7 steps in one call; a tile that does not fit is refused."""
    n = 130
    rng = np.random.default_rng(rows + tiles + hidden)
    p, w, state = _walk_operands(rng, cell, 7, n, hidden, cuda)
    w = w.to(torch.bfloat16)
    kernel, plain = _k1_bf16_walk(cell)
    if tiles > ops.fwd_tc_max_tiles(rows, hidden, cell):
        with pytest.raises(ValueError, match="tiles"):
            kernel(p, w, *state, form="tc", rows=rows, tiles=tiles)
        return
    got = kernel(p, w, *state, form="tc", rows=rows, tiles=tiles)
    torch.cuda.synchronize()
    want = plain(p, w, *state)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(), w_.float().cpu().numpy(),
                                   atol=K1_BF16_ATOL)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hidden, n", [(512, 1), (384, 20), (384, 320), (384, 2056)])
def test_k1_bf16_walk_dispatch_follows_the_picker(cuda, cell, hidden, n):
    """The walk called without a form (as the registered operators call it)
    launches the form :func:`pick_fwd_bf16_form` names for the shape on this
    card, and that form's result."""
    rng = np.random.default_rng(n)
    p, w, state = _walk_operands(rng, cell, 3, n, hidden, cuda)
    w = w.to(torch.bfloat16)
    kernel, plain = _k1_bf16_walk(cell)
    form, _ = kernel.form(n, hidden, cuda)
    kernel.reset_counts()
    got = kernel(p, w, *state)
    torch.cuda.synchronize()
    assert dict(kernel.forms_by_shape) == {((n, hidden), form): 1}
    for g, w_ in zip(got, plain(p, w, *state)):
        np.testing.assert_allclose(g.float().cpu().numpy(), w_.float().cpu().numpy(),
                                   atol=K1_BF16_ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("f_in, hidden, out_dim, n, chunk", [
    (256, 512, 256, 1, None), (62, 384, 2, 20, 7), (76, 384, 16, 352, None)])
def test_k1_bf16_forward_matches_plain(cuda, cell, f_in, hidden, out_dim, n, chunk):
    """fused_subband_lstm on a bf16 CUDA tensor without autograd (and
    fused_forward in chunks, the input width padded as the main path pads
    it): tc_gemm and the bf16 walk alone, never the fp32 K1, against the
    plain version of K1-bf16; and within the bf16 rounding of the fp32 K1
    on the same input."""
    t = 20
    rng = np.random.default_rng(n + hidden)
    layers, fc = _stack(rng, f_in, hidden, out_dim, 2, cuda, cell.lower())
    x = _f32(rng, t, n, f_in, device=cuda).abs().to(torch.bfloat16)
    walk = ops.lstm_fwd_walk_bf16 if cell == "LSTM" else ops.gru_fwd_walk_bf16
    kernels = (ops.tc_gemm, walk, ops.fwd_gemm, ops.lstm_fwd_walk, ops.gru_fwd_walk)
    for kernel in kernels:
        kernel.reset_counts()
    with torch.no_grad():
        if chunk:
            xp, lp = ops.pad_input(x, layers, ops.TC_INPUT_MULTIPLE)
            got = ops.fused_forward(xp, lp, fc, chunk)
        else:
            got = ops.fused_subband_lstm(x, *layers, fc)
        torch.cuda.synchronize()
        chunks = -(-t // (chunk or t))
        assert [k.launches for k in kernels] == [chunks * 3, chunks * 2, 0, 0, 0]
        want = ops.plain_fused_forward(x, layers, fc)
        fp32 = ops.fused_subband_lstm(x.float(), *layers, fc)
    assert got.dtype == torch.float32 and got.shape == (t, n, out_dim)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=K1_BF16_ATOL)
    np.testing.assert_allclose(got.cpu().numpy(), fp32.cpu().numpy(), atol=5 * K1_BF16_ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_improved_compute_dtype_launches_k1_bf16(cuda, cell):
    """Improved FullSubNet with compute_dtype at small widths on the card:
    every stack's no-grad forward runs K1-bf16 (tc_gemm and the bf16 walk)
    and none of the fp32 K1; the waveform against the CPU's plain path."""
    from fullsubnet_tpu_torch.models import ImprovedFullSubNet

    model = ImprovedFullSubNet(
        n_fft=64, hop_length=16, win_length=64, num_freqs=33, freq_cutoffs=(8, 16),
        sb_num_center_freqs=(1, 2, 4), sb_num_neighbor_freqs=(3, 3, 3),
        fb_num_center_freqs=(1, 2, 4), fb_num_neighbor_freqs=(3, 3, 3), fb_hidden_size=32,
        sb_hidden_size=16, sequence_model=cell, compute_dtype="bfloat16").eval()
    y = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 1600)).astype(np.float32))
    walk = ops.lstm_fwd_walk_bf16 if cell == "LSTM" else ops.gru_fwd_walk_bf16
    kernels = (ops.tc_gemm, walk, ops.fwd_gemm, ops.lstm_fwd_walk, ops.gru_fwd_walk)
    for kernel in kernels:
        kernel.reset_counts()
    with torch.inference_mode():
        got = model.to(cuda)(y.to(cuda)).cpu()
        torch.cuda.synchronize()
        assert [k.launches for k in kernels] == [4 * 3, 4 * 2, 0, 0, 0]
        want = model.cpu()(y)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=K1_BF16_ATOL * float(want.abs().max()))


def test_k1_bf16_wrappers_refuse_bad_operands(cuda):
    """The bf16 walk takes a bf16 W_hh and fp32 P and states; the fp32 walk
    has no streaming form and refuses a bf16 W_hh; nothing falls back."""
    rng = np.random.default_rng(0)
    p, w, state = _walk_operands(rng, "lstm", 3, 5, 64, cuda)
    for kernel in (ops.lstm_fwd_walk_bf16, ops.lstm_fwd_walk, ops.fwd_gemm):
        kernel.reset_counts()
    with pytest.raises(TypeError):
        ops.lstm_fwd_walk_bf16(p, w, *state)  # fp32 W_hh
    with pytest.raises(TypeError):
        ops.lstm_fwd_walk_bf16(p, w.to(torch.bfloat16), state[0].to(torch.bfloat16), state[1])
    with pytest.raises(TypeError):
        ops.lstm_fwd_walk(p, w.to(torch.bfloat16), *state)
    with pytest.raises(ValueError):
        ops.lstm_fwd_walk(p, w, *state, form="streaming")
    with pytest.raises(TypeError):
        ops.fwd_gemm(p[0].to(torch.bfloat16), w)
    assert ops.lstm_fwd_walk_bf16.launches == ops.lstm_fwd_walk.launches == ops.fwd_gemm.launches == 0
