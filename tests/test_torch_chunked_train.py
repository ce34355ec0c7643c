"""The port's time-chunked training stash against the JAX package on the
CPU: the chunk picker against ``_pick_chunk``; the loss and gradients of
``fused_subband_lstm(..., time_chunk=8)`` (``ChunkedRnnScanFunction``:
K1's plain stages chunk by chunk forward, K2's re-run from each chunk's
boundary state and K3/K4 with their carries chained backward) against
``jax.value_and_grad`` of ``fused_subband_lstm_train(..., time_chunk=8)``
in interpret mode (``_bwd_chunked``), at fp32 and bf16; and the chunked
result against the port's own unchunked one, the chunk forced by a tiny
``stash_budget``. Same numpy-seeded weights and inputs on both sides.

The chunked route on the card is held in tests/test_torch_kernel_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.ops.subband_lstm import _pick_chunk, fused_subband_lstm_train
from fullsubnet_tpu_torch.ops import subband_lstm as ops

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 gradients against the JAX VJP: the tolerance of the JAX package's own
# chunked-VJP tests (tests/test_pallas_subband.py), as
# tests/test_torch_ops_train.py holds the unchunked op
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# bf16: each gradient within this share of its largest magnitude. The
# gradients of the bf16 weights and x come back through their bf16 casts, so
# each is rounded to bf16 (2^-8 relative); fp32 sums of the same bf16
# products in another order put a value on the other side of a rounding
# boundary, one bf16 step apart, and the recurrence carries it on. Four
# steps of the largest (measured on these cases: 7.2e-3 at most)
BF16_GRAD_RTOL = 2.0**-6
# the loss of a bf16 call against the JAX one (tests/test_torch_improved_
# fullsubnet.py's AMP_VS_JAX_LOSS_RTOL; measured: 8.9e-5 at most)
BF16_LOSS_RTOL = 1e-3
# the port's chunked gradients against its unchunked ones: equal at fp32 up
# to the order of the sums; at bf16 the backward's re-run restarts from the
# boundary states rounded to bf16 (as the JAX kernel's boundary stash is),
# so its stash strays from the forward's trajectory by a bf16 step there,
# which the recurrence carries on: BF16_GRAD_RTOL (measured: 5.2e-3 at most)
CHUNK_F32_RTOL = 1e-5

GATES = {"lstm": 4, "gru": 3}
KERNELS = ("tc_gemm", "fwd_gemm", "lstm_fwd_walk", "gru_fwd_walk", "lstm_fwd_walk_bf16",
           "gru_fwd_walk_bf16", "lstm_train_walk", "gru_train_walk", "lstm_train_walk_f32",
           "gru_train_walk_f32", "lstm_walk", "gru_walk", "lstm_walk_f32", "gru_walk_f32",
           "dw_gemm", "dw_tma")


def _stack(rng, cell, num_layers, f_in, hidden, out_dim):
    """numpy layer dicts (torch layout) and a head [out_dim, H], U(±1/sqrt(H));
    ``out_dim`` 0: the identity head, which stands for a head-less stack on
    the JAX side (its op always has a head)."""
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    layers, in_dim = [], f_in
    for _ in range(num_layers):
        layers.append({"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh),
                       "b_hh": u(gh)})
        in_dim = hidden
    if out_dim == 0:
        return layers, {"weight": np.eye(hidden, dtype=np.float32),
                        "bias": np.zeros(hidden, np.float32)}
    return layers, {"weight": u(out_dim, hidden), "bias": u(out_dim)}


def _jax_loss_and_grads(layers, fc, x, target, dtype, time_chunk):
    """jit(value_and_grad) of the mean squared error of the JAX op in
    interpret mode; the weights cast to ``dtype`` inside the loss, so the
    gradients come back fp32, as the port's bf16 copies hand theirs to fp32
    leaves."""
    def loss(params, xj):
        stack, head = params
        cast = lambda d: {k: v.astype(dtype) for k, v in d.items()}  # noqa: E731
        out = fused_subband_lstm_train(xj.astype(dtype), *[cast(l) for l in stack], cast(head),
                                       row_tile=8, interpret=True, time_chunk=time_chunk)
        return jnp.mean(jnp.square(out - target))

    val, (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        (jax.tree.map(jnp.asarray, layers), jax.tree.map(jnp.asarray, fc)), jnp.asarray(x))
    grads = [np.asarray(g[k]) for g in g_params[0] for k in layers[0]]
    grads += [np.asarray(g_params[1][k]) for k in fc]
    return float(val), grads + [np.asarray(g_x)]


def _torch_loss_and_grads(layers, fc, x, target, dtype, headless=False, **chunking):
    """The port's op under autograd on fp32 leaves cast to ``dtype``; a
    head-less stack passes no head. Returns (loss, grads in the order of
    ``_jax_loss_and_grads``, the head's omitted when head-less)."""
    stack = [{k: torch.from_numpy(v).requires_grad_() for k, v in l.items()} for l in layers]
    head = {k: torch.from_numpy(v).requires_grad_() for k, v in fc.items()}
    xt = torch.from_numpy(x).requires_grad_()
    cast = lambda d: {k: v.to(dtype) for k, v in d.items()}  # noqa: E731
    out = ops.fused_subband_lstm(xt.to(dtype), *[cast(l) for l in stack],
                                 None if headless else cast(head), **chunking)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    leaves = [v for l in stack for v in l.values()] + ([] if headless else list(head.values()))
    grads = torch.autograd.grad(loss, [*leaves, xt])
    return float(loss.detach()), [g.numpy() for g in grads]


def _close_to_max(got, want, rtol):
    for g, w in zip(got, want, strict=True):
        scale = float(np.max(np.abs(w))) or 1.0
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0)


@pytest.mark.parametrize("t", [8, 17, 192, 195, 1878, 1880])
@pytest.mark.parametrize("n, hidden, cell, itemsize, num_layers", [
    (128, 384, "lstm", 2, 2), (16384, 384, "lstm", 2, 2), (32768, 384, "lstm", 2, 2),
    (4096, 384, "gru", 4, 2), (72, 512, "lstm", 4, 3), (13, 16, "gru", 2, 1)])
@pytest.mark.parametrize("budget", [4096, 2**30, 6 * 2**30, 16 * 2**30])
def test_pick_chunk_matches_jax(t, n, hidden, cell, itemsize, num_layers, budget):
    """``pick_chunk`` on the JAX package's per-step bytes (its stash alone,
    every layer's h and the LSTM's c) picks what ``_pick_chunk`` picks, over
    a grid that takes in tests/test_pallas_subband.py::test_pick_chunk_bounds'
    shapes (T = 192 and 1,880; N = 128, 16,384, 32,768 rows of H = 384 at
    bf16 under 6 GiB)."""
    per_step = (2 if cell == "lstm" else 1) * num_layers * n * hidden * itemsize
    want = _pick_chunk(t, n, hidden, cell, itemsize, budget, num_layers)
    assert ops.pick_chunk(t, per_step, budget) == want


def test_training_accounting():
    """The port's accounting: the stash and the backward's transients a step;
    0 while T steps of them fit the budget, and chunked above it under the
    budget where the √T minimum allows; the unchunked peak above the chunked
    one; the flagship's bf16 sub-band stage at B = 32 x 30 s (N = 4,096 after
    drop_band, T = 1,878) chunked under FullSubNet's share of an H100 80GB,
    and at B = 32 x 3.072 s (T = 195, bf16 and fp32) not."""
    stash, per_step = ops.train_step_bytes(4096, 384, "lstm", 2, 2)
    assert stash == 4 * 4096 * 384 * 2
    assert per_step == stash + 4096 * 384 * (2 + 16 + 8)
    gru_stash, gru_step = ops.train_step_bytes(4096, 384, "gru", 4, 2)
    assert gru_stash == 2 * 4096 * 384 * 4 and gru_step == gru_stash + 4096 * 384 * (4 + 16 + 24)
    sub_band = ops.stash_budget_bytes(10.5 / 16)
    assert ops.train_chunk(195, 4096, 384, "lstm", 2, 2, sub_band) == 0
    assert ops.train_chunk(195, 4096, 384, "lstm", 4, 2, sub_band) == 0
    k = ops.train_chunk(1878, 4096, 384, "lstm", 2, 2, sub_band)
    assert k % 8 == 0 and 8 <= k < 1878
    peak = ops.train_bwd_peak_bytes(1878, 4096, 384, 32, 2, "lstm", 2, sub_band, 2)
    assert peak <= sub_band < ops.train_bwd_peak_bytes(1878, 4096, 384, 32, 2, "lstm", 2,
                                                       sub_band, 2, time_chunk=0)
    chunks = -(-1878 // k)
    assert ops.train_stash_bytes(1878, 4096, 384, "lstm", 2, sub_band, 2) == \
        (chunks - 1 + k) * stash
    assert ops.train_stash_bytes(195, 4096, 384, "lstm", 2, sub_band, 2) == 195 * stash
    # the card's budget is a share of its memory; a CPU tensor's of an H100's
    assert ops.stash_budget_bytes(0.5, "cpu") == ops.CPU_CARD_BYTES // 2


CASES = [  # (cell, layers, head, T, N, dtype)
    ("lstm", 1, True, 29, 16, "float32"), ("lstm", 2, True, 17, 13, "float32"),
    ("lstm", 3, True, 29, 16, "float32"), ("gru", 1, True, 17, 13, "float32"),
    ("gru", 2, True, 29, 16, "float32"), ("gru", 3, True, 17, 13, "float32"),
    ("lstm", 2, False, 17, 13, "float32"), ("gru", 2, False, 29, 16, "float32"),
    ("lstm", 2, True, 29, 16, "bfloat16"), ("gru", 3, True, 17, 13, "bfloat16"),
    ("lstm", 1, False, 17, 13, "bfloat16"), ("gru", 2, False, 29, 16, "bfloat16"),
]


@pytest.mark.parametrize("cell, num_layers, head, t, n, dtype", CASES)
def test_chunked_grads_match_jax(cell, num_layers, head, t, n, dtype):
    """At ``time_chunk`` = 8 (T = 29: chunks of 8, 8, 8 and 5 steps; T = 17:
    8, 8 and 1) the loss and every gradient of the port's op against the
    JAX package's chunked VJP. A head-less stack is held to the JAX op with
    an identity head: its output is then the top layer's h in fp32 and the
    head's backward hands the cotangent, cast to the compute dtype, to the
    top layer, as the port's head-less backward does."""
    rng = np.random.default_rng(t * 10 + num_layers)
    f_in, hidden = 8, 16
    layers, fc = _stack(rng, cell, num_layers, f_in, hidden, 2 if head else 0)
    x = rng.standard_normal((t, n, f_in)).astype(np.float32)
    target = rng.standard_normal((t, n, 2 if head else hidden)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_loss, want = _jax_loss_and_grads(layers, fc, x, target, jdt, 8)
    ops.train_chunks.clear()
    got_loss, got = _torch_loss_and_grads(layers, fc, x, target, tdt, headless=not head,
                                          time_chunk=8)
    assert ops.train_chunks == {8: 1}
    if not head:
        want = want[:-3] + want[-1:]  # the identity head's gradients are not the stack's
    if dtype == "float32":
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    else:
        np.testing.assert_allclose(got_loss, want_loss, rtol=BF16_LOSS_RTOL)
        _close_to_max(got, want, BF16_GRAD_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers, head", [(1, True), (2, False), (3, True)])
def test_chunked_equals_unchunked(cell, num_layers, head, dtype):
    """A stash budget of 4 KiB forces the op's own pick to chunk (the √T
    minimum, 8 steps at T = 29); its loss equals the full stash's (the
    forward is one uninterrupted pass either way) and its gradients match.
    On the CPU neither route launches a kernel."""
    rng = np.random.default_rng(num_layers)
    layers, fc = _stack(rng, cell, num_layers, 8, 16, 2 if head else 0)
    x = rng.standard_normal((29, 16, 8)).astype(np.float32)
    target = rng.standard_normal((29, 16, 2 if head else 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    for name in KERNELS:
        getattr(ops, name).reset_counts()
    ops.train_chunks.clear()
    full_loss, full = _torch_loss_and_grads(layers, fc, x, target, tdt, headless=not head,
                                            time_chunk=0)
    got_loss, got = _torch_loss_and_grads(layers, fc, x, target, tdt, headless=not head,
                                          stash_budget=4096)
    assert ops.train_chunks == {0: 1, 8: 1}
    assert got_loss == full_loss
    _close_to_max(got, full, CHUNK_F32_RTOL if dtype == "float32" else BF16_GRAD_RTOL)
    assert [getattr(ops, name).launches for name in KERNELS] == [0] * len(KERNELS)


def test_time_chunk_refusals():
    """``time_chunk`` keeps the JAX package's meaning: a multiple of 8 steps,
    0 the full stash."""
    rng = np.random.default_rng(0)
    layers, fc = _stack(rng, "lstm", 1, 4, 8, 2)
    stack = [{k: torch.from_numpy(v).requires_grad_() for k, v in l.items()} for l in layers]
    x = torch.zeros(9, 3, 4)
    for bad in (5, -8):
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.fused_subband_lstm(x, *stack, {k: torch.from_numpy(v) for k, v in fc.items()},
                                   time_chunk=bad)
