"""K1's bf16 instance (K1-bf16: the inference forward on a bf16 x, the JAX
kernel's ``compute_dtype = x.dtype``) and the path that runs it, Improved
FullSubNet's ``compute_dtype``, against the JAX package on the same weights:
the plain stages of K1-bf16 against the Pallas kernel in interpret mode on
a bf16 x, in chunks and from carried states; the walk's bf16 tiles and its
form picker; the registered operators at bf16; the model against the JAX
model with its stacks routed through the interpret-mode kernels (a
monkeypatch inside the test: the JAX package takes its kernels only on a
TPU) and against the JAX CPU route; the TOML string; served against live;
the streaming engine; the train step against the JAX Trainer's. The JAX
references run under ``jax.jit``. The kernels run only on a card:
tests/test_torch_kernel_cuda.py."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullsubnet_tpu.models.improved_fullsubnet as jax_improved_module
import fullsubnet_tpu.nn.sequence_model as jax_sequence_model
import fullsubnet_tpu.ops.subband_lstm as jax_ops
from fullsubnet_tpu.config import build_loss as jax_build_loss
from fullsubnet_tpu.config import build_model as jax_build_model
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.models import ImprovedFullSubNet as JaxImprovedFullSubNet
from fullsubnet_tpu_torch import serving
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.config import build_model, load_config
from fullsubnet_tpu_torch.infer.inferencer import Inferencer
from fullsubnet_tpu_torch.infer.streaming import StreamingImprovedFullSubNet
from fullsubnet_tpu_torch.models import ImprovedFullSubNet
from fullsubnet_tpu_torch.models.improved_fullsubnet import _compute_dtype
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.ops import subband_lstm as ops
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_baselines import jax_forward, model_section, with_model
from test_torch_fwd_stages import _stack, _torch
from test_torch_improved_fullsubnet import (
    LAYOUTS,
    SMALL,
    _grads_by_key,
    _improved,
    _jax_waveform_loss_fn,
    _waves,
)
from test_torch_serving import FAMILIES as SERVING_FAMILIES
from test_torch_serving import LIVE_ATOL, noisy_wave
from test_torch_train import BF16_VS_FP32_GRAD_RTOL, _close_by_key, write_config
from test_torch_train_fwd_stages import BF16_ATOL

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# K1-bf16's plain stages against the Pallas kernel on a bf16 x: both round
# the weights, x and each h to bf16 and sum in fp32, in another order; most
# outputs agree within 3e-8, and an h value that lands one bf16 step away
# moves an output by up to 7.4e-5 (measured over 12 seeds and T = 5, 7; the
# fp32 forward is 3e-4 to 1.4e-3 away). Tighter than BF16_ATOL, the bf16
# training forward's.
K1_BF16_ATOL = 1e-4
assert K1_BF16_ATOL <= BF16_ATOL
# the same plain stages cut into other chunks: the carries stay fp32, so
# only the GEMMs' blocking over Tc·N rows may move a sum
CHUNK_ATOL = 1e-6
# Improved FullSubNet with compute_dtype against the JAX model with its
# stacks on the interpret-mode kernels, every section at 128 rows or more
# (the JAX kernel route): the waveform within 2e-5 (2.8e-6 measured, the
# norm's bf16 arithmetic in XLA's order; the fp32 model is 7.7e-5 away)
MODEL_ATOL = 2e-5
# with valid_samples the masked norm's fp32 count promotes the normalised
# input to fp32 in both packages, so the stacks compute at fp32 after the
# bf16-rounded magnitude: the fp32 tests' bound (9e-9 measured)
VALID_ATOL = 1e-5
# against the JAX CPU route (its scan, which with a bf16 compute_dtype runs
# only on bf16 weights: its state is then bf16 too, where the kernels keep
# it fp32): 1.3e-4 of a 0.037 peak measured
CPU_ROUTE_ATOL = 5e-4
# the train step against the JAX step on the interpret-mode kernels: the
# loss within 1e-3 (2.8e-5 measured); the gradients within
# BF16_VS_FP32_GRAD_RTOL of each tensor's largest (1.2e-2 measured, 1.5e-2
# under use_amp: below 128 section rows the JAX sections round their output
# to bf16, the port's kernel route keeps it fp32)
STEP_LOSS_RTOL = 1e-3
# a compute_dtype model's waveform against the fp32 model's on the same
# weights, as a share of the peak: the bf16 roundings of the magnitude, the
# weights and each h (1.6e-3 here; 3.8e-3 at the 16 kHz recipe's width on
# an H100)
BF16_VS_FP32_WAVE_RTOL = 2e-2

BF16 = torch.bfloat16


def _bf16_input(rng, t, n, f_in):
    """x rounded to bf16, as numpy fp32 (for JAX) and as a torch bf16."""
    x = np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32)
    xt = torch.from_numpy(x).to(BF16)
    return xt.float().numpy(), xt


def _jnp_stack(layers, fc):
    return ([{k: jnp.asarray(v) for k, v in l.items()} for l in layers],
            {k: jnp.asarray(v) for k, v in fc.items()})


# --------------------------------------------------------------------------
# the stages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_k1_bf16_matches_pallas_interpret(cell, num_layers):
    """The plain stages at bf16 (plain_tc_gemm and the bf16 walk), three
    chunks of 2 steps, against the Pallas kernel on the same bf16 x in
    interpret mode. N = 37 and T = 5 are ragged against the TPU tiles and
    the chunks; the output is fp32."""
    t, n, f_in, hidden, out_dim = 5, 37, 12, 32, 3
    rng = np.random.default_rng(20 + num_layers)
    layers, fc = _stack(rng, f_in, hidden, out_dim, num_layers, cell)
    x, xt = _bf16_input(rng, t, n, f_in)
    jl, jfc = _jnp_stack(layers, fc)
    want = jax.jit(lambda v: jax_ops.fused_subband_lstm(v, *jl, jfc, row_tile=8, interpret=True))(
        jnp.asarray(x).astype(jnp.bfloat16))
    got = ops.plain_fused_forward(xt, *_torch(layers, fc), chunk=2)
    assert got.shape == (t, n, out_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K1_BF16_ATOL)
    fp32 = ops.plain_fused_forward(torch.from_numpy(x), *_torch(layers, fc))
    assert float((fp32 - got).abs().max()) > 2 * K1_BF16_ATOL  # the test sees bf16


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_chunks_carry_fp32_states(cell):
    """Chunks of 1, 2 and T steps against one pass: the carries between
    chunks are the fp32 (h, c), not the bf16 stream's last row (the JAX
    kernel rounds nothing at a chunk boundary). Two walks from the first's
    state equal one walk exactly; for the GRU, whose z·h reads the fp32 h,
    carrying the rounded h would not."""
    t, n, f_in, hidden, out_dim = 6, 9, 8, 16, 2
    rng = np.random.default_rng(cell == "gru")
    layers, fc = _torch(*_stack(rng, f_in, hidden, out_dim, 2, cell))
    _, x = _bf16_input(rng, t, n, f_in)
    one_pass = ops.plain_fused_forward(x, layers, fc)
    for chunk in (1, 2, t):
        np.testing.assert_allclose(ops.plain_fused_forward(x, layers, fc, chunk).numpy(),
                                   one_pass.numpy(), atol=CHUNK_ATOL)
    layer = layers[0]
    p = ops.plain_tc_gemm(x.reshape(t * n, f_in), layer["w_ih"].t().to(BF16),
                          layer["b_ih"]).view(t, n, -1)
    w = layer["w_hh"].to(BF16)
    h0 = torch.zeros(n, hidden)
    if cell == "lstm":
        whole = ops.plain_lstm_fwd_walk_bf16(p, w, h0, h0)
        first = ops.plain_lstm_fwd_walk_bf16(p[:3], w, h0, h0)
        second = ops.plain_lstm_fwd_walk_bf16(p[3:], w, *first[1:])
    else:
        whole = ops.plain_gru_fwd_walk_bf16(p, w, layer["b_hh"], h0)
        first = ops.plain_gru_fwd_walk_bf16(p[:3], w, layer["b_hh"], h0)
        second = ops.plain_gru_fwd_walk_bf16(p[3:], w, layer["b_hh"], first[1])
        rounded = ops.plain_gru_fwd_walk_bf16(p[3:], w, layer["b_hh"], first[0][-1].float())
        assert not torch.equal(rounded[1], whole[1])
    assert whole[0].dtype == BF16 and all(v.dtype == torch.float32 for v in whole[1:])
    assert torch.equal(torch.cat([first[0], second[0]]), whole[0])
    for a, b in zip(second[1:], whole[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_step_from_carried_states(cell):
    """fused_subband_lstm_step on a bf16 x from fp32 states (the registered
    operators, plain on the CPU) against the plain stages from the same
    states, and two steps against one block of both frames; the states come
    back fp32."""
    n, f_in, hidden, out_dim = 7, 10, 16, 4
    rng = np.random.default_rng(5)
    layers, fc = _torch(*_stack(rng, f_in, hidden, out_dim, 2, cell))
    _, x = _bf16_input(rng, 2, n, f_in)

    def state():
        return torch.from_numpy(rng.uniform(-0.5, 0.5, (n, hidden)).astype(np.float32))

    states = [(state(), state()) if cell == "lstm" else state() for _ in layers]
    with torch.inference_mode():
        block, final = ops.fused_subband_lstm_step(x, *layers, fc, states=states)
        first, mid = ops.fused_subband_lstm_step(x[:1], *layers, fc, states=states)
        second, final2 = ops.fused_subband_lstm_step(x[1:], *layers, fc, states=mid)
    walk = ops.plain_lstm_fwd_walk_bf16 if cell == "lstm" else ops.plain_gru_fwd_walk_bf16
    want, want_final = ops.step_stages(ops.plain_tc_gemm, walk, x, layers, fc, states, hidden)
    assert block.dtype == torch.float32
    np.testing.assert_allclose(block.numpy(), want.numpy(), atol=CHUNK_ATOL)
    np.testing.assert_allclose(torch.cat([first, second]).numpy(), block.numpy(),
                               atol=CHUNK_ATOL)
    flat = lambda sts: [v for s in sts for v in (s if cell == "lstm" else (s,))]  # noqa: E731
    for a, b, c in zip(flat(final), flat(want_final), flat(final2)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=CHUNK_ATOL)
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=CHUNK_ATOL)


def test_bf16_walk_tiles_and_forms():
    """The bf16 cluster walk's shared memory (rnn_fwd.cu, walk_smem with a
    2-byte storage type), its tiles without register rows (the LSTM's W_hh^T
    at H = 512 takes 128 KB a CTA, 32 rows fit, 40 do not), and the form
    picker at Improved FullSubNet's shapes with 7 clusters in flight."""
    assert ops.fwd_walk_kr(16, 512, "lstm") == ops.FWD_REG_ROWS  # fp32: registers
    assert ops.fwd_walk_kr(16, 512, "lstm", BF16) == 0
    assert ops.fwd_walk_kr(32, 512, "lstm", BF16) == 0
    assert ops.fwd_walk_kr(40, 512, "lstm", BF16) is None
    assert ops.fwd_walk_smem_bytes(32, 512, "lstm", 0, BF16) == 217_088
    assert ops.fwd_walk_smem_bytes(40, 384, "lstm", 0, BF16) == 154_368
    assert ops.fwd_walk_smem_bytes(8, 384, "gru", 0, BF16) == 2 * (4 * 96 * 72 + 2 * 8 * 24) \
        + 4 * 4 * 8 * 72 + 4 * (8 * 72 + 72)
    # fp32 unchanged: floats of W beyond KR, h, the slice, P and b_hh
    assert ops.fwd_walk_smem_bytes(8, 384, "gru", 0) == 4 * (4 * 96 * 72 + 8 * 384 + 2 * 8 * 24
                                                             + 8 * 72 + 72)
    assert ops.pick_fwd_tile(1, 512, "lstm", 7, BF16) == (1, 0)
    assert ops.pick_fwd_tile(16, 512, "lstm", 7, BF16) == (4, 0)
    assert ops.pick_fwd_tile(352, 384, "lstm", 7, BF16) == (40, 0)
    # where the tensor-core walk takes H (128, 256, 384, 512): the forms
    # over the rows FWD_BF16_FORM_BOUNDS gives (at H = 384 the cluster walk
    # to 13 rows, the tensor-core walk at its planned tile to 2,896, the
    # streaming walk to 4,096, the tensor-core walk again to 5,793 (LSTM),
    # the streaming walk above); elsewhere the cluster walk, or the
    # streaming walk where the widest cluster tile needs a third wave
    pick = ops.pick_fwd_bf16_form
    assert pick(22, 384, "lstm", 7) == ("tc", 16)
    assert pick(352, 384, "gru", 7) == ("tc", 64)
    assert pick(560, 384, "lstm", 7) == ("tc", 80)
    assert pick(561, 384, "lstm", 7) == ("tc", 48)
    assert pick(2056, 384, "lstm", lambda form, rows: 7) == ("tc", 64)
    assert pick(13, 384, "gru", 7) == ("cluster", 2)
    assert pick(14, 384, "gru", 7) == ("tc", 16)
    assert pick(2896, 384, "lstm", 7) == ("tc", 64)
    assert pick(2897, 384, "lstm", 7) == ("streaming", 32)
    assert pick(4097, 384, "lstm", 7) == ("tc", 64)
    assert pick(5794, 384, "lstm", 7) == ("streaming", 32)
    assert pick(448, 512, "lstm", 7) == ("tc", 16)
    assert pick(449, 512, "lstm", 7) == ("tc", 16)
    assert pick(1723, 512, "lstm", 7) == ("streaming", 16)
    assert pick(7, 512, "gru", 7) == ("cluster", 1)
    assert pick(8, 512, "gru", 7) == ("tc", 16)
    assert pick(300, 128, "gru", 7) == ("streaming", 16)  # never the tensor-core walk
    with pytest.raises(ValueError, match="H = 528"):  # no form takes it
        pick(10_000, 528, "lstm", 7)
    assert pick(560, 320, "lstm", 7) == ("cluster", 40)
    assert pick(561, 320, "lstm", 7) == ("streaming", 16)
    assert pick(22, 320, "gru", 7) == ("cluster", 4)


# pick_fwd_bf16_form with 7 clusters in flight (the H100's count for every
# form here): (form, rows) by (N, H, cell)
BF16_FORMS = {
    (1, 384, "lstm"): ("cluster", 1), (22, 384, "lstm"): ("tc", 16),
    (240, 384, "lstm"): ("tc", 48), (257, 384, "lstm"): ("tc", 48),
    (352, 384, "lstm"): ("tc", 64), (1280, 384, "lstm"): ("tc", 64),
    (2056, 384, "lstm"): ("tc", 64), (4096, 384, "lstm"): ("streaming", 32),
    (8224, 384, "lstm"): ("streaming", 32),
    (1, 384, "gru"): ("cluster", 1), (22, 384, "gru"): ("tc", 16),
    (240, 384, "gru"): ("tc", 48), (257, 384, "gru"): ("tc", 48),
    (352, 384, "gru"): ("tc", 64), (1280, 384, "gru"): ("tc", 64),
    (2056, 384, "gru"): ("tc", 112), (4096, 384, "gru"): ("streaming", 32),
    (8224, 384, "gru"): ("streaming", 32),
    (1, 512, "lstm"): ("cluster", 1), (22, 512, "lstm"): ("tc", 16),
    (240, 512, "lstm"): ("tc", 16), (257, 512, "lstm"): ("tc", 16),
    (352, 512, "lstm"): ("tc", 16), (1280, 512, "lstm"): ("tc", 16),
    (2056, 512, "lstm"): ("streaming", 16), (4096, 512, "lstm"): ("streaming", 32),
    (8224, 512, "lstm"): ("streaming", 32),
    (1, 512, "gru"): ("cluster", 1), (22, 512, "gru"): ("tc", 16),
    (240, 512, "gru"): ("tc", 48), (257, 512, "gru"): ("tc", 48),
    (352, 512, "gru"): ("tc", 64), (1280, 512, "gru"): ("tc", 64),
    (2056, 512, "gru"): ("tc", 64), (4096, 512, "gru"): ("tc", 64),
    (8224, 512, "gru"): ("tc", 64),
}


@pytest.mark.parametrize("n, hidden, cell", sorted(BF16_FORMS))
def test_pick_fwd_bf16_form(n, hidden, cell):
    """The bf16 walk's form and rows by shape (FWD_BF16_FORM_BOUNDS): the
    cluster walk at N = 1, the tensor-core walk from 22 rows (one tile a
    cluster as small as covers N in one wave: 48 rows for N = 240-320 over
    7 clusters, 64 for 352; past one wave, waves of 64-row tiles (LSTM) or
    bands of 3 x 64 (GRU) at N = 1,280, waves of 64 or 112 rows at 2,056;
    at H = 512 the LSTM's W_hh rows leave room for 16-row tiles only), the
    streaming walk at 4,096 and 8,224 rows (32-row blocks), and at H = 512
    past 1,722 rows for the LSTM (16-row blocks at 2,056), never for the GRU.
    The tensor-core plan behind a "tc" pick, and the callable form of
    max_clusters, agree."""
    want = BF16_FORMS[n, hidden, cell]
    assert ops.pick_fwd_bf16_form(n, hidden, cell, 7) == want
    assert ops.pick_fwd_bf16_form(n, hidden, cell, lambda form, rows: 7) == want
    if want[0] == "tc":
        rows, tiles = ops.fwd_tc_plan(n, hidden, cell, 7)
        assert rows == want[1]
        assert 1 <= tiles <= ops.fwd_tc_max_tiles(rows, hidden, cell)
        assert ops.fwd_tc_smem_bytes(rows, tiles, hidden, cell) <= ops._MAX_SMEM_BYTES


def test_tc_plan_bands():
    """fwd_tc_plan past one wave: waves of single tiles or bands of several,
    by the cost rule waves x tiles a cluster x (FWD_TC_TILE_COST_ROWS + rows,
    a row FWD_TC_ONE_SLICE_COST dearer with one K slice)."""
    assert ops.fwd_tc_plan(1280, 384, "lstm", 7) == (64, 1)  # 3 waves of 64: 3 x 89
    assert ops.fwd_tc_plan(1280, 384, "gru", 7) == (64, 3)  # a band of 3 x 64: 267
    assert ops.fwd_tc_plan(1000, 384, "lstm", 7) == (48, 3)
    assert ops.fwd_tc_plan(130, 512, "lstm", 7) == (16, 2)
    assert ops.fwd_tc_plan(2056, 384, "gru", 7) == (112, 1)  # 3 waves at 1.2 a row
    # 14 clusters in flight: one wave of 14 tiles of 96 rows
    assert ops.fwd_tc_plan(1280, 384, "gru", 14) == (96, 1)


def test_tc_walk_shared_memory_and_tiles():
    """The tensor-core walk's pure rules (rnn_fwd_tc.cu): a CTA's h slice
    pitch (an odd number of 16-byte chunks), its K slices (as many as keep
    a CTA at 16 warps: a pair of m-tiles, 8 units and a K slice each), its shared
    memory (W_hh rows, one or two tile buffers that hold the gathered h and
    then the fp32 partial sums, two fp32 P tiles, the fp32 carry and the h
    slices by parity of every tile of the band, the GRU's b_hh) and the most
    tiles a cluster holds."""
    assert [ops.fwd_tc_slice_pitch(h) for h in (128, 256, 384, 512)] == [8, 24, 24, 40]
    assert [ops.fwd_tc_ksplit(r, 384) for r in (16, 32, 48, 64, 80, 128)] == [4, 4, 2, 2, 1, 1]
    # W_hh rows 2·96·384; a buffer of 16 rows x max(2·384, 4·4·(96 + 8)); P
    # tiles 4·2·16·96; the carry 4·16·24; the slices 2·2·16·24
    assert ops.fwd_tc_smem_bytes(16, 1, 384, "lstm") == 73_728 + 26_624 + 12_288 + 1_536 + 1_536
    # two buffers of 48 x max(768, 4·2·104) at two tiles a cluster
    assert ops.fwd_tc_smem_bytes(48, 2, 384, "lstm") == (73_728 + 2 * 39_936 + 36_864 + 9_216
                                                         + 9_216)
    assert ops.fwd_tc_smem_bytes(80, 1, 384, "lstm") == 73_728 + 61_440 + 61_440 + 7_680 + 7_680
    assert ops.fwd_tc_smem_bytes(16, 3, 384, "gru") == (55_296 + 2 * 20_480 + 9_216 + 4_608
                                                        + 4_608 + 288)
    assert ops.fwd_tc_smem_bytes(96, 1, 384, "lstm") > ops._MAX_SMEM_BYTES
    assert [ops.fwd_tc_max_tiles(r, 384, "lstm") for r in ops.FWD_TC_ROWS] == [
        30, 4, 4, 1, 1, 0, 0, 0]
    assert [ops.fwd_tc_max_tiles(r, 512, "lstm") for r in ops.FWD_TC_ROWS] == [
        3, 0, 0, 0, 0, 0, 0, 0]
    assert [ops.fwd_tc_max_tiles(r, 384, "gru") for r in ops.FWD_TC_ROWS] == [
        41, 12, 8, 3, 1, 1, 1, 0]
    assert ops.fwd_tc_takes(384, "gru") and ops.fwd_tc_takes(128, "lstm")
    assert not ops.fwd_tc_takes(320, "lstm") and not ops.fwd_tc_takes(640, "gru")


def test_bf16_wrappers_refuse_cpu_tensors():
    """The bf16 walk and its GEMM are CUDA kernels: on CPU tensors they
    raise and count nothing (the plain versions serve the CPU)."""
    rng = np.random.default_rng(0)
    p = torch.zeros(2, 3, 64)
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (64, 16)).astype(np.float32)).to(BF16)
    h = torch.zeros(3, 16)
    for kernel in (ops.lstm_fwd_walk_bf16, ops.tc_gemm):
        kernel.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.lstm_fwd_walk_bf16(p, w, h, h)
    with pytest.raises(ValueError, match="CUDA"):
        ops.lstm_fwd_walk_bf16(p, w, h, h, form="streaming")
    with pytest.raises(ValueError, match="CUDA"):
        ops.lstm_fwd_walk_bf16(p, w, h, h, form="tc")
    with pytest.raises(ValueError, match="CUDA"):
        ops.tc_gemm(h.to(BF16), w.t().contiguous())
    assert ops.lstm_fwd_walk_bf16.launches == ops.tc_gemm.launches == 0


def test_registered_ops_follow_the_weights_dtype():
    """K1-bf16 through the registered operators: their fakes give the h
    stream in W_hh's type (bf16) and the state in fp32, as the plain kernels
    do, and a SequenceModel exported on a bf16 input holds ``fsn.tc_gemm``
    and the walk's operator, never ``fsn.fwd_gemm``; the program's output
    equals the eager one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (64, 16)).astype(np.float32)).to(BF16)
    h = torch.zeros(5, 16)
    eager = torch.ops.fsn.lstm_fwd_walk(p, w, h, h)
    a, b = p[0].to(BF16), w  # [5, 64] . [64, 16]
    with FakeTensorMode() as mode:
        fake = torch.ops.fsn.lstm_fwd_walk(*(mode.from_tensor(v) for v in (p, w, h, h)))
        gemm = torch.ops.fsn.tc_gemm(mode.from_tensor(a), mode.from_tensor(b), None)
    assert [v.dtype for v in fake] == [v.dtype for v in eager] == [BF16] + [torch.float32] * 2
    assert gemm.dtype == torch.float32 and gemm.shape == (5, 16)

    model = SequenceModel(12, 3, 16, 2, False, "LSTM", None).eval()
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 12, 7))).astype(np.float32)).to(BF16)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
        want = model(x)
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    assert sum("fsn.tc_gemm" in t for t in targets) == 3
    assert sum("fsn.lstm_fwd_walk" in t for t in targets) == 2
    assert not any("fsn.fwd_gemm" in t for t in targets)
    assert torch.equal(program.module()(x), want) and want.dtype == BF16


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _route_jax_through_kernels(monkeypatch):
    """The JAX package's stacks routed through its kernels in interpret
    mode, as a TPU routes them (the sections' fused kernel from 128 rows,
    the full-band stack's through ``SequenceModel._pallas_forward``), by
    patching the JAX modules' lookups here; nothing in the JAX package
    changes."""
    class TpuBackend:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def default_backend():
            return "tpu"

    forward = jax_sequence_model.SequenceModel._pallas_forward
    monkeypatch.setattr(jax_improved_module, "jax", TpuBackend())
    monkeypatch.setattr(jax_sequence_model.SequenceModel, "_pallas_eligible",
                        lambda self, b, t, training=False, itemsize=4: True)
    monkeypatch.setattr(jax_sequence_model.SequenceModel, "_pallas_forward",
                        lambda self, p, x, training, interpret=False: forward(
                            self, p, x, training, interpret=True))
    for name in ("fused_subband_lstm", "fused_subband_lstm_train"):
        monkeypatch.setattr(jax_ops, name, functools.partial(getattr(jax_ops, name),
                                                             interpret=True))


@pytest.fixture
def jax_kernel_route(monkeypatch):
    _route_jax_through_kernels(monkeypatch)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_improved_compute_dtype_matches_jax_kernel_route(jax_kernel_route, cell):
    """fb 16 / sb 12 at the 16 kHz layout, B = 9 x 0.1 s (every section at
    128 rows or more: the JAX kernel route, whose sections keep the stack's
    fp32 output): the waveform against ``ImprovedFullSubNet(compute_dtype=
    jnp.bfloat16)`` on the same weights, and far from the fp32 model."""
    config, model, params = _improved(16000, seed=3, sequence_model=cell)
    y = _waves((9, 1600), 4)
    want = jax_forward(JaxImprovedFullSubNet(**config, compute_dtype=jnp.bfloat16), params, y)
    model.compute_dtype = BF16
    with torch.inference_mode():
        got = model(torch.from_numpy(y)).numpy()
        model.compute_dtype = None
        fp32 = model(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (9, 1, 1600) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    assert np.abs(fp32 - want).max() > 2 * MODEL_ATOL


@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_improved_compute_dtype_valid_samples_matches_jax(jax_kernel_route, form):
    """``valid_samples`` as one count and as a [B] vector on a zero-padded
    batch of 9 rows: each row's first L samples against the JAX model's.
    The masked norm's fp32 count promotes its output to fp32 in both
    packages, so after the bf16 magnitude the stacks run at fp32."""
    config, model, params = _improved(16000, seed=5)
    most = 1600
    counts = (np.array([most] * 9) if form == "scalar"
              else np.array([most, most * 5 // 8 + 1, most * 7 // 16] + [most] * 6))
    y = _waves((9, most), 6)
    padded = np.zeros((9, most + 512), np.float32)
    for b, n in enumerate(counts):
        padded[b, :n] = y[b, :n]
    arg = counts[0] if form == "scalar" else counts
    want = jax_forward(JaxImprovedFullSubNet(**config, compute_dtype=jnp.bfloat16), params,
                       padded, valid_samples=arg)
    model.compute_dtype = BF16
    with torch.inference_mode():
        got = model(torch.from_numpy(padded), valid_samples=torch.as_tensor(arg)).numpy()
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, 0, :n], want[b, 0, :n], atol=VALID_ATOL)


def test_improved_compute_dtype_against_the_jax_cpu_route():
    """The JAX model on its own CPU route (its scans): with a bf16
    compute_dtype it runs on bf16 weights (fp32 ones meet a bf16 scan carry
    and raise there), so its state is bf16 as well; the port (kernels' fp32
    state) within the wider CPU_ROUTE_ATOL, B = 2 x 0.1 s."""
    config, model, params = _improved(16000, seed=3)
    y = _waves((2, 1600), 4)
    bf16_params = jax.tree.map(lambda v: v.astype(jnp.bfloat16), params)
    want = jax_forward(JaxImprovedFullSubNet(**config, compute_dtype=jnp.bfloat16), bf16_params,
                       y)
    model.compute_dtype = BF16
    with torch.inference_mode():
        got = model(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=CPU_ROUTE_ATOL)


def test_compute_dtype_from_toml(tmp_path):
    """``[model.args] compute_dtype = "bfloat16"`` builds in both packages:
    the port's model computes its stacks at bf16; None and a torch dtype
    are taken too, another string raises."""
    section = model_section("improved_fullsubnet.model.Model",
                            {**LAYOUTS[16000], **SMALL, "compute_dtype": "bfloat16"})
    cfg = tmp_path / "m.toml"
    cfg.write_text(section)
    model, _ = build_model(load_config(cfg))
    assert model.compute_dtype == BF16
    assert jax_build_model(jax_load_config(cfg))[0].compute_dtype == "bfloat16"
    assert _compute_dtype(None) is None and _compute_dtype(BF16) == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        _compute_dtype("float16")
    # the weights and their keys do not depend on it
    assert sorted(model.state_dict()) == sorted(ImprovedFullSubNet(**LAYOUTS[16000], **SMALL)
                                                .state_dict())


def _improved_config(tmp_path, norm: str, strategy: str = "time_domain"):
    """serving's tiny Improved FullSubNet with compute_dtype, its checkpoint
    and an inference config."""
    _, _, path, args, acoustics = SERVING_FAMILIES["improved"]
    args = {**args, "sequence_model": "LSTM", "norm_type": norm, "compute_dtype": "bfloat16"}
    model = ImprovedFullSubNet(**args, generator=torch.Generator().manual_seed(11)).eval()
    ckpt = tmp_path / "improved_bf16.tar"
    torch.save(model.state_dict(), ckpt)
    config = {"acoustics": dict(acoustics), "inferencer": {"type": strategy, "args": {}},
              "model": {"path": path, "args": args}}
    return model, ckpt, config


def test_inferencer_and_served_programs_with_compute_dtype(tmp_path):
    """The Inferencer's ``time_domain`` (exact: the model's bf16 stacks)
    and ``enhance_bucket`` (bucketed on ``valid_samples``) with such a
    model against the model's forward, ``overlapped_chunk`` against the
    fp32 model's within the bf16 rounding (chunks of 0.05 s at a 0.025 s
    hop: each chunk's forward at exact length, on the bf16 stacks); the
    bucketed program exported by ``serving.export_enhancer`` against the
    live ``enhance_bucket``."""
    model, ckpt, config = _improved_config(tmp_path, "offline_laplace_norm")
    live = Inferencer(config, str(ckpt), None, device="cpu")
    assert live.model.compute_dtype == BF16
    wave = noisy_wave(0, 1200)
    with torch.inference_mode():
        exact = model(torch.from_numpy(wave[None]))[0, 0].numpy()
    np.testing.assert_array_equal(live.time_domain(torch.from_numpy(wave[None])), exact)
    chunked = {}
    for dtype in ("bfloat16", None):
        args = {**config["model"]["args"], "compute_dtype": dtype}
        cfg = {**config, "inferencer": {"type": "overlapped_chunk",
                                        "args": {"chunk_length": 0.05}},
               "model": {**config["model"], "args": args}}
        chunked[dtype] = Inferencer(cfg, str(ckpt), None, device="cpu").overlapped_chunk(
            torch.from_numpy(wave[None]))
    assert chunked["bfloat16"].shape == wave.shape
    gap = np.abs(chunked["bfloat16"] - chunked[None]).max() / np.abs(chunked[None]).max()
    assert 0 < gap <= BF16_VS_FP32_WAVE_RTOL, gap
    out = tmp_path / "served"
    serving.export_enhancer(config, str(ckpt), out, seconds=(0.1,), batch=1, device="cpu")
    served = serving.ServingModel.load(out)
    bucket = served._pick_bucket(len(wave))
    padded = np.zeros((1, bucket), np.float32)
    padded[0, : len(wave)] = wave
    with torch.inference_mode():
        masked = model(torch.from_numpy(padded), valid_samples=len(wave))[0, 0, : len(wave)]
    live_out = live.enhance_bucket([wave], bucket)[0]
    np.testing.assert_allclose(live_out, masked.numpy(), atol=LIVE_ATOL, rtol=0)
    np.testing.assert_allclose(served.enhance(wave), live_out, atol=LIVE_ATOL, rtol=0)


def test_streaming_engine_runs_fp32(tmp_path):
    """The JAX streaming engines never read compute_dtype: the port's
    Improved engine for such a model equals the one for the fp32 model on
    the same weights."""
    model, _, _ = _improved_config(tmp_path, "cumulative_laplace_norm")
    fp32 = ImprovedFullSubNet(**{**SERVING_FAMILIES["improved"][3], "sequence_model": "LSTM",
                                 "norm_type": "cumulative_laplace_norm"}).eval()
    fp32.load_state_dict(model.state_dict())
    wave = torch.from_numpy(noisy_wave(2, 900))
    got = StreamingImprovedFullSubNet(model).enhance_wave(wave)
    want = StreamingImprovedFullSubNet(fp32).enhance_wave(wave)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_step(tmp_path_factory):
    """The port's Trainer of a tiny TOML with an Improved FullSubNet at
    ``compute_dtype = "bfloat16"``, its first batch, and the JAX Trainer's
    step on it (tests/test_torch_improved_fullsubnet.py's stand-in: the JAX
    model, loss and acoustics of the same TOML, on the port's weights),
    without use_amp, on the interpret-mode kernels: (loss, gradients)."""
    tmp_path = tmp_path_factory.mktemp("bf16_train")
    cfg = write_config(tmp_path, use_amp=False)
    toml = with_model(cfg.read_text(), model_section(
        "improved_fullsubnet.model.Model",
        {**LAYOUTS[16000], **SMALL, "compute_dtype": "bfloat16"}))
    toml = toml.replace("n_fft = 320\nwin_length = 320", "n_fft = 512\nwin_length = 512")
    cfg.write_text(toml.replace("hop_length = 160", "hop_length = 128")
                   .replace('name = "mse_loss"', 'name = "si_snr_loss"'))
    port = Trainer(load_config(cfg), output_dir=str(tmp_path / "port"), device="cpu")
    port.train_loader.set_epoch(1)
    noisy, clean = next(iter(port.train_loader))
    config = jax_load_config(cfg)
    jt = types.SimpleNamespace(model=jax_build_model(config)[0],
                               loss_function=jax_build_loss(config))
    params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(port.model.state_dict()))
    with pytest.MonkeyPatch.context() as monkeypatch:
        _route_jax_through_kernels(monkeypatch)
        want = jax.jit(jax.value_and_grad(_jax_waveform_loss_fn(jt, False)))(
            params, jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy()))
    return port, (noisy, clean), want


@pytest.mark.parametrize("use_amp", [False, True])
def test_train_step_with_compute_dtype_matches_jax_trainer(bf16_step, use_amp):
    """The waveform step of a compute_dtype model, with and without
    use_amp: its stacks take the bf16 K2/K3/dW stages (here their plain
    versions). The SI-SNR loss and the gradients before clipping against
    the JAX Trainer's step on its interpret-mode kernels (the route a TPU
    takes). use_amp changes only the roundings the kernels already make
    (the weights to bf16) and a few besides (the LSTM bias pair summed in
    bf16, the head's bias, the gradients on their way back), so both are
    held to the JAX step without it."""
    port, (noisy, clean), (want_loss, want_grads) = bf16_step
    port.use_amp = use_amp
    port.model.zero_grad(set_to_none=True)
    loss = port.compute_loss(noisy, clean)
    loss.backward()
    names = dict(port.model.named_parameters())
    got = {k: p.grad.numpy() for k, p in names.items()}
    assert all(g.dtype == np.float32 for g in got.values())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=STEP_LOSS_RTOL)
    _close_by_key(got, _grads_by_key(want_grads, names), BF16_VS_FP32_GRAD_RTOL)
