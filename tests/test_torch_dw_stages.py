"""The layer backward's dW stage (K3's and K4's weight gradients: the
persistent GEMM of ``csrc/rnn_dw_tma.cu`` on the main path, the split-K
GEMM of ``csrc/rnn_dw.cu`` of the earlier design) through its plain version
on the CPU: ``plain_dw_gemm`` composed as ``RnnScanFunction`` composes it
(``weight_grads`` over the cotangent streams of the plain layer backward)
against the JAX package's ``_pallas_layer_bwd`` in interpret mode with
``split_dw=False``, the form whose kernel body sums the weight gradients
itself; the persistent GEMM's plan (``plan_dw``: every tile and k-tile in
exactly one unit, the head units, each slot inside one segment) at the
flagship shapes, and its composition unit by unit against one pass; the
split of K into slices summed in order against one pass; the pick of the
slices at the flagship shapes; the wrappers' refusal of CPU tensors; and no
dW launch on the CPU training path. The kernels themselves run only on a
card: tests/test_torch_kernel_cuda.py.
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
    """No fallback inside the wrappers: a CPU tensor is an error there."""
    for dtype in (torch.float32, torch.bfloat16):
        for wrapper in (ops.dw_gemm, ops.dw_tma):
            with pytest.raises(ValueError, match="CUDA tensors"):
                wrapper(torch.zeros(40, 8, dtype=dtype), torch.zeros(40, 32, dtype=dtype),
                        prev=torch.zeros(40, 8, dtype=dtype), head=torch.zeros(5, 8, dtype=dtype))


# the persistent GEMM's plan at the flagship shapes: (F, H, shift, Ncols, K)
# per problem; sub-band N = 4,096 rows a step, full-band N = 32
PLAN_SHAPES = {
    "sub-band LSTM layer 1": (32, 384, 4096, 1536, 798_720),
    "sub-band LSTM layer 2": (384, 384, 4096, 1536, 798_720),
    "sub-band GRU layer 1 [x | 1]": (32, 0, 0, 1152, 798_720),
    "sub-band GRU [h_prev | 1]": (0, 384, 4096, 1152, 798_720),
    "sub-band GRU layer 2 [x | 1]": (384, 0, 0, 1152, 798_720),
    "full-band LSTM layer 1": (257, 512, 32, 2048, 6_240),
    "full-band LSTM layer 1, bf16 padded": (264, 512, 32, 2048, 6_240),
    "full-band LSTM layer 2": (512, 512, 32, 2048, 6_240),
    "chunked sub-band LSTM layer 1, 64 steps": (32, 384, 4096, 1536, 64 * 4096),
}


def _segment_cols(plan, seg):
    return {"a": plan.cols0, "prev": plan.cols1, "head": plan.cols1}[seg]


@pytest.mark.parametrize("dtype, cluster", [(torch.bfloat16, True), (torch.bfloat16, False),
                                            (torch.float32, False)])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_dw_plan_covers_every_tile_once(shape, sms, dtype, cluster):
    """plan_dw on a card of 132 SMs and of 7, in clusters of two CTAs that
    share B (bf16) and of one: the slab units cover each tile's k-tiles
    exactly once, in slab order; no unit is empty; a cluster's CTAs take
    the pairs of one group, one column tile and one k range together; every
    unit belongs to exactly one CTA of its rank; the CTAs take them round
    robin by cluster; the head units (where a_prev is shifted) cover [0,
    ceil(min(shift, K) / bk)) of each tile that holds an a_prev slot, once,
    and load nothing for the others."""
    f_in, hidden, shift, ncols, k = PLAN_SHAPES[shape]
    plan = ops.plan_dw(f_in, hidden, shift, ncols, k, sms, dtype, cluster)
    assert plan.cs == (2 if cluster and plan.pairs % 2 == 0
                       and plan.k_tiles >= ops.DW_CLUSTER_K_TILES else 1)
    assert plan.k_tiles == -(-k // ops.DW_K_TILE[dtype]) and plan.bk == ops.DW_K_TILE[dtype]
    assert plan.n_tiles == -(-ncols // ops.DW_TILE_N) and plan.pairs == -(-plan.n_slots // 2)
    assert 1 <= plan.slabs <= plan.k_tiles
    assert plan.ctas % plan.cs == 0 and plan.ctas == plan.cs * min(sms // plan.cs,
                                                                   plan.units // plan.cs)
    assert plan.units == plan.head_units + plan.slabs * plan.tiles * plan.cs
    spans, heads = {}, {}
    for u in range(plan.units):
        pair, nt, kt0, kt1, head = plan.unit(u)
        assert 0 <= pair < plan.groups * plan.cs and 0 <= nt < plan.n_tiles and 0 <= kt0 < kt1
        assert pair % plan.cs == u % plan.cs
        if u % plan.cs:  # a cluster's CTAs: one group, column tile and k range
            mate = plan.unit(u - u % plan.cs)
            assert (mate[0] // plan.cs, *mate[1:]) == (pair // plan.cs, nt, kt0, kt1, head)
        if pair >= plan.pairs:  # past the last pair: no slots
            assert all(plan.slot(2 * pair + h, head)[0] is None for h in range(2))
            continue
        (heads if head else spans).setdefault((pair, nt), []).append((kt0, kt1))
    assert set(spans) == {(p, n) for p in range(plan.pairs) for n in range(plan.n_tiles)}
    for tile, parts in spans.items():
        assert parts[0][0] == 0 and parts[-1][1] == plan.k_tiles, tile
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:])), tile
        assert len(parts) == plan.slabs
    prev_pairs = {(plan.n0 + i) // 2 for i in range(plan.n1)}
    if plan.head_units:
        head_tiles = -(-min(shift, k) // plan.bk)
        assert {t for t in heads if t[0] in prev_pairs} == {
            (p, n) for p in prev_pairs for n in range(plan.n_tiles)}
        assert all(parts == [(0, head_tiles)] for parts in heads.values())
        for (pair, _), _ in heads.items():
            if pair not in prev_pairs:
                assert all(plan.slot(2 * pair + h, True)[0] is None for h in range(2))
    else:
        assert not heads
    taken = sorted(u for c in range(plan.ctas) for u in plan.cta_units(c))
    assert taken == list(range(plan.units))
    clusters = plan.ctas // plan.cs
    for c in range(plan.ctas):
        got = list(plan.cta_units(c))
        assert all(u % plan.cs == c % plan.cs for u in got)
        assert got[:2] == [c, c + clusters * plan.cs][: len(got)]


@pytest.mark.parametrize("f_in, hidden, shift", [
    (32, 384, 4096), (32, 384, 0), (32, 0, 4096), (0, 384, 4096), (0, 384, 0), (20, 44, 37)])
def test_dw_plan_has_head_units_iff_shifted(f_in, hidden, shift):
    """A head unit appears exactly where a_prev is there and shifted (shift >
    0); [x | 1] alone, or a_prev unshifted, has none."""
    for dtype, cluster in ((torch.bfloat16, True), (torch.bfloat16, False),
                           (torch.float32, False)):
        plan = ops.plan_dw(f_in, hidden, shift, 1152, 50_000, 132, dtype, cluster)
        heads = [u for u in range(plan.units) if plan.unit(u)[4]]
        assert bool(heads) == (hidden > 0 and shift > 0)
        assert heads == list(range(plan.units - plan.head_units, plan.units))  # last


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES) + ["ragged"])
def test_dw_plan_loads_stay_in_their_segment(shape, dtype):
    """Each slot of each unit loads from one segment: a's or a_prev's (the
    head block in a head unit), its columns starting inside that segment on
    the 64-row grid; a head unit loads nothing but a_prev's head block.
    Every row of C but the last maps to one (slot, row) inside its
    segment's columns and no two rows to the same; the last, the bias row,
    takes no slot and is summed by the slab units of the first pair alone."""
    f_in, hidden, shift, ncols, k = PLAN_SHAPES.get(shape, (20, 44, 37, 132, 777))
    plan = ops.plan_dw(f_in, hidden, shift, ncols, k, 132, dtype, dtype == torch.bfloat16)
    assert plan.n_slots == -(-f_in // ops.DW_SLOT) - (-hidden // ops.DW_SLOT)
    for head in (False, True):
        for index in range(2 * plan.groups * plan.cs):
            seg, col0 = plan.slot(index, head)
            if index >= plan.n_slots or (head and index < plan.n0):
                assert seg is None
                continue
            want = ("a" if index < plan.n0 else "head" if head else "prev")
            assert seg == want and col0 % ops.DW_SLOT == 0 and col0 < _segment_cols(plan, seg)
    rows = [plan.row_of(r) for r in range(f_in + hidden)]
    assert len(set(rows)) == len(rows)
    for r, (slot, lr) in enumerate(rows):
        seg, col0 = plan.slot(slot, False)
        assert 0 <= lr < ops.DW_SLOT and col0 + lr == (r if r < f_in else r - f_in)
        assert col0 + lr < _segment_cols(plan, seg)
    bias = [u for u in range(plan.units) if plan.bias_unit(plan.unit(u)[0], plan.unit(u)[4])]
    assert len(bias) == plan.slabs * plan.n_tiles
    assert {plan.unit(u)[1] for u in bias} == set(range(plan.n_tiles))


@pytest.mark.parametrize("dtype, cluster", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
@pytest.mark.parametrize("f_in, hidden, shift, ncols, k, sms", [
    (32, 48, 37, 300, 1000, 4),   # a's slot half full; shift < a k-tile
    (20, 44, 37, 132, 777, 3),    # ragged everywhere
    (0, 64, 5, 64, 130, 2),       # [h_prev | 1], one full slot
    (64, 0, 0, 520, 97, 5),       # [x | 1], one full slot, three column tiles
    (130, 70, 200, 257, 150, 7),  # shift past K's k-tiles' end: head only
    (64, 64, 300, 256, 2000, 9),  # shift over several k-tiles
    (8, 16, 4, 40, 20, 132),      # K under one k-tile
])
def test_dw_plan_composition_matches_single_pass(dtype, cluster, f_in, hidden, shift, ncols, k,
                                                 sms):
    """plain_dw_plan (each unit's product over its k-tiles, summed into C in
    the plan's order, the head units on a_prev's rows), in clusters of two
    CTAs and of one, against one pass of plain_dw_gemm, at F32_RTOL_OF_MAX of
    the largest value: fp32 sums of the same products in another order (bf16
    products are exact in fp32)."""
    rng = np.random.default_rng(k + ncols)

    def draw(*shape):
        return _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    a = draw(k, f_in) if f_in else None
    prev = draw(k, hidden) if hidden else None
    head = draw(max(shift, 1), hidden)[:shift] if hidden else None
    b = draw(k, ncols)
    plan = ops.plan_dw(f_in, hidden, shift if hidden else 0, ncols, k, sms, dtype, cluster)
    got = ops.plain_dw_plan(plan, a, b, prev, head)
    want = ops.plain_dw_gemm(a, b, prev, head)
    assert got.shape == want.shape == (f_in + hidden + 1, ncols) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_RTOL_OF_MAX * float(want.abs().max()))


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
    ops.dw_tma.reset_counts()
    ops.fused_subband_lstm(x, *stack, head).square().sum().backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all())
               for v in stack[0].values())
    assert ops.dw_gemm.launches == 0 and not ops.dw_gemm.launches_by_shape
    assert ops.dw_tma.launches == 0 and not ops.dw_tma.launches_by_shape
