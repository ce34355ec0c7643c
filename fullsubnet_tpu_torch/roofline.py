"""Analytic FLOPs, bytes and roofline shares (counterpart of
``fullsubnet_tpu/roofline.py``), with the H100's peaks.

Every model family gets a closed-form forward FLOP count from its own
``SequenceModel`` stacks: the gate GEMMs and the output projections, two
FLOPs a multiply-add (the matmul-only convention; pointwise and
transcendental work is left out, so ``mfu`` is conservative). Bytes are a
lower bound: each stack's activations read and written once at the compute
dtype, plus one sweep of its parameters. ``roofline_fields`` turns a
measured time into ``mfu`` (against the card's dense bf16 peak, the
card's maximum, whatever the dtype), ``hbm_bw_util_lb`` and
``roofline_ratio`` (the least time over the measured time: 1.0 is the
speed of light under the bound).

``bound``, ``stack_flops``, ``walk_flops``, ``layer_bwd_flops``,
``gemm_flops`` and ``weight_elems`` count one kernel call's work at the
shapes the caller gives: ``chip_smoke.py``'s bound column and PERF.md's
read them, so a kernel's roofline is the same count whatever implements it.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its full
# 700 W power limit: TFLOP/s on the tensor cores at bf16, on the fp32
# cores outside them, and the HBM rate in GB/s
H100_PEAKS = {"tflops": 989.0, "fp32_tflops": 67.0, "hbm_gbps": 3350.0}
# the cards whose peaks are known, by ``torch.cuda.get_device_name``
_PEAKS = {"NVIDIA H100 80GB HBM3": H100_PEAKS}
# ``bound``'s peaks by operand type, in operations a second
PEAK_FLOPS = {"fp32": H100_PEAKS["fp32_tflops"] * 1e12, "bf16": H100_PEAKS["tflops"] * 1e12}
HBM_BYTES_PER_S = H100_PEAKS["hbm_gbps"] * 1e9
GATES = {"lstm": 4, "gru": 3}


def device_peaks() -> dict | None:
    """The current card's peaks (``tflops``: dense bf16; ``fp32_tflops``;
    ``hbm_gbps``) and its ``device_kind``, or None on the CPU or a card
    not in the table: a share of a guessed peak would be noise, not a
    metric."""
    import torch

    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name()
    peaks = _PEAKS.get(kind)
    return None if peaks is None else dict(peaks, device_kind=kind)


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) an H100 could take for ``flops`` operations on
    ``dtype`` ("fp32" or "bf16") operands that must move ``nbytes``: the
    larger of the operations over the type's peak and the bytes over the
    HBM rate; and which of the two it is ("operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gemm_flops(m: int, k: int, n: int) -> int:
    """FLOPs of an [m, k] x [k, n] product."""
    return 2 * m * k * n


def stack_flops(t: int, n: int, f_in: int, hidden: int, out_dim: int, layers: int = 2,
                cell: str = "lstm") -> int:
    """FLOPs of the fused LSTM or GRU stack + head forward over ``n`` rows
    and ``t`` steps (``out_dim`` 0: no head)."""
    per_row_step, in_dim = 0, f_in
    for _ in range(layers):
        per_row_step += 2 * (in_dim + hidden) * GATES[cell] * hidden
        in_dim = hidden
    return (per_row_step + 2 * hidden * out_dim) * t * n


def walk_flops(t: int, n: int, hidden: int, layers: int = 2, cell: str = "lstm") -> int:
    """The recurrent products' share of ``stack_flops``: h_{t-1} . W_hh^T,
    every layer, step and row (the walks' work; the GEMMs do the rest)."""
    return layers * gemm_flops(t * n, hidden, GATES[cell] * hidden)


def layer_bwd_flops(t: int, n: int, f_in: int, hidden: int, layers: int = 2,
                    cell: str = "lstm") -> int:
    """FLOPs of the stack's layer backward with its dW products: three
    times each layer's forward gate GEMMs (dgates into dx and dh, and the
    weight gradients)."""
    flops, in_dim = 0, f_in
    for _ in range(layers):
        flops += 3 * 2 * (in_dim + hidden) * GATES[cell] * hidden * t * n
        in_dim = hidden
    return flops


def weight_elems(f_in: int, hidden: int, out_dim: int, layers: int = 2,
                 cell: str = "lstm") -> int:
    """Elements of the kernels' weight operands: the LSTM's biases fused
    ([4H]), the GRU's a pair ([2, 3H])."""
    gh = GATES[cell] * hidden
    elems, in_dim = 0, f_in
    for _ in range(layers):
        elems += (in_dim + hidden) * gh + (gh if cell == "lstm" else 2 * gh)
        in_dim = hidden
    return elems + hidden * out_dim + out_dim


def _cell(sm) -> str:
    return sm.cell_type.lower()


def seq_model_flops(sm, rows: int, steps: int) -> int:
    """Matmul FLOPs of one ``SequenceModel`` forward: per row-step each
    layer's [1, in + H] x [in + H, G·H] product, plus the output
    projection."""
    return stack_flops(steps, rows, sm.input_size, sm.hidden_size, sm.output_size,
                       sm.num_layers, _cell(sm))


def seq_model_io_elems(sm, rows: int, steps: int) -> int:
    """The stack's activation traffic, a lower bound in elements: the input
    read once, the output written once (the recurrent state stays on
    chip)."""
    return rows * steps * (sm.input_size + (sm.output_size or sm.hidden_size))


def _param_count(sm) -> int:
    gh = GATES[_cell(sm)] * sm.hidden_size
    n, in_dim = 0, sm.input_size
    for _ in range(sm.num_layers):
        n += gh * (in_dim + sm.hidden_size) + 2 * gh
        in_dim = sm.hidden_size
    if sm.output_size:
        n += sm.hidden_size * sm.output_size + sm.output_size
    return n


def _stages(model, batch: int, frames: int, drop_groups: int = 1):
    """(SequenceModel, rows, steps) of each stack of any family.

    ``frames``: the model's input frames (Improved FullSubNet's from its
    samples upstream). ``drop_groups`` > 1 shrinks the sub-band rows as the
    training step's drop_band does (F -> F // groups)."""
    name = type(model).__name__
    t = frames + getattr(model, "look_ahead", 0)
    if name == "FullSubNet":
        f_eff = model.num_freqs // drop_groups if drop_groups > 1 else model.num_freqs
        yield model.fb_model, batch, t
        yield model.sb_model, batch * f_eff, t
    elif name == "SubBandBaseline":
        # F is the input's, not the model's: the paper's spectrum unless set
        f = getattr(model, "num_freqs", 257)
        f_eff = f // drop_groups if drop_groups > 1 else f
        yield model.sb_model, batch * f_eff, t
    elif name == "FullBandModel":
        yield model.fullband_model, batch, t
    elif name == "FastFullSubNet":
        s = model.shrink_size
        t_down = (t - 1 + s - 1) // s + 1  # frame 0, then ceil((T-1)/s) blocks
        yield model.encoder[0], batch, t
        yield model.encoder[1], batch, t
        yield model.bottleneck, batch * model.num_mels, t_down
        yield model.decoder_lstm[0], batch, t
        yield model.decoder_lstm[1], batch, t
    elif name == "ImprovedFullSubNet":
        yield model.fb_model, batch, frames
        sb, f = model.sb_model, model.num_freqs - 1  # the last bin is dropped
        for i, sm in enumerate(sb.sb_models):
            lower, upper = sb._section_bounds(i, f)
            yield sm, batch * ((upper - lower) // sb.sb_num_center_freqs[i]), frames
    else:
        raise ValueError(f"no analytic FLOPs model for {name}")


def model_fwd_flops(model, batch: int, frames: int, drop_groups: int = 1) -> int:
    return sum(seq_model_flops(sm, r, s) for sm, r, s in _stages(model, batch, frames, drop_groups))


def model_min_bytes(model, batch: int, frames: int, itemsize: int = 2,
                    drop_groups: int = 1) -> int:
    """The HBM traffic of one forward, a lower bound: each stack's
    activations in and out at the compute dtype, plus one parameter
    sweep."""
    stages = list(_stages(model, batch, frames, drop_groups))
    elems = sum(seq_model_io_elems(sm, r, s) for sm, r, s in stages)
    params = sum(_param_count(sm) for sm, _, _ in stages)
    return (elems + params) * itemsize


def roofline_fields(
    model,
    batch: int,
    frames: int,
    seconds_per_step: float,
    *,
    itemsize: int = 2,
    drop_groups: int = 1,
    train: bool = False,
) -> dict:
    """``mfu``, ``hbm_bw_util_lb`` and ``roofline_ratio`` of a forward (or,
    with ``train=True``, a training step) measured at ``seconds_per_step``
    on the current card, beside the counted ``analytic_tflops`` and the
    card's ``peak_tflops``; {} on the CPU or a card without known peaks.

    ``train=True`` counts three times the forward's FLOPs (the forward and
    the backward's two products a forward product; the optimizer's work is
    left out) and twice its bytes (the stash written, then read again)."""
    peaks = device_peaks()
    if peaks is None or seconds_per_step <= 0:
        return {}
    flops = model_fwd_flops(model, batch, frames, drop_groups)
    nbytes = model_min_bytes(model, batch, frames, itemsize, drop_groups)
    if train:
        flops *= 3
        nbytes *= 2
    t_flops = flops / (peaks["tflops"] * 1e12)
    t_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    return {
        "analytic_tflops": flops / 1e12,
        "mfu": t_flops / seconds_per_step,
        "hbm_bw_util_lb": t_bytes / seconds_per_step,
        "roofline_ratio": max(t_flops, t_bytes) / seconds_per_step,
        "peak_tflops": peaks["tflops"],
    }
