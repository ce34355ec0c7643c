"""The yardstick's operation and byte counts, and the H100's peaks.

A frozen copy of the counting in ``fullsubnet_tpu_torch/roofline.py``
(``bound``, ``stack_flops``, ``layer_bwd_flops``, ``weight_elems``, the
stages of ``_stages``), kept here so that no change to the program moves the
benchmark's shares. It differs in three ways:

* the stacks come from the configuration's sizes
  (``reference.models.stacks``), not from the program's model object;
* a kernel's share of its roofline (``rnn_roofline.*``) puts each stack's
  work against the peak of the type the stack computes in: fp32 stacks
  (Fast FullSubNet's under ``use_amp``, every inference forward) against
  the 67 TFLOP/s outside the tensor cores. ``roofline_fields``'
  ``roofline_ratio`` puts all work against the bf16 peak, which is the
  wrong peak for an fp32 stack and would read a fp32 kernel at its roofline
  as 7% of it. Only ``mfu`` keeps the card's maximum, the dense bf16 peak,
  as model FLOP utilisation conventionally does;
* a layer's backward counts the work it needs, twice its forward's gate
  products, not the three times of ``roofline.layer_bwd_flops``, which
  counts the port's recompute of the pre-activations. So a step is three
  times its forward, in ``mfu`` and in the rooflines alike.

FLOPs are two a multiply-add of the matrix products (gates and heads);
pointwise work is left out, so every share is conservative.
"""

from __future__ import annotations

from portbench.reference.models import Stack, drop_groups, stacks

# NVIDIA's data sheet for the H100 SXM at its full 700 W limit, dense:
# operations a second by operand type, and HBM bytes a second
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bf16": 2, "fp32": 4}
GATES = 4  # the LSTM's


def bound(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds an H100 could take: operations over the type's
    peak or bytes over the HBM rate, the larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def stack_flops(t: int, n: int, f_in: int, hidden: int, out_dim: int, layers: int) -> int:
    """The stack + head forward over ``n`` rows of ``t`` steps."""
    per_row_step, in_dim = 0, f_in
    for _ in range(layers):
        per_row_step += 2 * (in_dim + hidden) * GATES * hidden
        in_dim = hidden
    return (per_row_step + 2 * hidden * out_dim) * t * n


def layer_bwd_flops(t: int, n: int, f_in: int, hidden: int, layers: int) -> int:
    """The layers' backward with the weight gradients: twice each layer's
    gate products, the gates' gradient into x and h (one forward's worth)
    and the weight gradients (a second). The head's backward is a library
    GEMM, left out."""
    flops, in_dim = 0, f_in
    for _ in range(layers):
        # roofline.py's count takes 3: the port recomputes the gates'
        # pre-activations in the backward, and a recompute is not needed work
        flops += 2 * 2 * (in_dim + hidden) * GATES * hidden * t * n
        in_dim = hidden
    return flops


def weight_elems(f_in: int, hidden: int, out_dim: int, layers: int) -> int:
    """The kernels' weight operands, the biases fused ([4H] a layer)."""
    elems, in_dim = 0, f_in
    for _ in range(layers):
        elems += (in_dim + hidden) * GATES * hidden + GATES * hidden
        in_dim = hidden
    return elems + hidden * out_dim + out_dim


def stack_bytes(st: Stack, t: int, n: int, itemsize: int) -> int:
    """A forward call's least traffic: its input and output once, its
    weights once."""
    out = st.out or st.hidden
    return itemsize * (t * n * (st.f_in + out) + weight_elems(st.f_in, st.hidden, st.out, st.layers))


def frames(samples: int, hop: int) -> int:
    """STFT frames of ``samples`` (centred, even n_fft)."""
    return 1 + samples // hop


def model_stages(family: str, args: dict, batch: int, t_frames: int,
                 training: bool = False) -> list[tuple[Stack, int, int]]:
    """(stack, rows, steps) of each stack for a batch of ``t_frames`` STFT
    frames; ``training`` applies drop_band's rows where the step does."""
    st = stacks(family, args)
    t = t_frames + args["look_ahead"]
    if family == "fullsubnet":
        groups = drop_groups(family, args, batch) if training else 1
        return [(st[0], batch, t), (st[1], batch * (args["num_freqs"] // groups), t)]
    t_down = (t - 1 + args["shrink_size"] - 1) // args["shrink_size"] + 1
    enc0, enc1, bottleneck, dec0, dec1 = st
    return [(enc0, batch, t), (enc1, batch, t), (bottleneck, batch * args["num_mels"], t_down),
            (dec0, batch, t), (dec1, batch, t)]


def forward_flops(family: str, args: dict, batch: int, t_frames: int,
                  training: bool = False) -> int:
    return sum(stack_flops(t, n, s.f_in, s.hidden, s.out, s.layers)
               for s, n, t in model_stages(family, args, batch, t_frames, training))


def step_flops(family: str, args: dict, batch: int, t_frames: int) -> int:
    """A training step's matrix FLOPs: three times the forward's (the
    forward, and the backward's two products a forward product)."""
    return 3 * forward_flops(family, args, batch, t_frames, training=True)


def stacks_bound(family: str, args: dict, batch: int, t_frames: int, dtype: str,
                 training: bool) -> float:
    """The least seconds of the stacks' kernels for one forward (and, with
    ``training``, one layer backward with its weight gradients) at
    ``dtype``: each kernel call's bound, summed."""
    total, size = 0.0, ITEMSIZE[dtype]
    for s, n, t in model_stages(family, args, batch, t_frames, training):
        fwd = stack_bytes(s, t, n, size)
        total += bound(stack_flops(t, n, s.f_in, s.hidden, s.out, s.layers), fwd, dtype)
        if training:
            total += bound(layer_bwd_flops(t, n, s.f_in, s.hidden, s.layers), 2 * fwd, dtype)
    return total
