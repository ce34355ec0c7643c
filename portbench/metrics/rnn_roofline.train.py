"""The recurrent stacks' kernels against their roofline in the training
step: the summed least time of each stack's forward and layer backward with
its weight gradients (``counts.stacks_bound``, at the type the stacks
compute in, fp32 stacks against the fp32 peak) for every step of the
traced window, over the device time of the port's kernels that do that
work (named below, from ``fullsubnet_tpu_torch/ops/csrc``). The heads'
backward products are library GEMMs, left out of both sides."""

from portbench import counts

# the port's GEMM, walk and weight-gradient kernels, by their base names
KERNELS = (
    "fwd_gemm_kernel", "rnn_fwd_walk_kernel", "tc_gemm_kernel",
    "train_walk_kernel", "train_walk_split_kernel", "train_f32_walk_kernel",
    "rnn_bwd_walk_kernel", "rnn_bwd_walk_split_kernel", "rnn_bwd_f32_walk_kernel",
    "rnn_bwd_f32_stream_kernel", "dw_tma_bf16_kernel", "dw_tma_f32_kernel",
    "dw_tma_reduce_kernel",
)


def read(run):
    busy = run.trace.kernel_time(KERNELS)
    if busy <= 0:
        return None
    t, dtype = run.traffic, run.cell.workload["stack_dtype"]
    frames = counts.frames(t["samples"], run.acoustics["hop_length"])
    least = counts.stacks_bound(run.family, run.args, t["batch"], frames, dtype, training=True)
    return 100 * least * run.window.units / busy
