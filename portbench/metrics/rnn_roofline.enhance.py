"""The recurrent stacks' kernels against their roofline in enhancement:
the summed least time of each stack's forward at the clips' true length
(``counts.stacks_bound``, at the fp32 peak: inference runs fp32) for every
call of the traced window, over the device time of the port's kernels
(named below, from ``fullsubnet_tpu_torch/ops/csrc``). Padding the kernels
walk through is not counted as work."""

from portbench import counts

# the port's fp32 inference GEMM and walk, by their base names
KERNELS = ("fwd_gemm_kernel", "rnn_fwd_walk_kernel")


def read(run):
    busy = run.trace.kernel_time(KERNELS)
    if busy <= 0:
        return None
    t = run.traffic
    frames = counts.frames(t["samples"], run.acoustics["hop_length"])
    least = counts.stacks_bound(run.family, run.args, t["batch"], frames,
                                run.cell.workload["stack_dtype"], training=False)
    return 100 * least * run.window.units / busy
