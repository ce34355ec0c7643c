"""The enhancement forward's share of the card's dense bf16 peak (989
TFLOP/s at 700 W): the forward's matrix FLOPs at the clips' true length
(``counts.forward_flops``; the bucket's padding is not useful work) for
every call of the traced window, over the window."""

from portbench import counts


def read(run):
    t = run.traffic
    frames = counts.frames(t["samples"], run.acoustics["hop_length"])
    flops = counts.forward_flops(run.family, run.args, t["batch"], frames) * run.window.units
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS["bf16"]
