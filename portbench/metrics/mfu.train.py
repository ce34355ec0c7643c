"""The training step's share of the card's dense bf16 peak (989 TFLOP/s at
700 W): three times the forward's matrix FLOPs (``counts.step_flops``, at
the configuration's sizes, with drop_band's rows) for every step of the
traced window, over the window."""

from portbench import counts


def read(run):
    t = run.traffic
    frames = counts.frames(t["samples"], run.acoustics["hop_length"])
    flops = counts.step_flops(run.family, run.args, t["batch"], frames) * run.window.units
    return 100 * flops / run.trace.window_s / counts.PEAK_FLOPS["bf16"]
