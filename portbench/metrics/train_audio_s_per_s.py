"""Audio-seconds a second of the window: all the optimizer steps (crops of the mix's length) in the window, over
its wall, which ends when the last of them has finished."""


def read(run):
    return run.window.audio_s / run.window.wall_s
