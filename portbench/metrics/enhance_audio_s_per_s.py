"""Audio-seconds a second of the window: all the clips enhanced on one card at their true length and returned to the host in the window, over
its wall, which ends when the last of them has finished."""


def read(run):
    return run.window.audio_s / run.window.wall_s
