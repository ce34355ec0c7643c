"""Set-up seconds, from the process's start to the window's first call:
the interpreter and torch, the CUDA context, the kernel libraries (built
together on a checkout's first run), the seeded inputs and weights, the
system under test and its warm-up on every shape the window uses."""


def read(run):
    return run.setup_s
