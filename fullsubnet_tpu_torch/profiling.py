"""Tracing and timing (counterpart of ``fullsubnet_tpu/profiling.py``), on
``torch.profiler`` and CUDA's synchronisation:

* ``trace(logdir)``: a ``torch.profiler`` trace of the host and, where
  there is a card, its kernels, written into ``logdir`` as a Chrome trace
  (``chrome://tracing``, Perfetto, TensorBoard's profiler plugin);
* ``annotate(name)``: a named span inside a trace;
* ``timed(fn, *args)``: the median seconds a call, each call waited for;
* ``device_memory_stats()``: each card's allocator statistics.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | os.PathLike):
    """Profile the block, the host and (with a card) the card's kernels, and
    write ``<host>_<pid>.<ns>.pt.trace.json`` into ``logdir`` when it ends;
    yields the ``torch.profiler.profile`` (``key_averages()`` and the
    events are there too)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    handler = torch.profiler.tensorboard_trace_handler(os.fspath(logdir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof


def annotate(name: str):
    """A named span inside a trace: ``with annotate("subband"): ...``."""
    return torch.profiler.record_function(name)


def _wait(out) -> None:
    """Wait for ``out``'s first tensor: synchronise its card, or read it on
    the host."""
    leaves = [x for x in torch.utils._pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
    if not leaves:
        return
    if leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)
    else:
        float(leaves[0].detach().float().sum())


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """The median seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each call's output waited for (the card synchronised where
    it is on one)."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_memory_stats() -> dict:
    """``{"cuda:<i>": torch.cuda.memory_stats(i)}`` for each visible card
    (``allocated_bytes.all.peak``, ``reserved_bytes.all.current``, ...);
    {} without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
