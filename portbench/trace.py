"""The traced window: a ``torch.profiler`` profile of the host and every
card, reduced to what the per-layer metrics read.

The window is the span ``portbench.window`` that the harness records around
its loop. On each card, busy time is the union of the intervals in which a
device operation (kernel, copy, set) ran, clipped to the window; idle time
is the rest. Each idle gap is named by the host operation that ran through
its middle, the innermost one. A trace without a device kernel is an error,
never a zero.
"""

from __future__ import annotations

import contextlib
import heapq
import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW_SPAN = "portbench.window"


class EmptyTrace(RuntimeError):
    """The profile holds no kernel on the card."""


@dataclass
class Summary:
    window_s: float
    busy_s: dict[int, float]  # by card index
    kernel_s: dict[str, float]  # device time by operation name, every card
    idle_by_host: dict[str, float] = field(default_factory=dict)

    @property
    def busy_mean_s(self) -> float:
        return float(np.mean(list(self.busy_s.values())))

    def idle_share(self) -> float:
        return 1.0 - self.busy_mean_s / self.window_s

    def kernel_time(self, names) -> float:
        """Device seconds of the operations whose names hold one of
        ``names`` as a whole word (a kernel's base name)."""
        pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) +
                             r")(?![A-Za-z0-9_])")
        return sum(s for name, s in self.kernel_s.items() if pattern.search(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def profiled():
    """Profile the block's host and card activity; yields the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(prof, devices: list[int]) -> Summary:
    """Reduce the profile of a window to busy and idle time on ``devices``
    (card indices), device time by operation, and idle time by host
    operation."""
    events = prof.profiler.kineto_results.events()
    host, device = [], defaultdict(list)
    kernel_ns: dict[str, int] = defaultdict(int)
    window = None
    cuda = torch.autograd.DeviceType.CUDA
    has_kernel = False
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            if ev.is_user_annotation():  # a host span mirrored onto the card
                continue
            device[ev.device_index()].append((start, end))
            kernel_ns[ev.name()] += end - start
            has_kernel = has_kernel or not ev.name().startswith(("Memcpy", "Memset"))
        else:
            if ev.name() == WINDOW_SPAN:
                window = (start, end)
            host.append((start, end, ev.name()))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    if not has_kernel:
        raise EmptyTrace("the traced window holds no kernel on the card")
    w0, w1 = window
    busy, gaps = {}, []
    for index in devices:
        spans = [(max(a, w0), min(b, w1)) for a, b in _union(device.get(index, [])) if b > w0 and a < w1]
        busy[index] = sum(b - a for a, b in spans) / 1e9
        edges = [w0] + [x for span in spans for x in span] + [w1]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy,
                   kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
                   idle_by_host=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by the innermost host operation running through each
    gap's middle (the harness's loop itself where none is): one sweep over
    the middles in order, the operations begun so far in a heap by their
    start, the latest first, those already ended dropped from its top."""
    host = sorted(h for h in host if h[2] != WINDOW_SPAN)
    out: dict[str, float] = defaultdict(float)
    active: list = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        out[active[0][2] if active else WINDOW_SPAN] += (b - a) / 1e9
    return dict(out)
