"""The trace's reduction: busy time as a union of device intervals, idle
gaps named by the innermost host operation, and no kernel an error."""

from __future__ import annotations

import pytest
import torch

from portbench import trace


def test_union_merges_overlapping_intervals():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_gaps_are_named_by_the_innermost_host_operation():
    host = [(0, 100, "outer"), (10, 40, "inner"), (60, 70, "late")]
    gaps = [(20, 30), (45, 55), (62, 64), (150, 160)]
    named = trace._name_gaps(gaps, host)
    assert named == {"inner": 10e-9, "outer": 10e-9, "late": 2e-9, trace.WINDOW_SPAN: 10e-9}


def test_a_window_with_no_kernel_is_an_error():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            torch.ones(4).sum()
    with pytest.raises(trace.EmptyTrace):
        trace.summarize(prof, [0])


def test_kernel_time_matches_whole_names():
    s = trace.Summary(window_s=1.0, busy_s={0: 0.5},
                      kernel_s={"void a::fwd_gemm_kernel<true>(x)": 0.25,
                                "void a::fwd_gemm_kernel_v2(x)": 0.5})
    assert s.kernel_time(["fwd_gemm_kernel"]) == 0.25
    assert s.idle_share() == 0.5
