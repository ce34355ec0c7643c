"""The port's tracing and timing (``fullsubnet_tpu_torch/profiling.py``) on
the CPU: ``timed`` waits for and times a call, ``trace`` with ``annotate``
writes a Chrome trace that names the spans, and without a card
``device_memory_stats`` is empty."""

import json
import time

import pytest
import torch

from fullsubnet_tpu_torch import profiling

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)


def test_timed_is_the_median_of_waited_calls():
    calls = []

    def fn(x, pause):
        calls.append(x)
        time.sleep(pause)
        return {"out": (x @ x, 3)}

    x = torch.randn(8, 8)
    seconds = profiling.timed(fn, x, 0.02, iters=5, warmup=1)
    assert len(calls) == 6
    assert 0.02 <= seconds < 0.5
    assert profiling.timed(lambda: None, iters=2, warmup=0) < 0.1  # nothing to wait for


def test_trace_writes_the_spans(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("fullband"):
            y = x @ x
        with profiling.annotate("subband"):
            torch.tanh(y)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"fullband", "subband"} <= names
    assert {"fullband", "subband"} <= {e.key for e in prof.key_averages()}


def test_no_card_no_memory_stats():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: its statistics are read on it")
    assert profiling.device_memory_stats() == {}
