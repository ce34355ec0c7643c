"""The run's own guards: JAX and the JAX package are refused by their
whole top-level names, and a machine without the cell's cards gets no
result."""

from __future__ import annotations

import sys
import types

from portbench import run as harness


def test_forbidden_modules_are_found_by_their_whole_top_level_name(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "fullsubnet_tpu_torch_extra", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fullsubnet_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["fullsubnet_tpu", "jaxlib"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(["--workload", "fullsubnet.train.b32x3s", "--seed", str(2**33 + 1),
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "needs 1 CUDA card" in out.err


def test_the_harness_imports_no_jax():
    import subprocess

    code = ("import sys; import portbench.run, portbench.calibrate, portbench.reference.steps, "
            "portbench.traffic.train_batches, portbench.traffic.exact_enhance, "
            "portbench.trace; from portbench import run; "
            "assert run.forbidden_modules() == [], run.forbidden_modules()")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=harness.ROOT)


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        text = path.read_text()
        assert "fullsubnet_tpu" not in text and "import jax" not in text, path
