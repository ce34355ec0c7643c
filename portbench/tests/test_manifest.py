"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import importlib
import json
import math
import re

import pytest

from portbench import run as harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_manifest_has_the_contracts_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(map(_line, MANIFEST["command"]))
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for path in MANIFEST["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits its 12 hours
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for section, keys in KEYS.items():
        entries = MANIFEST[section]
        assert entries and len({e["name"] for e in entries}) == len(entries)
        for e in entries:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e["name"]
    assert len(MANIFEST["configs"]) <= 24 and len(MANIFEST["workloads"]) <= 24
    assert len(MANIFEST["end_to_end"]) <= 16 and len(MANIFEST["per_layer"]) <= 128
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    for section in KEYS:
        for e in MANIFEST[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                assert text is None or _line(text)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_cells_configurations_and_metrics_fit_together():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs) and {c for c, _ in pairs} == configs
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in MANIFEST["paths"])
        assert (harness.ROOT / f).is_file()
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    # every cell reports the set-up time, a cell added later too
    assert "workloads" not in E2E["setup_s"]
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for name in CELLS:
        cell = harness.load_cell(name)
        reported = [m["name"] for m in cell.metrics]
        assert "setup_s" in reported and len(reported) >= 2, name
        assert cell.layer_metrics, name


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in E2E[m["moves"]].get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_every_cells_files_are_found_by_name(name):
    root = harness.ROOT
    cell = harness.load_cell(name, root)
    kind = harness.kind_module(cell)
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(kind, fn)), fn
    assert cell.workload["control"] != cell.workload["precision"]
    assert cell.workload["stack_dtype"] in ("fp32", "bf16")
    if cell.traffic["kind"] == "train_batches":
        assert 1 <= cell.workload["loss_steps"] <= cell.traffic["warm_steps"]
        assert cell.workload["change_leaf"] in ("worst", "median")
    assert cell.workload["limits"] and all(v > 0 for v in cell.workload["limits"].values())
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    for library in cell.workload["libraries"]:
        assert hasattr(ops, library) and hasattr(getattr(ops, library), "SOURCES")
    for m in cell.metrics + cell.layer_metrics:
        assert callable(harness.reader(m["name"], root))
    importlib.import_module("portbench.reference.steps")


@pytest.mark.parametrize("name", CELLS)
def test_every_metric_listed_for_a_cell_reads_a_number_there(name, tmp_path):
    """No reader asks which kind of traffic it is in: the manifest's lists
    decide where a metric is read."""
    from portbench import trace

    cell = harness.load_cell(name)
    run = harness.Run(cell, 1, ["cpu"], tmp_path, True)
    run.window = harness.Window(wall_s=10.0, units=10, audio_s=30.0, attempted=10)
    run.trace = trace.Summary(window_s=10.0, busy_s={0: 9.0},
                              kernel_s={"void fwd_gemm_kernel(x)": 5.0})
    run.setup_s = 20.0
    for m in cell.metrics + cell.layer_metrics:
        value = harness.reader(m["name"])(run)
        assert isinstance(value, float) and 0 < value < math.inf, m["name"]
