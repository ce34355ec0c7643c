"""A new configuration, traffic mix, cell and metric are new files and
entries: added to a copy of the benchmark, the new cell runs and no file
that was there changes."""

from __future__ import annotations

import hashlib
import json
import shutil

import torch

from portbench import run as harness
from portbench.tests import small

torch.set_num_threads(2)

READER = '''"""Calls a second of the window."""


def read(run):
    return run.window.units / run.window.wall_s
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_throwaway_cell_runs_from_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    (root / "portbench").mkdir(parents=True)
    for name in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(harness.BENCH_DIR / name, root / "portbench" / name)
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    before = _digests(root)
    bench = root / "portbench"

    config = (bench / "configs" / "fullsubnet.toml").read_text()
    (bench / "configs" / "fullsubnet_b8.toml").write_text(
        config.replace("batch_size = 32", "batch_size = 8"))
    (bench / "traffic" / "enhance.b2x0p5s.toml").write_text(
        'kind = "bucketed_enhance"\nbatch = 2\nsamples = 8000\npool = 2\nwarm_calls = 1\n'
        'sample_rows = 2\nsnr_db = [0, 10]\nlevel_dbfs = [-30, -20]\n')
    (bench / "workloads" / "fullsubnet_b8.enhance.b2x0p5s.toml").write_text(
        'libraries = ["fwd_library"]\nstack_dtype = "fp32"\nprecision = {products = "fp32"}\n'
        'control = {products = "tf32"}\n[limits]\nwave_gap = 0.001\n')
    (bench / "metrics" / "calls_per_s.py").write_text(READER)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "fullsubnet_b8", "source": "https://example.org/a",
                                "file": "portbench/configs/fullsubnet_b8.toml", "reduced": [],
                                "why": "a throwaway configuration"})
    cell = "fullsubnet_b8.enhance.b2x0p5s"
    manifest["workloads"].append({"name": cell, "config": "fullsubnet_b8",
                                  "traffic": "enhance.b2x0p5s", "chips": 1,
                                  "why": "a throwaway cell"})
    manifest["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    for m in manifest["end_to_end"]:
        if m["name"] == "enhance_audio_s_per_s":
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    result = small.run(cell, root=root)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"calls_per_s", "enhance_audio_s_per_s", "setup_s"}
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {harness.Path("BENCHMARK.json")}
