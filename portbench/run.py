"""One run of one cell of the port's benchmark.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell's configuration (its ``file``), its traffic mix
(``portbench/traffic/<traffic>.toml``, whose ``kind`` names the generator
and loop ``portbench/traffic/<kind>.py``), the cell's own settings
(``portbench/workloads/<cell>.toml``: the kernel libraries it builds and
the limits of the numbers it compares) and each metric's reader
(``portbench/metrics/<metric>.py``). A new cell, mix, configuration or
metric is new files and entries; no file here changes.

A run: the cell's kernel libraries built at once (only the first run in a
checkout compiles), the inputs and weights made from the seed, the system
under test built and warmed up on every shape the window uses (all of it
``setup_s``), then ``--seconds`` of closed-loop traffic, the peak memory
read, the program's state freed, and the plain reference run over what the
window produced. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. ``--trace 1`` profiles the window and reports the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import tomllib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import trace as tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level modules that may not be loaded in a run's process: JAX and the
# JAX package, whose name the port's begins with (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fullsubnet_tpu")


def _toml(path: Path) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file: the recipe's sections and [bench]
    traffic: dict  # the traffic mix's parameters
    workload: dict  # the cell's libraries and limits
    metrics: list[dict]  # BENCHMARK.json's entries reported with --trace 0
    layer_metrics: list[dict]  # those reported with --trace 1

    @property
    def family(self) -> str:
        return self.config["bench"]["family"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, every file found by
    the names there."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])

    def of_cell(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_toml(root / config["file"]),
        traffic=_toml(root / "portbench" / "traffic" / f"{entry['traffic']}.toml"),
        workload=_toml(root / "portbench" / "workloads" / f"{name}.toml"),
        metrics=[m for m in manifest["end_to_end"] if of_cell(m)],
        layer_metrics=[m for m in manifest["per_layer"] if of_cell(m)],
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kind_module(cell: Cell):
    return importlib.import_module(f"portbench.traffic.{cell.traffic['kind']}")


@dataclasses.dataclass
class Window:
    """What the measured window did: ``units`` steps or calls in
    ``wall_s`` seconds, ``audio_s`` audio-seconds of work, ``attempted``
    answers of which ``failed`` were missing or wrong."""

    wall_s: float
    units: int
    audio_s: float
    attempted: int
    failed: int = 0


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    at: str = ""  # where the value was read: a step, a leaf, a clip

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Run:
    """One run's state, handed to the traffic kind and the metric readers."""

    def __init__(self, cell: Cell, seed: int, devices: list, tmp: Path, traced: bool):
        self.cell, self.seed, self.tmp, self.traced = cell, seed, tmp, traced
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.recipe = {k: v for k, v in cell.config.items() if k != "bench"}
        self.family = cell.family
        self.args = self.recipe["model"]["args"]
        self.acoustics = self.recipe["acoustics"]
        self.sr = int(self.acoustics["sr"])
        self.traffic = cell.traffic
        self.state = SimpleNamespace()
        self.window: Window | None = None
        self.trace = None  # trace.Summary of a traced window
        self.setup_s = self.build_s = 0.0
        self.cold = False  # whether a kernel library had to be compiled
        self.marks: list[tuple[str, float]] = []

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, for the result line's breakdown."""
        self.marks.append((phase, time.time()))

    def span(self, name: str):
        """A named host span in a traced run; nothing otherwise."""
        return torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()

    def sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)


def build_libraries(names: list[str]) -> tuple[float, bool]:
    """Build (or load) the named kernel libraries of
    ``fullsubnet_tpu_torch.ops.subband_lstm`` all at once: each library's
    ``.cu`` files compile in parallel inside it, and the libraries in
    parallel with each other. Returns the seconds and whether any had to be
    compiled."""
    from fullsubnet_tpu_torch.ops import build
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    libraries = [getattr(ops, name) for name in names]
    cold = not all(build.library_path(lib.NAME, list(lib.SOURCES)).exists() for lib in libraries)
    t0 = time.perf_counter()
    if libraries:
        with ThreadPoolExecutor(len(libraries)) as pool:
            for future in [pool.submit(lib) for lib in libraries]:
                future.result()
    return time.perf_counter() - t0, cold


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def peak_bytes(devices) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, devices: list,
             started: float | None = None, root: Path = ROOT) -> dict:
    """Run ``cell`` once on ``devices`` (torch device names, one a chip the
    cell asks for) and return the result line's object."""
    started = time.time() if started is None else started
    kind = kind_module(cell)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        run = Run(cell, seed, devices, tmp, traced)
        run.marks.append(("start", started))
        run.mark("process")
        if run.device.type == "cuda":
            run.build_s, run.cold = build_libraries(cell.workload.get("libraries", []))
        run.mark("libraries")
        kind.setup(run)
        run.sync()
        run.mark("warm-up")
        if traced:
            with tracing.profiled() as prof:
                run.setup_s = time.time() - started
                with torch.profiler.record_function(tracing.WINDOW_SPAN):
                    kind.window(run, seconds)
            run.trace = tracing.summarize(prof, sorted({d.index or 0 for d in run.devices}))
            del prof
        else:
            run.setup_s = time.time() - started
            kind.window(run, seconds)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"modules loaded in the run's process: {', '.join(found)}")
        peak = peak_bytes(run.devices)
        kind.release(run)
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = kind.check(run)
        t_check = time.perf_counter() - t_check
        wanted = cell.layer_metrics if traced else cell.metrics
        metrics = {}
        for m in wanted:
            value = reader(m["name"], root)(run)
            if value is None and not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            if value is None:
                # left out of the line, which the cell's listing then lacks
                print(f"per-layer metric {m['name']} listed for {cell.name} read nothing",
                      file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        w = run.window
        correct = w.failed == 0 and all(c.passed for c in checks)
        device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
                  "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
                  "count": len(run.devices), "memory_peak_bytes": peak}
        out = {"correct": correct, "attempted": w.attempted, "failed": w.failed,
               "metrics": metrics, "device": device}
        if traced:
            device["busy_s"] = run.trace.busy_mean_s
            device["window_s"] = run.trace.window_s
            out["breakdown"] = run.trace.breakdown()
        phases = {b[0]: b[1] - a[1] for a, b in zip(run.marks, run.marks[1:])}
        out["setup"] = {"setup_s": run.setup_s, "build_s": run.build_s,
                        "cold": run.cold, "phases": phases}
        out["window"] = {"wall_s": w.wall_s, "units": w.units, "audio_s": w.audio_s,
                         "check_s": t_check}
        out["checks"] = {c.name: {"value": c.value, "limit": c.limit, "at": c.at} for c in checks}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def main(argv=None, started: float | None = None) -> int:
    started = _process_start() if started is None else started
    parser = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(cell.chips)], started)
    found = forbidden_modules()
    if found:
        print(f"modules loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']} failed {result['failed']} of {result['attempted']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} at {c['at']}", file=sys.stderr)
    sys.stderr.flush()
    return 0
