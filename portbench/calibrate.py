"""The readings that the limits of a cell's compared numbers are set from,
on the chip at the cell's own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 --out <dir> [--seconds 3]

* the program's numbers, one short run of the cell a seed (training reads
  its numbers in set-up and needs no window; enhancement compares as many
  answers as a full run does);
* the control's: the reference computed one precision below the
  configuration's (the cell's ``control``) put in the program's place;
* the faults the cell's traffic kind plants (its ``PLANTED``), in the
  reference put in the program's place: for training, "half of the batch
  left out, the mean taken over the rest".
  ("A step that returns its state unchanged" reads 1 on ``change_gap`` by
  the measure and needs no run.)

Each reading is one JSON line on standard output and in
``<out>/calibrate.<cell>.jsonl``. Never run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import tempfile
import time
from pathlib import Path

import torch

from portbench import run as harness


def _emit(line: dict, sink) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    sink.write(text + "\n")
    sink.flush()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s)")
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    kind = harness.kind_module(cell)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    with open(out / f"calibrate.{cell.name}.jsonl", "a") as sink:
        for seed in seeds:
            result = harness.run_cell(cell, seed, args.seconds, False, devices)
            _emit({"cell": cell.name, "reading": "program", "seed": seed,
                   "numbers": {k: v["value"] for k, v in result["checks"].items()},
                   "at": {k: v["at"] for k, v in result["checks"].items()},
                   "failed": result["failed"], "attempted": result["attempted"]}, sink)
            gc.collect()
            torch.cuda.empty_cache()
        faults = {"control": {}, **getattr(kind, "PLANTED", {})}
        for seed in control_seeds:
            for name, kwargs in faults.items():
                with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
                    run = harness.Run(cell, seed, devices, Path(tmp), False)
                    t0 = time.perf_counter()
                    numbers = kind.control(run, **kwargs)
                _emit({"cell": cell.name, "reading": name, "seed": seed,
                       "numbers": {k: v for k, (v, _) in numbers.items()},
                       "at": {k: at for k, (_, at) in numbers.items()},
                       "precision": cell.workload["precision" if kwargs else "control"],
                       "seconds": time.perf_counter() - t0}, sink)
                del run
                gc.collect()
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
