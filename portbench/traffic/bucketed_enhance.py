"""Offline-enhancement traffic: a closed loop of
``Inferencer.enhance_bucket(waves, bucket)``, the infer CLI's batched path,
on host batches of seeded clips, cycling a pool of distinct batches.

Every clip of the mix has one length, so every call pads to one bucket: the
Inferencer's rule, the clip's length plus one FFT frame rounded up to
``[inferencer] bucket_seconds``. The Inferencer loads the seeded weights
from a checkpoint file under the run's temporary folder.

Parameters (the mix's file): ``batch`` clips of ``samples`` samples a call,
``pool`` distinct batches, ``warm_calls`` calls of set-up, ``sample_rows``
answers of the window compared with the reference after it (a sample of
all of them, drawn from the seed), ``snr_db`` and ``level_dbfs`` for the
mixtures.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, synth
from portbench.run import Check, Window
from portbench.reference import steps


def clips(run, index: int, device) -> torch.Tensor:
    """Pool batch ``index``: [batch, samples] float32 on ``device``."""
    t = run.traffic
    return synth.speech_pairs(run.seed, index, t["batch"], t["samples"], run.sr, t["snr_db"],
                              t["level_dbfs"], device)[0]


def bucket_samples(run) -> int:
    """The Inferencer's bucket of a clip of the mix's length."""
    step = int(run.recipe["inferencer"]["bucket_seconds"] * run.sr)
    return -(-(run.traffic["samples"] + run.acoustics["n_fft"]) // step) * step


def inferencer(run):
    """The Inferencer of the configuration, on the seeded weights (also kept
    in ``run.state.weights`` for the reference)."""
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    s = run.state
    s.weights = synth.weights(run.family, run.args, run.sr, run.seed, run.device)
    checkpoint = run.tmp / "model.pth"
    torch.save({"model": {k: v.cpu() for k, v in s.weights.items()}}, checkpoint)
    return Inferencer(run.recipe, str(checkpoint), None, device=run.device)


def setup(run) -> None:
    s, t = run.state, run.traffic
    s.inferencer = inferencer(run)
    run.mark("system")
    s.pool = [list(clips(run, i, run.device).cpu().numpy()) for i in range(t["pool"])]
    s.bucket = bucket_samples(run)
    run.mark("inputs")
    for _ in range(t["warm_calls"]):
        s.inferencer.enhance_bucket(s.pool[0], s.bucket)


class Sample:
    """A uniform sample of ``size`` of the window's answers, drawn from the
    seed as they come (a reservoir), so that a long window keeps no more
    than ``size`` of them."""

    def __init__(self, run, size: int):
        self.rng = np.random.default_rng(synth.derive(run.seed, 4))
        self.size, self.seen = size, 0
        self.kept: list[tuple[int, int, np.ndarray]] = []

    def offer(self, index: int, row: int, answer: np.ndarray) -> None:
        """Answer ``row`` of pool batch ``index``, copied if it is kept (it
        may be a view of the call's whole batch)."""
        if len(self.kept) < self.size:
            self.kept.append((index, row, answer.copy()))
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.kept[slot] = (index, row, answer.copy())
        self.seen += 1


def window(run, seconds: float) -> None:
    s, t = run.state, run.traffic
    sample, failed, calls = Sample(run, t["sample_rows"]), 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        index = calls % len(s.pool)
        with run.span("portbench.call"):
            out = s.inferencer.enhance_bucket(s.pool[index], s.bucket)
        if len(out) != t["batch"] or any(len(o) != t["samples"] for o in out):
            failed += t["batch"]
        else:
            for row, answer in enumerate(out):
                sample.offer(index, row, answer)
        calls += 1
    wall = time.perf_counter() - t0
    s.kept = sample.kept
    run.window = Window(wall_s=wall, units=calls,
                        audio_s=calls * t["batch"] * t["samples"] / run.sr,
                        attempted=calls * t["batch"], failed=failed)


def release(run) -> None:
    del run.state.inferencer


def reference_of(run, pairs, precision: dict | None = None) -> np.ndarray:
    """The reference's answers for the clips (pool batch, row) of
    ``pairs``, computed on the run's first card at the configuration's
    precision (the cell's ``precision``) unless another is given."""
    inputs = torch.stack([torch.from_numpy(np.asarray(run.state.pool[i][r])) for i, r in pairs])
    return steps.enhance(run.family, run.args, run.acoustics, run.state.weights,
                         inputs.to(run.device), precision or run.cell.workload["precision"]
                         ).cpu().numpy()


def check(run) -> list:
    answers = sorted(run.state.kept, key=lambda a: a[:2])
    if not answers:
        return [Check("wave_gap", float("nan"), run.cell.workload["limits"]["wave_gap"])]
    program = np.stack([y for _, _, y in answers])
    run.window.failed += int((~np.isfinite(program).all(axis=1)).sum())
    want = reference_of(run, [(i, r) for i, r, _ in answers])
    gaps = compare.wave_gaps(program, want)
    worst = int(np.argmax(gaps))
    at = f"pool batch {answers[worst][0]} row {answers[worst][1]}"
    return [Check("wave_gap", float(gaps[worst]), run.cell.workload["limits"]["wave_gap"], at)]


def control(run, precision: dict | None = None) -> dict[str, tuple]:
    """``wave_gap`` of the reference computed in ``precision`` (the cell's
    ``control`` by default) put in the program's place, on ``sample_rows``
    clips of the pool's first batches. Needs no program."""
    s, t = run.state, run.traffic
    s.weights = synth.weights(run.family, run.args, run.sr, run.seed, run.device)
    need = -(-t["sample_rows"] // t["batch"])
    s.pool = [clips(run, i, run.device).cpu().numpy() for i in range(need)]
    pairs = [(k // t["batch"], k % t["batch"]) for k in range(t["sample_rows"])]
    placed = reference_of(run, pairs, precision or run.cell.workload["control"])
    gaps = compare.wave_gaps(placed, reference_of(run, pairs))
    worst = int(np.argmax(gaps))
    return {"wave_gap": (float(gaps[worst]), f"pool batch {pairs[worst][0]} row {pairs[worst][1]}")}
