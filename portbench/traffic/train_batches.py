"""Training traffic: a closed loop of ``Trainer.train_step(noisy, clean)``
on device batches, cycling a pool of distinct seeded batches, with no host
loader in the window.

Set-up builds the Trainer from the configuration (its dataset lists point
at a few seeded wavs; the loader is never iterated), loads the seeded
weights into it, and drives it through the mix's first ``warm_steps`` steps
on batches 0, 1, 2, ... of the pool: the reference follows those steps from
the same weights and batches. The window goes on with the same Trainer
from the next batch.

Parameters (the mix's file): ``batch`` rows of ``samples`` samples,
``pool`` distinct batches, ``warm_steps``, ``snr_db`` [low, high] and
``level_dbfs`` [low, high] for the mixtures.
"""

from __future__ import annotations

import copy
import time
import wave

import numpy as np
import torch

from portbench import compare, synth
from portbench.run import Check, Window
from portbench.reference import steps

# the faults that calibration plants in the reference put in the program's
# place, by name: the arguments of ``control``
PLANTED = {"half_batch": {"half_batch": True}}


def _write_wav(path, samples: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def _dataset_lists(root, seed: int, sr: int) -> dict[str, str]:
    """One short seeded wav each for the clean, noise and RIR lists the
    Trainer's training set is built from."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(synth.derive(seed, 3))
    out = {}
    for kind, seconds in (("clean", 0.5), ("noise", 0.5), ("rir", 0.05)):
        wav = root / f"{kind}.wav"
        _write_wav(wav, 0.1 * rng.standard_normal(int(seconds * sr)), sr)
        (root / f"{kind}.txt").write_text(f"{wav}\n")
        out[f"{kind}_dataset"] = str(root / f"{kind}.txt")
    return out


def batches(run, indices) -> list[tuple[torch.Tensor, torch.Tensor]]:
    t = run.traffic
    return [synth.speech_pairs(run.seed, i, t["batch"], t["samples"], run.sr, t["snr_db"],
                               t["level_dbfs"], run.device) for i in indices]


def _optimizer(run) -> dict:
    opt, clip = run.recipe["optimizer"], run.recipe["trainer"]["train"]["clip_grad_norm_value"]
    return {"lr": opt["lr"], "betas": (opt["beta1"], opt["beta2"]), "clip": clip}


def setup(run) -> None:
    from fullsubnet_tpu_torch.train.trainer import Trainer

    t, s = run.traffic, run.state
    s.weights = synth.weights(run.family, run.args, run.sr, run.seed, run.device)
    config = copy.deepcopy(run.recipe)
    config["train_dataset"]["args"].update(_dataset_lists(run.tmp / "lists", run.seed, run.sr))
    s.trainer = Trainer(config, output_dir=str(run.tmp / "runs"), experiment_name=run.cell.name,
                        device=run.device)
    s.trainer.model.load_state_dict(s.weights)
    run.mark("system")
    s.pool = batches(run, range(t["pool"]))
    run.mark("inputs")
    beta1 = run.recipe["optimizer"]["beta1"]
    s.losses = []
    for k in range(t["warm_steps"]):
        s.losses.append(float(s.trainer.train_step(*s.pool[k])))
        if k == 0:
            # Adam's first moment after one step is (1 - beta1) g; a
            # parameter the step left without state got no gradient
            state = s.trainer.optimizer.state
            s.grad1 = {name: float(torch.linalg.vector_norm(state[p]["exp_avg"])) / (1 - beta1)
                       if "exp_avg" in state.get(p, {}) else 0.0
                       for name, p in s.trainer.model.named_parameters()}
    s.change = {name: float(torch.linalg.vector_norm(p.detach() - s.weights[name]))
                for name, p in s.trainer.model.named_parameters()}


def window(run, seconds: float) -> None:
    t, s = run.traffic, run.state
    losses, i = [], t["warm_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with run.span("portbench.step"):
            losses.append(s.trainer.train_step(*s.pool[i % len(s.pool)]))
        i += 1
    run.sync()
    wall = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    run.window = Window(wall_s=wall, units=len(losses),
                        audio_s=len(losses) * t["batch"] * t["samples"] / run.sr,
                        attempted=len(losses), failed=failed)


def release(run) -> None:
    s = run.state
    s.ref_batches = s.pool[: run.traffic["warm_steps"]]
    if s.trainer.writer is not None:
        s.trainer.writer.close()
    del s.trainer, s.pool


def reference(run, precision: dict | None = None, half_batch: bool = False) -> dict:
    """The reference's steps at the configuration's precision (the cell's
    ``precision``) unless another is given."""
    s = run.state
    return steps.train_steps(run.family, run.args, run.acoustics, s.weights, s.ref_batches,
                             precision=precision or run.cell.workload["precision"],
                             half_batch=half_batch, **_optimizer(run))


def check(run) -> list:
    s = run.state
    w = run.cell.workload
    numbers = compare.train_numbers(s.losses, s.grad1, s.change, reference(run),
                                    w["loss_steps"], w["change_leaf"])
    return [Check(k, v, run.cell.workload["limits"][k], at) for k, (v, at) in numbers.items()]


def control(run, precision: dict | None = None, half_batch: bool = False) -> dict[str, tuple]:
    """The numbers of the reference put in the program's place: computed in
    ``precision`` (the cell's ``control`` by default), or at the
    configuration's precision with the planted half-batch fault; against the reference on the seed's weights and first
    batches. Needs no program."""
    s = run.state
    s.weights = synth.weights(run.family, run.args, run.sr, run.seed, run.device)
    s.ref_batches = batches(run, range(run.traffic["warm_steps"]))
    placed = reference(run, precision or (None if half_batch else run.cell.workload["control"]),
                       half_batch)
    w = run.cell.workload
    return compare.train_numbers(placed["losses"], placed["grad1"], placed["change"],
                                 reference(run), w["loss_steps"], w["change_leaf"])
