"""Offline enhancement one clip at a time: a closed loop of
``Inferencer.full_band_crm_mask(noisy [1, T])``, the infer CLI's path at
the recipe's own ``batch_size`` of 1, where each clip runs at its exact
length, cycling a pool of distinct seeded clips. As the CLI does, each call
copies its host clip to the card and returns the enhanced clip to the host.

Parameters (the mix's file): those of ``bucketed_enhance``, with ``batch``
1 (a pool batch is one clip).
"""

from __future__ import annotations

import time

import torch

from portbench.run import Window
from portbench.traffic import bucketed_enhance as bucketed

release, reference_of, check, control = (
    bucketed.release, bucketed.reference_of, bucketed.check, bucketed.control)


def setup(run) -> None:
    s, t = run.state, run.traffic
    if t["batch"] != 1:
        raise ValueError(f"exact_enhance enhances one clip a call, not {t['batch']}")
    s.inferencer = bucketed.inferencer(run)
    run.mark("system")
    s.pool = [bucketed.clips(run, i, run.device).cpu().numpy() for i in range(t["pool"])]
    run.mark("inputs")
    for _ in range(t["warm_calls"]):
        s.inferencer.full_band_crm_mask(torch.from_numpy(s.pool[0]).to(run.device))


def window(run, seconds: float) -> None:
    s, t = run.state, run.traffic
    sample, failed, calls = bucketed.Sample(run, t["sample_rows"]), 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        index = calls % len(s.pool)
        with run.span("portbench.call"):
            out = s.inferencer.full_band_crm_mask(torch.from_numpy(s.pool[index]).to(run.device))
        if out.shape != (t["samples"],):
            failed += 1
        else:
            sample.offer(index, 0, out)
        calls += 1
    wall = time.perf_counter() - t0
    s.kept = sample.kept
    run.window = Window(wall_s=wall, units=calls, audio_s=calls * t["samples"] / run.sr,
                        attempted=calls, failed=failed)
