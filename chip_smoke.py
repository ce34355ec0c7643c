#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship paths once on one NVIDIA GPU and
check them: inference (K1 as the fp32 GEMM and cluster walk stages) and a
training step (K2 as the tensor-core GEMM and the LSTM training walk, and
K3 as the tensor-core GEMM and LSTM walk, at bf16) with the recipe's LSTM
cell, then the same paths with the GRU cell (``sequence_model = "GRU"``:
K1-GRU as the GEMM and GRU walk stages, K2-GRU as the GEMM and the GRU
training walk, and K4 as the GEMM and GRU walk at bf16). The fp32 steps
run the fp32 training forward as stages (K2, K2-GRU: the fp32 GEMM of K1
for the input projections and the head, and the fp32 training walk of
either cell, K1's cluster walk with its c stream for few rows or the
streaming walk for many) and the fp32 layer backward as stages (K3, K4:
the fp32 GEMM of K1 with a second K segment, and the fp32 walk of either
cell); at either storage type the layer backward's dW stage (K3, K4: the
persistent TMA-fed GEMM of rnn_dw_tma.cu over the cotangent streams, the
split-K GEMM of rnn_dw.cu of the earlier design beside it). The inference
kernels of the earlier design (lstm_scan, gru_scan), the earlier fp32
training forward (stash_fwd, gru_stash_fwd) and layer backward (layer_bwd,
gru_layer_bwd) and the earlier training kernels' bf16 instances are
checked and timed beside their redesign. Two more paths run K1's stages
at their own shapes: batched, length-masked inference (``[inferencer]
batch_size``) and validation in the train loop (the recipe's
``[validation_dataset]``, every 2 epochs, and ``-V``).

    python3 chip_smoke.py              # from the root of a checkout, one card
    python3 chip_smoke.py --fp32-step  # the fp32 train step's numbers alone
    python3 chip_smoke.py --validation-epoch  # a validation epoch at the DNS
                                              # test set's size, both cells
    python3 chip_smoke.py --families   # phases 17-21 alone (after the build)
    python3 chip_smoke.py --batched-throughput  # phase 8b alone, for the
                                                # checkout the script sits in
    python3 chip_smoke.py --streaming  # phase 22 alone (after the build)
    python3 chip_smoke.py --serving    # phase 23 alone (after the build)
    python3 chip_smoke.py --train-scale  # phase 24 alone (after the build)
    python3 chip_smoke.py --bf16-forward  # phase 25 alone (after the build)
    python3 chip_smoke.py --chunked-train  # phase 26 alone (after the build)
    python3 chip_smoke.py --dw         # the dW stage of phases 4 and 6 alone
                                       # (after the build), on random streams
    python3 chip_smoke.py --parallel-enhance  # the multi-card enhancer on 1, 2
                                       # and 4 cards (after building its
                                       # libraries); run it on four cards
    python3 chip_smoke.py --last-modules  # phase 28 alone (after the build and
                                          # phase 11's LSTM step)

Phases, in the order they run (each one that fails ends the run with exit
code 1):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN;
2. build: compile the eleven kernel libraries from
   ``fullsubnet_tpu_torch/ops/csrc``, one nvcc per source, all started
   together, and print ptxas's registers, shared memory and spills;
3. K1 at the flagship inference shapes (T = 400), fp32: the main
   path's stages (the GEMM and the walk) and the whole forward against
   plain PyTorch and cuDNN ``nn.LSTM`` + Linear; times of the stages (GEMM
   ms, walk ms and us a step, the walk's tile and clusters in flight,
   block 0's cycles by phase), of the earlier kernel (lstm_scan), the plain version,
   cuDNN and cuBLAS on the GEMMs' products, and the bounds; at N = 2056,
   T = 400 the fp32 training walk's streaming form (the LSTM's with its c
   stream) on the same walks, beside the cluster walk;
4. K2 and K3 vs plain at the flagship training shapes (both stages at
   B = 32 x 3.072 s), fp32 and bf16: the forward output and stashes and
   the layer backward's outputs (the fp32 stages at fp32, the tensor-core
   stages at bf16), and the gradients of a fixed loss through
   ``RnnScanFunction`` against autograd of the plain version; times of the
   forward, the layer backward, the dW products, the plain version and
   cuDNN; each stage of the forward and the layer backward against its
   plain version, its time (GEMMs and walks apart, TFLOP/s, us a step,
   block 0's cycles by phase; the fp32 training walk's ptxas registers and
   spills), cuBLAS on the GEMMs' products, a sweep of each walk's forms;
   the earlier fp32 training forward and layer backward and the earlier
   kernels' bf16 instances; the dW stage (dw_tma) against its plain
   version on the same streams, the same bits on a repeat (ms, TFLOP/s,
   the share of the bound, the plan's units and CTAs, the bound, the split-
   K dw_gemm of the earlier design, cuBLAS on the same stored operands in
   the storage type, and a sweep over K at the chunk shapes);
5. GRU: K1-GRU as phase 3, against ``nn.GRU`` + Linear, beside the earlier
   kernel (gru_scan);
6. GRU: K2-GRU and K4 vs plain at the phase-4 shapes, fp32 and bf16, as
   phase 4;
7. inference end to end: random full-width FullSubNet weights from a seed,
   three noisy wavs, the flagship inference TOML, and the port's CLI on the
   card; the outputs, the launch counts by shape (per utterance and stage
   a GEMM per layer and one for the head, a walk per layer; no
   lstm_scan or gru_scan), and the card's cIRM against the plain CPU path;
8. the model forward's real-time factor at B=1 and B=8 x 10 s, and at
   B=128 x 30 s (one call after a warm-up: audio-s/s, peak memory beside
   the unfused input's 24.14 GiB before the fused sub-band stage, finite
   output; the sub-band input built by the fused stage); at that shape
   each stage through K1's stages (the earlier kernel, lstm_scan, is timed
   at phase 3's shapes only), through cuDNN ``nn.LSTM`` + Linear
   over the stages' time chunks with (h, c) carried and through the plain
   stages over the same chunks, on the inputs the forward gives it (one
   call each, timed as it is compared), all held to each other; then
   a torch.profiler breakdown of the B=1 forward;
8a. batched inference: the infer CLI with ``[inferencer] batch_size = 8``
   over 12 wavs of 0.01 to 12 s (ten buckets of 1 s, each a partial
   flush of its own rows, no filler; 0.01 s takes the exact path): finite
   outputs at the input's length and rate, peak 0.8; each output before
   its int16 write against the ``batch_size = 1`` run's; K1's launches by
   shape, a set for each flush at N = rows·257 and rows;
8b. the batched Inferencer at B=128 x 30 s (``enhance_bucket`` in memory,
   one call after a warm-up): audio-s/s, peak memory (the fused
   sub-band stage's, beside the unfused input's 24.14 GiB), the share
   outside the model and the host padding, beside phase 8's model
   forward; K1's launches by shape (the sub-band stage in 93 chunks);
9. training end to end: 64 clean wavs, 4 noise wavs and 2 RIRs written from
   a seed, and two validation directories of the DNS layout (with_reverb,
   no_reverb: 3, 7 and 10 s each), a copy of the flagship train TOML
   pointed at them (3 epochs, validation at epoch 2 as the recipe sets),
   and the port's train CLI on the card; finite losses, launch counts by
   shape outside the validation epoch, and apart for epoch 3, which trains
   after validating in the same Trainer (a step: the GEMM 6 times in the
   forward and 8 in the backward, the LSTM training walk 4, the LSTM
   walk 4 times and the dW stage 4, by shape; no other kernel, the earlier
   K2 none), in it K1's stages alone (per utterance a GEMM per layer and
   one for the head and a walk per layer in both stages) and finite
   ``Validation/*`` scalars, the checkpoint set with ``best_model.tar``,
   ``-R`` resuming at epoch 4 (which validates again), and the infer CLI
   on the epoch-3 weights;
9a. validation: ``-P model_0002.pth -V`` on the card (as phase 9's
   validation epoch, STOI in [0, 1], PESQ in [-0.5, 4.5], no step, no
   launch outside the epoch, ``best_model.tar``) and on the CPU (no
   launch); the card's enhanced waveforms, losses and scalars against the
   CPU's; each epoch's wall time, the forward and the host metrics apart
   (6 clips: mostly the metric pool's start; ``--validation-epoch`` times
   an epoch at the DNS synthetic test set's 2 x 150 clips of 10 s);
10. one fp32 step at B=4 x 3.072 s, full width: the loss and every gradient
    on the card against the port's plain CPU path; fwd_gemm 14 (6 in the
    forward, 8 in the backward), the fp32 LSTM training walk 4 (2 in each
    form), the fp32 LSTM walk 4 times and the dW stage 4, no launch of the
    earlier fp32 K2 or K3, of an inference walk or of a tensor-core stage;
11. the train step's audio-seconds per second at B=32 x 3.072 s (median of
    5 after 2 warm-ups), its launches a step, its peak memory (under 24
    GiB), and a torch.profiler breakdown of one step, in which the library
    GEMMs are no more than the head backward's 4 (no dW sgemm);
12. GRU: the infer CLI on a copy of the inference TOML that sets
    ``sequence_model = "GRU"``: the launch counts of phase 7 with the GRU
    walk, none of the LSTM walk, lstm_scan or gru_scan; the card's cIRM
    against the CPU path;
12a. GRU: batched inference, as phase 8a;
13. GRU: the train CLI on a GRU copy of the train TOML, 1 epoch and ``-R``
    (which validates at epoch 2): the launches of phase 9 with the GRU
    walks (the dW stage 8: two problems a layer), none of the LSTM's and
    no K2-GRU;
13a. GRU: validation, as phase 9a;
14. GRU: one fp32 step at B=4, card vs CPU; fwd_gemm 14, the fp32 GRU
    training walk 4, the fp32 GRU walk 4 times and the dW stage 8, no
    earlier K2-GRU or K4;
15. GRU: the train step's numbers, as phase 11;
16. the flagship train step at fp32 storage (``use_amp = false``), B=32 x
    3.072 s, both cells: median of 5 after 2 warm-ups, audio-s/s, peak
    memory, launches a step and the profile's top kernels (library GEMMs
    no more than the head backward's 4); then the same
    step with the earlier fp32 training forward in the dispatch, in the same
    run;
17. the full-band baseline (``fullband_baseline/{inference,train}.toml``,
    3 LSTM layers of 512 over 257 bins, a head to 514), random weights
    from a seed: the infer CLI on three wavs (K1's launches by shape, the
    card's cRM against the plain CPU path), the batched infer CLI
    (``batch_size = 8``) against ``batch_size = 1``, the RTF at B=1 x 10
    s; the infer CLI with the ``mag`` and ``scaled_mask`` strategies on
    three wavs (K1's launches by shape, the card's waveform against the
    plain CPU path); the train CLI on the recipe as shipped but its data
    (one epoch of B=32, ``weight_init = true``; the tensor-core stages'
    launches by shape); one fp32 step at B=4 card vs CPU (the fp32 stages'
    launches by shape); the recipe's bf16 step at B=100 (median of 5 after
    2 warm-ups, audio-s/s, peak memory, launches by shape, the profile's
    library GEMMs);
18. the sub-band baseline (``subband_baseline/train.toml``: 2 layers of
    H = 320 over units of 31, drop_band): the infer CLI with its
    ``sub_band_crm_mask`` strategy (the recipe ships no inference TOML:
    one is written from the train recipe's ``[acoustics]`` and
    ``[model]``, ``n_neighbor = 15``) on three wavs, K1's launches by shape
    (N = 257 rows of 31), ``batch_size = 4`` against ``batch_size = 1``,
    the card's waveform against the plain CPU path, the RTF at B=1 x 10 s,
    and K1 at that shape (N = 257, T = 626) against the plain version and
    cuDNN with its bound; then as 17 from the train CLI on, the step at
    B=32;
19. Fast FullSubNet (``fast_fullsubnet/{inference,train_shrinkSize2}.toml``):
    as 17 without the extra strategies, and the batched infer CLI with
    ``norm_type = "offline_gaussian_norm"`` against ``batch_size = 1`` on
    wavs whose downsampled clocks end in a partial tail block; the step at
    B=72. Its mel projection promotes to the fp32
    filterbank, as in the JAX package, so its training stacks take the
    fp32 stages under ``use_amp``, so its step card vs CPU runs at fp32
    alone; its two head-less stacks launch no head GEMM, and its 257-unit
    stack runs zero-padded to 272 units;
20. Improved FullSubNet at 16 kHz and 48 kHz
    (``improved_fullsubnet/train_{16k,48k}.toml``: a full-band stack of 2
    x 512 over 256 or 480 bins and 3 or 4 sections of 2 x 384 over units
    of (c + 30)·2 with heads of 2c), random weights from a seed, each on
    wavs and data at its rate: the infer CLI with ``time_domain`` (the
    repo ships no inference TOML: one is written from the recipe's
    ``[acoustics]`` and ``[model]``) on three wavs, at ``batch_size = 4``
    against ``batch_size = 1``, and with ``overlapped_chunk``, K1's
    launches by shape for every stack, call and chunk; the card's
    waveform against the plain CPU path; the RTF at B=1 x 10 s; the train
    CLI on the recipe as shipped but its data and epochs (two epochs of
    B=16, validation at epoch 2 as the recipe sets it: the waveform loss
    and the metric pool), the fp32 stages' launches by shape beside
    validation's K1; one step at the recipe's B=16 card vs CPU at fp32 (under
    ``use_amp`` its stacks run the same fp32 stages, so that step is not
    repeated); the recipe's step at B=16 (its stacks at fp32 under
    ``use_amp``: no tensor-core stage), its library GEMMs no more than the
    heads' backward's (8 at 16 kHz, 10 at 48 kHz), and each stack's walk
    forms;
21. the offline tools: ``fullsubnet_tpu_torch.tools.calculate_metrics`` on
    phase 18's ``sub_band_crm_mask`` outputs against the tones they were
    made from (SI_SDR, STOI, WB_PESQ, ``--export_dir``, 3 spawned
    workers), in a subprocess where importing jax or joblib fails: exit 0,
    a .csv and a .xlsx per metric, the rows and means equal to the port's
    metrics computed in-process.
22. streaming inference (``infer/streaming.py``): K1 and K1-GRU at T = 1
    from random non-zero (h0, c0) at every stack shape a hop runs (the
    full band at N = 1 and 8, the sub band at N = 257, 8·257 and 64·257,
    Fast's bottleneck at N = 64 and its 257-unit stack at 272): the
    stateful stack (``fused_subband_lstm_step``) and the walk alone against
    their plain versions on the card, final states included, timed beside
    the plain stages, cuDNN with ``hx`` + Linear and the bound; the
    cumulative-norm recipe (``fullsubnet/inference_cum.toml``, full width,
    random weights) built by the Inferencer and wrapped in
    ``StreamingEnhancer``: 10 s in 256-sample hops with the plain stages
    refused, 10 K1 launches a hop from the wrappers' counts, the per-hop
    wall (median and p99) and real-time factor, a torch.profiler
    breakdown of a 50-push stream (device busy a hop, launches a hop), the
    stream against the CPU's and against the card's offline
    ``full_band_crm_mask``;
    ``MultiStreamEnhancer`` at 8 and 64 lanes (ms a tick, every lane
    against its own stream); the full-band baseline, Fast FullSubNet and
    Improved FullSubNet at 16 and 48 kHz with the cumulative norm written
    into a copy of their TOMLs, 3 s each card vs CPU, per-hop wall.
23. serving (``serving.py``): the flagship ``inference.toml`` exported
    with ``torch.export`` on the card, bucketed at 2 s and 11 s (batch 1)
    and at 11 s for batch 8, ``inference_cum.toml`` as a stream and as 8
    lanes, and its GRU copy as a stream (random full-width weights); a
    child process loads and serves them with the port's serving classes
    alone, where importing jax, the JAX package or the port's models,
    engines, Inferencer or trainer fails, and the plain stages are refused:
    10 s at B=1 (and 1.5 s in the 2 s bucket), 8 utterances of 3-10 s in
    one batched call, 10 s streamed, 8 lanes of 2 s, 3 s of the GRU
    stream. The same runs on the live eager path here; every served
    output within 1e-5 of the live one's peak, the served K1 / K1-GRU
    launches by shape equal to the live path's (10 a flagship hop); the
    served hop's median and p99 wall and the served RTF at B=1 x 10 s
    beside the live path's.
24. training at scale, the flagship train TOML at full width: (a) one
    optimizer step at B=32 x 3.072 s with ``grad_accum_steps = 2`` and
    one with 1, same weights and batch, bf16 and fp32: the loss and the
    pre-clip gradients held to each other, the launches by shape twice a
    microbatch of 16's stacks, each step's median wall and peak memory;
    (b) 32 items at the same (seed, epoch, index) mixed on the card
    (``device_synthesis``, f32 and int16 transfers) against the host
    mixer, within 1e-5 and 1e-4 of each row's peak, the synthesis's
    device time, and the loader's steady seconds a batch at the recipe's
    ``num_workers`` over 96 batches after the first 32 (which the workers
    make at once) for device synthesis (phase 28 times host mixing), beside
    one item's time in one process; (c) the
    train CLI under ``python -m torch.distributed.run --nproc_per_node 1``
    over NCCL for 2 epochs with validation, ``grad_accum_steps = 2`` and
    ``device_synthesis``, then ``-P model_0002.pth -V`` (checked in that
    process: launches by shape, validation, checkpoints), and two ranks on
    the one card over gloo, each with half of a global batch of 32, against
    one process's step (loss, pre-clip gradients; the update against one
    clip and optimizer step replayed on the rank's gradients).
25. K1-bf16 (the inference forward on a bf16 x: ``tc_gemm`` for the input
    projections and the head, and the bf16 walk in the form
    ``pick_fwd_bf16_form`` picks: the tensor-core walk of ``rnn_fwd_tc.cu``,
    the cluster walk of ``rnn_fwd.cu`` or the bf16 training walk's inference
    form from ``rnn_train_fwd_tc.cu``) and K1-GRU-bf16 against their plain
    versions at Improved FullSubNet's 16 kHz stacks over 10 s (B = 1 and
    16, section 0 at 64 too), the flagship sub-band stack at N = 257 and
    2,056, T = 400, and the chunked training forward's N = 4,096, T = 195:
    every stage and the three walk forms held and timed, with block 0's
    cycles by phase, beside the fp32 K1 on the same input, the plain
    version and cuDNN at bf16 + Linear; the tensor-core walk at every tile
    that fits (past 64 rows) and each case's forms in one line, the sweep
    behind the picker's constants; the dispatched form's launches held to
    the picker; then the main path, Improved FullSubNet with
    ``compute_dtype = "bfloat16"`` at B = 1, 16 and 64 x 10 s for both
    cells (launches of K1-bf16's kernels alone, by walk form as the picker
    names it, the plain stages refused; card vs CPU; RTF at each batch
    beside fp32), the same model exported bucketed and served, and the
    recipe's train step with compute_dtype beside the recipe as shipped
    (``--bf16-forward`` runs it alone).
26. the time-chunked training stash (``--chunked-train`` runs it alone),
    after a check that every training call of phases 9-25 kept the full
    stash (chunk 0): (1) the flagship step at B=32 x 3.072 s with the
    sub-band stage's chunk forced to 64 (chunks of 64, 64, 64 and 3 steps)
    against the same step unchunked, bf16 for the LSTM and the GRU, fp32
    for the LSTM at B=8: the loss and every gradient, both steps' launches
    against the formula (a chunk: K1's stages forward, K2 re-run, K3/K4
    and the dW stage backward); the training op alone at the sub-band
    stage's shape (N = 4,096, T = 195, bf16, both cells), chunked on the
    kernels against the plain chunked op on the card, timed beside the
    unchunked op, cuDNN + Linear and the bound; (2) the flagship bf16 step at B=32 x 30 s
    crops, whose full stash does not fit the card: the chunk the sub-band
    stage's share picks, finite loss and gradients, the launches against
    the formula, the median of 3 steps after a warm-up, the peak memory
    beside the accounting's prediction (within 15%) and the card's memory,
    and the unchunked route's predicted bytes (not run), the dW stage's
    device time in one step and its share of the median step (CUDA events
    around each weight_grads call), and the sub-band stage's op alone at
    that shape timed beside its bound and beside cuDNN bf16 nn.LSTM +
    Linear over the same chunks, (h, c) carried, each chunk under
    torch.utils.checkpoint (the largest chunk that fits, halving, where
    one does not); (3) the fused
    sub-band stage forced at inference against the unfused route at B=8 x
    10 s for both fusable norms: the cRM, the peak memory, equal K1
    launches.
27. the multi-card enhancer (``parallel/inference.py``,
    ``make_parallel_enhancer``) on the flagship recipe at full width, LSTM
    and GRU, on a mesh of the card (data = 1) and of the card twice (data =
    2: the split, a host thread a slice, the gather): the plain form at B=8
    x 10 s, fp32 and compute_dtype bf16, and the bucketed form at B=8 over
    seeded lengths of 2-10 s; each output against the one-card path (the
    model with ``full_band_crm_mask`` or ``bucketed_enhance``) within 1e-5
    of its peak, and whether the bits are equal; K1's or K1-bf16's launches
    by shape and by card as the slices need (the bf16 walk's by form), the
    plain stages refused, the weights on the card once a weight set.
    ``--parallel-enhance`` (not in the whole smoke) times the enhancer at
    B=128 x 30 s on meshes of 1, 2 and 4 cards, fp32 and bf16, and the
    bucketed form over 2-30 s on the most cards against one: audio-s/s
    (median of 3 after a warm-up), the scaling efficiency, each card's busy
    time (a profiled call), the gather's time, each slice's host time, each
    card's peak memory, the launches by shape and card, the output against
    the one-card mesh's within 1e-5 of its peak; its last line is the
    smoke's.
28. the last modules of the JAX package in the port: (a) the host mixer
    (``native/``) built with g++ into a folder of its own (its seconds) and
    32 seeded items of the flagship's training set at reverb 0.5 against
    the same items mixed in numpy (``TrainDataset.plain_snr_mix``), within
    tests/test_native.py's tolerances; (b) the loader's steady ms a batch
    at the recipe's 16 workers mixing in the host mixer (the path) and in
    numpy over the same batches, beside phase 11's bf16 step (recorded, not
    gated); (c) ``profiling.trace`` around one flagship forward at B=1 x 10
    s with ``annotate`` spans "fullband" and "subband" on the two stacks, in
    a fresh process (``--trace-child``): the trace file names both spans and
    K1's walk kernel; ``timed``'s RTF beside phase 8's,
    ``device_memory_stats``'s peak; the same trace in the smoke's own
    process beside it, its events by category recorded, not gated (late in
    the whole smoke its traces have held the spans but no kernel); (d)
    ``roofline_fields`` of that forward (fp32) and of phase 11's bf16 step
    at B=32 x 3.072 s (``train=True``, drop_band's 2 groups): ``mfu``,
    ``hbm_bw_util_lb`` and ``roofline_ratio``, each in (0, 1.05].

Each path's launch counts are set to 0 just before it runs and read just
after; the LSTM paths must launch no GRU kernel and the GRU paths no LSTM
kernel. Phases 17-20 and 22 hold every path's launches by shape to what
their stacks need, fixed in this script from the recipes. The last line
of stdout is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit, and before that one JSON line with each
kernel's launches on its main path, error and times.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

try:  # the port's counts of a kernel's work and the H100's peaks (main()
    # refuses to run outside a checkout, where this import fails)
    from fullsubnet_tpu_torch import roofline
    from fullsubnet_tpu_torch.roofline import GATES, bound, stack_flops, weight_elems
except ImportError:
    pass

REPO = Path(__file__).resolve().parent
RECIPE = REPO / "recipes" / "dns_interspeech_2020" / "fullsubnet" / "inference.toml"
TRAIN_RECIPE = REPO / "recipes" / "dns_interspeech_2020" / "fullsubnet" / "train.toml"
SEED = 0
# fp32 kernel vs fp32 plain PyTorch on the card after T steps: the sums
# run in another order, nothing else differs
KERNEL_ATOL = 1e-4
# K3's dx and dgates grow with the carries over T steps: held to a share
# of their largest magnitude (at bf16, to GRAD_RTOL_BF16)
K3_RTOL_FP32 = 1e-4
# gradients through the training op, each tensor held to a share of its
# largest magnitude: fp32 kernels vs fp32 autograd of the plain version
# (sums over T*N = 800k rows in another order); bf16 storage vs autograd
# of the plain version on the same bf16 values in fp32, and vs the fp32
# result (bf16 keeps 8 bits: one rounding step is 2^-8 relative, and the
# rounded h and dgates travel through 195 steps)
GRAD_RTOL_FP32 = 1e-3
GRAD_RTOL_BF16 = 5e-2
# bf16 stashes and outputs vs the plain version rounding at the same
# points: a value that lands on the other side of a rounding boundary
# is one bf16 step apart, and that step travels through the recurrence
BF16_ATOL = 5e-2
# the bf16 layer backward's GEMM vs its plain version, both fp32 sums of
# the same bf16 products in another order: fp32 output within 1e-5 of its
# largest value; bf16 output within one bf16 step at the largest value
# (2^-7 of it), where the two sums round to neighbouring values
TC_GEMM_RTOL_FP32 = 1e-5
TC_GEMM_RTOL_BF16 = 2.0**-7
# the dW stage (K3/K4's weight gradients) vs its plain version on the same
# stored operands: both are fp32 sums of the same products (bf16 x bf16 is
# exact in fp32) in another order, over up to T*N = 800k rows; held to this
# share of the largest value
DW_RTOL_OF_MAX = 1e-4
# the fp32 layer backward's stages (and each of them) vs their plain
# versions on the card: the card tests' fp32 tolerance (only the order of
# the sums differs); the fp32 GEMM held to a share of its largest value, as
# the bf16 GEMM's fp32 output is
F32_STAGES_ATOL = 1e-5
# the GEMM's dynamic shared memory (rnn_bwd_tc.cu, kGemmSmem): 4 stages of
# a 128 x 32 A tile and a 32 x 128 B tile in bf16
TC_GEMM_SMEM = 4 * 2 * (128 * 32 + 32 * 128)
# FullSubNet's compressed cIRM (|m| < 10), card vs CPU, after both stages
CRM_ATOL = 1e-3
# one fp32 train step, card vs CPU: the loss, and each gradient within
# this share of its largest magnitude (cuFFT vs the CPU FFT, and every
# sum in another order, through both stages and back)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# the same step under the bf16 policy, card vs CPU, both rounding at the same
# points: a value on the other side of a rounding boundary is one bf16 step
# (2^-8 relative) apart, and the step carries it through every stack; the
# gradients are held to GRAD_RTOL_BF16
STEP_LOSS_RTOL_BF16 = 1e-2
# written wavs are int16: the 0.8 peak is within one quantisation step
PEAK_ATOL = 1.0 / 32768


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment() -> str:
    import torch

    card = card_line()
    print(f"card (name, power limit): {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    from fullsubnet_tpu_torch.ops.build import find_nvcc

    nvcc = find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    print(f"nvcc {nvcc}: {ver[-1] if ver else '?'}; CUDA_HOME={os.environ.get('CUDA_HOME')}")
    try:
        import triton

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    cutlass = Path("/usr/local/cutlass/include")
    print(f"triton {triton_ver}; CUTLASS headers {'present' if cutlass.is_dir() else 'absent'} "
          f"at {cutlass}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(only=None) -> None:
    """Build the kernel libraries (``only``: those names), one nvcc per
    source, all started together."""
    from fullsubnet_tpu_torch.ops import build
    from fullsubnet_tpu_torch.ops.subband_lstm import (
        bwd_f32_library,
        dw_library,
        dw_tma_library,
        fwd_library,
        fwd_tc_library,
        gru_library,
        lstm_scan,
        tc_library,
        train_f32_library,
        train_fwd_library,
        train_library,
    )

    libraries = {
        fwd_library.NAME: (list(fwd_library.SOURCES), fwd_library),
        "fsn_lstm_scan": (list(lstm_scan._SOURCES), lstm_scan.library),
        train_library.NAME: (list(train_library.SOURCES), train_library),
        gru_library.NAME: (list(gru_library.SOURCES), gru_library),
        tc_library.NAME: (list(tc_library.SOURCES), tc_library),
        train_fwd_library.NAME: (list(train_fwd_library.SOURCES), train_fwd_library),
        bwd_f32_library.NAME: (list(bwd_f32_library.SOURCES), bwd_f32_library),
        train_f32_library.NAME: (list(train_f32_library.SOURCES), train_f32_library),
        dw_library.NAME: (list(dw_library.SOURCES), dw_library),
        dw_tma_library.NAME: (list(dw_tma_library.SOURCES), dw_tma_library),
        fwd_tc_library.NAME: (list(fwd_tc_library.SOURCES), fwd_tc_library),
    }
    if only is not None:
        libraries = {name: libraries[name] for name in only}
    paths = {name: build.library_path(name, sources) for name, (sources, _) in libraries.items()}
    for path in paths.values():
        path.unlink(missing_ok=True)  # always build from the checkout's sources
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(load) for _, load in libraries.values()]:
            future.result()
    print(f"build: {', '.join(str(p.relative_to(REPO)) for p in paths.values())} "
          f"in {time.perf_counter() - t0:.2f} s (all sources compiled in parallel)")
    for path in paths.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if re.search(r"Compiling entry|registers|spill", line):
                print(f"  ptxas: {line.strip()}")


def _stack(rng, f_in: int, hidden: int, out_dim: int, device, cell: str = "lstm",
           num_layers: int = 2):
    import numpy as np
    import torch

    def u(shape, bound_):
        return torch.from_numpy(rng.uniform(-bound_, bound_, shape).astype(np.float32)).to(device)

    b = 1.0 / hidden**0.5
    gh = GATES[cell] * hidden
    layers = []
    in_dim = f_in
    for _ in range(num_layers):
        layers.append({
            "w_ih": u((gh, in_dim), b), "w_hh": u((gh, hidden), b),
            "b_ih": u((gh,), b), "b_hh": u((gh,), b),
        })
        in_dim = hidden
    fc = {"weight": u((out_dim, hidden), b), "bias": u((out_dim,), b)}
    return layers, fc


def _cudnn_rnn(layers, f_in: int, hidden: int, dtype, device, cell: str = "lstm"):
    """``nn.LSTM`` or ``nn.GRU`` holding the stack's weights: the library
    yardstick."""
    import torch

    kind_of = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU}[cell]
    rnn = kind_of(f_in, hidden, num_layers=len(layers)).to(device, dtype)
    with torch.no_grad():
        for k, layer in enumerate(layers):
            for key, v in layer.items():
                kind = "weight" if key.startswith("w_") else "bias"
                getattr(rnn, f"{kind}_{key[2:]}_l{k}").copy_(v)
    rnn.flatten_parameters()
    return rnn


KERNEL_CASES = (
    # name, F_in, H, OUT, N
    ("sub-band B=1", 32, 384, 2, 257),
    ("sub-band B=8", 32, 384, 2, 8 * 257),
    ("full-band B=1", 257, 512, 257, 1),
    ("full-band B=8", 257, 512, 257, 8),
)
# steps of each case: 4 s of audio
KERNEL_STEPS = (400,)


def _fwd_stages(x, layers, fc, cell: str):
    """The main path's stages of one forward in one chunk, each with the
    inputs it gets there: ``forward_stages``, the composition
    ``fused_forward`` runs, over the kernels with their operands recorded:
    the GEMMs' (a, b, bias) (each layer's input projection, then the head)
    and the walks' operands (from the zero state)."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    kernel = ops.lstm_fwd_walk if cell == "lstm" else ops.gru_fwd_walk
    gemms, walks = [], []

    def gemm(*args, out=None):
        gemms.append(args)
        return ops.fwd_gemm(*args, out=out)

    def walk(*args):
        walks.append(args)
        return kernel(*args)

    ops.forward_stages(gemm, walk, x, layers, fc, chunk=x.shape[0])
    return gemms, walks


def phase_kernel_vs_plain(card: str, cell: str = "lstm") -> list[dict]:
    """K1 (or K1-GRU) at the flagship inference shapes: the main path's
    stages (fused_subband_lstm on the card: fwd_gemm and the cluster walk),
    each stage and the whole forward against its plain version and cuDNN,
    with times; beside them the kernel of the earlier design (lstm_scan or
    gru_scan), which no path runs now; at N = 2056, T = 400 also the fp32
    training walk's streaming form on the same walks (the LSTM's writes its
    c stream too), timed beside the cluster walk (K1's dispatch does not
    take it)."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED if cell == "lstm" else SEED + 5)
    lstm = cell == "lstm"
    plain_fn = ops.plain_fused_subband_lstm if lstm else ops.plain_fused_subband_gru
    old = ops.lstm_scan if lstm else ops.gru_scan
    walk, plain_walk = ((ops.lstm_fwd_walk, ops.plain_lstm_fwd_walk) if lstm
                        else (ops.gru_fwd_walk, ops.plain_gru_fwd_walk))
    label = "K1" if lstm else "K1-GRU"
    results = []
    for name, f_in, hidden, out_dim, n in KERNEL_CASES:
        layers, fc = _stack(rng, f_in, hidden, out_dim, dev, cell)
        rnn = _cudnn_rnn(layers, f_in, hidden, torch.float32, dev, cell)
        gh = GATES[cell] * hidden
        for t in KERNEL_STEPS:
            x = torch.from_numpy(
                np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32) * 1.25).to(dev)
            with torch.no_grad():
                got = ops.fused_subband_lstm(x, *layers, fc)
                old_out = old(x, layers, fc)
                torch.cuda.synchronize()
                plain = plain_fn(x, layers, fc)
                cudnn = rnn(x)[0] @ fc["weight"].t() + fc["bias"]
                torch.cuda.synchronize()
                gemms, walks = _fwd_stages(x, layers, fc, cell)
                torch.cuda.synchronize()
                gemm_err = max(float((ops.fwd_gemm(*g) - ops.plain_fwd_gemm(*g)).abs().max())
                               for g in gemms)
                walk_err = max(float((a - b).abs().max()) for w in walks
                               for a, b in zip(walk(*w), plain_walk(*w)))
            check(got.shape == (t, n, out_dim), f"{name}: output shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name}: output not finite")
            err = float((got - plain).abs().max())
            err_cudnn = float((got - cudnn).abs().max())
            old_err = float((old_out - plain).abs().max())
            with torch.no_grad():
                ms = cuda_ms(lambda: ops.fused_subband_lstm(x, *layers, fc))
                gemm_ms = cuda_ms(lambda: [ops.fwd_gemm(*g) for g in gemms])
                walk_ms = cuda_ms(lambda: [walk(*w) for w in walks])
                stream_txt, stream = "", None
                if (n, t) == (2056, 400):
                    # the streaming walk of the fp32 training forward on the same
                    # walks, its weights regrouped once ahead; the LSTM's also
                    # writes its c stream
                    train_walk = ops.lstm_train_walk_f32 if lstm else ops.gru_train_walk_f32
                    grouped = [(w[0], ops._group_hh(w[1], GATES[cell]), *w[2:]) for w in walks]
                    stream_err = max(
                        float((a - b).abs().max()) for w, g in zip(walks, grouped)
                        for a, b in zip(train_walk(*g) if lstm else (train_walk(*g),),
                                        plain_walk(*w, stash=True) if lstm
                                        else (plain_walk(*w, stash=True),)))
                    stream_ms = cuda_ms(lambda: [train_walk(*g) for g in grouped])
                    check(stream_err <= KERNEL_ATOL, f"{label} {name} T={t}: the streaming walk vs "
                          f"plain {stream_err:.3e} > {KERNEL_ATOL:g}")
                    stream = {"err": stream_err, "ms": stream_ms}
                    stream_txt = (f"\n  the fp32 training walk's streaming form"
                                  f"{' (with its c stream)' if lstm else ''} on the same walks: "
                                  f"{stream_ms:.3f} ms ({stream_ms / walk_ms:.3f}x the cluster "
                                  f"walk's), stashes vs plain {stream_err:.3e}")
                    del grouped
                cublas_ms = cuda_ms(lambda: [torch.addmm(g[2], g[0], g[1].t()) for g in gemms])
                old_ms = cuda_ms(lambda: old(x, layers, fc))
                plain_ms = cuda_ms(lambda: plain_fn(x, layers, fc), reps=1)
                plain_gemm_ms = cuda_ms(lambda: [ops.plain_fwd_gemm(*g) for g in gemms], reps=1)
                plain_walk_ms = cuda_ms(lambda: [plain_walk(*w) for w in walks], reps=1)
                cudnn_ms = cuda_ms(lambda: rnn(x)[0] @ fc["weight"].t() + fc["bias"])
                clocks = torch.zeros(3, dtype=torch.int64, device=dev)
                walk(*walks[0], clocks=clocks)
            cycles = clocks.tolist()
            phases = ", ".join(f"{k} {c / sum(cycles):.1%}" for k, c in
                               zip(("exchange", "product", "cell"), cycles))
            # fp32 outside the tensor cores: TF32 would change the results
            nbytes = 4 * (t * n * f_in + weight_elems(f_in, hidden, out_dim, cell=cell)
                          + t * n * out_dim)
            bound_ms, bound_by = bound(stack_flops(t, n, f_in, hidden, out_dim, cell=cell),
                                       nbytes, "fp32")
            # the stages apart: the GEMMs read x and each h stream and write
            # P and the output; the walks read P and write the h streams
            walk_flops = roofline.walk_flops(t, n, hidden, cell=cell)
            walk_bytes = 2 * 4 * (t * n * (gh + hidden) + hidden * gh)
            walk_bound = bound(walk_flops, walk_bytes, "fp32")
            gemm_flops = stack_flops(t, n, f_in, hidden, out_dim, cell=cell) - walk_flops
            gemm_bytes = 4 * (t * n * (f_in + 2 * gh + 2 * hidden + out_dim)
                              + (f_in + hidden) * gh + hidden * out_dim + 2 * gh + out_dim)
            gemm_bound = bound(gemm_flops, gemm_bytes, "fp32")
            rows, kr, in_flight = walk.tile(n, hidden, dev)
            tiles = -(-n // rows)
            tile = (f"{rows} rows a cluster of {ops.FWD_CTAS} CTAs, KR {kr}, "
                    f"{ops.fwd_walk_smem_bytes(rows, hidden, cell, kr)} B of shared memory a CTA, "
                    f"{tiles} cluster(s), {in_flight} in flight, {-(-tiles // in_flight)} wave(s)")
            print(f"{label} {name} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}) "
                  f"[{card}]:\n"
                  f"  stages {ms:.3f} ms (GEMMs {gemm_ms:.3f} = "
                  f"{gemm_flops / (gemm_ms * 1e9):.1f} TFLOP/s, bound {gemm_bound[0]:.3f} "
                  f"({gemm_bound[1]}), cuBLAS fp32 {cublas_ms:.3f}; walks {walk_ms:.3f} = "
                  f"{1e3 * walk_ms / (2 * t):.2f} us a step, bound {walk_bound[0]:.3f} "
                  f"({walk_bound[1]})); earlier kernel {old_ms:.3f} ms "
                  f"({old_ms / ms:.1f}x); plain {plain_ms:.3f} ms (GEMMs {plain_gemm_ms:.3f}, "
                  f"walks {plain_walk_ms:.3f}); cuDNN {cudnn_ms:.3f} ms; bound {bound_ms:.3f} ms "
                  f"({bound_by})\n"
                  f"  walk tile: {tile}; block 0's cycles (layer 0): {phases} of {sum(cycles)}\n"
                  f"  max|stages-plain| {err:.3e}, max|stages-cuDNN| {err_cudnn:.3e}, GEMM vs "
                  f"plain {gemm_err:.3e}, walk vs plain {walk_err:.3e}, earlier kernel vs plain "
                  f"{old_err:.3e} (tol {KERNEL_ATOL:g}){stream_txt}")
            for what, e in (("stages vs plain", err), ("stages vs cuDNN", err_cudnn),
                            ("GEMM vs plain", gemm_err), ("walk vs plain", walk_err),
                            ("earlier kernel vs plain", old_err)):
                check(e <= KERNEL_ATOL, f"{label} {name} T={t}: {what} {e:.3e} > {KERNEL_ATOL:g}")
            results.append({
                "name": f"{name}, T={t}", "err": max(err, err_cudnn), "ms": ms,
                "plain_ms": plain_ms, "library_ms": cudnn_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "gemm": {"err": gemm_err, "ms": gemm_ms, "plain_ms": plain_gemm_ms,
                         "library_ms": cublas_ms, "bound_ms": gemm_bound[0],
                         "bound_by": gemm_bound[1]},
                "walk": {"err": walk_err, "ms": walk_ms, "plain_ms": plain_walk_ms,
                         "library_ms": None, "bound_ms": walk_bound[0],
                         "bound_by": walk_bound[1]},
                "old": {"err": old_err, "ms": old_ms, "plain_ms": plain_ms,
                        "library_ms": cudnn_ms, "bound_ms": bound_ms, "bound_by": bound_by},
                "stream_walk": stream,
            })
            del x, got, old_out, plain, cudnn, gemms, walks
            torch.cuda.empty_cache()
        del rnn
    return results


TRAIN_CASES = (
    # name, F_in, H, OUT, N, T: the two stages of the flagship train step at
    # B = 32 x 3.072 s (193 frames + 2 of look-ahead); the sub-band stage
    # sees 256 of 257 bins, halved by drop_band
    ("sub-band", 32, 384, 2, 32 * 128, 195),
    ("full-band", 257, 512, 257, 32, 195),
)


def _rel_errs(got, want) -> list[float]:
    """max|g - w| / max|w| of each pair."""
    return [float((g.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


def _op_loss_grads(op, x, layers, fc, target, dtype, hold=None):
    """Loss mean((op(x) - target)^2) and its gradients w.r.t. x and every
    weight, with x and the weights rounded to ``dtype`` and held in
    ``hold`` (default: ``dtype``); gradients as fp32."""
    import torch

    def leaf(v):
        return v.detach().to(dtype).to(hold or dtype).requires_grad_()

    leaves = [leaf(v) for l in layers for v in l.values()]
    head = [leaf(fc["weight"]), leaf(fc["bias"])]
    xr = leaf(x)
    stack = [dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), leaves[4 * k : 4 * k + 4]))
             for k in range(len(layers))]
    out = op(xr, stack, {"weight": head[0], "bias": head[1]})
    loss = torch.mean((out.float() - target) ** 2)
    grads = torch.autograd.grad(loss, [xr, *leaves, *head])
    return float(loss.detach()), [g.float() for g in grads]


def phase_train_kernels(card: str, cell: str = "lstm") -> dict:
    """The training forward and the layer backward (K2 and K3, or K2-GRU
    and K4) as the main path runs them (``stash_forward`` and
    ``layer_backward``: the fp32 stages at fp32, the tensor-core stages at
    bf16) against their plain versions at the flagship training shapes,
    fp32 and bf16, with times and bounds; each stage apart, and the earlier
    fp32 kernels (training forward and layer backward) and the earlier
    kernels' bf16 instances beside them."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    lstm = cell == "lstm"
    fwd_name, bwd_name = ("K2", "K3") if lstm else ("K2-GRU", "K4")
    fwd_kernel = ops.stash_fwd if lstm else ops.gru_stash_fwd
    bwd_kernel, bwd_plain = ((ops.layer_bwd, ops.plain_layer_backward) if lstm
                             else (ops.gru_layer_bwd, ops.plain_gru_layer_backward))
    plain_forward = ops.plain_fused_subband_lstm if lstm else ops.plain_fused_subband_gru
    gates = GATES[cell]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3 if lstm else SEED + 6)
    fp32, bf16 = torch.float32, torch.bfloat16
    found = {"fwd": {}, "bwd": {}, "tc": {}, "fwd_tc": {}, "f32": {}, "fwd_f32": {}, "dw": {}}
    for name, f_in, hidden, out_dim, n, t in TRAIN_CASES:
        layers32, fc32 = _stack(rng, f_in, hidden, out_dim, dev, cell)
        x32 = torch.from_numpy(
            np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32) * 1.25).to(dev)
        target = torch.from_numpy(
            rng.standard_normal((t, n, out_dim)).astype(np.float32) * 0.1).to(dev)

        def plain_op(xr, stack, head):
            return plain_forward(
                xr.float(), [{k: v.float() for k, v in l.items()} for l in stack],
                {k: v.float() for k, v in head.items()})

        def kernel_op(xr, stack, head):
            return ops.fused_subband_lstm(xr, *stack, head)

        ref_loss, ref_grads = _op_loss_grads(plain_op, x32, layers32, fc32, target, fp32)
        for dtype in (fp32, bf16):
            tag = f"{name} {str(dtype).split('.')[-1]}"
            x = x32.to(dtype)
            ws, bs, wfc, bfc = ops.prep_weights(layers32, fc32, dtype)
            zeros = x.new_zeros(n, hidden)
            states = ([zeros] * 2, [zeros] * 2) if lstm else ([zeros] * 2,)

            # the main path's training forward (the fp32 stages at fp32, the
            # tensor-core stages at bf16): the head output and the stashes (h
            # and c, or h)
            got_fwd = ops.stash_forward(x, ws, bs, wfc, bfc, *states)
            torch.cuda.synchronize()
            want_fwd = ops.plain_stash_forward(x, ws, bs, wfc, bfc, *states)
            flat_got = [got_fwd[0], *(v for stash in got_fwd[1:] for v in stash)]
            flat_want_fwd = [want_fwd[0], *(v for stash in want_fwd[1:] for v in stash)]
            fwd_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(flat_got, flat_want_fwd))
            check(all(bool(torch.isfinite(v).all()) for v in flat_got),
                  f"{fwd_name} {tag}: output not finite")
            out, hs = got_fwd[0], got_fwd[1]
            cs = got_fwd[2] if lstm else None

            # the layer backward, both layers, from a head cotangent of order
            # one (the loss's own, 2 (out - target) / numel, is about 1e-8 here)
            g = out - target
            dh = (g.to(dtype).float() @ fc32["weight"].to(dtype).float()).to(dtype)
            zero_f = torch.zeros((n, hidden), device=dev)
            wts = [w.t().contiguous() for w in ws]

            def bwd_both(backward):
                """(dx of layer 0, [the cotangent streams of each layer])"""
                d, streams = dh, []
                for li in (1, 0):
                    x_seq = x if li == 0 else hs[0]
                    if lstm:
                        d, dg, _, _ = backward(d, x_seq, hs[li], cs[li], ws[li], wts[li], bs[li],
                                               zeros, zeros, zero_f, zero_f)
                        streams.append((dg,))
                    else:
                        d, dxw, dhw, _ = backward(d, x_seq, hs[li], ws[li], wts[li], bs[li],
                                                  zeros, zero_f)
                        streams.append((dxw, dhw))
                return d, streams

            # the main path's layer backward: the fp32 stages (fwd_gemm and the
            # fp32 walk) at fp32, the tensor-core stages at bf16
            dispatch = ops.layer_backward if lstm else ops.gru_layer_backward
            bwd_dx, bwd_streams = bwd_both(dispatch)
            torch.cuda.synchronize()
            p_dx, p_streams = bwd_both(bwd_plain)
            flat_got = [bwd_dx, *(v for st in bwd_streams for v in st)]
            flat_want = [p_dx, *(v for st in p_streams for v in st)]
            bwd_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(flat_got, flat_want))
            bwd_rel = max(_rel_errs(flat_got, flat_want))

            def dw_both(streams, weight_grads=ops.weight_grads):
                for li, st in zip((1, 0), streams):
                    weight_grads(x if li == 0 else hs[0], hs[li], zeros, *st)

            # the gradients of the loss through RnnScanFunction
            loss, grads = _op_loss_grads(kernel_op, x32, layers32, fc32, target, dtype)
            if dtype == fp32:
                errs = _rel_errs(grads, ref_grads)
                grad_tol, vs = GRAD_RTOL_FP32, "fp32 plain autograd"
                errs_fp32 = errs
            else:
                _, same_values = _op_loss_grads(plain_op, x32, layers32, fc32, target, bf16,
                                                hold=fp32)
                errs = _rel_errs(grads, same_values)
                errs_fp32 = _rel_errs(grads, ref_grads)
                grad_tol, vs = GRAD_RTOL_BF16, "plain autograd on the bf16 values"

            ms_fwd = cuda_ms(lambda: ops.stash_forward(x, ws, bs, wfc, bfc, *states))
            ms_plain_fwd = cuda_ms(lambda: ops.plain_stash_forward(x, ws, bs, wfc, bfc, *states),
                                   reps=1)
            ms_bwd = cuda_ms(lambda: bwd_both(dispatch))
            ms_dw = cuda_ms(lambda: dw_both(bwd_streams))
            ms_plain_bwd = cuda_ms(
                lambda: dw_both(bwd_both(bwd_plain)[1], ops.layer_weight_grads), reps=1)
            dw = _dw_stage(tag, card, x, hs, zeros, bwd_streams)
            tc = fwd_tc = f32 = fwd_f32 = None
            if dtype == fp32:
                # the earlier fp32 layer backward, which no path runs now,
                # checked and timed beside the stages that replaced it
                old_dx, old_streams = bwd_both(bwd_kernel)
                torch.cuda.synchronize()
                old_bwd_err = max(float((a - b).abs().max()) for a, b in zip(
                    [old_dx, *(v for st in old_streams for v in st)], flat_want))
                # the fp32 streams of both layers (5-15 GB at the sub-band
                # stage) make room for the stages' own
                del old_dx, old_streams
                bwd_dx = bwd_streams = p_dx = p_streams = flat_got = flat_want = None
                torch.cuda.empty_cache()
                ms_old_bwd = cuda_ms(lambda: bwd_both(bwd_kernel))
                f32 = _f32_stages(cell, tag, card, dh, x, hs, cs, ws, wts, bs, zeros, zero_f)
                f32["old"] = {"err": old_bwd_err, "ms": ms_old_bwd}
                print(f"  {bwd_name} {tag}: fp32 stages {ms_bwd:.3f} ms both layers (GEMMs "
                      f"{f32['gemm']['ms']:.3f} + walks {f32['walk']['ms']:.3f} + weight prep), "
                      f"the earlier fp32 kernel {ms_old_bwd:.3f} ms: {ms_old_bwd / ms_bwd:.1f}x; "
                      f"earlier kernel vs plain {old_bwd_err:.3e} (tol {F32_STAGES_ATOL:g}) "
                      f"[{card}]")
                check(old_bwd_err <= F32_STAGES_ATOL,
                      f"{bwd_name} earlier fp32 kernel {tag}: vs plain {old_bwd_err:.3e}")
                # the earlier fp32 training forward, which no path runs now,
                # checked and timed beside the stages that replaced it
                old_fwd = fwd_kernel(x, ws, bs, wfc, bfc, *states)
                old_fwd_err = max(float((a - b).abs().max()) for a, b in zip(
                    [old_fwd[0], *(v for s in old_fwd[1:] for v in s)], flat_want_fwd))
                del old_fwd
                ms_old_fwd = cuda_ms(lambda: fwd_kernel(x, ws, bs, wfc, bfc, *states))
                fwd_f32 = _fwd_f32_stages(cell, tag, card, x, ws, bs, wfc, bfc, states)
                fwd_f32["old"] = {"err": old_fwd_err, "ms": ms_old_fwd}
                print(f"  {fwd_name} {tag}: fp32 stages {ms_fwd:.3f} ms both layers + head (GEMMs "
                      f"{fwd_f32['gemm']['ms']:.3f} + walks {fwd_f32['walk']['ms']:.3f} + weight "
                      f"prep), the earlier fp32 kernel {ms_old_fwd:.3f} ms: "
                      f"{ms_old_fwd / ms_fwd:.1f}x; earlier kernel vs plain {old_fwd_err:.3e} (tol "
                      f"{KERNEL_ATOL:g}) [{card}]")
                check(old_fwd_err <= KERNEL_ATOL,
                      f"{fwd_name} earlier fp32 kernel {tag}: vs plain {old_fwd_err:.3e} > "
                      f"{KERNEL_ATOL:g}")
            if dtype == bf16:
                # the fp32-storage kernels' bf16 instances, which no path runs
                # now, checked and timed beside the stages that replaced them
                ms_old_bwd = cuda_ms(lambda: bwd_both(bwd_kernel))
                tc = _tc_stages(cell, tag, card, dh, x, hs, cs, ws, wts, bs, zeros, zero_f)
                print(f"  {bwd_name} {tag}: tensor-core stages {ms_bwd:.3f} ms both layers "
                      f"(GEMMs {tc['gemm']['ms']:.3f} + walks {tc['walk']['ms']:.3f} + weight "
                      f"prep), the fp32-storage kernel's bf16 instance {ms_old_bwd:.3f} ms: "
                      f"{ms_old_bwd / ms_bwd:.1f}x [{card}]")
                old_fwd = fwd_kernel(x, ws, bs, wfc, bfc, *states)
                old_fwd_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
                    [old_fwd[0], *(v for s in old_fwd[1:] for v in s)], flat_want_fwd))
                del old_fwd
                ms_old_fwd = cuda_ms(lambda: fwd_kernel(x, ws, bs, wfc, bfc, *states))
                fwd_tc = _fwd_tc_stages(cell, tag, card, x, ws, bs, wfc, bfc, states)
                fwd_tc["old"] = {"err": old_fwd_err, "ms": ms_old_fwd}
                print(f"  {fwd_name} {tag}: tensor-core stages {ms_fwd:.3f} ms both layers + head "
                      f"(GEMMs {fwd_tc['gemm']['ms']:.3f} + walks {fwd_tc['walk']['ms']:.3f} + "
                      f"weight prep), the earlier kernel's bf16 instance {ms_old_fwd:.3f} ms: "
                      f"{ms_old_fwd / ms_fwd:.1f}x; earlier kernel vs plain {old_fwd_err:.3e} "
                      f"(tol {BF16_ATOL:g}) [{card}]")
                check(old_fwd_err <= BF16_ATOL,
                      f"{fwd_name} earlier kernel {tag}: vs plain {old_fwd_err:.3e} > {BF16_ATOL:g}")
            ms_cudnn_fwd = ms_cudnn_bwd = None
            try:  # the library yardstick: cuDNN's training forward and its backward
                rnn = _cudnn_rnn(layers32, f_in, hidden, dtype, dev, cell)
                xr = x.detach().requires_grad_()
                wfc_c, bfc_c = fc32["weight"].to(dtype), fc32["bias"].to(dtype)
                ms_cudnn_fwd = cuda_ms(lambda: rnn(xr)[0] @ wfc_c.t() + bfc_c)
                y = rnn(xr)[0]
                dy = torch.randn_like(y)
                ms_cudnn_bwd = cuda_ms(lambda: torch.autograd.grad(
                    y, [xr, *rnn.parameters()], dy, retain_graph=True))
                del rnn, xr, y, dy
            except RuntimeError as e:  # not measured: the port never calls cuDNN
                print(f"  cuDNN {tag}: not measured ({str(e).splitlines()[0][:120]})")

            kind = "fp32" if dtype == fp32 else "bf16"
            s = 4 if dtype == fp32 else 2
            # per layer: h0 (and c0) read, the h (and c) stash written
            n_states = 2 if lstm else 1
            fwd_bytes = (s * (t * n * f_in + 2 * n_states * n * hidden
                              + 2 * n_states * t * n * hidden)
                         + s * weight_elems(f_in, hidden, out_dim, cell=cell)
                         + 4 * t * n * out_dim)
            fwd_bound = bound(stack_flops(t, n, f_in, hidden, out_dim, cell=cell), fwd_bytes, kind)
            # the layer backward + dW products, both layers: the layer
            # backward of _pallas_layer_bwd; its inputs dh, x and the stashes
            # (h_{t-1}, and c_{t-1}, c_t), its outputs dx and the fp32 weight
            # gradients (the cotangent streams stay inside)
            bwd_flops = roofline.layer_bwd_flops(t, n, f_in, hidden, cell=cell)
            bwd_bytes = 0
            for in_dim in (f_in, hidden):
                bwd_bytes += s * t * n * ((1 + n_states) * hidden + 2 * in_dim)
                bwd_bytes += (s + 4) * (in_dim + hidden) * gates * hidden
            bwd_bound = bound(bwd_flops, bwd_bytes, kind)
            cudnn_txt = ("not measured" if ms_cudnn_fwd is None else
                         f"fwd {ms_cudnn_fwd:.3f} ms, bwd {ms_cudnn_bwd:.3f} ms")
            streams_txt = "dgates" if lstm else "dxw and dhw"
            print(f"{fwd_name}/{bwd_name} {tag} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, "
                  f"T {t}) [{card}]:\n"
                  f"  {fwd_name} (the stages) max|kernel-plain| {fwd_err:.3e} over out and "
                  "stashes; "
                  f"{fwd_name} "
                  f"{ms_fwd:.3f} ms, plain {ms_plain_fwd:.3f} ms, bound {fwd_bound[0]:.3f} ms "
                  f"({fwd_bound[1]})\n"
                  f"  {bwd_name} max|kernel-plain| {bwd_err:.3e} ({bwd_rel:.2e} of the largest "
                  f"value) over dx and {streams_txt}; {bwd_name} both layers "
                  f"{ms_bwd:.3f} ms + dW products {ms_dw:.3f} ms, plain {ms_plain_bwd:.3f} ms, "
                  f"bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]})\n"
                  f"  cuDNN nn.{cell.upper()}: {cudnn_txt}\n"
                  f"  loss {loss:.6e} (plain fp32 {ref_loss:.6e}); gradient errors / max vs "
                  f"{vs}: {max(errs):.2e} (tol {grad_tol:g}); vs fp32 plain: "
                  f"{max(errs_fp32):.2e}")
            atol = KERNEL_ATOL if dtype == fp32 else BF16_ATOL
            check(fwd_err <= atol, f"{fwd_name} {tag}: kernel vs plain {fwd_err:.3e} > {atol:g}")
            bwd_tol = K3_RTOL_FP32 if dtype == fp32 else GRAD_RTOL_BF16
            check(bwd_rel <= bwd_tol,
                  f"{bwd_name} {tag}: kernel vs plain {bwd_rel:.2e} > {bwd_tol:g} of max")
            if dtype == fp32:
                check(bwd_err <= F32_STAGES_ATOL,
                      f"{bwd_name} {tag}: stages vs plain {bwd_err:.3e} > {F32_STAGES_ATOL:g}")
            check(max(errs) <= grad_tol, f"{tag}: gradients vs {vs} {max(errs):.2e} > {grad_tol:g}")
            check(max(errs_fp32) <= GRAD_RTOL_BF16,
                  f"{tag}: gradients vs fp32 plain {max(errs_fp32):.2e} > {GRAD_RTOL_BF16:g}")
            found["fwd"][tag] = {"err": fwd_err, "ms": ms_fwd, "plain_ms": ms_plain_fwd,
                                 "library_ms": ms_cudnn_fwd, "bound_ms": fwd_bound[0],
                                 "bound_by": fwd_bound[1]}
            found["bwd"][tag] = {"err": bwd_err, "ms": ms_bwd + ms_dw, "kernel_ms": ms_bwd,
                                 "dw_ms": ms_dw, "plain_ms": ms_plain_bwd,
                                 "library_ms": ms_cudnn_bwd, "bound_ms": bwd_bound[0],
                                 "bound_by": bwd_bound[1]}
            found["dw"][tag] = dw
            if tc is not None:
                found["tc"][tag] = tc
                found["fwd_tc"][tag] = fwd_tc
            if f32 is not None:
                found["f32"][tag] = f32
                found["fwd_f32"][tag] = fwd_f32
            del out, hs, cs, got_fwd, want_fwd, bwd_dx, bwd_streams, p_dx, p_streams, grads
            del flat_got, flat_want, flat_want_fwd, tc, fwd_tc, f32, fwd_f32, dw
            torch.cuda.empty_cache()
    return found


def _dw_stage(tag: str, card: str, x, hs, zeros, streams, deep: bool = False) -> dict:
    """The dW stage of both layers as ``weight_grads`` runs it on the card:
    ``dw_tma`` (the persistent TMA-fed GEMM) on each problem (the LSTM's
    [x | h_prev | 1]^T . dgates, the GRU's [x | 1]^T . dxw and [h_prev |
    1]^T . dhw) against ``plain_dw_gemm`` on the same stored operands, and
    the same bits on a repeat; beside it the split-K ``dw_gemm`` of the
    earlier design (checked as well), cuBLAS on the same stored operands
    ([x | h_prev | 1] made beforehand: torch.matmul in the storage type),
    the plain version and the bound (from the features the gradient has:
    at bf16 the full-band x runs padded to 264, as the main path's
    ``pad_input`` gives it, and the bound counts its 257); TFLOP/s, the
    share of the bound, the plan's units, slabs, CTAs and clusters; at the
    sub-band stage ``dw_tma`` over K at the chunk shapes (K = steps x N,
    layer 2's first problem). ``deep`` (``--dw``) adds ``dw_gemm`` to that
    sweep, more steps, and the problems again without clusters where the
    plan takes clusters of two."""
    import torch
    import torch.nn.functional as F

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    t, n, hidden = hs[0].shape
    k = t * n
    features = x.shape[-1]
    if x.dtype == torch.bfloat16 and x.shape[-1] % ops.TC_INPUT_MULTIPLE:
        x = F.pad(x, (0, -x.shape[-1] % ops.TC_INPUT_MULTIPLE))
    problems, widths = [], []
    for li, st in zip((1, 0), streams):
        a = (x if li == 0 else hs[0]).reshape(k, -1)
        cols = features if li == 0 else hidden
        prev = {"prev": hs[li].reshape(k, hidden), "head": zeros}
        if len(st) == 1:
            problems.append({"a": a, "b": st[0].reshape(k, -1), **prev})
            widths.append((cols + hidden + 1, st[0].shape[-1]))
        else:
            problems += [{"a": a, "b": st[0].reshape(k, -1)},
                         {"a": None, "b": st[1].reshape(k, -1), **prev}]
            widths += [(cols + 1, st[0].shape[-1]), (hidden + 1, st[1].shape[-1])]
    err = rel = err_old = rel_old = 0.0
    same = True
    for p in problems:
        got, again, want = ops.dw_tma(**p), ops.dw_tma(**p), ops.plain_dw_gemm(**p)
        same = same and torch.equal(got, again)
        err = max(err, float((got - want).abs().max()))
        rel = max(rel, *_rel_errs([got], [want]))
        old = ops.dw_gemm(**p)
        err_old = max(err_old, float((old - want).abs().max()))
        rel_old = max(rel_old, *_rel_errs([old], [want]))
        del got, again, want, old
    ms = cuda_ms(lambda: [ops.dw_tma(**p) for p in problems])
    ms_old = cuda_ms(lambda: [ops.dw_gemm(**p) for p in problems])
    ms_plain = cuda_ms(lambda: [ops.plain_dw_gemm(**p) for p in problems], reps=1)
    plans = [ops.dw_tma.plan(**p) for p in problems]
    clusters_off = None
    if deep and any(pl.cs > 1 for pl in plans):  # the same problems with B's loads not shared
        alone = [ops.plan_dw(pl.cols0, pl.cols1, pl.shift, pl.ncols, pl.k,
                             ops.dw_tma.sms(p["b"].device), p["b"].dtype)
                 for pl, p in zip(plans, problems)]
        clusters_off = cuda_ms(lambda: [ops.dw_tma(**p, plan=q) for p, q in zip(problems, alone)])
    ms_lib = 0.0
    for p in problems:
        cols = [] if p["a"] is None else [p["a"]]
        if "prev" in p:
            cols.append(torch.cat([p["head"], p["prev"][: k - n]]))
        a_t = torch.cat([*cols, p["b"].new_ones(k, 1)], dim=1).t()
        ms_lib += cuda_ms(lambda: a_t @ p["b"])
        del a_t
    sweep = {}
    if n > 1024:  # the sub-band stage: layer 2's first problem over the chunk shapes
        for steps in ((16, 32, 64, 128, t) if deep else (16, 64, t)):
            q = {key: (v[: steps * n] if key in ("a", "b", "prev") and v is not None else v)
                 for key, v in problems[0].items()}
            sweep[steps * n] = ((round(cuda_ms(lambda: ops.dw_tma(**q)), 3),
                                 round(cuda_ms(lambda: ops.dw_gemm(**q)), 3)) if deep
                                else round(cuda_ms(lambda: ops.dw_tma(**q)), 3))
    size = x.element_size()
    flops = sum(roofline.gemm_flops(k, m, ncols) for m, ncols in widths)
    nbytes = sum(size * k * (m - 1 + ncols) + 4 * m * ncols for m, ncols in widths)
    kind = "fp32" if x.dtype == torch.float32 else "bf16"
    dw_bound = bound(flops, nbytes, kind)
    clusters_txt = ("" if clusters_off is None
                    else f"; with no clusters {clusters_off:.3f} ms")
    print(f"  dW stage, {tag}, both layers ({len(problems)} GEMMs) [{card}]: dw_tma "
          f"{ms:.3f} ms = {flops / (ms * 1e9):.1f} TFLOP/s, {dw_bound[0] / ms:.0%} of the bound "
          f"(units {[pl.units for pl in plans]}, slabs {[pl.slabs for pl in plans]}, CTAs "
          f"{[pl.ctas for pl in plans]}, clusters of {[pl.cs for pl in plans]}{clusters_txt}); "
          f"dw_gemm (the earlier split-K kernel) {ms_old:.3f} ms "
          f"= {flops / (ms_old * 1e9):.1f} TFLOP/s; cuBLAS {kind} on the same stored operands "
          f"{ms_lib:.3f} ms; plain {ms_plain:.3f} ms; bound {dw_bound[0]:.3f} ms ({dw_bound[1]}; "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.2f} GB); max|dw_tma-plain| {err:.3e} "
          f"({rel:.2e} of the largest value, tol {DW_RTOL_OF_MAX:g}), the same bits on a repeat "
          f"{same}; max|dw_gemm-plain| {err_old:.3e} ({rel_old:.2e}); over K (layer 2, first "
          f"GEMM: K -> {'(dw_tma, dw_gemm)' if deep else 'dw_tma'} ms) {sweep}")
    check(rel <= DW_RTOL_OF_MAX,
          f"dw_tma {tag}: kernel vs plain {rel:.2e} of max > {DW_RTOL_OF_MAX:g}")
    check(same, f"dw_tma {tag}: a repeat gave other bits")
    check(rel_old <= DW_RTOL_OF_MAX,
          f"dw_gemm {tag}: kernel vs plain {rel_old:.2e} of max > {DW_RTOL_OF_MAX:g}")
    return {"err": err, "ms": ms, "plain_ms": ms_plain, "library_ms": ms_lib,
            "bound_ms": dw_bound[0], "bound_by": dw_bound[1], "no_clusters_ms": clusters_off,
            "old": {"err": err_old, "ms": ms_old, "plain_ms": ms_plain, "library_ms": ms_lib,
                    "bound_ms": dw_bound[0], "bound_by": dw_bound[1]}}


# --dw's sweep of the slab count: (cell, case of TRAIN_CASES, a's columns:
# 0 the input's, 1 the hidden state's) and the slab counts around the plan's
DW_SLAB_SWEEP = (("lstm", 0, 1), ("lstm", 1, 0), ("gru", 0, 1))
DW_SLAB_STEPS = (-0.5, -0.25, -1, 0, 1, 0.25, 0.5)
# --dw's one-sign operands at bf16: K rows, (F, H, Ncols), rows a unit
DW_SIGN_CASES = ((3 * 8_192, (384, 0, 1_536)), (798_720, (32, 384, 1_536)))
DW_SIGN_UNIT_ROWS = (2_048, 4_096, 8_192, 16_384, 32_768)


def _dw_slab_sweep(card: str, gen) -> None:
    """``dw_tma`` at slab counts around the plan's (``DW_SLAB_SWEEP``) on
    random streams: the plan's time beside the fastest, timed in turns (the
    plan's first and last) so that a drift of the clock shows."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    for dtype in (torch.bfloat16, torch.float32):
        for cell, case, which in DW_SLAB_SWEEP:
            _, f_in, hidden, _, n, t = TRAIN_CASES[case]
            k, gh = t * n, GATES[cell] * hidden
            cols = (f_in + (-f_in % ops.TC_INPUT_MULTIPLE if dtype == torch.bfloat16 else 0),
                    hidden)[which]
            a = torch.randn(k, cols, device="cuda", generator=gen).to(dtype)
            b = torch.randn(k, gh, device="cuda", generator=gen).to(dtype)
            kw = {"a": a, "b": b}
            if cell == "lstm":
                kw.update(prev=torch.randn(k, hidden, device="cuda", generator=gen).to(dtype),
                          head=torch.zeros(n, hidden, device="cuda", dtype=dtype))
            pl = ops.dw_tma.plan(**kw)
            counts = sorted({max(1, min(pl.k_tiles, round(pl.slabs + (d if abs(d) >= 1
                                                                     else d * pl.slabs))))
                             for d in DW_SLAB_STEPS})
            counts = [pl.slabs] + [c for c in counts if c != pl.slabs] + [pl.slabs]
            times = []
            for c in counts:
                q = ops._dw_plan(pl.cols0, pl.cols1, pl.shift, pl.ncols, pl.k,
                                 ops.dw_tma.sms(b.device), dtype, c, pl.cs)
                times.append((c, round(cuda_ms(lambda: ops.dw_tma(**kw, plan=q), reps=5), 4)))
            best = min(times, key=lambda ct: ct[1])
            print(f"  dW slab sweep, {str(dtype).split('.')[-1]} {cell} ({pl.cols0}, {pl.cols1}, "
                  f"{pl.ncols}), K {k} [{card}]: the plan's {pl.slabs} slabs {times[0][1]} / "
                  f"{times[-1][1]} ms (first / last), the fastest {best[0]} at {best[1]} ms; "
                  f"(slabs, ms) in turn {times}")
            del a, b, kw
            torch.cuda.empty_cache()


def _dw_sign_probe(card: str, gen) -> None:
    """The bf16 instance on operands of one sign (a and b uniform in [0,
    1)), where the tensor cores' sums, which round toward zero, err the
    most: the error against an fp64 product by the rows a unit sums (the
    plan's slab count changed), the plan's own beside it; products and the
    bias row (fp32 adds) apart."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    for k, (cols0, cols1, ncols) in DW_SIGN_CASES:
        a = torch.rand(k, cols0, device="cuda", generator=gen).to(torch.bfloat16)
        b = torch.rand(k, ncols, device="cuda", generator=gen).to(torch.bfloat16)
        kw = {"a": a, "b": b}
        if cols1:
            shift = 4_096
            kw.update(prev=torch.rand(k - shift, cols1, device="cuda", generator=gen
                                      ).to(torch.bfloat16),
                      head=torch.zeros(shift, cols1, device="cuda", dtype=torch.bfloat16))
        cols = [a.double()]
        if cols1:
            cols.append(torch.cat([kw["head"], kw["prev"]]).double())
        want = torch.cat([*cols, b.new_ones(k, 1, dtype=torch.float64)], dim=1).t() @ b.double()
        mw, top = cols0 + cols1, float(want.abs().max())
        pl = ops.dw_tma.plan(**kw)

        def errs(got):
            d = (got.double() - want).abs()
            return f"{float(d[:mw].max()) / top:.2e}", f"{float(d[mw:].max()) / top:.2e}"

        by_rows = {}
        for rows in DW_SIGN_UNIT_ROWS:
            slabs = -(-k // rows)
            if slabs > pl.k_tiles:
                continue
            q = ops._dw_plan(pl.cols0, pl.cols1, pl.shift, pl.ncols, pl.k,
                             ops.dw_tma.sms(b.device), torch.bfloat16, slabs, pl.cs)
            by_rows[rows] = (slabs, *errs(ops.dw_tma(**kw, plan=q)))
        print(f"  dW bf16 on one-sign operands, K {k}, ({cols0}, {cols1}, {ncols}) [{card}]: "
              f"the plan's {pl.slabs} slabs ({-(-k // pl.slabs)} rows a unit) "
              f"{errs(ops.dw_tma(**kw))} of the largest value (products, bias row); by rows a "
              f"unit (slabs, products, bias row) {by_rows}; cap "
              f"{ops.DW_MAX_UNIT_ROWS[torch.bfloat16]} rows")
        del a, b, kw, want, cols
        torch.cuda.empty_cache()


def phase_dw_alone(card: str) -> dict:
    """The dW stage alone (``--dw``): ``_dw_stage`` in depth at the training
    shapes of phases 4 and 6, both cells and storage types, on streams of
    random values from the seed (the stage's arithmetic does not depend on
    the values; phases 4 and 6 run it on the layer backward's own streams);
    then the slab sweep and the one-sign probe."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    out = {}
    for cell in ("lstm", "gru"):
        for name, f_in, hidden, _, n, t in TRAIN_CASES:
            for dtype in (torch.float32, torch.bfloat16):

                def draw(*shape):
                    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

                gh = GATES[cell] * hidden
                x, hs = draw(t, n, f_in), [draw(t, n, hidden) for _ in range(2)]
                zeros = torch.zeros(n, hidden, device="cuda", dtype=dtype)
                streams = [tuple(draw(t, n, gh) for _ in range(1 if cell == "lstm" else 2))
                           for _ in range(2)]
                tag = f"{name} {str(dtype).split('.')[-1]} {cell}"
                out[tag] = _dw_stage(tag, card, x, hs, zeros, streams, deep=True)
                del x, hs, streams
                torch.cuda.empty_cache()
    _dw_slab_sweep(card, gen)
    _dw_sign_probe(card, gen)
    return out


def _tc_stages(cell: str, tag: str, card: str, dh, x, hs, cs, ws, wts, bs, zeros, zero_f) -> dict:
    """The bf16 layer backward of both layers stage by stage, as
    ``layer_backward`` / ``gru_layer_backward`` run it on the card: the
    pre-activation GEMM, the walk, the dx GEMM. Each stage against its
    plain version on the same inputs; times of each stage, of the plain
    versions and of cuBLAS on the same products (a yardstick the port never
    calls); a sweep of the walk's row tile; bounds."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    lstm = cell == "lstm"
    walk, plain_walk = ((ops.lstm_walk, ops.plain_lstm_walk) if lstm
                        else (ops.gru_walk, ops.plain_gru_walk))
    t, n, hidden = dh.shape
    m = t * n
    gates = GATES[cell] * hidden
    stages, d = [], dh
    gemm_flops = gemm_bytes = walk_flops = walk_bytes = 0
    for li in (1, 0):
        x_seq = x if li == 0 else hs[0]
        f_in = x_seq.shape[-1]
        w, b = (ws[li], bs[li]) if lstm else ops.pack_gru_weights(ws[li], bs[li], f_in)
        pre = {"a": x_seq.reshape(m, f_in), "b": w, "bias": b, "prev": hs[li].reshape(m, hidden),
               "head": zeros}
        p = ops.tc_gemm(**pre)
        rest = (zero_f, zero_f) if lstm else (zero_f,)
        walk_args = (p.view(t, n, -1), d, cs[li] if lstm else hs[li], zeros, wts[li][:, f_in:],
                     *rest)
        outs = walk(*walk_args)
        dx_args = {"a": outs[0].view(m, gates), "b": wts[li][:, :f_in], "out_dtype": x.dtype}
        d = ops.tc_gemm(**dx_args).view(t, n, f_in)
        # cuBLAS on the same two products: [x | h_prev] made beforehand
        xh = torch.cat([pre["a"], torch.cat([zeros, pre["prev"][: m - n]])], dim=1)
        stages.append((pre, walk_args, dx_args, outs, xh))
        # the packed GRU weight is 4H wide but a quarter zero blocks: the four
        # sums need (F + H) . 3H products a row; its bytes are all moved
        g4 = w.shape[1]
        gemm_flops += (roofline.gemm_flops(m, f_in + hidden, gates)
                       + roofline.gemm_flops(m, gates, f_in))
        gemm_bytes += (2 * m * (f_in + hidden) + 2 * (f_in + hidden) * g4 + 4 * m * g4
                       + 2 * m * gates + 2 * gates * f_in + 2 * m * f_in)
        walk_flops += roofline.walk_flops(t, n, hidden, layers=1, cell=cell)
        # P, dh and the stash read; the cotangent streams written; W_hh^T
        walk_bytes += (4 * m * 4 * hidden + 2 * 2 * m * hidden + 2 * m * gates * (1 if lstm else 2)
                       + 2 * gates * hidden)
    torch.cuda.synchronize()

    # each stage against its plain version on the same inputs; the GEMM's
    # fp32 output (the pre-activations) and its bf16 output (dx) apart
    gemm_err, gemm_rel, walk_err, walk_rel = 0.0, [0.0, 0.0], 0.0, 0.0
    for pre, walk_args, dx_args, outs, _ in stages:
        for k, args in enumerate((pre, dx_args)):
            got, want = ops.tc_gemm(**args), ops.plain_tc_gemm(**args)
            gemm_err = max(gemm_err, float((got.float() - want.float()).abs().max()))
            gemm_rel[k] = max(gemm_rel[k], *_rel_errs([got], [want]))
        want = plain_walk(*walk_args)
        walk_err = max(walk_err, *(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(outs, want)))
        walk_rel = max(walk_rel, *_rel_errs(outs, want))
        del got, want

    ms_pre = cuda_ms(lambda: [ops.tc_gemm(**s[0]) for s in stages])
    ms_walk = cuda_ms(lambda: [walk(*s[1]) for s in stages])
    ms_dxg = cuda_ms(lambda: [ops.tc_gemm(**s[2]) for s in stages])
    ms_plain_gemm = cuda_ms(lambda: [(ops.plain_tc_gemm(**s[0]), ops.plain_tc_gemm(**s[2]))
                                     for s in stages], reps=1)
    ms_plain_walk = cuda_ms(lambda: [plain_walk(*s[1]) for s in stages], reps=1)
    ms_cublas = cuda_ms(lambda: [(s[4] @ s[0]["b"], s[2]["a"] @ s[2]["b"]) for s in stages])
    # the streaming walk at each row tile (the deepest ring that fits), and
    # the split walk where it applies
    sweep = {}
    for rows in ops.WALK_ROWS:
        if ops.walk_smem_bytes(rows, gates, hidden, 2) <= 232_448:
            sweep[rows] = cuda_ms(lambda: [walk(*s[1], rows_per_block=rows) for s in stages])
    if hidden in (256, 512):
        sweep["split"] = cuda_ms(lambda: [walk(*s[1], split=True) for s in stages])
    if ops.walk_splits(n, hidden):
        tile = (f"split over {-(-n // ops.SPLIT_ROWS)} cluster(s) of {ops.SPLIT_CTAS} CTAs, "
                f"{ops.split_smem_bytes(gates, hidden)} B of shared memory a CTA")
    else:
        rows, ring = ops.pick_walk_tile(n, gates, hidden)
        tile = (f"{rows} rows/block, {ring} ring slots, "
                f"{ops.walk_smem_bytes(rows, gates, hidden, ring)} B of shared memory a block")
    # where block 0's cycles go over the walk of the last layer (the
    # cell backward, the product, and the split walk's cluster exchange)
    clocks = torch.zeros(3, dtype=torch.int64, device=dh.device)
    walk(*stages[0][1], clocks=clocks)
    cycles = clocks.tolist()
    phases = ", ".join(f"{name} {c / sum(cycles):.1%}" for name, c in
                       zip(("cell backward", "product", "cluster exchange"), cycles))
    gemm_bound = bound(gemm_flops, gemm_bytes, "bf16")
    walk_bound = bound(walk_flops, walk_bytes, "bf16")
    print(f"  tensor-core stages, {tag}, both layers [{card}]:\n"
          f"    GEMM (128 x 128 x 32 tiles, 4 stages, {TC_GEMM_SMEM} B of shared memory a block): "
          f"pre-activations {ms_pre:.3f} ms + dx {ms_dxg:.3f} ms = "
          f"{gemm_flops / ((ms_pre + ms_dxg) * 1e9):.1f} TFLOP/s; plain {ms_plain_gemm:.3f} ms, "
          f"cuBLAS bf16 {ms_cublas:.3f} ms, bound {gemm_bound[0]:.3f} ms ({gemm_bound[1]}); "
          f"max|kernel-plain| {gemm_err:.3e}: {gemm_rel[0]:.2e} of the largest value on the fp32 "
          f"pre-activations (tol {TC_GEMM_RTOL_FP32:g}), {gemm_rel[1]:.2e} on the bf16 dx (tol "
          f"{TC_GEMM_RTOL_BF16:g})\n"
          f"    walk: {ms_walk:.3f} ms ({tile}; {1e3 * ms_walk / (2 * t):.1f} us a step), plain "
          f"{ms_plain_walk:.3f} ms, bound {walk_bound[0]:.3f} ms ({walk_bound[1]}); "
          f"max|kernel-plain| {walk_err:.3e} ({walk_rel:.2e} of the largest value); "
          f"sweep (streaming rows/block, split) { {r: round(v, 3) for r, v in sweep.items()} } ms; "
          f"block 0's cycles: {phases} of {sum(cycles)}")
    check(gemm_rel[0] <= TC_GEMM_RTOL_FP32,
          f"tc_gemm {tag}: fp32 out vs plain {gemm_rel[0]:.2e} of max > {TC_GEMM_RTOL_FP32:g}")
    check(gemm_rel[1] <= TC_GEMM_RTOL_BF16,
          f"tc_gemm {tag}: bf16 out vs plain {gemm_rel[1]:.2e} of max > {TC_GEMM_RTOL_BF16:g}")
    check(walk_rel <= GRAD_RTOL_BF16,
          f"{cell} walk {tag}: kernel vs plain {walk_rel:.2e} of max > {GRAD_RTOL_BF16:g}")
    return {
        "gemm": {"err": gemm_err, "ms": ms_pre + ms_dxg, "plain_ms": ms_plain_gemm,
                 "library_ms": ms_cublas, "bound_ms": gemm_bound[0], "bound_by": gemm_bound[1]},
        "walk": {"err": walk_err, "ms": ms_walk, "plain_ms": ms_plain_walk, "library_ms": None,
                 "bound_ms": walk_bound[0], "bound_by": walk_bound[1]},
    }


def _f32_stages(cell: str, tag: str, card: str, dh, x, hs, cs, ws, wts, bs, zeros, zero_f) -> dict:
    """The fp32 layer backward of both layers stage by stage, as
    ``layer_backward`` / ``gru_layer_backward`` run it on the card: fwd_gemm
    for the pre-activations (A's second K segment the h stash one block of
    rows back), the fp32 walk, fwd_gemm for dx. Each stage against its plain
    version on the same inputs; times of each stage, of the plain versions
    and of cuBLAS fp32 on the same products (a yardstick the port never
    calls); a sweep of the walk's forms (the cluster form at each tile, the
    streaming form); block 0's cycles by phase; bounds. One
    layer's fp32 operands are alive at a time (a layer's P and cotangent
    streams are 5-7 GB at the sub-band stage); its times are summed."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    lstm = cell == "lstm"
    walk, plain_walk = ((ops.lstm_walk_f32, ops.plain_lstm_walk) if lstm
                        else (ops.gru_walk_f32, ops.plain_gru_walk))
    t, n, hidden = dh.shape
    m = t * n
    gates = GATES[cell] * hidden
    forms = {f"cluster, {r} rows": {"rows": r} for r in ops.BWD_F32_ROWS
             if ops.bwd_f32_kr(r, hidden, cell) is not None}
    if ops.bwd_f32_stream_fits(hidden, cell):
        forms["streaming"] = {"stream": True}
    ms = dict.fromkeys(("pre", "walk", "dx", "plain_gemm", "plain_walk", "cublas"), 0.0)
    sweep = dict.fromkeys(forms, 0.0)
    gemm_flops = gemm_bytes = walk_flops = walk_bytes = 0
    gemm_err, gemm_rel, walk_err = 0.0, 0.0, 0.0
    d, phases, cycles = dh, "", [0]
    for li in (1, 0):
        x_seq = x if li == 0 else hs[0]
        f_in = x_seq.shape[-1]
        b, bias = (wts[li], bs[li]) if lstm else ops.pack_gru_weights_t(wts[li], bs[li], f_in)
        pre = {"a": x_seq.reshape(m, f_in), "b": b, "bias": bias,
               "prev": hs[li].reshape(m, hidden), "head": zeros}
        p = ops.fwd_gemm(**pre)
        rest = (zero_f, zero_f) if lstm else (zero_f,)
        walk_args = (p.view(t, n, -1), d, cs[li] if lstm else hs[li], zeros, wts[li][:, f_in:],
                     *rest)
        outs = walk(*walk_args)
        dx_args = {"a": outs[0].view(m, gates), "b": ws[li][:f_in]}
        d_next = ops.fwd_gemm(**dx_args).view(t, n, f_in)
        torch.cuda.synchronize()
        for args in (pre, dx_args):
            got, want = ops.fwd_gemm(**args), ops.plain_fwd_gemm(**args)
            gemm_err = max(gemm_err, float((got - want).abs().max()))
            gemm_rel = max(gemm_rel, *_rel_errs([got], [want]))
            del got, want
        want = plain_walk(*walk_args)
        walk_err = max(walk_err, *(float((g - w).abs().max()) for g, w in zip(outs, want)))
        del want
        ms["pre"] += cuda_ms(lambda: ops.fwd_gemm(**pre))
        ms["walk"] += cuda_ms(lambda: walk(*walk_args))
        ms["dx"] += cuda_ms(lambda: ops.fwd_gemm(**dx_args))
        ms["plain_gemm"] += cuda_ms(lambda: (ops.plain_fwd_gemm(**pre),
                                             ops.plain_fwd_gemm(**dx_args)), reps=1)
        ms["plain_walk"] += cuda_ms(lambda: plain_walk(*walk_args), reps=1)
        # cuBLAS on the same two products: [x | h_prev] made beforehand
        xh = torch.cat([pre["a"], torch.cat([zeros, pre["prev"][: m - n]])], dim=1)
        ms["cublas"] += cuda_ms(lambda: (torch.addmm(bias, xh, b.t()),
                                         dx_args["a"] @ dx_args["b"].t()))
        del xh
        for name, kw in forms.items():
            got = walk(*walk_args, **kw)
            torch.cuda.synchronize()
            walk_err = max(walk_err, *(float((g - w).abs().max()) for g, w in zip(got, outs)))
            del got
            sweep[name] += cuda_ms(lambda: walk(*walk_args, **kw))
        if li == 1:  # where block 0's cycles go over the walk of the last layer
            clocks = torch.zeros(3, dtype=torch.int64, device=dh.device)
            walk(*walk_args, clocks=clocks)
            cycles = clocks.tolist()
            phases = ", ".join(f"{name} {c / max(sum(cycles), 1):.1%}" for name, c in
                               zip(("cell backward", "product", "cluster exchange"), cycles))
        g4 = b.shape[0]  # the GRU's packed 4H: FLOPs counted on its 3H gates, as above
        gemm_flops += (roofline.gemm_flops(m, f_in + hidden, gates)
                       + roofline.gemm_flops(m, gates, f_in))
        gemm_bytes += 4 * (m * (f_in + hidden) + (f_in + hidden) * g4 + g4 + m * g4
                           + m * gates + gates * f_in + m * f_in)
        walk_flops += roofline.walk_flops(t, n, hidden, layers=1, cell=cell)
        # P, dh and the stash read; the cotangent streams written; W_hh
        walk_bytes += 4 * (m * 4 * hidden + 2 * m * hidden + m * gates * (1 if lstm else 2)
                           + gates * hidden)
        del p, outs, walk_args, pre, dx_args, b, bias
        d = d_next
        torch.cuda.empty_cache()
    if ops.bwd_f32_streams(n, hidden, cell,
                           lambda r, k: walk.max_clusters(hidden, r, k, dh.device)):
        tile = (f"streaming, blocks of {ops.BWD_F32_STREAM_ROWS} rows, {-(-n // 16)} blocks, "
                f"2 ring slots, {ops.bwd_f32_stream_smem_bytes(hidden, cell)} B of shared "
                "memory a block")
    else:
        rows, kr, in_flight = walk.tile(n, hidden, dh.device)
        tiles = -(-n // rows)
        tile = (f"cluster, {rows} rows a cluster of {ops.FWD_CTAS} CTAs, KR {kr}, "
                f"{ops.bwd_f32_smem_bytes(rows, hidden, cell, kr)} B of shared memory a CTA, "
                f"{tiles} cluster(s), {in_flight} in flight, {-(-tiles // in_flight)} wave(s)")
    gemm_bound = bound(gemm_flops, gemm_bytes, "fp32")
    walk_bound = bound(walk_flops, walk_bytes, "fp32")
    ms_gemm = ms["pre"] + ms["dx"]
    print(f"  fp32 stages, {tag}, both layers [{card}]:\n"
          f"    GEMM (fwd_gemm, 128 x 128 x 8 tiles): pre-activations {ms['pre']:.3f} ms + dx "
          f"{ms['dx']:.3f} ms = {gemm_flops / (ms_gemm * 1e9):.1f} TFLOP/s; plain "
          f"{ms['plain_gemm']:.3f} ms, cuBLAS fp32 {ms['cublas']:.3f} ms, bound "
          f"{gemm_bound[0]:.3f} ms ({gemm_bound[1]}); max|kernel-plain| {gemm_err:.3e}, "
          f"{gemm_rel:.2e} of the largest value (tol {TC_GEMM_RTOL_FP32:g})\n"
          f"    walk: {ms['walk']:.3f} ms ({tile}; {1e3 * ms['walk'] / (2 * t):.2f} us a step, "
          f"{walk_flops / (ms['walk'] * 1e9):.1f} TFLOP/s), plain {ms['plain_walk']:.3f} ms, "
          f"bound {walk_bound[0]:.3f} ms ({walk_bound[1]}); max|kernel-plain| {walk_err:.3e} "
          f"over every form (tol {F32_STAGES_ATOL:g}); sweep "
          f"{ {k: round(v, 3) for k, v in sweep.items()} } ms; block 0's cycles: {phases} of "
          f"{sum(cycles)}")
    check(gemm_rel <= TC_GEMM_RTOL_FP32,
          f"fwd_gemm (fp32 layer backward) {tag}: vs plain {gemm_rel:.2e} of max > "
          f"{TC_GEMM_RTOL_FP32:g}")
    check(walk_err <= F32_STAGES_ATOL,
          f"{cell} fp32 walk {tag}: vs plain {walk_err:.3e} > {F32_STAGES_ATOL:g}")
    return {
        "gemm": {"err": gemm_err, "ms": ms_gemm, "plain_ms": ms["plain_gemm"],
                 "library_ms": ms["cublas"], "bound_ms": gemm_bound[0],
                 "bound_by": gemm_bound[1]},
        "walk": {"err": walk_err, "ms": ms["walk"], "plain_ms": ms["plain_walk"],
                 "library_ms": None, "bound_ms": walk_bound[0], "bound_by": walk_bound[1],
                 "us_step": 1e3 * ms["walk"] / (2 * t), "sweep": sweep, "cycles": phases,
                 "tile": tile},
    }


def _fwd_tc_stages(cell: str, tag: str, card: str, x, ws, bs, wfc, bfc, states) -> dict:
    """The bf16 training forward of both layers stage by stage, as
    ``stash_forward`` runs it on the card: ``_train_forward_stages`` over
    recording wrappers of the kernels gives each stage's own inputs (each
    layer's input-projection GEMM and walk, the head's GEMM). Each stage
    against its plain version on the same inputs; times of each stage, of
    the plain versions and of cuBLAS on the GEMMs' products (a yardstick
    the port never calls); a sweep of the walk's forms; block 0's cycles by
    phase; bounds."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    lstm = cell == "lstm"
    walk, plain_walk = ((ops.lstm_train_walk, ops.plain_lstm_train_walk) if lstm
                        else (ops.gru_train_walk, ops.plain_gru_train_walk))
    gemms, walks = [], []

    def gemm(a, b, bias):
        gemms.append((a, b, bias))
        return ops.tc_gemm(a, b, bias=bias)

    def recorded_walk(*args):
        walks.append(args)
        return walk(*args)

    ops._train_forward_stages(gemm, recorded_walk, x, ws, bs, wfc, bfc, *states)
    torch.cuda.synchronize()
    t, n, _ = x.shape
    m = t * n
    hidden = ws[0].shape[1] // GATES[cell]
    gates = GATES[cell] * hidden
    gemm_err, gemm_rel, walk_err = 0.0, 0.0, 0.0
    for a, b, bias in gemms:
        got, want = ops.tc_gemm(a, b, bias=bias), ops.plain_tc_gemm(a, b, bias=bias)
        gemm_err = max(gemm_err, float((got - want).abs().max()))
        gemm_rel = max(gemm_rel, *_rel_errs([got], [want]))
    for args in walks:
        got, want = walk(*args), plain_walk(*args)
        got, want = (got, want) if lstm else ((got,), (want,))
        walk_err = max(walk_err, *(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want)))
        del got, want
    ms_gemm = cuda_ms(lambda: [ops.tc_gemm(a, b, bias=bias) for a, b, bias in gemms])
    ms_walk = cuda_ms(lambda: [walk(*args) for args in walks])
    ms_plain_gemm = cuda_ms(lambda: [ops.plain_tc_gemm(a, b, bias=bias) for a, b, bias in gemms],
                            reps=1)
    ms_plain_walk = cuda_ms(lambda: [plain_walk(*args) for args in walks], reps=1)
    ms_cublas = cuda_ms(lambda: [a @ b for a, b, _ in gemms])
    # the walk's forms: split where H allows, streaming at each row tile with
    # the deepest ring and with 3 slots
    sweep = {}
    if hidden % ops.TRAIN_CHUNK == 0:
        sweep["split"] = cuda_ms(lambda: [walk(*args, split=True) for args in walks])
    for rows in ops.TRAIN_WALK_ROWS:
        deepest = ops.train_walk_ring(rows, cell, hidden)
        for slots in sorted({3, deepest}):
            sweep[f"{rows} rows, {slots} slots"] = cuda_ms(
                lambda: [walk(*args, rows_per_block=rows, stages=slots) for args in walks])
    if ops.train_walk_splits(n, hidden):
        tile = (f"split over {-(-n // ops.SPLIT_ROWS)} cluster(s) of {ops.SPLIT_CTAS} CTAs, "
                f"{ops.train_split_smem_bytes(cell, hidden)} B of shared memory a CTA")
        phase_names = ("product", "cell and stash stores", "cluster exchange")
    else:
        rows, ring = ops.pick_train_walk_tile(n, cell, hidden)
        tile = (f"{rows} rows/block, {-(-n // rows)} blocks, {ring} ring slots, "
                f"{ops.train_walk_smem_bytes(rows, cell, hidden, ring)} B of shared memory a block")
        phase_names = ("product", "cell and stash stores")
    clocks = torch.zeros(3, dtype=torch.int64, device=x.device)
    walk(*walks[0], clocks=clocks)
    cycles = clocks.tolist()[: len(phase_names)]
    phases = ", ".join(f"{name} {c / sum(cycles):.1%}" for name, c in zip(phase_names, cycles))
    # the GEMMs read their A and B once and write P (fp32); the head writes
    # the fp32 output; the walks read P, W_hh^T and the initial states and
    # write the stashes
    gemm_flops = gemm_bytes = 0
    for a, b, bias in gemms:
        gemm_flops += roofline.gemm_flops(a.shape[0], a.shape[1], b.shape[1])
        gemm_bytes += 2 * a.numel() + 2 * b.numel() + 4 * bias.numel() + 4 * a.shape[0] * b.shape[1]
    n_states = 2 if lstm else 1
    walk_flops = roofline.walk_flops(t, n, hidden, cell=cell)
    walk_bytes = 2 * (4 * m * gates + 2 * hidden * gates + 2 * n_states * n * hidden
                      + 2 * n_states * m * hidden + (0 if lstm else 4 * gates))
    gemm_bound = bound(gemm_flops, gemm_bytes, "bf16")
    walk_bound = bound(walk_flops, walk_bytes, "bf16")
    print(f"  training forward's tensor-core stages, {tag}, both layers + head [{card}]:\n"
          f"    GEMM: input projections and head {ms_gemm:.3f} ms ({len(gemms)} launches) = "
          f"{gemm_flops / (ms_gemm * 1e9):.1f} TFLOP/s; plain {ms_plain_gemm:.3f} ms, cuBLAS bf16 "
          f"{ms_cublas:.3f} ms, bound {gemm_bound[0]:.3f} ms ({gemm_bound[1]}); max|kernel-plain| "
          f"{gemm_err:.3e}, {gemm_rel:.2e} of the largest value (tol {TC_GEMM_RTOL_FP32:g})\n"
          f"    walk: {ms_walk:.3f} ms ({tile}; {1e3 * ms_walk / (2 * t):.2f} us a step), plain "
          f"{ms_plain_walk:.3f} ms, bound {walk_bound[0]:.3f} ms ({walk_bound[1]}); "
          f"max|kernel-plain| {walk_err:.3e} (tol {BF16_ATOL:g}); sweep "
          f"{ {k: round(v, 3) for k, v in sweep.items()} } ms; block 0's cycles (layer 0): "
          f"{phases} of {sum(cycles)}")
    check(gemm_rel <= TC_GEMM_RTOL_FP32,
          f"tc_gemm (training forward) {tag}: vs plain {gemm_rel:.2e} of max > "
          f"{TC_GEMM_RTOL_FP32:g}")
    check(walk_err <= BF16_ATOL, f"{cell} training walk {tag}: vs plain {walk_err:.3e} > "
          f"{BF16_ATOL:g}")
    del gemms, walks
    return {
        "gemm": {"err": gemm_err, "ms": ms_gemm, "plain_ms": ms_plain_gemm,
                 "library_ms": ms_cublas, "bound_ms": gemm_bound[0], "bound_by": gemm_bound[1]},
        "walk": {"err": walk_err, "ms": ms_walk, "plain_ms": ms_plain_walk, "library_ms": None,
                 "bound_ms": walk_bound[0], "bound_by": walk_bound[1],
                 "us_step": 1e3 * ms_walk / (2 * t), "sweep": sweep, "cycles": phases},
    }


def _ptxas(library, sources, entry: str) -> list[str]:
    """ptxas's register and spill lines of each kernel of ``library`` (name,
    sources) whose mangled name contains ``entry``, from its build log."""
    from fullsubnet_tpu_torch.ops import build

    lines = build.library_path(library, sources).with_suffix(".log").read_text().splitlines()
    found = []
    for k, line in enumerate(lines):
        if "Compiling entry" in line and entry in line:
            name = re.search(r"'([^']+)'", line)
            stats = [ln.strip() for ln in lines[k + 1 : k + 3] if re.search(r"registers|spill", ln)]
            found.append(f"{name.group(1) if name else line.strip()}: {'; '.join(stats)}")
    return found


def _fwd_f32_stages(cell: str, tag: str, card: str, x, ws, bs, wfc, bfc, states) -> dict:
    """The fp32 training forward of both layers stage by stage, as
    ``stash_forward`` runs it on the card: ``_train_forward_stages`` over
    recording wrappers of the kernels, with the weights ``stash_forward``
    makes (B in PyTorch's layout; W_hh in the walk's form, made once ahead,
    so the walk's time has no repack in it), gives each stage's own inputs
    (each layer's input-projection GEMM and walk, the head's GEMM). Each
    stage against its plain version on the same inputs; times of each
    stage, of the plain versions and of cuBLAS fp32 on the GEMMs' products
    (a yardstick the port never calls); the walk's form and a sweep of both
    forms (the cluster form at each tile that fits, or at the one it would
    take where the rows need many waves; the streaming form); block 0's
    cycles by phase; ptxas's registers and spills; bounds."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    lstm = cell == "lstm"
    walk, plain_walk = ((ops.lstm_train_walk_f32, ops.plain_lstm_fwd_walk) if lstm
                        else (ops.gru_train_walk_f32, ops.plain_gru_fwd_walk))
    gemms, walks = [], []

    def gemm(a, b, bias):
        gemms.append((a, b, bias))
        return ops.fwd_gemm(a, b, bias)

    def recorded_walk(*args):
        walks.append(args)
        return walk(*args)

    t, n, _ = x.shape
    ops._train_forward_stages(gemm, recorded_walk, x, walk.layer_weights(ws, n), bs,
                              wfc.t().contiguous(), bfc, *states, out_in=True)
    torch.cuda.synchronize()
    m = t * n
    hidden = ws[0].shape[1] // GATES[cell]
    # each walk's operands with W_hh [G·H, H] (the plain walk's and the
    # cluster form's) and with the regrouped W_hh^T (the streaming form's)
    w_hh = [w[-hidden:].t().contiguous() for w in ws]
    flat = [(args[0], w, *args[2:]) for args, w in zip(walks, w_hh)]
    grouped = [(args[0], ops._group_hh(w, GATES[cell]), *args[2:])
               for args, w in zip(walks, w_hh)]
    gates = GATES[cell] * hidden
    dev = x.device
    streams = walk.streams(n, hidden, dev)
    forms = {}
    if ops._fwd_walk_takes(hidden, cell):
        tiles = [r for r in ops.FWD_ROWS if ops.fwd_walk_kr(r, hidden, cell) is not None]
        if streams:  # many rows: the cluster form at the tile it would take
            tiles = [ops.pick_fwd_tile(n, hidden, cell,
                                       lambda r, k: walk.max_clusters(hidden, r, k, dev))[0]]
        forms.update({f"cluster, {r} rows": (flat, {"rows": r}) for r in tiles})
    if ops.train_f32_stream_fits(hidden, cell):
        forms["streaming"] = (grouped, {})
    gemm_err, gemm_rel, walk_err = 0.0, 0.0, 0.0
    for a, b, bias in gemms:
        got, want = ops.fwd_gemm(a, b, bias), ops.plain_fwd_gemm(a, b, bias)
        gemm_err = max(gemm_err, float((got - want).abs().max()))
        gemm_rel = max(gemm_rel, *_rel_errs([got], [want]))
    for li, plain_args in enumerate(flat):
        want = plain_walk(*plain_args, stash=True)
        want = want if lstm else (want,)
        for form_walks, kw in ((walks, {}), *forms.values()):
            got = walk(*form_walks[li], **kw)
            torch.cuda.synchronize()
            got = got if lstm else (got,)
            walk_err = max(walk_err, *(float((g - w).abs().max()) for g, w in zip(got, want)))
            del got
        del want
    ms_gemm = cuda_ms(lambda: [ops.fwd_gemm(a, b, bias) for a, b, bias in gemms])
    ms_walk = cuda_ms(lambda: [walk(*args) for args in walks])
    ms_plain_gemm = cuda_ms(lambda: [ops.plain_fwd_gemm(a, b, bias) for a, b, bias in gemms],
                            reps=1)
    ms_plain_walk = cuda_ms(lambda: [plain_walk(*args, stash=True) for args in flat], reps=1)
    ms_cublas = cuda_ms(lambda: [torch.addmm(bias, a, b.t()) for a, b, bias in gemms])
    sweep = {name: cuda_ms(lambda: [walk(*args, **kw) for args in form_walks])
             for name, (form_walks, kw) in forms.items()}
    if streams:
        tile = (f"streaming, blocks of {ops.TRAIN_F32_ROWS} rows, {-(-n // ops.TRAIN_F32_ROWS)} "
                f"blocks, groups of {ops.TRAIN_F32_UNITS} units, a ring of {ops._TRAIN_F32_RING} "
                f"slots of {ops._TRAIN_F32_CHUNK} K rows, "
                f"{ops.train_f32_stream_smem_bytes(hidden, cell)} B of shared memory a block")
        phase_names = ("ring wait", "product", "cell")
        entry = f"train_f32_walk_kernelILb{int(lstm)}EE"
        ptxas = _ptxas(ops.train_f32_library.NAME, list(ops.train_f32_library.SOURCES), entry)
    else:
        rows, kr, in_flight = walk.tile(n, hidden, dev)
        tiles = -(-n // rows)
        tile = (f"cluster, {rows} rows a cluster of {ops.FWD_CTAS} CTAs, KR {kr}, "
                f"{ops.fwd_walk_smem_bytes(rows, hidden, cell, kr)} B of shared memory a CTA, "
                f"{tiles} cluster(s), {in_flight} in flight, {-(-tiles // in_flight)} wave(s)")
        phase_names = ("exchange", "product", "cell")
        entry = f"rnn_fwd_walk_kernelILi{rows}ELb{int(lstm)}ELi{kr}ELb{int(lstm)}E"
        ptxas = _ptxas(ops.fwd_library.NAME, list(ops.fwd_library.SOURCES), entry)
    clocks = torch.zeros(3, dtype=torch.int64, device=dev)
    walk(*walks[0], clocks=clocks)
    cycles = clocks.tolist()
    phases = ", ".join(f"{name} {c / max(sum(cycles), 1):.1%}"
                       for name, c in zip(phase_names, cycles))
    # the GEMMs read A and B once and write P (the head: the output); the
    # walks read P, W_hh and the initial states and write the stashes
    gemm_flops = gemm_bytes = 0
    for a, b, bias in gemms:
        gemm_flops += roofline.gemm_flops(a.shape[0], a.shape[1], b.shape[0])
        gemm_bytes += 4 * (a.numel() + b.numel() + bias.numel() + a.shape[0] * b.shape[0])
    n_states = 2 if lstm else 1
    walk_flops = roofline.walk_flops(t, n, hidden, cell=cell)
    walk_bytes = 2 * 4 * (m * gates + hidden * gates + n_states * n * hidden
                          + n_states * m * hidden + (0 if lstm else gates))
    gemm_bound = bound(gemm_flops, gemm_bytes, "fp32")
    walk_bound = bound(walk_flops, walk_bytes, "fp32")
    print(f"  training forward's fp32 stages, {tag}, both layers + head [{card}]:\n"
          f"    GEMM (fwd_gemm, 128 x 128 x 8 tiles): input projections and head {ms_gemm:.3f} ms "
          f"({len(gemms)} launches) = {gemm_flops / (ms_gemm * 1e9):.1f} TFLOP/s; plain "
          f"{ms_plain_gemm:.3f} ms, cuBLAS fp32 {ms_cublas:.3f} ms, bound {gemm_bound[0]:.3f} ms "
          f"({gemm_bound[1]}); max|kernel-plain| {gemm_err:.3e}, {gemm_rel:.2e} of the largest "
          f"value (tol {TC_GEMM_RTOL_FP32:g})\n"
          f"    walk: {ms_walk:.3f} ms ({tile}; {1e3 * ms_walk / (2 * t):.2f} us a step, "
          f"{walk_flops / (ms_walk * 1e9):.1f} TFLOP/s), plain {ms_plain_walk:.3f} ms, bound "
          f"{walk_bound[0]:.3f} ms ({walk_bound[1]}); max|kernel-plain| {walk_err:.3e} over every "
          f"form (tol {F32_STAGES_ATOL:g}); sweep { {k: round(v, 3) for k, v in sweep.items()} } "
          f"ms; block 0's cycles (layer 0): {phases} of {sum(cycles)}\n"
          f"    ptxas: {' | '.join(ptxas) or 'no entry found'}")
    check(gemm_rel <= TC_GEMM_RTOL_FP32,
          f"fwd_gemm (fp32 training forward) {tag}: vs plain {gemm_rel:.2e} of max > "
          f"{TC_GEMM_RTOL_FP32:g}")
    check(walk_err <= F32_STAGES_ATOL,
          f"{cell} fp32 training walk {tag}: vs plain {walk_err:.3e} > {F32_STAGES_ATOL:g}")
    del gemms, walks, flat, grouped
    return {
        "gemm": {"err": gemm_err, "ms": ms_gemm, "plain_ms": ms_plain_gemm,
                 "library_ms": ms_cublas, "bound_ms": gemm_bound[0], "bound_by": gemm_bound[1]},
        "walk": {"err": walk_err, "ms": ms_walk, "plain_ms": ms_plain_walk, "library_ms": None,
                 "bound_ms": walk_bound[0], "bound_by": walk_bound[1],
                 "us_step": 1e3 * ms_walk / (2 * t), "sweep": sweep, "cycles": phases,
                 "tile": tile, "form": "streaming" if streams else "cluster"},
    }


def _write_flagship_checkpoint(path: Path, cfg: Path) -> None:
    """Full-width weights of the model ``cfg`` names (the flagship, with
    its cell) from a numpy seed, torch-default scale, saved with the
    reference keys."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import build_model, load_config

    model, _ = build_model(load_config(cfg))
    rng = np.random.default_rng(SEED + 1)
    state = {}
    for key, v in model.state_dict().items():
        # LSTM and head weights alike: U(±1/sqrt(H)) of their stage
        hidden = model.get_submodule(key.split(".")[0]).hidden_size
        bound_ = 1.0 / hidden**0.5
        state[key] = torch.from_numpy(
            rng.uniform(-bound_, bound_, tuple(v.shape)).astype(np.float32)
        )
    torch.save({"model": state, "epoch": 0}, path)


def _set_cell(toml: str, cell: str) -> str:
    """The recipe with ``sequence_model`` set to ``cell`` ("LSTM" or "GRU")."""
    toml, n_sub = re.subn(r'(?m)^sequence_model = "LSTM"', f'sequence_model = "{cell}"', toml)
    check(n_sub == 1, "recipe has no single sequence_model line")
    return toml


def _inference_config(work: Path, noisy_dir: Path, cell: str = "LSTM", batch_size: int = 1,
                      recipe: Path = RECIPE) -> Path:
    """The inference TOML ``recipe`` (the flagship's by default) pointed at
    ``noisy_dir``, with ``cell``, and ``[inferencer] batch_size`` where it
    is above 1."""
    toml = _set_cell(recipe.read_text(), cell)
    toml, n_sub = re.subn(r"(?m)^dataset_dir_list = .*$",
                          f"dataset_dir_list = [{json.dumps(str(noisy_dir))}]", toml)
    check(n_sub == 1, "recipe has no dataset_dir_list line to point at the wavs")
    if batch_size > 1:
        toml, n_sub = re.subn(r'(?m)^(type = "full_band_crm_mask")$',
                              rf"\1\nbatch_size = {batch_size}", toml)
        check(n_sub == 1, "recipe has no single [inferencer] type line")
    cfg = work / f"inference_{recipe.parent.name}_{cell}_{noisy_dir.name}_b{batch_size}.toml"
    cfg.write_text(toml)
    return cfg


def _wrappers() -> dict:
    """Every kernel wrapper of the port (``ops.subband_lstm``), by name."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    return {k: v for k, v in vars(ops).items() if isinstance(v, ops._Counts)}


def _launch_counts() -> dict:
    """Each kernel wrapper's launches and launches by shape, by wrapper."""
    return {w: (w.launches, collections.Counter(w.launches_by_shape))
            for w in _wrappers().values()}


def _frames(samples: int) -> int:
    """The model's frames for a flagship STFT (n_fft 512, hop 256) of
    ``samples``, with its 2 look-ahead frames."""
    from fullsubnet_tpu_torch.acoustics.stft import num_stft_frames

    return num_stft_frames(samples, 256, 512) + 2


# the time chunks of the inference forward's sub-band stage at the smoke's
# shapes, fixed here and not read from the code under test: the forward
# keeps its gate pre-activations P [Tc, N, G·H] fp32 under 4 GiB a chunk.
# Every utterance and flush of phases 7, 8a, 9 and 9a (at most 2 x 257
# rows and 815 frames) takes one chunk of each stage; phase 8b's B = 128
# flush (N = 32,896 sub-band rows, 1,940 frames) takes 93 chunks of 21
# steps with the LSTM. The full-band stage takes one chunk throughout.
B128_SUB_CHUNKS = 93


def _k1_launches(cell: str, calls) -> tuple[dict, dict]:
    """What the inference forward launches, by shape key, for ``calls``:
    (B, T, chunks) model calls of B rows and T frames (the look-ahead
    included) whose sub-band stage runs in ``chunks`` time chunks and the
    full-band stage in one. Per stage (full-band: N = B rows of 257;
    sub-band: N = 257 B rows of 32) and per chunk, a GEMM for each layer's
    input projection (F or H, G·H) and the head (H, OUT), and a walk per
    layer (N, H)."""
    gemm, walk = collections.Counter(), collections.Counter()
    for batch, _, sub_chunks in calls:
        for f_in, hidden, out_dim, n, chunks in ((257, 512, 257, batch, 1),
                                                 (32, 384, 2, 257 * batch, sub_chunks)):
            gh = GATES[cell.lower()] * hidden
            for key in ((f_in, gh), (hidden, gh), (hidden, out_dim)):
                gemm[key] += chunks
            walk[(n, hidden)] += 2 * chunks
    return dict(gemm), dict(walk)


def _inference_kernels(cell: str) -> tuple[dict, dict]:
    """(the inference path's kernel wrappers by name: the forward GEMM and
    the cell's walk; the other forward kernels by name: the other cell's
    walk and the kernels of the earlier design, lstm_scan and gru_scan)."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    every = {"fwd_gemm": ops.fwd_gemm, "lstm_fwd_walk": ops.lstm_fwd_walk,
             "gru_fwd_walk": ops.gru_fwd_walk, "lstm_scan": ops.lstm_scan,
             "gru_scan": ops.gru_scan}
    own = ("fwd_gemm", "lstm_fwd_walk" if cell == "LSTM" else "gru_fwd_walk")
    return {k: every[k] for k in own}, {k: v for k, v in every.items() if k not in own}


def _flagship_wave10(work: Path):
    """Phase 7's 10 s noisy wave (its third, from the seed), as the
    Inferencer reads it back."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav

    sr, rng = 16000, np.random.default_rng(SEED + 2)
    for seconds in (1, 4, 10):
        t = np.arange(seconds * sr) / sr
        wave = (0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    write_wav(work / "wave10.wav", wave, sr)
    return read_wav(work / "wave10.wav")[0]


def phase_end_to_end(work: Path, card: str, cell: str = "LSTM") -> dict:
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    own, others = _inference_kernels(cell)
    label = "K1" if cell == "LSTM" else "K1-GRU"
    sr = 16000
    rng = np.random.default_rng(SEED + 2)
    noisy_dir = work / f"noisy_in_{cell}"
    noisy_dir.mkdir()
    inputs = {}
    for seconds in (1, 4, 10):
        t = np.arange(seconds * sr) / sr
        wave = (0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        name = f"utt_{seconds:02d}s"
        write_wav(noisy_dir / f"{name}.wav", wave, sr)
        inputs[name] = read_wav(noisy_dir / f"{name}.wav")[0]
    cfg = _inference_config(work, noisy_dir, cell)
    ckpt = work / f"flagship_{cell}_random.tar"
    _write_flagship_checkpoint(ckpt, cfg)
    out_dir = work / f"out_{cell}"

    for kernel in (*own.values(), *others.values()):
        kernel.reset_counts()
    t0 = time.perf_counter()
    cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (kernel.launches, dict(kernel.launches_by_shape))
              for k, kernel in (*own.items(), *others.items())}
    print(f"infer CLI ({cell}) on {len(inputs)} wavs (1 s, 4 s, 10 s): {wall:.2f} s wall incl. "
          f"first-call set-up; {label} stages' launches {counts} [{card}]")
    for other in others:
        check(counts[other][0] == 0, f"the {cell} infer path launched {other}")

    for name, noisy in inputs.items():
        out, got_sr = read_wav(out_dir / "enhanced" / f"{name}.wav")
        check(got_sr == sr, f"{name}: sample rate {got_sr}")
        check(out.shape == noisy.shape, f"{name}: length {out.shape} != {noisy.shape}")
        check(bool(np.isfinite(out).all()), f"{name}: enhanced audio not finite")
        peak = float(np.max(np.abs(out)))
        check(abs(peak - 0.8) <= PEAK_ATOL, f"{name}: peak {peak} is not 0.8")
    print(f"outputs: {len(inputs)} enhanced wavs, finite, input length and rate, peak 0.8 "
          f"(tol {PEAK_ATOL:.2e})")
    want_gemm, want_walk = _k1_launches(cell, [(1, _frames(w.size), 1)
                                               for w in inputs.values()])
    gemm_name, walk_name = own
    check(counts[gemm_name][1] == want_gemm, f"fwd_gemm launches by shape {counts[gemm_name][1]}")
    check(counts[walk_name][1] == want_walk,
          f"{walk_name} launches by shape {counts[walk_name][1]}")

    # the card's cIRM against the port's plain CPU path, same input
    config = load_config(cfg)
    check(config["model"]["args"]["sequence_model"] == cell, f"{cfg} is not a {cell} config")
    gpu = Inferencer(config, str(ckpt), None, device="cuda")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    wave = torch.from_numpy(inputs["utt_01s"][None])
    crm_cpu, spec = cpu.predict_crm(wave)
    crm_gpu, _ = gpu.predict_crm(wave.cuda())
    with torch.inference_mode():
        mag = spec.abs()[:, None]  # one spectrogram for both: compare the model alone
        m_cpu = cpu.model(mag, dropping_band=False)
        m_gpu = gpu.model(mag.cuda(), dropping_band=False).cpu()
    err = float((m_gpu - m_cpu).abs().max())
    err_dec = float((crm_gpu.cpu() - crm_cpu).abs().max())
    print(f"cIRM ({cell}) card vs plain CPU (1 s utterance): max|diff| {err:.3e} compressed "
          f"(tol {CRM_ATOL:g}), {err_dec:.3e} after decompression")
    check(bool(torch.isfinite(m_gpu).all()), "card cIRM not finite")
    check(err <= CRM_ATOL, f"cIRM card vs CPU {err:.3e} > {CRM_ATOL:g}")
    return {"launches": {k: v[0] for k, v in counts.items()}, "model": gpu.model,
            "wave10": inputs["utt_10s"], "ckpt": ckpt}


# the batched phase's wavs, in seconds: 0.01 s (160 samples) takes the exact
# path; the rest fill ten buckets of 1 s, each a partial flush (one or two
# rows)
BATCH_SECONDS = (0.01, 0.5, 1, 2.5, 3, 4, 6, 7.5, 9, 10, 10, 12)
# the batched CLI's enhanced signal (before the int16 write) against the
# batch_size = 1 run's on the card, held to this share of its peak: the same
# fp32 frames and weights; the norm statistics are a sum over the padded
# row over the true count where the exact run takes a mean, the stages
# run at other N and T (a flush's rows over the bucket's frames), and the
# cIRM decompression's slope reaches 100 at its 9.9 clamp
BATCH_RTOL = 1e-4


@contextlib.contextmanager
def _recorded_outputs():
    """Within the block, each enhanced signal the Inferencer writes, before
    its int16 conversion, by file name (into the yielded dict)."""
    import numpy as np

    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    out = {}
    write = Inferencer._write_outputs

    def record(self, enhanced, noisy, name):
        out[name] = np.asarray(enhanced, np.float32).copy()
        write(self, enhanced, noisy, name)

    Inferencer._write_outputs = record
    try:
        yield out
    finally:
        Inferencer._write_outputs = write


def phase_batched_infer(work: Path, card: str, cell: str, ckpt: Path) -> dict:
    """The infer CLI with ``[inferencer] batch_size = 8`` on a copy of the
    flagship inference TOML, over the ``BATCH_SECONDS`` wavs: finite
    outputs at the input's length and rate, peak 0.8; each output (before
    the int16 write) against the ``batch_size = 1`` run's of the same wav;
    K1's launches by shape: one set for each flush at N = rows·257 and
    rows (a flush runs its own rows only), and the exact path's at 257 and
    1; no earlier kernel."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli

    sr, n_fft, batch = 16000, 512, 8
    rng = np.random.default_rng(SEED + 5)
    noisy_dir = work / f"noisy_batched_{cell}"
    noisy_dir.mkdir()
    inputs = {}
    for i, seconds in enumerate(BATCH_SECONDS):
        t = np.arange(int(seconds * sr)) / sr
        wave = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
                + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        name = f"utt{i:02d}_{seconds:g}s"
        write_wav(noisy_dir / f"{name}.wav", wave, sr)
        inputs[name] = read_wav(noisy_dir / f"{name}.wav")[0]
    walk_name = "lstm_fwd_walk" if cell == "LSTM" else "gru_fwd_walk"
    outputs, walls = {}, {}
    for size in (batch, 1):
        cfg = _inference_config(work, noisy_dir, cell, batch_size=size)
        for kernel in _wrappers().values():
            kernel.reset_counts()
        with _recorded_outputs() as outputs[size]:
            t0 = time.perf_counter()
            cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(work / f"out_b{size}_{cell}"),
                      "--device", "cuda"])
            torch.cuda.synchronize()
            walls[size] = time.perf_counter() - t0
        if size == batch:
            launched = {k: (w.launches, dict(w.launches_by_shape))
                        for k, w in _wrappers().items() if w.launches}

    # the Inferencer's grouping: the exact path at <= n_fft // 2 samples,
    # else buckets of 1 s (length + n_fft rounded up), flushed 8 at a time,
    # a partial flush with its own rows only; each call one chunk
    calls, buckets = [], collections.Counter()
    for wave in inputs.values():
        if wave.size <= n_fft // 2:
            calls.append((1, _frames(wave.size), 1))
        else:
            buckets[-(-(wave.size + n_fft) // sr) * sr] += 1
    for bucket, count in buckets.items():
        calls += [(min(batch, count - i), _frames(bucket), 1) for i in range(0, count, batch)]
    want_gemm, want_walk = _k1_launches(cell, calls)
    rows = sorted(b for b, _, _ in calls[1:])
    print(f"infer CLI ({cell}), batch_size {batch}, {len(inputs)} wavs of {BATCH_SECONDS} s: "
          f"{walls[batch]:.2f} s wall ({len(rows)} flushes of {rows} rows in {len(buckets)} "
          f"buckets, one exact call); batch_size 1: {walls[1]:.2f} s; launches {launched} [{card}]")
    check(set(launched) == {"fwd_gemm", walk_name},
          f"the batched {cell} infer CLI launched {sorted(launched)}")
    check(launched["fwd_gemm"][1] == want_gemm,
          f"batched fwd_gemm launches by shape {launched['fwd_gemm'][1]}, want {want_gemm}")
    check(launched[walk_name][1] == want_walk,
          f"batched {walk_name} launches by shape {launched[walk_name][1]}, want {want_walk}")

    worst = 0.0
    for name, noisy in inputs.items():
        got, one = outputs[batch][name], outputs[1][name]
        check(got.shape == one.shape == noisy.shape, f"{name}: batched length {got.shape}")
        check(bool(np.isfinite(got).all()), f"{name}: batched output not finite")
        err = float(np.max(np.abs(got - one)) / max(float(np.max(np.abs(one))), 1e-30))
        worst = max(worst, err)
        check(err <= BATCH_RTOL, f"{name}: batched vs batch_size 1 {err:.3e} of the peak")
        out, got_sr = read_wav(work / f"out_b{batch}_{cell}" / "enhanced" / f"{name}.wav")
        check(got_sr == sr and out.shape == noisy.shape and bool(np.isfinite(out).all()),
              f"{name}: written batched wav")
        peak = float(np.max(np.abs(out)))
        check(abs(peak - 0.8) <= PEAK_ATOL, f"{name}: batched peak {peak} is not 0.8")
    print(f"batched outputs ({cell}): finite, input length and rate, peak 0.8; against "
          f"batch_size 1, max|diff| / peak {worst:.3e} (tol {BATCH_RTOL:g})")
    return {"fwd_gemm": launched["fwd_gemm"][0], walk_name: launched[walk_name][0]}


def phase_batched_throughput(work: Path, wave10, card: str, ckpt: Path, forward: dict) -> dict:
    """The batched Inferencer at B=128 x 30 s (the LSTM; ``enhance_bucket``
    in memory, no wav I/O): one call after a warm-up, audio-s/s and
    peak memory beside phase 8's model forward (``forward``, None when
    phase 8 did not run) in this run;
    and the share outside the model (STFT, masking, iSTFT, copies), with
    the host padding timed apart; K1's launches by shape over the 2 calls,
    the sub-band stage in ``B128_SUB_CHUNKS`` chunks."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.infer.host import pad_bucket_batch
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    batch, sr, n_fft = 128, 16000, 512
    wave30 = np.tile(wave10, 3)
    waves = [wave30] * batch
    bucket = -(-(wave30.size + n_fft) // sr) * sr
    empty = work / "no_wavs"
    empty.mkdir()
    cfg = _inference_config(work, empty, "LSTM", batch_size=batch)
    inferencer = Inferencer(load_config(cfg), str(ckpt), None, device="cuda")
    model_s = []

    def start(*_):
        torch.cuda.synchronize()
        model_s.append(-time.perf_counter())

    def stop(*_):
        torch.cuda.synchronize()
        model_s[-1] += time.perf_counter()

    hooks = [inferencer.model.register_forward_pre_hook(start),
             inferencer.model.register_forward_hook(stop)]
    for kernel in _wrappers().values():
        kernel.reset_counts()
    try:
        out = inferencer.enhance_bucket(waves, bucket)  # warm-up
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model_s.clear()
        # one timed call (a cut for the smoke's time limit: three spread
        # 0.17% in PR 21's first smoke run)
        out = None
        t0 = time.perf_counter()
        out = inferencer.enhance_bucket(waves, bucket)
        times = [time.perf_counter() - t0]
    finally:
        for hook in hooks:
            hook.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launched = {k: (w.launches, dict(w.launches_by_shape))
                for k, w in _wrappers().items() if w.launches}
    pad_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pad_bucket_batch(waves, batch, bucket)
        pad_s.append(time.perf_counter() - t0)
    wall, model, pad = times[0], model_s[0], sorted(pad_s)[1]
    check(len(out) == batch and all(o.shape == wave30.shape for o in out),
          "batched B=128 output shapes")
    check(all(bool(np.isfinite(o).all()) for o in out), "batched B=128 output not finite")
    # the warm-up and the timed call: K1's stages alone, the sub-band stage
    # in its chunks
    want_gemm, want_walk = _k1_launches("LSTM", [(batch, _frames(bucket), B128_SUB_CHUNKS)] * 2)
    check(set(launched) == {"fwd_gemm", "lstm_fwd_walk"},
          f"the batched Inferencer at B={batch} launched {sorted(launched)}")
    check(launched["fwd_gemm"][1] == want_gemm,
          f"B={batch} fwd_gemm launches by shape {launched['fwd_gemm'][1]}, want {want_gemm}")
    check(launched["lstm_fwd_walk"][1] == want_walk,
          f"B={batch} lstm_fwd_walk launches by shape {launched['lstm_fwd_walk'][1]}, want "
          f"{want_walk}")
    audio = batch * wave30.size / sr
    print(f"batched Inferencer B={batch} x {wave30.size / sr:g} s (bucket {bucket / sr:g} s, "
          f"{bucket // 256 + 3} frames with the look-ahead): {wall * 1e3:.1f} ms after a "
          f"warm-up, {audio / wall:.1f} audio-s/s, peak memory "
          f"{peak_gb:.2f} GiB; the model {model * 1e3:.1f} ms, outside it "
          f"{(wall - model) * 1e3:.1f} ms = {1 - model / wall:.3f} of the call (STFT, masking, "
          f"iSTFT, copies, and the host padding {pad * 1e3:.1f} ms); the unfused sub-band "
          f"input's peak before the fused stage {UNFUSED_B128_PEAK_GIB} GiB"
          + ("" if forward is None else
             f"; phase 8's model forward at B={batch} x 30 s on the exact frames: "
             f"{forward['ms']:.1f} ms, {forward['audio_s_per_s']:.1f} audio-s/s, "
             f"{forward['peak_gib']:.2f} GiB")
          + f"; launches over the 2 calls {launched} [{card}]")
    del inferencer, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": wall * 1e3, "audio_s_per_s": audio / wall, "peak_gib": peak_gb,
            "model_ms": model * 1e3, "pad_ms": pad * 1e3}


def phase_rtf(model, wave10, card: str) -> dict:
    """The model forward's real-time factor at B=1 and B=8 x 10 s (median
    of 3), then at B=128 x 30 s (the wave tiled three times; one call after
    a warm-up): audio-s/s, peak memory, finite output; and at that
    shape each stage through the main path (K1's stages) beside cuDNN
    (nn.LSTM + Linear over the
    stages' time chunks, (h, c) carried: one call's output would not fit)
    and the plain stages over the same chunks, on the inputs the forward
    gives it (one call each, the call compared)."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    spec = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512)
    seconds = wave10.size / 16000
    rtf = {}
    for batch in (1, 8):
        mag = spec.abs()[None, None].expand(batch, 1, -1, -1).contiguous()
        with torch.inference_mode():
            model(mag, dropping_band=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                model(mag, dropping_band=False)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        best = sorted(times)[len(times) // 2]
        rtf[batch] = best / (batch * seconds)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"model forward B={batch} x {seconds:g} s: median {best * 1e3:.1f} ms of "
              f"{[round(t * 1e3, 1) for t in times]}, RTF {best / (batch * seconds):.5f} "
              f"(s of compute per s of audio), peak memory {peak_gb:.2f} GiB [{card}]")

    # the offline-throughput point: B=128 x 30 s
    batch, wave30 = 128, np.tile(wave10, 3)
    seconds = wave30.size / 16000
    mag = stft_complex(torch.from_numpy(wave30).cuda(), 512, 256, 512).abs()[None, None]
    mag = mag.expand(batch, 1, -1, -1).contiguous()
    with torch.inference_mode():
        model(mag, dropping_band=False)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # one call after the warm-up: three calls spread 0.01% on an H100
        times = []
        for _ in range(1):
            out = None
            t0 = time.perf_counter()
            out = model(mag, dropping_band=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    wall = times[0]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(out).all())
    print(f"model forward B={batch} x {seconds:g} s ({mag.shape[-1]} frames; the sub-band stage "
          f"N = {batch * mag.shape[2]}, fused input): {wall * 1e3:.1f} ms after a warm-up, "
          f"{batch * seconds / wall:.1f} audio-s/s, peak "
          f"memory {peak_gb:.2f} GiB (the batched Inferencer's with the unfused input: "
          f"{UNFUSED_B128_PEAK_GIB} GiB), output {tuple(out.shape)} finite {finite} [{card}]")
    check(out.shape[0] == batch and out.shape[-1] == mag.shape[-1], "B=128 output shape")
    check(finite, "B=128 x 30 s output not finite")
    del out

    # each stage's input as the forward hands it to fused_subband_lstm: the
    # full-band stack's through its module, the fused sub-band stage's
    # [T, N, unit] input where it calls the op
    from fullsubnet_tpu_torch.models import fullsubnet as fullsubnet_module

    stage_inputs = {}
    stages = {"full-band": model.fb_model, "sub-band": model.sb_model}
    hook = model.fb_model.register_forward_pre_hook(
        lambda _, args: stage_inputs.__setitem__("full-band", args[0].permute(2, 0, 1)
                                                 .contiguous()))
    op = fullsubnet_module.fused_subband_lstm

    def sub_band_op(x, *args, **kwargs):
        stage_inputs["sub-band"] = x
        return op(x, *args, **kwargs)

    fullsubnet_module.fused_subband_lstm = sub_band_op
    try:
        with torch.inference_mode():
            model(mag, dropping_band=False)
    finally:
        hook.remove()
        fullsubnet_module.fused_subband_lstm = op
    check(set(stage_inputs) == set(stages), f"B=128 stage inputs captured: {sorted(stage_inputs)}")
    del mag
    stage_ms = {}
    for name, module in stages.items():
        x = stage_inputs.pop(name)
        layers = module.sequence_model.layers()
        fc = {"weight": module.fc_output_layer.weight, "bias": module.fc_output_layer.bias}
        t, n, f_in = x.shape
        hidden = module.hidden_size
        steps = ops.fwd_chunk_steps(t, n, hidden, "lstm")
        rnn = _cudnn_rnn(layers, f_in, hidden, torch.float32, x.device)

        def cudnn_forward():
            """nn.LSTM + Linear chunk by chunk of the stages' steps, (h, c)
            carried, the head written into one output."""
            out = torch.empty((t, n, fc["weight"].shape[0]), device=x.device)
            state = None
            for t0 in range(0, t, steps):
                y, state = rnn(x[t0 : t0 + steps], state)
                torch.addmm(fc["bias"], y.view(-1, hidden), fc["weight"].t(),
                            out=out[t0 : t0 + steps].view(-1, out.shape[-1]))
                del y
            return out

        def timed(fn):
            """(fn(), its device ms by CUDA events)."""
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)

        # one call each, timed as it is compared (cuts for the smoke's time
        # limit: no untimed round first, the forward above ran K1's stages
        # at this shape twice; the earlier kernel, lstm_scan, is timed at
        # phase 3's shapes only)
        with torch.inference_mode():
            new, ms = timed(lambda: ops.fused_subband_lstm(x, *layers, fc))
            lib, cudnn_ms = timed(cudnn_forward)
            err_cudnn = float((new - lib).abs().max())
            del lib
            # the plain stages over the same chunks: bound by host launches,
            # a GEMM and a dozen element-wise ops a step
            plain, plain_ms = timed(lambda: ops.plain_fused_forward(x, layers, fc, steps))
            err_plain = float((new - plain).abs().max())
            del new, plain
        stage_times = {"stages": [ms], "cuDNN": [cudnn_ms], "plain": [plain_ms]}
        del rnn
        rows, kr, in_flight = ops.lstm_fwd_walk.tile(n, hidden, x.device)
        chunks = -(-t // steps)
        samples = {k: [round(v, 1) for v in vs] for k, vs in stage_times.items()}
        print(f"  {name} stage at B={batch} x {seconds:g} s (N {n}, T {t}), one call each "
              f"{samples}: K1's stages {ms:.1f} ms ({chunks} chunk(s) of {steps} steps; "
              f"walk tile {rows} rows, {-(-n // rows)} cluster(s), {in_flight} in flight), cuDNN "
              f"nn.LSTM + Linear over the same chunks {cudnn_ms:.1f} ms ({cudnn_ms / ms:.3f}x), "
              f"the plain stages over the same chunks {plain_ms:.1f} ms ({plain_ms / ms:.3f}x); "
              f"max|stages - cuDNN| {err_cudnn:.3e}, max|stages - plain| {err_plain:.3e} (tol "
              f"{KERNEL_ATOL:g}) [{card}]")
        check(err_cudnn <= KERNEL_ATOL,
              f"B=128 {name} stage vs cuDNN {err_cudnn:.3e} > {KERNEL_ATOL:g}")
        check(err_plain <= KERNEL_ATOL,
              f"B=128 {name} stage vs plain {err_plain:.3e} > {KERNEL_ATOL:g}")
        stage_ms[name] = {"ms": ms, "cudnn_ms": cudnn_ms, "plain_ms": plain_ms,
                          "err": max(err_cudnn, err_plain)}
        del x
    torch.cuda.empty_cache()
    return {"ms": wall * 1e3, "audio_s_per_s": batch * seconds / wall, "peak_gib": peak_gb,
            "stages": stage_ms, "rtf_b1": rtf[1]}


def _profile(fn, label: str, card: str) -> list:
    """torch.profiler over one call of ``fn`` (which synchronises): device
    time by kernel and the device's idle share. Returns the kernel rows
    (device us, name, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats the device time of the
        # kernels it launched
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    if not rows:
        print(f"profile of {label}: the profiler recorded no device time (not measured)")
        return rows
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_us):.3f} [{card}]")
    for dev_us, key, count in rows[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / busy:5.1f}%  x{count}  {key[:90]}")
    return rows


# a train step's GEMMs outside the port's kernels (which live in an
# anonymous namespace): the head backward's two fp32 products a stage
# (dW_fc and dh), and no dW product since the dW stage is a kernel
HEAD_BWD_GEMMS = 4


def _check_library_gemms(rows, label: str, limit: int = HEAD_BWD_GEMMS) -> None:
    """At most ``limit`` library GEMM launches among the profile's kernels:
    the head backward's two a headed stack (and, where a model has one, a
    plain matrix product outside its stacks, as Fast's mel projection)."""
    gemms = {key[:90]: (count, round(us / 1e3, 3)) for us, key, count in rows
             if re.search(r"gemm|gemv|nvjet", key, re.I) and "anonymous namespace" not in key}
    launches = sum(count for count, _ in gemms.values())
    print(f"  library GEMM kernels in {label} (launches, ms): {gemms}")
    check(launches <= limit,
          f"{label}: {launches} library GEMM launches, more than the {limit} outside the "
          f"stacks: {gemms}")


def phase_profile(model, wave10, card: str) -> None:
    """Where the time of one B=1 x 10 s forward goes on the card."""
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex

    spec = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512)
    mag = spec.abs()[None, None]

    def forward():
        with torch.inference_mode():
            model(mag, dropping_band=False)
        torch.cuda.synchronize()

    forward()
    _profile(forward, f"one B=1 x {wave10.size / 16000:g} s forward", card)


def _write_train_data(root: Path, sr: int = 16000) -> dict:
    """64 clean wavs of 4 s (amplitude-modulated tones), 4 noise wavs and
    2 short RIRs from a numpy seed, and their list files; and the two
    validation directories of the DNS synthetic test set's layout (see
    ``_write_validation_dirs``), under ``"val"``; all at ``sr``."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(SEED + 4)
    root.mkdir(parents=True)
    t = np.arange(4 * sr) / sr
    lists = {"clean": [], "noise": [], "rir": []}
    for i in range(64):
        f0, fm = rng.uniform(120, 400), rng.uniform(2, 6)
        wave = 0.3 * np.sin(2 * np.pi * f0 * t + 2 * np.sin(2 * np.pi * 0.5 * t))
        wave *= 0.55 + 0.45 * np.sin(2 * np.pi * fm * t + rng.uniform(0, 2 * np.pi))
        lists["clean"].append(root / f"clean_{i:02d}.wav")
        write_wav(lists["clean"][-1], wave.astype(np.float32), sr)
    for i, seconds in enumerate((2.0, 3.5, 5.0, 1.5)):
        noise = rng.standard_normal(int(seconds * sr))
        if i % 2:  # brown noise
            noise = np.cumsum(noise)
            noise -= np.convolve(noise, np.ones(400) / 400, mode="same")
        noise = 0.2 * noise / np.max(np.abs(noise))
        lists["noise"].append(root / f"noise_{i}.wav")
        write_wav(lists["noise"][-1], noise.astype(np.float32), sr)
    for i, seconds in enumerate((0.1, 0.25)):
        n = int(seconds * sr)
        rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.2 * n))
        rir[0] = 1.0
        lists["rir"].append(root / f"rir_{i}.wav")
        write_wav(lists["rir"][-1], (0.9 * rir / np.max(np.abs(rir))).astype(np.float32), sr)
    out = {}
    for kind, paths in lists.items():
        out[kind] = root / f"{kind}.txt"
        out[kind].write_text("".join(f"{p}\n" for p in paths))
    out["val"] = _write_validation_dirs(root / "val", rng, sr=sr)
    return out


# validation utterances a split, in seconds (the DNS synthetic test set's
# clips are 10 s)
VAL_SECONDS = (3, 7, 10)


def _write_validation_dirs(root: Path, rng, seconds_list=VAL_SECONDS, sr: int = 16000) -> list:
    """``root/{with_reverb,no_reverb}/{noisy,clean}`` with DNS names
    (``..._fileid_N.wav`` beside ``clean_fileid_N.wav``): per split a clip
    of each length in ``seconds_list`` at ``sr``, a gliding,
    amplitude-modulated tone and that tone with noise at 5 dB SNR
    (with_reverb: convolved with a decaying noise RIR first). Returns the
    two split directories."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import write_wav

    dirs = []
    for split in ("with_reverb", "no_reverb"):
        base = root / split
        (base / "noisy").mkdir(parents=True)
        (base / "clean").mkdir()
        for i, seconds in enumerate(seconds_list):
            t = np.arange(seconds * sr) / sr
            f0 = rng.uniform(120, 300)
            clean = 0.3 * np.sin(2 * np.pi * f0 * t + 3 * np.sin(2 * np.pi * 0.4 * t))
            clean *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
            mix = clean
            if split == "with_reverb":
                n = int(0.2 * sr)
                rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * sr))
                rir[0] = 1.0
                mix = np.convolve(clean, rir / np.sqrt(np.sum(rir**2)))[: clean.size]
            noise = rng.standard_normal(clean.size)
            noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** 0.5)
            noisy = mix + noise
            noisy *= 0.9 / max(1.0, float(np.max(np.abs(noisy))))
            write_wav(base / "noisy" / f"clnsp{i}_snr5_tl-25_fileid_{i}.wav",
                      noisy.astype(np.float32), sr)
            write_wav(base / "clean" / f"clean_fileid_{i}.wav", clean.astype(np.float32), sr)
        dirs.append(base)
    return dirs




# the section of the train recipe each key that the smoke changes lives in
_TRAIN_KEYS = {
    "use_amp": "meta",
    "batch_size": "train_dataset.dataloader",
    "num_workers": "train_dataset.dataloader",
    "epochs": "trainer.train",
    "save_checkpoint_interval": "trainer.train",
    "grad_accum_steps": "trainer.train",
    "device_synthesis": "train_dataset.args",
    "device_synthesis_transfer": "train_dataset.args",
}
# keys the recipes leave at their defaults: written into their section
_TRAIN_NEW_KEYS = ("grad_accum_steps", "device_synthesis", "device_synthesis_transfer")


def _train_config(work: Path, lists: dict, name: str, cell: str = "LSTM",
                  recipe: Path = TRAIN_RECIPE, **changes) -> Path:
    """The train TOML ``recipe`` (the flagship's by default) with the dataset
    lists and the validation set's ``dataset_dir_list`` pointed at
    ``lists`` (a ``[validation_dataset]`` at the recipe's rate added where
    it has none), ``sequence_model = cell``, and ``changes`` (key = value)
    made in their sections; everything else as the recipe has it."""
    toml = _set_cell(recipe.read_text(), cell)
    if "[validation_dataset]" not in toml:  # the Improved FullSubNet recipes ship none
        sr = re.search(r"(?m)^sr = (\d+)", toml).group(1)
        toml += ('\n[validation_dataset]\npath = "dataset_validation.Dataset"\n'
                 f"[validation_dataset.args]\ndataset_dir_list = []\nsr = {sr}\n")
    for kind in ("clean", "noise", "rir"):
        toml, n_sub = re.subn(rf"(?m)^{kind}_dataset = .*$",
                              f"{kind}_dataset = {json.dumps(str(lists[kind]))}", toml)
        check(n_sub == 1, f"train recipe has no {kind}_dataset line")
    toml, n_sub = re.subn(r"(?ms)^dataset_dir_list = \[.*?\]",
                          f"dataset_dir_list = {json.dumps([str(d) for d in lists['val']])}", toml)
    check(n_sub == 1, "train recipe has no single dataset_dir_list (its validation set)")
    for key, value in changes.items():
        header = f"[{_TRAIN_KEYS[key]}]\n"
        start = toml.index(header) + len(header)
        end = toml.find("\n[", start)
        end = len(toml) if end < 0 else end
        section, n_sub = re.subn(rf"(?m)^{key} = [^#\n]*", f"{key} = {value} ", toml[start:end])
        if n_sub == 0 and key in _TRAIN_NEW_KEYS:
            section, n_sub = f"{key} = {value}\n" + section, 1
        check(n_sub == 1, f"train recipe has no single {key} line in [{_TRAIN_KEYS[key]}]")
        toml = toml[:start] + section + toml[end:]
    cfg = work / f"{name}.toml"
    cfg.write_text(toml)
    return cfg


def _training_kernels(cell: str) -> tuple[dict, dict]:
    """(the bf16 train step's kernel wrappers by name: the tensor-core GEMM,
    the cell's backward walk, its training walk and the dW stage; every
    other wrapper by name, the fp32 stages' walks and the earlier fp32
    kernels K2, K2-GRU, K3 and K4 among them)."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    every = {"K1": ops.lstm_scan, "K1-GRU": ops.gru_scan, "fwd_gemm": ops.fwd_gemm,
             "lstm_fwd_walk": ops.lstm_fwd_walk, "gru_fwd_walk": ops.gru_fwd_walk,
             "K2": ops.stash_fwd,
             "K2-GRU": ops.gru_stash_fwd, "K3": ops.layer_bwd, "K4": ops.gru_layer_bwd,
             "tc_gemm": ops.tc_gemm, "lstm_walk": ops.lstm_walk, "gru_walk": ops.gru_walk,
             "lstm_train_walk": ops.lstm_train_walk, "gru_train_walk": ops.gru_train_walk,
             "lstm_walk_f32": ops.lstm_walk_f32, "gru_walk_f32": ops.gru_walk_f32,
             "lstm_train_walk_f32": ops.lstm_train_walk_f32,
             "gru_train_walk_f32": ops.gru_train_walk_f32, "dw_tma": ops.dw_tma,
             "dw_gemm": ops.dw_gemm}
    own = (("tc_gemm", "lstm_walk", "lstm_train_walk", "dw_tma") if cell == "LSTM"
           else ("tc_gemm", "gru_walk", "gru_train_walk", "dw_tma"))
    return {k: every[k] for k in own}, {k: v for k, v in every.items() if k not in own}


def _f32_fwd_gemm_shapes(cell: str) -> set:
    """The shape keys (K, Ncols) of the fp32 training forward's fwd_gemm
    launches in a flagship step: per stage each layer's input projection
    (F_in or H, G·H) and the head (H, OUT); the layer backward's (F_in + H,
    4H) and (G·H, F_in) are other keys."""
    keys = set()
    for f_in, hidden, out_dim in ((257, 512, 257), (32, 384, 2)):
        gh = GATES[cell.lower()] * hidden
        keys |= {(f_in, gh), (hidden, gh), (hidden, out_dim)}
    return keys


def _tc_launches_by_shape(cell: str, steps: int, batch: int = 32) -> tuple[dict, dict, dict]:
    """What one bf16 flagship step (or microbatch) of ``batch`` rows
    launches of the tensor-core GEMM, by shape key (K0, K1, Ncols), times
    ``steps``: the training forward's (per layer an input projection (F_in,
    0, G·H); the head (H, 0, OUT rounded up to 8)), the layer backward's
    (per layer a pre-activation GEMM (F_in, H, 4H) and a dx GEMM (G·H, 0,
    F_in)); and of either walk, by (N, H): two a stage (one a layer), N =
    B at the full band and B·128 at the sub band (drop_band's 2 groups).
    The full-band stage's 257 bins run padded to 264 features, the GEMM's
    16-byte width (``ops.pad_input``)."""
    fwd, bwd, walk = {}, {}, {}
    for f_in, hidden, out_dim, n in ((264, 512, 257, batch), (32, 384, 2, batch * 128)):
        gh = GATES[cell.lower()] * hidden
        for f in (f_in, hidden):
            fwd[(f, 0, gh)] = steps
            bwd[(f, hidden, 4 * hidden)] = steps
            bwd[(gh, 0, f)] = steps
        fwd[(hidden, 0, -(-out_dim // 8) * 8)] = steps
        walk[(n, hidden)] = 2 * steps
    return fwd, bwd, walk


def _dw_launches_by_shape(cell: str, steps: int) -> dict:
    """What ``steps`` flagship bf16 steps launch of the dW stage, by shape key
    (F, H, Ncols): per stage and layer one (F_in or H, H, 4H) for the LSTM, a
    (F_in or H, 0, 3H) and a (0, H, 3H) for the GRU; the full-band F_in 257
    padded to 264 as in ``_tc_launches_by_shape``."""
    want = {}
    for f_in, hidden in ((264, 512), (32, 384)):
        for f in (f_in, hidden):
            if cell == "LSTM":
                want[(f, hidden, 4 * hidden)] = steps
            else:
                want[(f, 0, 3 * hidden)] = steps
                want[(0, hidden, 3 * hidden)] = want.get((0, hidden, 3 * hidden), 0) + steps
    return want


def dw_per_step(cell: str) -> int:
    """dW launches in one flagship step: one per layer and stage (LSTM), two
    (GRU)."""
    return 4 if cell.upper() == "LSTM" else 8


@contextlib.contextmanager
def _watch_validation():
    """Within the block, one record for each validation epoch a Trainer
    runs: its epoch, the launches each kernel wrapper made in it (by
    wrapper: (launches, Counter by shape)), its utterances' enhanced
    waveforms and losses, its scalars and score, its wall time with the
    forward (``_enhance_utterance``, which ends in a copy to the host) and
    the host metrics (``metrics_visualization``) apart, and every
    wrapper's counts at its end (``counts_after``). Yields the list of
    records."""
    from fullsubnet_tpu_torch.train.trainer import Trainer

    records = []
    saved = {name: getattr(Trainer, name)
             for name in ("_validation_epoch", "_enhance_utterance", "metrics_visualization")}

    def validation_epoch(self, epoch):
        record = {"epoch": epoch, "forward_s": 0.0, "metrics_s": 0.0, "enhanced": [],
                  "losses": []}
        records.append(record)
        before = _launch_counts()
        t0 = time.perf_counter()
        score = saved["_validation_epoch"](self, epoch)
        record["wall_s"] = time.perf_counter() - t0
        after = _launch_counts()
        record["launches"] = {w: (after[w][0] - before[w][0], after[w][1] - before[w][1])
                              for w in after if after[w][0] > before[w][0]}
        record["counts_after"] = after
        record["scalars"] = dict(self.scalars[epoch])
        record["score"] = score
        return score

    def enhance_utterance(self, noisy, clean):
        t0 = time.perf_counter()
        enhanced, loss = saved["_enhance_utterance"](self, noisy, clean)
        records[-1]["forward_s"] += time.perf_counter() - t0
        records[-1]["enhanced"].append(enhanced)
        records[-1]["losses"].append(loss)
        return enhanced, loss

    def metrics_visualization(self, rows, epoch, all_types=None):
        t0 = time.perf_counter()
        score = saved["metrics_visualization"](self, rows, epoch, all_types)
        records[-1]["metrics_s"] += time.perf_counter() - t0
        return score

    Trainer._validation_epoch = validation_epoch
    Trainer._enhance_utterance = enhance_utterance
    Trainer.metrics_visualization = metrics_visualization
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(Trainer, name, fn)


def _check_validation(record: dict, cell: str, where: str) -> None:
    """A validation epoch on the card: K1's stages alone, per utterance a
    GEMM for each layer's input projection and the head and a walk per
    layer in both stages; every ``Validation/*`` scalar finite, STOI in
    [0, 1], PESQ in [-0.5, 4.5]; prints its wall split."""
    import math

    wrappers = _wrappers()
    names = {w: k for k, w in wrappers.items()}
    launched = {names[w]: (n, dict(by_shape)) for w, (n, by_shape) in record["launches"].items()}
    walk_name = "lstm_fwd_walk" if cell == "LSTM" else "gru_fwd_walk"
    utterances = len(record["enhanced"])
    want_gemm, want_walk = _k1_launches(cell, [(1, _frames(e.size), 1)
                                               for e in record["enhanced"]])
    scalars = record["scalars"]
    seconds = collections.Counter(round(e.size / 16000, 2) for e in record["enhanced"])
    print(f"validation epoch {record['epoch']} ({where}, {cell}): {utterances} utterances "
          f"(seconds: count {dict(seconds)}), wall "
          f"{record['wall_s']:.2f} s = forward {record['forward_s']:.2f} s + host metrics "
          f"{record['metrics_s']:.2f} s + the rest; score {record['score']:.6f}; launches "
          f"{launched}")
    check(set(launched) == {"fwd_gemm", walk_name},
          f"validation ({where}) launched {sorted(launched)}, not K1's stages alone")
    check(launched["fwd_gemm"][1] == want_gemm,
          f"validation fwd_gemm launches by shape {launched['fwd_gemm'][1]}, want {want_gemm}")
    check(launched[walk_name][1] == want_walk,
          f"validation {walk_name} launches by shape {launched[walk_name][1]}, want {want_walk}")
    check(len([t for t in scalars if t.startswith("Validation/")]) == 15,
          f"validation scalars {sorted(scalars)}")
    for tag, value in scalars.items():
        check(math.isfinite(value), f"{tag} = {value} is not finite")
        if "STOI" in tag:
            check(0.0 <= value <= 1.0, f"{tag} = {value} outside [0, 1]")
        if "PESQ" in tag:
            check(-0.5 <= value <= 4.5, f"{tag} = {value} outside [-0.5, 4.5]")


def _check_step_launches(counts: dict, cell: str, steps: int, where: str,
                         batch: int = 32) -> None:
    """``counts`` (by kernel name: (launches, by shape)) are those of
    ``steps`` bf16 flagship steps (or microbatches) of ``batch`` rows: the
    tensor-core GEMM, the cell's two walks and the dW stage by shape, no
    other kernel of the port's."""
    own, others = _training_kernels(cell)
    _, walk_name, train_walk_name, _ = own
    # the fp32-storage training kernels (K2, K2-GRU, K3, K4) serve fp32
    # only: the bf16 step launches none of them
    for other in others:
        check(counts[other][0] == 0, f"{other} launched {counts[other][0]} times in {where}")
    want_fwd, want_bwd, want_walk = _tc_launches_by_shape(cell, steps, batch)
    check(counts["tc_gemm"][1] == {**want_fwd, **want_bwd},
          f"tc_gemm launches by shape in {where}: {counts['tc_gemm'][1]}")
    for walk in (walk_name, train_walk_name):
        check(counts[walk][1] == want_walk, f"{walk} launches by shape in {where}: "
              f"{counts[walk][1]}")
    check(counts["dw_tma"][1] == _dw_launches_by_shape(cell, steps),
          f"dw_tma launches by shape in {where}: {counts['dw_tma'][1]}")


def phase_train_end_to_end(work: Path, card: str, cell: str = "LSTM", lists=None) -> dict:
    """The flagship train step through the port's train CLI: the LSTM
    for 3 epochs, the GRU for 1, then ``-R`` for one more epoch, and the
    infer CLI on the last weights of the first run. The recipe validates
    every 2 epochs (the LSTM's epochs 2 and 4, the GRU's 2): those
    epochs' launches are counted apart from the training steps' and
    checked as ``_check_validation`` says. The LSTM's epoch 3 trains in
    the Trainer that has just validated: its steps' launches, read from
    the end of the validation epoch, are held to two steps' by shape, and
    its loss is finite."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli as infer_cli
    from fullsubnet_tpu_torch.train import cli as train_cli

    if lists is None:
        lists = _write_train_data(work / "train_data")
    epochs = 3 if cell == "LSTM" else 1
    name = f"flagship_train_{cell}"
    cfg = _train_config(work, lists, name, cell, epochs=epochs, save_checkpoint_interval=1)
    out = work / "runs"
    own, others = _training_kernels(cell)
    for kernel in _wrappers().values():
        kernel.reset_counts()
    t0 = time.perf_counter()
    with _watch_validation() as validations:
        trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the training steps' launches: the run's less its validation epochs'
    counts = {}
    for k, kernel in (*own.items(), *others.items()):
        n, by_shape = kernel.launches, collections.Counter(kernel.launches_by_shape)
        for record in validations:
            vn, vshape = record["launches"].get(kernel, (0, collections.Counter()))
            n, by_shape = n - vn, by_shape - vshape
        counts[k] = (n, dict(by_shape))
    steps = trainer.steps
    print(f"train CLI, flagship recipe with {cell} (B=32 x 3.072 s, bf16, clip 10), {epochs} "
          f"epoch(s) over 64 clips: {steps} steps in {wall:.2f} s wall incl. set-up and data; "
          f"losses by epoch {trainer.epoch_losses}; launches {counts} [{card}]")
    check(steps == 2 * epochs, f"{steps} steps, not {epochs} epoch(s) x 2 batches")
    check([r["epoch"] for r in validations] == [e for e in range(1, epochs + 1) if e % 2 == 0],
          f"validation ran at epochs {[r['epoch'] for r in validations]}")
    check(all(np.isfinite(v) for v in trainer.epoch_losses.values()), "a training loss is not finite")
    _check_step_launches(counts, cell, steps, f"{cell} training")
    if validations and validations[-1]["epoch"] < epochs:
        # the epochs after the last validation, in the Trainer that ran it
        after = validations[-1]["counts_after"]
        later = {k: (kernel.launches - after[kernel][0],
                     dict(collections.Counter(kernel.launches_by_shape) - after[kernel][1]))
                 for k, kernel in (*own.items(), *others.items())}
        later_epochs = range(validations[-1]["epoch"] + 1, epochs + 1)
        _check_step_launches(later, cell, 2 * len(later_epochs),
                             f"{cell} epochs {list(later_epochs)} after validating")
        print(f"train CLI ({cell}): epochs {list(later_epochs)} after validation epoch "
              f"{validations[-1]['epoch']} in the same Trainer: {2 * len(later_epochs)} steps, "
              f"losses {[trainer.epoch_losses[e] for e in later_epochs]}, launches {later}")
    ckpt = out / name / "checkpoints"
    for file in ("latest_model.tar", *(f"model_{e:04d}.pth" for e in range(1, epochs + 1))):
        check((ckpt / file).is_file(), f"no {file} after {epochs} epoch(s)")

    # -R with one more epoch resumes there
    cfg_resume = _train_config(work, lists, name, cell, epochs=epochs + 1,
                               save_checkpoint_interval=1)
    with _watch_validation() as resumed_validations:
        resumed = train_cli.main(["-C", str(cfg_resume), "-O", str(out), "--device", "cuda",
                                  "-R"])
    print(f"train CLI -R ({cell}): epochs run {sorted(resumed.epoch_losses)}, {resumed.steps} "
          f"steps, losses {resumed.epoch_losses}")
    validations += resumed_validations
    want_epochs = [e for e in range(1, epochs + 2) if e % 2 == 0]
    check([r["epoch"] for r in validations] == want_epochs,
          f"the runs validated at epochs {[r['epoch'] for r in validations]}, not {want_epochs}")
    for record in validations:
        _check_validation(record, cell, "train CLI")
    check((ckpt / "best_model.tar").is_file(), "no best_model.tar after the validation epoch")
    check(sorted(resumed.epoch_losses) == [epochs + 1] and resumed.steps == 2,
          f"-R did not resume at epoch {epochs + 1}")
    check((ckpt / f"model_{epochs + 1:04d}.pth").is_file(),
          f"no model_{epochs + 1:04d}.pth after the resumed epoch")
    del trainer, resumed

    # the infer CLI enhances one wav with the last weights of the first run
    noisy_dir = work / f"noisy_train_check_{cell}"
    noisy_dir.mkdir()
    sr = 16000
    clean_y = read_wav(Path(lists["clean"].read_text().split()[0]))[0][: 2 * sr]
    noise_y = read_wav(Path(lists["noise"].read_text().split()[0]))[0][: 2 * sr]
    write_wav(noisy_dir / "mix.wav", (clean_y + noise_y).astype(np.float32), sr)
    weights = ckpt / f"model_{epochs:04d}.pth"
    enhanced_dir = work / f"out_trained_{cell}"
    infer_cli.main(["-C", str(_inference_config(work, noisy_dir, cell)), "-M", str(weights),
                    "-O", str(enhanced_dir), "--device", "cuda"])
    enhanced, got_sr = read_wav(enhanced_dir / "enhanced" / "mix.wav")
    check(got_sr == sr and enhanced.shape == (2 * sr,) and bool(np.isfinite(enhanced).all()),
          f"the infer CLI on {weights.name} gave no finite 2 s wav")
    print(f"infer CLI on {weights.name} ({cell}): one 2 s wav enhanced, finite, input length")
    torch.cuda.empty_cache()
    launches = {k: v[0] for k, v in counts.items()}
    # the GEMM's launches by the stage it served
    want_fwd, want_bwd, _ = _tc_launches_by_shape(cell, steps)
    launches["tc_gemm_fwd"] = sum(counts["tc_gemm"][1].get(k, 0) for k in want_fwd)
    launches["tc_gemm_bwd"] = sum(counts["tc_gemm"][1].get(k, 0) for k in want_bwd)
    return {"lists": lists, "launches": launches, "steps": steps}


# the validation epoch on the card against the port's plain CPU path, same
# weights and utterances: each enhanced waveform within this share of its
# peak (cuFFT against the CPU FFT and K1's stages against the plain
# stacks, fp32 sums in another order over up to 628 steps, then the cIRM
# decompression, whose slope reaches 100 at its 9.9 clamp); each loss
# within this share of itself; every metric mean and the score within
# this of each other (PESQ picks discrete delays in its alignment, so a
# small change in a waveform can move a score by more than the change)
VAL_WAVE_RTOL = 1e-3
VAL_LOSS_RTOL = 1e-4
VAL_SCALAR_ATOL = 1e-2


def phase_validation(work: Path, lists: dict, card: str, cell: str = "LSTM") -> dict:
    """One validation epoch of the train CLI's epoch-2 weights at full
    width (``-P model_0002.pth -V``, the recipe's validation settings) on
    the card, then on the CPU: the card's epoch as ``_check_validation``
    says, ``best_model.tar`` written, no step, no launch outside the
    epoch; the CPU run launches nothing; the card's enhanced waveforms,
    losses and scalars against the CPU's. Returns the card's launches."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.train import cli as train_cli

    weights = work / "runs" / f"flagship_train_{cell}" / "checkpoints" / "model_0002.pth"
    cfg = _train_config(work, lists, f"validate_{cell}", cell)
    runs = {}
    for device in ("cuda", "cpu"):
        for kernel in _wrappers().values():
            kernel.reset_counts()
        out = work / f"validate_{device}"
        with _watch_validation() as records:
            trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", device,
                                      "-P", str(weights), "-V"])
        total = {w: w.launches for w in _wrappers().values() if w.launches}
        check(trainer.steps == 0 and [r["epoch"] for r in records] == [1],
              f"-V on the {device}: {trainer.steps} steps, validation epochs "
              f"{[r['epoch'] for r in records]}")
        check((out / f"validate_{cell}" / "checkpoints" / "best_model.tar").is_file(),
              f"-V on the {device} wrote no best_model.tar")
        runs[device] = records[0]
        if device == "cuda":
            torch.cuda.synchronize()
            _check_validation(records[0], cell, "-V on the card")
            in_epoch = {w: n for w, (n, _) in records[0]["launches"].items()}
            check(total == in_epoch, f"-V launched {len(total)} kernels in all, "
                  f"{len(in_epoch)} in its epoch, or counts differ")
        else:
            print(f"validation epoch 1 (-V on the CPU, {cell}): wall {records[0]['wall_s']:.2f} "
                  f"s = forward {records[0]['forward_s']:.2f} s + host metrics "
                  f"{records[0]['metrics_s']:.2f} s + the rest")
            check(not total, f"-V on the CPU launched {len(total)} kernels")
        del trainer
    gpu, cpu = runs["cuda"], runs["cpu"]
    wave_err = max(float(np.max(np.abs(g - c)) / max(float(np.max(np.abs(c))), 1e-30))
                   for g, c in zip(gpu["enhanced"], cpu["enhanced"]))
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu["losses"], cpu["losses"]))
    check(sorted(gpu["scalars"]) == sorted(cpu["scalars"]), "card and CPU scalars differ in tags")
    scalar_err = {t: abs(gpu["scalars"][t] - cpu["scalars"][t]) for t in gpu["scalars"]}
    worst = max(scalar_err, key=scalar_err.get)
    print(f"validation ({cell}) card vs plain CPU: enhanced max|diff| / peak {wave_err:.3e} (tol "
          f"{VAL_WAVE_RTOL:g}), loss rel {loss_err:.3e} (tol {VAL_LOSS_RTOL:g}), scalars worst "
          f"{worst} {scalar_err[worst]:.3e} (tol {VAL_SCALAR_ATOL:g}); card scalars "
          f"{ {t: round(v, 6) for t, v in sorted(gpu['scalars'].items())} } [{card}]")
    check(wave_err <= VAL_WAVE_RTOL, f"validation waveform card vs CPU {wave_err:.3e}")
    check(loss_err <= VAL_LOSS_RTOL, f"validation loss card vs CPU {loss_err:.3e}")
    check(scalar_err[worst] <= VAL_SCALAR_ATOL,
          f"validation {worst} card vs CPU {scalar_err[worst]:.3e}")
    torch.cuda.empty_cache()
    names = {w: k for k, w in _wrappers().items()}
    return {names[w]: n for w, (n, _) in gpu["launches"].items()}


# the DNS synthetic test set that the flagship recipe validates on: 150
# clips of 10 s in each of with_reverb and no_reverb
DNS_VAL_CLIPS = 150


def phase_validation_at_size(work: Path, lists: dict, card: str, cell: str) -> dict:
    """One validation epoch (``-V``) at the DNS synthetic test set's size
    (``DNS_VAL_CLIPS`` clips of 10 s a split, made from the seed as
    ``_write_validation_dirs`` makes them) with the recipe's settings (the
    metric pool of its 16 spawned workers), full-width weights from the
    seed, on the card: the checks of ``_check_validation``; the epoch's
    wall split into the forward (its wall, the copy to the host
    included), the host metrics and the rest (reading the wavs); and one
    clip's metrics timed serially in this process (median of 3), the
    host's own rate."""
    import torch

    from fullsubnet_tpu_torch.metrics import pesq_available, validation_metrics
    from fullsubnet_tpu_torch.train import cli as train_cli

    cfg = _train_config(work, lists, f"validate_at_size_{cell}", cell)
    ckpt = work / f"validate_at_size_{cell}.tar"
    _write_flagship_checkpoint(ckpt, cfg)
    for kernel in _wrappers().values():
        kernel.reset_counts()
    with _watch_validation() as records:
        trainer = train_cli.main(["-C", str(cfg), "-O", str(work / "validate_at_size"),
                                  "--device", "cuda", "-P", str(ckpt), "-V"])
    torch.cuda.synchronize()
    check(trainer.steps == 0 and [r["epoch"] for r in records] == [1],
          f"-V at size: {trainer.steps} steps, epochs {[r['epoch'] for r in records]}")
    record = records[0]
    check(len(record["enhanced"]) == 2 * DNS_VAL_CLIPS,
          f"-V at size enhanced {len(record['enhanced'])} clips")
    _check_validation(record, cell, f"-V at 2 x {DNS_VAL_CLIPS} clips of 10 s")
    wall, forward, metrics = record["wall_s"], record["forward_s"], record["metrics_s"]
    workers = int(trainer.vis_cfg.get("num_workers", 10))
    cores = len(os.sched_getaffinity(0))
    noisy, clean, _, _ = trainer.valid_dataset[0]
    serial = []
    for _ in range(3):
        t0 = time.perf_counter()
        validation_metrics(noisy, clean, record["enhanced"][0], 16000, pesq_available())
        serial.append(time.perf_counter() - t0)
    clip_s = sorted(serial)[1]
    print(f"validation epoch at size ({cell}): {2 * DNS_VAL_CLIPS} clips of 10 s, "
          f"{workers} spawned metric workers on {cores} host cores: wall {wall:.3f} s = "
          f"forward {forward:.3f} s ({forward / wall:.4f} of the wall; "
          f"{1e3 * forward / (2 * DNS_VAL_CLIPS):.2f} ms a clip) + host metrics {metrics:.3f} s "
          f"({metrics / wall:.4f}) + the rest {wall - forward - metrics:.3f} s; score "
          f"{record['score']:.6f}; one clip's metrics serially here {clip_s:.3f} s (median of "
          f"{[round(t, 3) for t in serial]}), {2 * DNS_VAL_CLIPS} of them over {cores} cores "
          f"{2 * DNS_VAL_CLIPS * clip_s / cores:.3f} s [{card}]")
    del trainer
    torch.cuda.empty_cache()
    return {"cell": cell, "clips": 2 * DNS_VAL_CLIPS, "workers": workers, "host_cores": cores,
            "wall_s": wall, "forward_s": forward, "metrics_s": metrics, "clip_metrics_s": clip_s}


def _first_batch(trainer, size: int):
    import numpy as np
    import torch

    ds = trainer.train_dataset
    ds.set_epoch(1)
    items = [ds[i % len(ds)] for i in range(size)]  # past the clips, they come round again
    return tuple(torch.from_numpy(np.stack([it[k] for it in items])) for k in (0, 1))


def phase_card_vs_cpu_step(work: Path, lists: dict, card: str, cell: str = "LSTM") -> dict:
    """One fp32 step at B=4 x 3.072 s, full width: loss and gradients on the
    card against the port's plain CPU path, same weights and batch. fp32
    storage takes the fp32 training forward's stages (fwd_gemm 6: a layer's
    input projection each and the head, in both stages; the cell's fp32
    training walk 4: the full-band stage's N = 4 in the cluster form, the
    sub-band stage's N = 512 streaming) and the fp32 layer backward's
    stages (fwd_gemm 8, the cell's fp32 walk 4), and no tensor-core stage,
    no inference walk, no other cell's walk and no launch of the earlier
    fp32 kernels (K2 or K2-GRU, K3 or K4); returns the launches by kernel
    ("fwd", "bwd" the earlier kernels, "fwd_gemm" split by stage,
    "train_walk" split by form, "walk")."""
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.ops import subband_lstm as ops
    from fullsubnet_tpu_torch.train.trainer import Trainer

    cfg = load_config(_train_config(work, lists, f"step_b4_fp32_{cell}", cell, use_amp="false",
                                    batch_size=4, num_workers=0))
    lstm = cell == "LSTM"
    fp32_fwd, fp32_bwd = ((ops.stash_fwd, ops.layer_bwd) if lstm
                          else (ops.gru_stash_fwd, ops.gru_layer_bwd))
    walk, other_walk = ((ops.lstm_walk_f32, ops.gru_walk_f32) if lstm
                        else (ops.gru_walk_f32, ops.lstm_walk_f32))
    train_walk, other_train_walk = ((ops.lstm_train_walk_f32, ops.gru_train_walk_f32) if lstm
                                    else (ops.gru_train_walk_f32, ops.lstm_train_walk_f32))
    unused = {"tc_gemm": ops.tc_gemm, "lstm_walk": ops.lstm_walk, "gru_walk": ops.gru_walk,
              "lstm_train_walk": ops.lstm_train_walk, "gru_train_walk": ops.gru_train_walk,
              "other fp32 walk": other_walk, "other fp32 training walk": other_train_walk,
              "lstm_fwd_walk": ops.lstm_fwd_walk, "gru_fwd_walk": ops.gru_fwd_walk,
              "stash_fwd": ops.stash_fwd, "gru_stash_fwd": ops.gru_stash_fwd,
              "layer_bwd": ops.layer_bwd, "gru_layer_bwd": ops.gru_layer_bwd}
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, output_dir=str(work / f"step_{cell}_{device}"), device=device)
        noisy, clean = _first_batch(trainer, 4)
        for kernel in (ops.fwd_gemm, walk, train_walk, ops.dw_tma, ops.dw_gemm,
                       *unused.values()):
            kernel.reset_counts()
        loss = trainer.compute_loss(noisy.to(device), clean.to(device))
        loss.backward()
        losses[device] = float(loss.detach())
        grads[device] = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
        if device == "cuda":
            fwd_keys = _f32_fwd_gemm_shapes(cell)
            by_shape = ops.fwd_gemm.launches_by_shape
            launches = {"fwd": fp32_fwd.launches, "bwd": fp32_bwd.launches,
                        "fwd_gemm": ops.fwd_gemm.launches,
                        "fwd_gemm_fwd": sum(v for k, v in by_shape.items() if k in fwd_keys),
                        "fwd_gemm_bwd": sum(v for k, v in by_shape.items() if k not in fwd_keys),
                        "train_walk": train_walk.launches,
                        "train_walk_cluster": train_walk.launches_by_form["cluster"],
                        "train_walk_streaming": train_walk.launches_by_form["streaming"],
                        "walk": walk.launches, "dw_tma": ops.dw_tma.launches,
                        "dw_gemm": ops.dw_gemm.launches}
            stray = {k: v.launches for k, v in unused.items() if v.launches}
            want = {"fwd": 0, "bwd": 0, "fwd_gemm": 14, "fwd_gemm_fwd": 6, "fwd_gemm_bwd": 8,
                    "train_walk": 4, "train_walk_cluster": 2, "train_walk_streaming": 2,
                    "walk": 4, "dw_tma": dw_per_step(cell), "dw_gemm": 0}
            check(launches == want and not stray,
                  f"fp32 {cell} step: launches {launches}, others {stray} (want {want}, nothing "
                  "else)")
        del trainer
    rel = {k: float((grads["cuda"][k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for k, w in grads["cpu"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"one fp32 {cell} step B=4 x 3.072 s, card vs plain CPU: loss {losses['cuda']:.8e} vs "
          f"{losses['cpu']:.8e} (rel {loss_rel:.2e}, tol {STEP_LOSS_RTOL:g}); gradient error / "
          f"max, worst {rel[worst]:.2e} at {worst} (tol {STEP_GRAD_RTOL:g}); launches of the "
          f"earlier fp32 training forward and layer backward, fwd_gemm, the fp32 training walk, "
          f"the fp32 backward walk and the dW stage {launches} [{card}]")
    check(loss_rel <= STEP_LOSS_RTOL, f"step loss card vs CPU {loss_rel:.2e}")
    check(rel[worst] <= STEP_GRAD_RTOL, f"step gradient {worst} card vs CPU {rel[worst]:.2e}")
    return launches


def phase_train_step_numbers(work: Path, lists: dict, card: str, cell: str = "LSTM") -> float:
    """audio-s/s of the flagship train step, its peak memory, and where one
    step's device time goes; returns the step's median seconds."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    # what earlier phases left in reference cycles would count in the peak
    gc.collect()
    torch.cuda.empty_cache()
    name = f"step_numbers_{cell}"
    trainer = Trainer(load_config(_train_config(work, lists, name, cell, num_workers=0)),
                      output_dir=str(work / name), device="cuda")
    noisy, clean = (v.cuda() for v in _first_batch(trainer, 32))
    audio_s = noisy.shape[0] * noisy.shape[1] / 16000

    def step():
        trainer.train_step(noisy, clean)
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30
    own, others = _training_kernels(cell)
    for kernel in (*own.values(), *others.values()):
        kernel.reset_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    median = sorted(times)[len(times) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    per_step = {k: kernel.launches / len(times) for k, kernel in own.items()}
    print(f"{cell} train step B=32 x 3.072 s (bf16, the batch on the card): median "
          f"{median * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
          f"{audio_s / median:.2f} audio-s/s, peak memory {peak_gb:.2f} GiB ({held_gb:.2f} GiB "
          f"held between steps); launches a step {per_step} [{card}]")
    check(all(kernel.launches == 0 for kernel in others.values()),
          f"the {cell} step launched {[k for k, v in others.items() if v.launches]}")
    check(per_step == dict(zip(own, (14, 4, 4, dw_per_step(cell)))),
          f"{cell} step launches {per_step}")
    check(peak_gb < 24, f"{cell} step peak memory {peak_gb:.2f} GiB is not under 24 GiB")
    label = f"one {cell} train step B=32 x 3.072 s"
    _check_library_gemms(_profile(step, label, card), label)
    del trainer
    torch.cuda.empty_cache()
    return median


def phase_fp32_step_numbers(work: Path, lists: dict, card: str, cell: str = "LSTM") -> dict:
    """The flagship train step at fp32 storage (``use_amp = false``), B=32 x
    3.072 s, the batch on the card: median of 5 steps after 2 warm-ups,
    audio-s/s, peak memory, launches a step by kernel, and the profile's top
    kernels. Where the port has the fp32 training forward's stages, the same
    step follows with the training forward of the earlier design (the fp32
    kernels stash_fwd / gru_stash_fwd, as the dispatch ran them before the
    stages), so that both figures come from one card in one run."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.ops import subband_lstm as ops
    from fullsubnet_tpu_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    name = f"step_numbers_fp32_{cell}"
    trainer = Trainer(load_config(_train_config(work, lists, name, cell, use_amp="false",
                                                num_workers=0)),
                      output_dir=str(work / name), device="cuda")
    noisy, clean = (v.cuda() for v in _first_batch(trainer, 32))
    audio_s = noisy.shape[0] * noisy.shape[1] / 16000
    wrappers = {k: v for k, v in vars(ops).items() if isinstance(v, ops._Counts)}

    def step():
        trainer.train_step(noisy, clean)
        torch.cuda.synchronize()

    def measure(label):
        for _ in range(2):
            step()
        torch.cuda.reset_peak_memory_stats()
        for kernel in wrappers.values():
            kernel.reset_counts()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        median = sorted(times)[len(times) // 2]
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        per_step = {k: v.launches / len(times) for k, v in wrappers.items() if v.launches}
        print(f"{cell} train step B=32 x 3.072 s, fp32 storage, {label}: median "
              f"{median * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
              f"{audio_s / median:.2f} audio-s/s, peak memory {peak_gb:.2f} GiB; launches a step "
              f"{per_step} [{card}]")
        return {"ms": median * 1e3, "audio_s_per_s": audio_s / median, "peak_gb": peak_gb,
                "launches": per_step}

    staged = hasattr(ops, "lstm_train_walk_f32")
    result = measure("the main path" if staged else "the main path (the earlier fp32 forward)")
    label = f"one fp32 {cell} train step B=32 x 3.072 s"
    _check_library_gemms(_profile(step, label, card), label)
    if staged:
        lstm = cell == "LSTM"
        walk, train_walk, earlier = (("lstm_walk_f32", "lstm_train_walk_f32", "stash_fwd") if lstm
                                     else ("gru_walk_f32", "gru_train_walk_f32", "gru_stash_fwd"))
        want = {"fwd_gemm": 14, train_walk: 4, walk: 4, "dw_tma": dw_per_step(cell)}
        check({k: result["launches"].get(k) for k in want} == want
              and not {"stash_fwd", "gru_stash_fwd", "layer_bwd", "gru_layer_bwd", "dw_gemm"}
              & set(result["launches"]), f"the fp32 {cell} step's launches {result['launches']}")
        # the dispatch of the earlier design: the fp32 training forward kernel
        saved = ops.stash_forward

        def earlier_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
            if c0s is None:
                return ops.gru_stash_fwd(x, ws, bs, wfc, bfc, h0s)
            return ops.stash_fwd(x, ws, bs, wfc, bfc, h0s, c0s)

        try:
            ops.stash_forward = earlier_stash_forward
            result["earlier"] = measure("with the earlier fp32 training forward (stash_fwd / "
                                        "gru_stash_fwd)")
        finally:
            ops.stash_forward = saved
        check(result["earlier"]["launches"].get(earlier) == 2
              and train_walk not in result["earlier"]["launches"],
              f"the earlier fp32 training forward did not run in the {cell} comparison")
    del trainer
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phases 17-20: the full-band baseline, the sub-band baseline, Fast
# FullSubNet and Improved FullSubNet, at their recipes' widths
# ---------------------------------------------------------------------------

FAMILY_DIR = REPO / "recipes" / "dns_interspeech_2020"
# each family's recipes (an inference TOML where the repo ships one) and the
# batch of its recipe's bf16 train step
FAMILIES = {
    "fullband_baseline": {"phase": 17, "infer": "fullband_baseline/inference.toml",
                          "train": "fullband_baseline/train.toml", "step_batch": 100},
    "subband_baseline": {"phase": 18, "infer": None, "train": "subband_baseline/train.toml",
                         "step_batch": 32},
    "fast_fullsubnet": {"phase": 19, "infer": "fast_fullsubnet/inference.toml",
                        "train": "fast_fullsubnet/train_shrinkSize2.toml", "step_batch": 72},
    "improved_fullsubnet_16k": {"phase": 20, "infer": None, "sr": 16000, "step_batch": 16,
                                "compare_batch": 16, "train": "improved_fullsubnet/train_16k.toml"},
    "improved_fullsubnet_48k": {"phase": 20, "infer": None, "sr": 48000, "step_batch": 16,
                                "compare_batch": 8, "train": "improved_fullsubnet/train_48k.toml"},
}
# the batch of the card-vs-CPU step (``compare_batch``, else 4): Improved
# FullSubNet's at 16 kHz is the recipe's, as its sections' walks take their
# streaming forms only at the recipe step's rows (N = 240-400); at 48 kHz
# half of it (N = 32-200), the streaming forms held by the 16 kHz step
# the families whose stacks compute at fp32 under ``use_amp``: Fast's mel
# projection promotes to the fp32 filterbank, Improved FullSubNet's stacks
# read the fp32 STFT of the waveform it takes, as in the JAX package
FP32_STACKS = ("fast_fullsubnet", "improved_fullsubnet_16k", "improved_fullsubnet_48k")
# Improved FullSubNet's layout at each rate, from its recipes: n_fft, hop,
# the full-band stack's F (the last bin dropped), and per section (unit
# width (c + 30)·2, head 2c, units)
IMPROVED_LAYOUT = {
    16000: {"n_fft": 512, "hop": 128, "bins": 256,
            "sections": [(62, 2, 20), (68, 8, 15), (76, 16, 22)]},
    48000: {"n_fft": 960, "hop": 480, "bins": 480,
            "sections": [(62, 2, 20), (68, 8, 25), (100, 40, 6), (180, 120, 4)]},
}
# the families' train CLI runs: one epoch of this batch over the 64 clips
FAMILY_CLI_BATCH = 32
# the families' forwards and steps, card vs CPU: the compressed cRM of a
# model on the same magnitudes within CRM_ATOL; an fp32 step's loss and
# gradients within STEP_LOSS_RTOL and STEP_GRAD_RTOL (phase 10's)


def _family_stacks(family: str, batch: int, frames: int, training: bool) -> list:
    """Every LSTM stack a forward of ``family`` at its recipe's width runs,
    as (F_in, H, OUT or 0 for a head-less stack, layers, N rows, T steps),
    fixed here from the recipes and the JAX models, not read from the code
    under test. ``frames`` counts the model's look-ahead frames."""
    if family.startswith("improved"):
        lay = IMPROVED_LAYOUT[FAMILIES[family]["sr"]]
        return [(lay["bins"], 512, lay["bins"], 2, batch, frames)] + [
            (width, 384, out_dim, 2, batch * units, frames)
            for width, out_dim, units in lay["sections"]]
    if family == "fullband_baseline":
        return [(257, 512, 514, 3, batch, frames)]
    if family == "subband_baseline":
        # drop_band in training (B > 2 groups): 128 of the 256 bands a sample
        bands = 128 if training and batch > 2 else 257
        return [(31, 320, 2, 2, batch * bands, frames)]
    down = -(-(frames - 1) // 2) + 1  # shrink 2: frame 0, then blocks of 2
    return [(64, 384, 0, 1, batch, frames), (384, 257, 64, 1, batch, frames),
            (12, 384, 1, 2, 64 * batch, down), (128, 512, 0, 1, batch, frames),
            (512, 512, 514, 1, batch, frames)]


def _family_launches(stacks, mode: str, cell: str = "lstm") -> dict:
    """What the LSTM stacks ``stacks`` (a list of ``_family_stacks``'
    tuples, over all calls) launch, by wrapper name and shape key: "infer"
    K1's stages (per layer an input projection GEMM (F, 4H) and a walk
    (N, H), the head's GEMM (H, OUT)), "bf16" the tensor-core training
    stages (tc_gemm: per layer (F, 0, 4H), (F, H, 4H) and (4H, 0, F), the
    head (H, 0, OUT rounded up to 8); per layer a training walk, a backward
    walk and a dW stage (F, H, 4H)), "fp32" the fp32 ones (fwd_gemm: per
    layer (F, 4H), (F + H, 4H) and (4H, F), the head (H, OUT); the fp32
    training walk, the fp32 backward walk, the dW stage). A head-less stack
    has no head GEMM; H is the width the walks run at (257 -> 272), and at
    bf16 F the tensor-core GEMM's width (``ops.pad_input``: 31 -> 32, 257 ->
    264). ``cell`` ("lstm" or "gru", "infer" only) sets the gate rows (4H or
    3H) and the walk."""
    from fullsubnet_tpu_torch.ops.subband_lstm import TC_INPUT_MULTIPLE, padded_hidden

    want = collections.defaultdict(collections.Counter)
    for f_in, hidden, out_dim, layers, n, _ in stacks:
        h = padded_hidden(hidden)
        if mode == "bf16":
            f_in = -(-f_in // TC_INPUT_MULTIPLE) * TC_INPUT_MULTIPLE
        ins = [f_in] + [h] * (layers - 1)
        if mode == "infer":
            for k in ins:
                want["fwd_gemm"][(k, GATES[cell] * h)] += 1
            if out_dim:
                want["fwd_gemm"][(h, out_dim)] += 1
            want[f"{cell}_fwd_walk"][(n, h)] += layers
            continue
        walks = (("lstm_train_walk", "lstm_walk") if mode == "bf16"
                 else ("lstm_train_walk_f32", "lstm_walk_f32"))
        for k in ins:
            if mode == "bf16":
                for key in ((k, 0, 4 * h), (k, h, 4 * h), (4 * h, 0, k)):
                    want["tc_gemm"][key] += 1
            else:
                for key in ((k, 4 * h), (k + h, 4 * h), (4 * h, k)):
                    want["fwd_gemm"][key] += 1
            want["dw_tma"][(k, h, 4 * h)] += 1
        if out_dim:
            gemm = "tc_gemm" if mode == "bf16" else "fwd_gemm"
            want[gemm][(h, 0, -(-out_dim // 8) * 8) if mode == "bf16" else (h, out_dim)] += 1
        for walk in walks:
            want[walk][(n, h)] += layers
    return {k: dict(v) for k, v in want.items()}


def _scaled(counts: dict, times: int) -> dict:
    return {k: {s: v * times for s, v in by.items()} for k, by in counts.items()}


def _merged(*counts: dict) -> dict:
    """The sum of launch counts by wrapper name and shape."""
    out = collections.defaultdict(collections.Counter)
    for by_name in counts:
        for name, by_shape in by_name.items():
            out[name].update(by_shape)
    return {k: dict(v) for k, v in out.items()}


def _family_sr(family: str) -> int:
    return FAMILIES[family].get("sr", 16000)


def _family_frames(family: str, samples: int) -> int:
    """The frames a family's stacks walk for ``samples``: the flagship STFT's
    with 2 look-ahead frames (``_frames``), or Improved FullSubNet's STFT
    at its rate, with none."""
    if not family.startswith("improved"):
        return _frames(samples)
    lay = IMPROVED_LAYOUT[_family_sr(family)]
    return 1 + samples // lay["hop"]


def _recipe(family: str, kind: str) -> Path:
    """The family's recipe of ``kind`` ("infer" or "train")."""
    return FAMILY_DIR / FAMILIES[family][kind]


def _launched() -> dict:
    """The wrappers that launched since their counts were reset: name ->
    launches by shape. The phases hold it equal to what their stacks need:
    no kernel of another cell, of the other storage type or of the earlier
    design, and no stack on another route."""
    return {k: dict(w.launches_by_shape) for k, w in _wrappers().items() if w.launches}


def _write_family_checkpoint(path: Path, cfg: Path) -> None:
    """Recipe-width weights of the model ``cfg`` names from a numpy seed, at
    torch's default scale (each stack's U(±1/sqrt(H))), saved with the
    reference keys; buffers (Fast's mel filterbank) as the model makes
    them."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import build_model, load_config

    model, _ = build_model(load_config(cfg))
    params = dict(model.named_parameters())
    rng = np.random.default_rng(SEED + 8)
    state = {}
    for key, v in model.state_dict().items():
        if key not in params:
            state[key] = v.clone()
            continue
        stack = key.split(".sequence_model.")[0].split(".fc_output_layer.")[0]
        bound_ = 1.0 / model.get_submodule(stack).hidden_size ** 0.5
        state[key] = torch.from_numpy(
            rng.uniform(-bound_, bound_, tuple(v.shape)).astype(np.float32))
    torch.save({"model": state, "epoch": 0}, path)


def _write_family_wavs(work: Path, family: str, sr: int, seed: int) -> tuple[dict, dict]:
    """Noisy wavs at ``sr`` from a numpy seed (tones in noise), as the
    Inferencer reads them back: three of 1, 4 and 10 s under "exact" and
    ``BATCH_SECONDS`` under "batched"; and the "exact" ones' tones alone,
    under the same names, under "clean". Returns (the three directories,
    the noisy waves by file name under "exact" and "batched")."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav

    rng = np.random.default_rng(seed)
    dirs = {"exact": work / f"noisy_{family}", "batched": work / f"noisy_batched_{family}"}
    inputs = {key: {} for key in dirs}
    dirs["clean"] = work / f"clean_{family}"
    dirs["clean"].mkdir()
    for key, seconds_list in (("exact", (1, 4, 10)), ("batched", BATCH_SECONDS)):
        dirs[key].mkdir()
        for i, seconds in enumerate(seconds_list):
            t = np.arange(int(seconds * sr)) / sr
            tone = 0.4 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
            wave = (tone + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
            name = f"utt{i:02d}_{seconds:g}s"
            write_wav(dirs[key] / f"{name}.wav", wave, sr)
            inputs[key][name] = read_wav(dirs[key] / f"{name}.wav")[0]
            if key == "exact":
                write_wav(dirs["clean"] / f"{name}.wav", tone.astype(np.float32), sr)
    return dirs, inputs


def _family_infer(work: Path, card: str, family: str) -> dict:
    """The infer CLI on the family's inference TOML over the smoke's three
    wavs (1, 4, 10 s): finite outputs at the input's length and rate, peak
    0.8, K1's launches by shape for every stack; the card's cRM against the
    plain CPU path on one spectrogram; the CLI at ``batch_size = 8`` over
    ``BATCH_SECONDS`` against ``batch_size = 1``, K1's launches by flush;
    then the forward's RTF at B=1 x 10 s (median of 3 after a warm-up)."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav
    from fullsubnet_tpu_torch.infer import cli
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    sr, n_fft, batch = 16000, 512, 8
    dirs, inputs = _write_family_wavs(work, family, sr, SEED + 9)
    cfg = _inference_config(work, dirs["exact"], recipe=_recipe(family, "infer"))
    ckpt = work / f"{family}_random.tar"
    _write_family_checkpoint(ckpt, cfg)

    outputs, launched, walls = {}, {}, {}
    for key, size in (("exact", 1), ("batched", batch), ("batched", 1)):
        run_cfg = (cfg if key == "exact" else
                   _inference_config(work, dirs[key], batch_size=size,
                                     recipe=_recipe(family, "infer")))
        for kernel in _wrappers().values():
            kernel.reset_counts()
        with _recorded_outputs() as outputs[(key, size)]:
            t0 = time.perf_counter()
            cli.main(["-C", str(run_cfg), "-M", str(ckpt),
                      "-O", str(work / f"out_{family}_{key}_{size}"), "--device", "cuda"])
            torch.cuda.synchronize()
            walls[(key, size)] = time.perf_counter() - t0
        launched[(key, size)] = _launched()
        for name, noisy in inputs[key].items():
            out, got_sr = read_wav(work / f"out_{family}_{key}_{size}" / "enhanced" / f"{name}.wav")
            check(got_sr == sr and out.shape == noisy.shape and bool(np.isfinite(out).all()),
                  f"{family} {key} b{size} {name}: written wav {out.shape} at {got_sr}")
            peak = float(np.max(np.abs(out)))
            check(abs(peak - 0.8) <= PEAK_ATOL, f"{family} {name}: peak {peak} is not 0.8")

    want = _family_launches([s for w in inputs["exact"].values()
                             for s in _family_stacks(family, 1, _frames(w.size), False)], "infer")
    check(launched[("exact", 1)] == want,
          f"{family} infer CLI: launches by shape {launched[('exact', 1)]}, want {want}")
    print(f"infer CLI ({family}) on 3 wavs (1, 4, 10 s): {walls[('exact', 1)]:.2f} s wall incl. "
          f"set-up; finite outputs, input length and rate, peak 0.8; launches by shape "
          f"{launched[('exact', 1)]} [{card}]")
    calls, buckets = [], collections.Counter()
    for wave in inputs["batched"].values():
        if wave.size <= n_fft // 2:
            calls.append((1, _frames(wave.size)))
        else:
            buckets[-(-(wave.size + n_fft) // sr) * sr] += 1
    for bucket, count in buckets.items():
        calls += [(min(batch, count - i), _frames(bucket)) for i in range(0, count, batch)]
    want = _family_launches([s for b, t in calls for s in _family_stacks(family, b, t, False)],
                            "infer")
    check(launched[("batched", batch)] == want, f"{family} batched infer CLI: launches by "
          f"shape {launched[('batched', batch)]}, want {want}")
    worst = 0.0
    for name in inputs["batched"]:
        got, one = outputs[("batched", batch)][name], outputs[("batched", 1)][name]
        err = float(np.max(np.abs(got - one)) / max(float(np.max(np.abs(one))), 1e-30))
        worst = max(worst, err)
        check(err <= BATCH_RTOL, f"{family} {name}: batched vs batch_size 1 {err:.3e} of the peak")
    print(f"batched infer CLI ({family}), batch_size {batch}, {len(calls) - 1} flushes and one "
          f"exact call over {len(inputs['batched'])} wavs: {walls[('batched', batch)]:.2f} s "
          f"wall (batch_size 1: {walls[('batched', 1)]:.2f} s); against batch_size 1, max|diff| "
          f"/ peak {worst:.3e} (tol {BATCH_RTOL:g}); launches by shape K1's alone")

    # the card's cRM against the port's plain CPU path, one spectrogram
    config = load_config(cfg)
    gpu = Inferencer(config, str(ckpt), None, device="cuda")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    spec = stft_complex(torch.from_numpy(inputs["exact"]["utt00_1s"][None]), 512, 256, 512)
    with torch.inference_mode():
        mag = spec.abs()[:, None]
        m_cpu = cpu.model(mag, dropping_band=False)
        m_gpu = gpu.model(mag.cuda(), dropping_band=False).cpu()
    err = float((m_gpu - m_cpu).abs().max())
    print(f"cRM ({family}) card vs plain CPU (1 s utterance): max|diff| {err:.3e} (tol "
          f"{CRM_ATOL:g}), max|cRM| {float(m_cpu.abs().max()):.3f}")
    check(bool(torch.isfinite(m_gpu).all()) and err <= CRM_ATOL,
          f"{family} cRM card vs CPU {err:.3e} > {CRM_ATOL:g}")

    # RTF at B=1 x 10 s: the model forward alone
    wave10 = inputs["exact"]["utt02_10s"]
    mag = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512).abs()[None, None]
    with torch.inference_mode():
        gpu.model(mag, dropping_band=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            gpu.model(mag, dropping_band=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    median = sorted(times)[1]
    rtf = median / (wave10.size / sr)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"{family} model forward B=1 x 10 s: median {median * 1e3:.2f} ms of "
          f"{[round(t * 1e3, 2) for t in times]}, RTF {rtf:.5f}, peak memory {peak_gb:.2f} GiB "
          f"[{card}]")
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"launches": {k: sum(v.values()) for k, v in launched[("exact", 1)].items()},
            "batched_launches": {k: sum(v.values())
                                 for k, v in launched[("batched", batch)].items()},
            "rtf": rtf, "rtf_ms": median * 1e3, "crm_err": err}


def _family_train_cli(work: Path, lists: dict, card: str, family: str) -> dict:
    """The train CLI on a copy of the family's train TOML, as shipped but for
    its data, one epoch at ``FAMILY_CLI_BATCH`` (two steps over the 64
    clips) and ``weight_init = true`` as the recipe sets it (Fast's recipe
    sets false): finite losses, a checkpoint, and the steps' launches by
    shape, every stack on the tensor-core stages (Fast: its mel projection
    promotes to fp32, so its stacks take the fp32 stages, as they compute
    at fp32 in the JAX package)."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.train import cli as train_cli

    name = f"train_{family}"
    cfg = _train_config(work, lists, name, recipe=_recipe(family, "train"), epochs=1,
                        batch_size=FAMILY_CLI_BATCH, save_checkpoint_interval=1)
    out = work / "runs_families"
    for kernel in _wrappers().values():
        kernel.reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launched()
    mode = "fp32" if family == "fast_fullsubnet" else "bf16"
    frames = _frames(int(3.072 * 16000))
    want = _scaled(_family_launches(_family_stacks(family, FAMILY_CLI_BATCH, frames, True),
                                    mode), trainer.steps)
    print(f"train CLI ({family}, recipe as shipped but its data; {trainer.steps} steps of "
          f"B={FAMILY_CLI_BATCH} x 3.072 s, use_amp, weight_init "
          f"{trainer.config['model']['args'].get('weight_init')}): {wall:.2f} s wall incl. "
          f"set-up and data; losses {trainer.epoch_losses}; launches by shape {got} [{card}]")
    check(trainer.steps == 64 // FAMILY_CLI_BATCH, f"{family}: {trainer.steps} steps")
    check(all(np.isfinite(v) for v in trainer.epoch_losses.values()),
          f"{family}: a training loss is not finite")
    check((out / name / "checkpoints" / "model_0001.pth").is_file(), f"{family}: no model_0001.pth")
    check(got == want, f"{family} train CLI: launches by shape {got}, want {want}")
    if family == "fast_fullsubnet":
        print(f"  {family}: the walks ran at (N, H) {sorted(got['lstm_walk_f32'])}: the 257-unit "
              "encoder stack at its padded width 272; the head-less stacks (encoder 0, decoder "
              "0) launched no head GEMM")
    del trainer
    torch.cuda.empty_cache()
    return {k: sum(v.values()) for k, v in got.items()}


def _family_card_vs_cpu_step(work: Path, lists: dict, card: str, family: str) -> dict:
    """One step at ``compare_batch`` (else 4) x 3.072 s at the recipe's
    width, at fp32 storage and under the recipe's ``use_amp`` (for
    ``FP32_STACKS``, whose stacks see fp32 inputs under it and run the same
    fp32 stages, at fp32 alone): the loss and every gradient on the card
    against the port's plain CPU path (whose plain stages round where the
    kernels do), the same weights and batch; the card's launches by shape
    the fp32 stages', or the bf16 ones', and the forms its fp32 walks
    launched."""
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    batch = FAMILIES[family].get("compare_batch", 4)
    result = {}
    # under use_amp the FP32_STACKS families run the fp32 stages of the fp32
    # step at the same shapes (their stacks' inputs promote): only the fp32
    # step is compared for them
    for amp in ("false",) if family in FP32_STACKS else ("false", "true"):
        cfg = load_config(_train_config(work, lists, f"step_b{batch}_{amp}_{family}",
                                        recipe=_recipe(family, "train"), use_amp=amp,
                                        batch_size=batch, num_workers=0))
        grads, losses, seconds = {}, {}, {}
        for device in ("cuda", "cpu"):
            trainer = Trainer(cfg, output_dir=str(work / f"step_{family}_{amp}_{device}"),
                              device=device)
            noisy, clean = _first_batch(trainer, batch)
            for kernel in _wrappers().values():
                kernel.reset_counts()
            t0 = time.perf_counter()
            loss = trainer.compute_loss(noisy.to(device), clean.to(device))
            loss.backward()
            losses[device] = float(loss.detach())
            seconds[device] = time.perf_counter() - t0
            grads[device] = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
            if device == "cuda":
                got, forms = _launched(), _walk_forms()
                mode = "bf16" if amp == "true" and family not in FP32_STACKS else "fp32"
                want = _family_launches(
                    _family_stacks(family, batch, _family_frames(family, noisy.shape[1]), True),
                    mode)
                check(got == want, f"{family} step (use_amp {amp}): launches by shape {got}, "
                      f"want {want}")
            del trainer
        rel = {k: float((grads["cuda"][k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for k, w in grads["cpu"].items()}
        worst = max(rel, key=rel.get)
        loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        loss_tol, grad_tol = ((STEP_LOSS_RTOL, STEP_GRAD_RTOL) if amp == "false"
                              else (STEP_LOSS_RTOL_BF16, GRAD_RTOL_BF16))
        print(f"one {family} step B={batch} x 3.072 s, use_amp {amp}, card vs plain CPU: loss "
              f"{losses['cuda']:.8e} vs {losses['cpu']:.8e} (rel {loss_rel:.2e}, tol "
              f"{loss_tol:g}); gradient error / max, worst {rel[worst]:.2e} at {worst} (tol "
              f"{grad_tol:g}); {seconds['cuda']:.2f} s on the card (first call), "
              f"{seconds['cpu']:.2f} s on the CPU; launches by shape {got}; fp32 walk forms "
              f"{json.dumps(forms)} [{card}]")
        check(loss_rel <= loss_tol, f"{family} step (use_amp {amp}) loss card vs CPU "
              f"{loss_rel:.2e}")
        check(rel[worst] <= grad_tol, f"{family} step (use_amp {amp}) gradient {worst} card vs "
              f"CPU {rel[worst]:.2e}")
        result["fp32" if amp == "false" else "amp"] = {k: sum(v.values()) for k, v in got.items()}
        result[f"{'fp32' if amp == 'false' else 'amp'}_walk_forms"] = forms
    result["batch"] = batch
    return result


def _walk_forms(steps: int = 1) -> dict:
    """The forms the fp32 LSTM walks launched since their counts were reset,
    as the wrappers counted them, by stack: "N=.. H=.." -> {"training walk":
    {form: launches}, "backward walk": {form: launches}}, over ``steps``
    steps."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    forms = collections.defaultdict(dict)
    for label, walk in (("training walk", ops.lstm_train_walk_f32),
                        ("backward walk", ops.lstm_walk_f32)):
        for ((n, h), form), count in sorted(walk.forms_by_shape.items()):
            forms[f"N={n} H={h}"].setdefault(label, {})[form] = count / steps
    return dict(forms)


def _family_step_numbers(work: Path, lists: dict, card: str, family: str,
                         compared: dict) -> dict:
    """The recipe's train step (``use_amp = true``) at its batch x 3.072 s,
    the batch on the card: median of 5 after 2 warm-ups, audio-s/s, peak
    memory, its launches by shape, the forms its fp32 walks launched (where
    ``compared``, the card-vs-CPU step's result, ran at this batch, the
    same forms as that step's), and a profile whose library GEMMs are no
    more than the head backward's two a headed stack and the forward's mel
    projection (Fast)."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    batch = FAMILIES[family]["step_batch"]
    name = f"step_numbers_{family}"
    trainer = Trainer(load_config(_train_config(work, lists, name, recipe=_recipe(family, "train"),
                                                num_workers=0)),
                      output_dir=str(work / name), device="cuda")
    noisy, clean = (v.cuda() for v in _first_batch(trainer, batch))
    audio_s = noisy.shape[0] * noisy.shape[1] / _family_sr(family)

    def step():
        trainer.train_step(noisy, clean)
        torch.cuda.synchronize()

    def measure():
        for _ in range(2):
            step()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        for kernel in _wrappers().values():
            kernel.reset_counts()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        return (times, held, torch.cuda.max_memory_allocated() / 2**30, _launched(),
                _walk_forms(len(times)))

    times, held_gb, peak_gb, got, forms = measure()
    median = sorted(times)[len(times) // 2]
    mode = "fp32" if family in FP32_STACKS else "bf16"
    stacks = _family_stacks(family, batch, _family_frames(family, noisy.shape[1]), True)
    want = _scaled(_family_launches(stacks, mode), len(times))
    check(got == want, f"{family} recipe step: launches by shape {got}, want {want}")
    if mode == "fp32":
        print(f"  fp32 walk forms a step, as the wrappers counted them: {json.dumps(forms)}")
        if compared["batch"] == batch:
            check(forms == compared["fp32_walk_forms"], f"{family} recipe step: walk forms "
                  f"{forms}, the card-vs-CPU fp32 step's {compared['fp32_walk_forms']}")
    print(f"{family} train step B={batch} x 3.072 s (use_amp as the recipe; stacks at "
          f"{'fp32, as the inputs promote' if mode == 'fp32' else 'bf16'}): median "
          f"{median * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
          f"{audio_s / median:.2f} audio-s/s, peak memory {peak_gb:.2f} GiB ({held_gb:.2f} GiB "
          f"held between steps) [{card}]")
    unpadded = None
    if mode == "bf16":
        # the same step with the input width unpadded (tc_gemm's element
        # loads at F = 31 or 257), in this run
        from fullsubnet_tpu_torch.ops import subband_lstm as ops

        saved, ops.TC_INPUT_MULTIPLE = ops.TC_INPUT_MULTIPLE, 1
        try:
            other = measure()[0]
        finally:
            ops.TC_INPUT_MULTIPLE = saved
        unpadded = sorted(other)[len(other) // 2] * 1e3
        print(f"  the same step with the input width unpadded: median {unpadded:.1f} ms of "
              f"{[round(t * 1e3, 1) for t in other]}, {audio_s / unpadded * 1e3:.2f} audio-s/s")
    label = f"one {family} train step B={batch} x 3.072 s"
    heads = sum(1 for s in stacks if s[2])
    rows = _profile(step, label, card)
    _check_library_gemms(rows, label, limit=2 * heads + (family == "fast_fullsubnet"))
    del trainer
    torch.cuda.empty_cache()
    return {"ms": median * 1e3, "audio_s_per_s": audio_s / median, "peak_gib": peak_gb,
            "unpadded_ms": unpadded, "walk_forms": forms if mode == "fp32" else None,
            "launches_per_step": {k: sum(v.values()) / len(times) for k, v in got.items()}}


def _written_inference_config(work: Path, family: str, noisy_dir: Path, strategy: str,
                              batch_size: int, args: str = "") -> Path:
    """An inference TOML written from the family's train recipe (for the
    strategies no shipped inference TOML sets): its ``[acoustics]`` and
    ``[model]``, ``[inferencer] type = strategy`` and ``batch_size`` with
    ``args`` under ``[inferencer.args]``, and a dataset of ``noisy_dir`` at
    the recipe's rate."""
    toml = _recipe(family, "train").read_text()
    sections = {}
    for name in ("acoustics", "model"):
        m = re.search(rf"(?ms)^\[{name}\]\n.*?(?=^\[(?!{name}\.))", toml)
        check(m is not None, f"{family} recipe has no [{name}] section")
        sections[name] = m.group(0)
    cfg = work / f"inference_{family}_{strategy}_{noisy_dir.name}_b{batch_size}.toml"
    cfg.write_text(
        sections["acoustics"] + sections["model"]
        + f'[inferencer]\npath = "inferencer.Inferencer"\ntype = "{strategy}"\n'
        + f"batch_size = {batch_size}\n[inferencer.args]\n{args}\n\n"
        + '[dataset]\npath = "dataset_inference.Dataset"\n[dataset.args]\n'
        + f"dataset_dir_list = [{json.dumps(str(noisy_dir))}]\nsr = {_family_sr(family)}\n")
    return cfg


def _overlapped_chunk_lengths(samples: int, sr: int, chunk_seconds: float = 4.0) -> list:
    """The lengths of the model calls of the ``overlapped_chunk`` strategy
    over ``samples``: chunks of ``chunk_seconds`` every half chunk, each with
    its 256 samples of history, the last ones cut by the utterance's end."""
    chunk = int(sr * chunk_seconds)
    hop = chunk // 2
    return [256 + max(0, min(chunk, samples - k * hop)) for k in range(samples // hop + 1)]


def _improved_infer(work: Path, card: str, family: str) -> dict:
    """The infer CLI with ``time_domain`` over three wavs (1, 4, 10 s) at the
    recipe's rate: finite outputs at the input's length and rate, peak 0.8,
    K1's launches by shape for every stack; ``batch_size = 4`` over
    ``BATCH_SECONDS`` against ``batch_size = 1``, K1's launches by flush;
    ``overlapped_chunk`` (4 s chunks) once over the three wavs, its launches
    by chunk; the card's waveform against the plain CPU path on the 1 s
    wav; then the forward's RTF at B=1 x 10 s (median of 3 after a
    warm-up)."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav
    from fullsubnet_tpu_torch.infer import cli
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    sr, batch = _family_sr(family), 4
    n_fft = IMPROVED_LAYOUT[sr]["n_fft"]
    dirs, inputs = _write_family_wavs(work, family, sr, SEED + 10)
    ckpt = work / f"{family}_random.tar"
    _write_family_checkpoint(ckpt, _recipe(family, "train"))

    outputs, launched, walls = {}, {}, {}
    runs = (("exact", "time_domain", 1), ("batched", "time_domain", batch),
            ("batched", "time_domain", 1), ("exact", "overlapped_chunk", 1))
    for key, strategy, size in runs:
        cfg = _written_inference_config(work, family, dirs[key], strategy, size)
        for kernel in _wrappers().values():
            kernel.reset_counts()
        out_dir = work / f"out_{family}_{key}_{strategy}_{size}"
        with _recorded_outputs() as outputs[(key, strategy, size)]:
            t0 = time.perf_counter()
            cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out_dir), "--device", "cuda"])
            torch.cuda.synchronize()
            walls[(key, strategy, size)] = time.perf_counter() - t0
        launched[(key, strategy, size)] = _launched()
        for name, noisy in inputs[key].items():
            out, got_sr = read_wav(out_dir / "enhanced" / f"{name}.wav")
            check(got_sr == sr and out.shape == noisy.shape and bool(np.isfinite(out).all()),
                  f"{family} {strategy} b{size} {name}: written wav {out.shape} at {got_sr}")
            peak = float(np.max(np.abs(out)))
            check(abs(peak - 0.8) <= PEAK_ATOL, f"{family} {name}: peak {peak} is not 0.8")

    def k1(calls):
        """K1's launches for model calls of (rows, samples)."""
        return _family_launches([s for b, n in calls for s in
                                 _family_stacks(family, b, _family_frames(family, n), False)],
                                "infer")

    exact = [(1, w.size) for w in inputs["exact"].values()]
    calls, buckets = [], collections.Counter()
    for wave in inputs["batched"].values():
        if wave.size <= n_fft // 2:
            calls.append((1, wave.size))
        else:
            buckets[-(-(wave.size + n_fft) // sr) * sr] += 1
    for bucket, count in buckets.items():
        calls += [(min(batch, count - i), bucket) for i in range(0, count, batch)]
    chunks = [(1, n) for w in inputs["exact"].values()
              for n in _overlapped_chunk_lengths(w.size, sr)]
    for run, want in ((runs[0], k1(exact)), (runs[1], k1(calls)),
                      (runs[2], k1([(1, w.size) for w in inputs["batched"].values()])),
                      (runs[3], k1(chunks))):
        check(launched[run] == want, f"{family} {run}: launches by shape {launched[run]}, "
              f"want {want}")
    print(f"infer CLI ({family}, time_domain) on 3 wavs (1, 4, 10 s at {sr} Hz): "
          f"{walls[runs[0]]:.2f} s wall incl. set-up; finite outputs, input length and rate, peak "
          f"0.8; launches by shape {launched[runs[0]]} [{card}]")
    worst = 0.0
    for name in inputs["batched"]:
        got, one = outputs[runs[1]][name], outputs[runs[2]][name]
        err = float(np.max(np.abs(got - one)) / max(float(np.max(np.abs(one))), 1e-30))
        worst = max(worst, err)
        check(err <= BATCH_RTOL, f"{family} {name}: batched vs batch_size 1 {err:.3e} of the peak")
    print(f"batched infer CLI ({family}, time_domain), batch_size {batch}, {len(calls) - 1} "
          f"flushes and one exact call over {len(inputs['batched'])} wavs: "
          f"{walls[runs[1]]:.2f} s wall (batch_size 1: {walls[runs[2]]:.2f} s); against "
          f"batch_size 1, max|diff| / peak {worst:.3e} (tol {BATCH_RTOL:g}); launches by shape "
          "K1's alone")
    print(f"overlapped_chunk ({family}, 4 s chunks) on the 3 wavs: {walls[runs[3]]:.2f} s wall, "
          f"{len(chunks)} chunk calls; launches by shape K1's alone")

    # the card's waveform against the port's plain CPU path
    config = load_config(_written_inference_config(work, family, dirs["exact"], "time_domain", 1))
    gpu = Inferencer(config, str(ckpt), None, device="cuda")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    wave1 = torch.from_numpy(inputs["exact"]["utt00_1s"][None])
    w_cpu, w_gpu = cpu.time_domain(wave1), gpu.time_domain(wave1.cuda())
    err = float(np.max(np.abs(w_gpu - w_cpu)) / np.max(np.abs(w_cpu)))
    print(f"enhanced waveform ({family}) card vs plain CPU (1 s utterance): max|diff| / peak "
          f"{err:.3e} (tol {VAL_WAVE_RTOL:g})")
    check(bool(np.isfinite(w_gpu).all()) and err <= VAL_WAVE_RTOL,
          f"{family} waveform card vs CPU {err:.3e} > {VAL_WAVE_RTOL:g}")

    # RTF at B=1 x 10 s: the model forward alone, waveform to waveform
    wave10 = torch.from_numpy(inputs["exact"]["utt02_10s"][None]).cuda()
    with torch.inference_mode():
        gpu.model(wave10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            gpu.model(wave10)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    median = sorted(times)[1]
    rtf = median / (wave10.shape[1] / sr)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"{family} model forward B=1 x 10 s: median {median * 1e3:.2f} ms of "
          f"{[round(t * 1e3, 2) for t in times]}, RTF {rtf:.5f}, peak memory {peak_gb:.2f} GiB "
          f"[{card}]")
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"launches": {k: sum(v.values()) for k, v in launched[runs[0]].items()},
            "batched_launches": {k: sum(v.values()) for k, v in launched[runs[1]].items()},
            "overlapped_chunk_launches": {k: sum(v.values()) for k, v in launched[runs[3]].items()},
            "rtf": rtf, "rtf_ms": median * 1e3, "wave_err": err}


def _improved_train_cli(work: Path, lists: dict, card: str, family: str) -> dict:
    """The train CLI on a copy of the recipe, as shipped but for its data
    (at the recipe's rate, validation pointed at the synthetic DNS
    directories) and its epochs: two epochs of B=16 (4 steps each over the
    64 clips), so that the recipe's ``validation_interval = 2`` validates
    once (the waveform ``_enhance_utterance`` and the metric pool): finite
    losses and ``Validation/*`` scalars, the epoch-2 checkpoints, and the
    launches by shape: the steps' fp32 stages and validation's K1, one
    forward per clip."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.train import cli as train_cli

    sr, batch = _family_sr(family), FAMILIES[family]["step_batch"]
    name = f"train_{family}"
    cfg = _train_config(work, lists, name, recipe=_recipe(family, "train"), epochs=2)
    out = work / "runs_families"
    for kernel in _wrappers().values():
        kernel.reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _launched()
    steps = _scaled(_family_launches(
        _family_stacks(family, batch, _family_frames(family, int(3.072 * sr)), True), "fp32"),
        trainer.steps)
    clips = [_family_stacks(family, 1, _family_frames(family, int(seconds * sr)), False)
             for seconds in VAL_SECONDS * 2]
    want = _merged(steps, _family_launches([s for c in clips for s in c], "infer"))
    scalars = trainer.scalars.get(2, {})
    val = {k: round(v, 4) for k, v in scalars.items() if k.startswith("Validation/")}
    print(f"train CLI ({family}, recipe as shipped but its data and epochs; {trainer.steps} "
          f"steps of B={batch} x 3.072 s at {sr} Hz, use_amp, si_snr_loss; validation at epoch "
          f"2 over {len(clips)} clips): {wall:.2f} s wall incl. set-up, data and the metric "
          f"pool; losses {trainer.epoch_losses}; validation {val}; launches by shape {got} "
          f"[{card}]")
    check(trainer.steps == 2 * (64 // batch), f"{family}: {trainer.steps} steps")
    check(all(np.isfinite(v) for v in trainer.epoch_losses.values()),
          f"{family}: a training loss is not finite")
    for tag in ("Validation/Loss_With_reverb", "Validation/Loss_No_reverb",
                "Validation/STOI_With_reverb_Enhanced", "Validation/SI_SDR_No_reverb_Enhanced",
                "Validation/Score"):
        check(tag in scalars and np.isfinite(scalars[tag]), f"{family}: {tag} missing or "
              f"not finite: {scalars.get(tag)}")
    for ckpt in ("model_0002.pth", "best_model.tar"):
        check((out / name / "checkpoints" / ckpt).is_file(), f"{family}: no {ckpt}")
    check(got == want, f"{family} train CLI: launches by shape {got}, want {want}")
    del trainer
    torch.cuda.empty_cache()
    return {k: sum(v.values()) for k, v in got.items()}


# the inference strategies each family runs through the infer CLI besides its
# recipe's, with their ``[inferencer.args]``: the full-band baseline's mask
# strategies and the sub-band baseline's own (its recipe ships no inference
# TOML; the TOML is written from its train recipe)
FAMILY_STRATEGIES = {"fullband_baseline": {"mag": "", "scaled_mask": ""},
                     "subband_baseline": {"sub_band_crm_mask": "n_neighbor = 15"}}


def _k1_at_shape(card: str, label: str, f_in: int, hidden: int, out_dim: int, n: int,
                 t: int) -> dict:
    """K1 (the LSTM's fwd_gemm and walk stages, through ``fused_subband_lstm``)
    on one stack of 2 layers at (F_in, H, OUT, N, T), fp32, with weights and
    inputs from a numpy seed: against the plain version and cuDNN
    ``nn.LSTM`` + Linear, and the three timed (CUDA events, mean of 3 after
    a warm-up; the plain version once), beside the bound."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 11)
    layers, fc = _stack(rng, f_in, hidden, out_dim, dev)
    rnn = _cudnn_rnn(layers, f_in, hidden, torch.float32, dev)
    x = torch.from_numpy(np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32)).to(dev)

    def cudnn():
        return rnn(x)[0] @ fc["weight"].t() + fc["bias"]

    with torch.no_grad():
        got = ops.fused_subband_lstm(x, *layers, fc)
        plain = ops.plain_fused_subband_lstm(x, layers, fc)
        err = float((got - plain).abs().max())
        err_cudnn = float((got - cudnn()).abs().max())
        ms = cuda_ms(lambda: ops.fused_subband_lstm(x, *layers, fc))
        plain_ms = cuda_ms(lambda: ops.plain_fused_subband_lstm(x, layers, fc), reps=1)
        cudnn_ms = cuda_ms(cudnn)
    nbytes = 4 * (t * n * f_in + weight_elems(f_in, hidden, out_dim) + t * n * out_dim)
    bound_ms, bound_by = bound(stack_flops(t, n, f_in, hidden, out_dim), nbytes, "fp32")
    print(f"K1 at {label} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}, 2 layers, "
          f"fp32) [{card}]: stages {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN nn.LSTM + "
          f"Linear {cudnn_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}); max|stages-plain| "
          f"{err:.3e}, max|stages-cuDNN| {err_cudnn:.3e} (tol {KERNEL_ATOL:g})")
    check(bool(torch.isfinite(got).all()) and max(err, err_cudnn) <= KERNEL_ATOL,
          f"K1 at {label}: vs plain {err:.3e}, vs cuDNN {err_cudnn:.3e} > {KERNEL_ATOL:g}")
    del x, got, plain, rnn
    torch.cuda.empty_cache()
    return {"name": f"{label}: F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}",
            "max_abs_err": max(err, err_cudnn), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cudnn_ms}


def _family_strategies(work: Path, card: str, family: str) -> dict:
    """The infer CLI with each of the family's ``FAMILY_STRATEGIES`` over
    the smoke's three wavs (1, 4, 10 s): finite outputs at the input's
    length and rate, peak 0.8, K1's launches by shape for every stack (per
    utterance: the magnitude strategies run the model on [1, 1, F, T'],
    ``sub_band_crm_mask`` its [F, 31, T] units, 257 rows, no look-ahead);
    the card's waveform against the plain CPU path on the 1 s wav. For the
    sub-band baseline also ``batch_size = 4`` over ``BATCH_SECONDS`` against
    ``batch_size = 1`` (these strategies run each utterance alone), the
    RTF at B=1 x 10 s (the model on its units, and the whole strategy) and
    K1 at the strategy's shape."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import num_stft_frames
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav
    from fullsubnet_tpu_torch.infer import cli
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    sr, batch = 16000, 4
    dirs, inputs = _write_family_wavs(work, f"{family}_strategies", sr, SEED + 12)
    ckpt = work / f"{family}_strategies_random.tar"
    _write_family_checkpoint(ckpt, _recipe(family, "train"))
    result = {"clean_dir": str(dirs["clean"])}
    for strategy, args in FAMILY_STRATEGIES[family].items():
        sub_band = strategy == "sub_band_crm_mask"
        runs = [("exact", 1)] + ([("batched", batch), ("batched", 1)] if sub_band else [])
        outputs, launched, walls = {}, {}, {}
        for key, size in runs:
            cfg = _written_inference_config(work, family, dirs[key], strategy, size, args)
            out_dir = work / f"out_{family}_{strategy}_{key}_{size}"
            for kernel in _wrappers().values():
                kernel.reset_counts()
            with _recorded_outputs() as outputs[(key, size)]:
                t0 = time.perf_counter()
                cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out_dir), "--device", "cuda"])
                torch.cuda.synchronize()
                walls[(key, size)] = time.perf_counter() - t0
            launched[(key, size)] = _launched()
            for name, noisy in inputs[key].items():
                out, got_sr = read_wav(out_dir / "enhanced" / f"{name}.wav")
                check(got_sr == sr and out.shape == noisy.shape and bool(np.isfinite(out).all()),
                      f"{family} {strategy} b{size} {name}: written wav {out.shape} at {got_sr}")
                peak = float(np.max(np.abs(out)))
                check(abs(peak - 0.8) <= PEAK_ATOL, f"{family} {strategy} {name}: peak {peak}")
            # one model call per utterance, at any batch size
            frames = [num_stft_frames(w.size, 256, 512) + (0 if sub_band else 2)
                      for w in inputs[key].values()]
            want = _family_launches([s for f in frames
                                     for s in _family_stacks(family, 1, f, False)], "infer")
            check(launched[(key, size)] == want, f"{family} {strategy} b{size}: launches by "
                  f"shape {launched[(key, size)]}, want {want}")
        print(f"infer CLI ({family}, {strategy}) on 3 wavs (1, 4, 10 s): "
              f"{walls[('exact', 1)]:.2f} s wall incl. set-up; finite outputs, input length and "
              f"rate, peak 0.8; launches by shape {launched[('exact', 1)]} [{card}]")
        entry = {"launches": {k: sum(v.values()) for k, v in launched[("exact", 1)].items()},
                 "enhanced_dir": str(work / f"out_{family}_{strategy}_exact_1" / "enhanced")}
        if sub_band:
            worst = 0.0
            for name in inputs["batched"]:
                got, one = outputs[("batched", batch)][name], outputs[("batched", 1)][name]
                err = float(np.max(np.abs(got - one)) / max(float(np.max(np.abs(one))), 1e-30))
                worst = max(worst, err)
                check(err <= BATCH_RTOL, f"{family} {name}: batch_size {batch} vs 1 {err:.3e}")
            print(f"infer CLI ({family}, {strategy}), batch_size {batch} over "
                  f"{len(inputs['batched'])} wavs (each alone): {walls[('batched', batch)]:.2f} s "
                  f"wall (batch_size 1: {walls[('batched', 1)]:.2f} s); against batch_size 1, "
                  f"max|diff| / peak {worst:.3e} (tol {BATCH_RTOL:g})")
            entry["batch_err"] = worst

        # the card's waveform against the port's plain CPU path
        config = load_config(_written_inference_config(work, family, dirs["exact"], strategy, 1,
                                                       args))
        gpu = Inferencer(config, str(ckpt), None, device="cuda")
        cpu = Inferencer(config, str(ckpt), None, device="cpu")
        wave1 = torch.from_numpy(inputs["exact"]["utt00_1s"][None])
        w_cpu, w_gpu = getattr(cpu, strategy)(wave1), getattr(gpu, strategy)(wave1.cuda())
        err = float(np.max(np.abs(w_gpu - w_cpu)) / np.max(np.abs(w_cpu)))
        print(f"enhanced waveform ({family}, {strategy}) card vs plain CPU (1 s utterance): "
              f"max|diff| / peak {err:.3e} (tol {VAL_WAVE_RTOL:g})")
        check(bool(np.isfinite(w_gpu).all()) and err <= VAL_WAVE_RTOL,
              f"{family} {strategy} waveform card vs CPU {err:.3e} > {VAL_WAVE_RTOL:g}")
        entry["wave_err"] = err

        if sub_band:
            # RTF at B=1 x 10 s: the model on the utterance's units, and the
            # whole strategy (STFT, unfold, model, mask, iSTFT)
            from fullsubnet_tpu_torch.acoustics.feature import freq_unfold
            from fullsubnet_tpu_torch.acoustics.stft import stft_complex

            wave10 = torch.from_numpy(inputs["exact"]["utt02_10s"][None]).cuda()
            mag = stft_complex(wave10, 512, 256, 512).abs()
            units = freq_unfold(mag[None], 15)[0, :, 0]  # [257, 31, T]
            timed = {}
            with torch.inference_mode():
                for what, fn in (("model", lambda: gpu.model(units)),
                                 ("strategy", lambda: gpu.sub_band_crm_mask(wave10))):
                    fn()
                    torch.cuda.synchronize()
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    timed[what] = sorted(times)[1]
            seconds = wave10.shape[1] / sr
            print(f"{family} {strategy} B=1 x 10 s: the model on [{', '.join(map(str, units.shape))}]"
                  f" units {timed['model'] * 1e3:.2f} ms (RTF {timed['model'] / seconds:.5f}), "
                  f"the whole strategy {timed['strategy'] * 1e3:.2f} ms (RTF "
                  f"{timed['strategy'] / seconds:.5f}), medians of 3 [{card}]")
            entry.update(rtf=timed["model"] / seconds, rtf_strategy=timed["strategy"] / seconds,
                         k1=_k1_at_shape(card, strategy, 31, 320, 2, 257, units.shape[-1]))
        del gpu, cpu
        torch.cuda.empty_cache()
        result[strategy] = entry
    return result


def _fast_gaussian_batched(work: Path, card: str) -> dict:
    """Fast FullSubNet's inference recipe with ``norm_type =
    "offline_gaussian_norm"``: the infer CLI at ``batch_size = 4`` (four
    wavs in one 2 s bucket, one flush of 4 rows, and one alone in a 1 s
    bucket) against ``batch_size = 1``. The four have an odd number of STFT
    hops, so the unpadded run's downsampled clock ends in a partial tail
    block, whose sum and sum of squares the batched run's masked Gaussian
    statistics rebuild; the fifth has an even number and no partial
    block."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli

    family, sr, batch = "fast_fullsubnet", 16000, 4
    noisy_dir = work / "noisy_fast_gaussian"
    noisy_dir.mkdir()
    rng = np.random.default_rng(SEED + 13)
    hops = (63, 81, 99, 117, 40)  # 256·k + 100 samples: T = k + 1 frames, + 2 look-ahead
    inputs = {}
    for k in hops:
        n = 256 * k + 100
        t = np.arange(n) / sr
        wave = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
                + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(noisy_dir / f"hops{k:03d}.wav", wave, sr)
        inputs[f"hops{k:03d}"] = read_wav(noisy_dir / f"hops{k:03d}.wav")[0]
    ckpt = work / f"{family}_random.tar"
    outputs, launched = {}, {}
    for size in (batch, 1):
        cfg = _inference_config(work, noisy_dir, batch_size=size, recipe=_recipe(family, "infer"))
        toml, n_sub = re.subn(r'(?m)^norm_type = "offline_laplace_norm"$',
                              'norm_type = "offline_gaussian_norm"', cfg.read_text())
        check(n_sub == 1, f"{family} inference recipe has no single norm_type line")
        cfg.write_text(toml)
        if not ckpt.is_file():
            _write_family_checkpoint(ckpt, cfg)
        for kernel in _wrappers().values():
            kernel.reset_counts()
        with _recorded_outputs() as outputs[size]:
            cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(work / f"out_fast_gauss_{size}"),
                      "--device", "cuda"])
            torch.cuda.synchronize()
        launched[size] = _launched()
    calls = [(batch, _frames(2 * sr)), (1, _frames(sr))]
    want = _family_launches([s for b, t in calls for s in _family_stacks(family, b, t, False)],
                            "infer")
    check(launched[batch] == want, f"{family} Gaussian batched: launches by shape "
          f"{launched[batch]}, want {want}")
    worst = 0.0
    for name, noisy in inputs.items():
        got, one = outputs[batch][name], outputs[1][name]
        check(got.shape == one.shape == noisy.shape and bool(np.isfinite(got).all()),
              f"{family} Gaussian {name}: outputs {got.shape}, {one.shape}")
        err = float(np.max(np.abs(got - one)) / max(float(np.max(np.abs(one))), 1e-30))
        worst = max(worst, err)
        check(err <= BATCH_RTOL, f"{family} Gaussian {name}: batched vs batch_size 1 {err:.3e}")
    print(f"batched infer CLI ({family}, offline_gaussian_norm), batch_size {batch}: one flush "
          f"of 4 rows with partial tail blocks (hops {hops[:4]}) and one of 1 without (hops "
          f"{hops[4]}); against batch_size 1, max|diff| / peak {worst:.3e} (tol {BATCH_RTOL:g}); "
          f"launches by shape K1's alone [{card}]")
    return {"batch_err": worst}


# the offline tools' phase: in a subprocess where importing jax or joblib
# fails, as on a host without them (a finder that refuses them; a None in
# sys.modules would break scipy, which looks for a loaded jax there)
TOOL_RUNNER = """
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "joblib"):
            raise ModuleNotFoundError(f"{name} is blocked")

sys.meta_path.insert(0, Refuse())
from fullsubnet_tpu_torch.tools import calculate_metrics
calculate_metrics.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "joblib",
                                                            "fullsubnet_tpu"))
sys.exit(f"imported {bad}" if bad else 0)
"""


def phase_tools(work: Path, card: str, strategies: dict) -> dict:
    """Phase 21: ``python -m fullsubnet_tpu_torch.tools.calculate_metrics``
    on phase 18's ``sub_band_crm_mask`` outputs against the tones they were
    made from, SI_SDR, STOI and WB_PESQ with ``--export_dir``, in a
    subprocess where jax and joblib cannot be imported, over a pool of 3
    spawned workers: exit 0, a .csv and a .xlsx per metric, and each CSV's
    rows and mean equal to the port's metrics computed here on the same
    files."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import read_wav
    from fullsubnet_tpu_torch.metrics import REGISTERED_METRICS

    enhanced = Path(strategies["sub_band_crm_mask"]["enhanced_dir"])
    clean = Path(strategies["clean_dir"])
    export = work / "metrics_export"
    metrics = ("SI_SDR", "STOI", "WB_PESQ")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TOOL_RUNNER, "-R", str(clean), "-E", str(enhanced), "-M",
         ",".join(metrics), "--export_dir", str(export), "--n_jobs", "3"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"calculate_metrics exited {proc.returncode}:\n{proc.stdout}\n"
          f"{proc.stderr}")
    means = {}
    for metric in metrics:
        csv_path, xlsx_path = export / f"{metric}.csv", export / f"{metric}.xlsx"
        check(csv_path.is_file() and xlsx_path.is_file(), f"calculate_metrics: no {metric} export")
        rows = [line.split(",") for line in csv_path.read_text().splitlines()]
        check(rows[0] == ["filename", metric] and rows[-1][0] == "mean" and len(rows) == 5,
              f"calculate_metrics {metric}.csv: {rows}")
        want = {}
        for name, _ in rows[1:-1]:
            ref, _ = read_wav(clean / f"{name}.wav", sr=16000, mono=True)
            est, _ = read_wav(enhanced / f"{name}.wav", sr=16000)
            n = min(len(ref), len(est))
            want[name] = float(REGISTERED_METRICS[metric](ref[:n], est[:n], sr=16000))
        got = {name: float(v) for name, v in rows[1:-1]}
        check(got == want, f"calculate_metrics {metric}: {got}, in-process {want}")
        mean = float(np.mean(list(want.values())))
        check(float(rows[-1][1]) == mean, f"calculate_metrics {metric} mean {rows[-1][1]} vs {mean}")
        means[metric] = mean
    print(f"calculate_metrics (import jax and joblib blocked, 3 spawned workers) on phase 18's "
          f"3 sub_band_crm_mask outputs: {wall:.2f} s wall; means {means}, equal to the port's "
          f"metrics computed in-process; .csv and .xlsx per metric; stdout "
          f"{proc.stdout.strip().splitlines()[1:]} [{card}]")
    return {"means": means, "wall_s": wall}


def phase_family(work: Path, lists: dict, card: str, family: str) -> dict:
    """Phase 17, 18, 19 or 20: the family's recipes on the card, at their
    widths, with random weights from a seed; Improved FullSubNet's on data
    at its recipe's rate."""
    result = {}
    if family.startswith("improved"):
        sr = _family_sr(family)
        if sr != 16000:
            lists = _write_train_data(work / f"train_data_{sr}", sr=sr)
        result["infer"] = _improved_infer(work, card, family)
        result["train_cli"] = _improved_train_cli(work, lists, card, family)
    else:
        if FAMILIES[family]["infer"]:
            result["infer"] = _family_infer(work, card, family)
        if family in FAMILY_STRATEGIES:
            result["strategies"] = _family_strategies(work, card, family)
        if family == "fast_fullsubnet":
            result["gaussian_batched"] = _fast_gaussian_batched(work, card)
        result["train_cli"] = _family_train_cli(work, lists, card, family)
    result["fp32_step"] = _family_card_vs_cpu_step(work, lists, card, family)
    result["step"] = _family_step_numbers(work, lists, card, family, result["fp32_step"])
    return result


# ---------------------------------------------------------------------------
# phase 22: streaming inference (infer/streaming.py): K1 and K1-GRU at T = 1
# from a carried state, the flagship's cumulative-norm recipe hop by hop, the
# multi-stream host's batched hop, and the other families' engines
# ---------------------------------------------------------------------------

CUM_RECIPE = REPO / "recipes" / "dns_interspeech_2020" / "fullsubnet" / "inference_cum.toml"
# the stacks a hop runs, at T = 1 with (h, c) carried: (label, F_in, H, OUT
# (0: head-less), N rows, layers), fixed here from the recipes
STREAM_WALK_CASES = (
    ("full-band, one stream", 257, 512, 257, 1, 2),
    ("full-band, 8 lanes", 257, 512, 257, 8, 2),
    ("sub-band, one stream", 32, 384, 2, 257, 2),
    ("sub-band, 8 lanes", 32, 384, 2, 8 * 257, 2),
    ("sub-band, 64 lanes", 32, 384, 2, 64 * 257, 2),
    ("Fast bottleneck, one stream", 12, 384, 1, 64, 2),
    ("Fast's 257-unit stack, run at 272", 384, 257, 64, 1, 1),
)
# the flagship stream: 10 s in hops of 256 samples (16 ms at 16 kHz)
STREAM_SECONDS = 10
STREAM_HOP_MS = 1e3 * 256 / 16000
# lanes of the multi-stream runs, and the seconds each lane streams
STREAM_LANES = {8: 2, 64: 1}
# the other families' streams: seconds each, from a copy of the recipe
# with the cumulative norm
STREAM_FAMILY_SECONDS = 3
STREAM_FAMILIES = ("fullband_baseline", "fast_fullsubnet", "improved_fullsubnet_16k",
                   "improved_fullsubnet_48k")
# the plain stages the card's streaming path must not run
PLAIN_STAGES = ("plain_fwd_gemm", "plain_lstm_fwd_walk", "plain_gru_fwd_walk",
                "plain_fused_subband_lstm", "plain_fused_subband_gru", "plain_fused_forward")


@contextlib.contextmanager
def _plain_stages_refused(names=PLAIN_STAGES):
    """The plain stages ``names`` of ``ops.subband_lstm`` raise while this
    holds: a card path that ran one would fail."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    saved = {name: getattr(ops, name) for name in names}

    def refuse(name):
        def run(*args, **kwargs):
            raise SmokeFailure(f"{name} ran on the card's path")
        return run

    for name in names:
        setattr(ops, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _quantiles_us(walls) -> dict:
    import numpy as np

    us = 1e6 * np.asarray(walls)
    return {"median_us": float(np.median(us)), "p99_us": float(np.percentile(us, 99)),
            "count": int(us.size)}


_SPIN = {}


def _device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls queued
    behind a spin kernel (``torch.cuda._sleep``) that outlasts the host's
    time to enqueue them all, timed by CUDA events around the calls alone.
    The card then runs them back to back, so unlike events around calls
    that each enqueue a few short kernels, this leaves out the host's time
    to launch them. Fails if the host had not queued every call before the
    spin ended."""
    import torch

    if not _SPIN:  # the spin kernel's cycles a ms on this card
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10**7)
        end.record()
        torch.cuda.synchronize()
        _SPIN["cycles_per_ms"] = 10**7 / start.elapsed_time(end)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_ms = 2e3 * (time.perf_counter() - t0) * reps + 5
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(int(spin_ms * _SPIN["cycles_per_ms"]))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    check(queued_ms < 0.8 * spin_ms,
          f"the host took {queued_ms:.1f} ms to queue {reps} calls behind a {spin_ms:.1f} ms spin")
    return start.elapsed_time(end) / reps


def _stream_step_case(card: str, cell: str, label: str, f_in: int, hidden: int, out_dim: int,
                      n: int, num_layers: int) -> dict:
    """One stack at T = 1 from random non-zero (h0, c0), fp32: the stateful
    stack (``fused_subband_lstm_step``: fwd_gemm and the cell's walk, at
    ``padded_hidden`` units) and the first layer's walk alone, each with its
    final state, against their plain versions on the card; the stack's
    launches from the wrappers' counts around its one compared call; device
    times a call (:func:`_device_ms`) of the stack (its kernels and glue),
    the walk alone, the plain stages and cuDNN with ``hx`` at T = 1 +
    Linear, beside the bound; and the stack's wall a call back to back by
    CUDA events (mean of 50 calls after 5), which at these sizes is the
    host's time to enqueue the launches."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    lstm = cell == "lstm"
    rng = np.random.default_rng(SEED + 22)
    layers, fc = _stack(rng, f_in, hidden, out_dim or 1, dev, cell, num_layers)
    fc = fc if out_dim else None

    def rand(*shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev)

    x = torch.from_numpy(np.abs(rng.standard_normal((1, n, f_in))).astype(np.float32)).to(dev)
    states = [(rand(n, hidden), rand(n, hidden)) if lstm else rand(n, hidden)
              for _ in range(num_layers)]
    flat = lambda st: [v for layer in st for v in (layer if lstm else (layer,))]  # noqa: E731
    plain_walk = ops.plain_lstm_fwd_walk if lstm else ops.plain_gru_fwd_walk
    walk = ops.lstm_fwd_walk if lstm else ops.gru_fwd_walk

    with torch.inference_mode():
        for kernel in _wrappers().values():
            kernel.reset_counts()
        got, got_st = ops.fused_subband_lstm_step(x, *layers, fc, states=states)
        launched = _launched()
        want_launches = _family_launches([(f_in, hidden, out_dim, num_layers, n, 1)], "infer",
                                         cell)
        want, want_st = ops.step_stages(ops.plain_fwd_gemm, plain_walk, x, layers, fc, states,
                                        hidden)
        err = max(float((g - w).abs().max())
                  for g, w in zip([got, *flat(got_st)], [want, *flat(want_st)], strict=True))
        # the first layer's walk alone, at the walks' width, from its state
        width = ops.padded_hidden(hidden)
        wl, _ = ops.pad_stack(layers, fc, width)
        pad = lambda v: torch.nn.functional.pad(v, (0, width - hidden))  # noqa: E731
        bias = wl[0]["b_ih"] + wl[0]["b_hh"] if lstm else wl[0]["b_ih"]
        proj = ops.plain_fwd_gemm(x[0], wl[0]["w_ih"], bias).view(1, n, -1)
        walk_args = ((proj, wl[0]["w_hh"], pad(states[0][0]), pad(states[0][1])) if lstm
                     else (proj, wl[0]["w_hh"], wl[0]["b_hh"], pad(states[0])))
        walk_got, walk_want = walk(*walk_args), plain_walk(*walk_args)
        walk_err = max(float((g - w).abs().max()) for g, w in zip(walk_got, walk_want,
                                                                    strict=True))
        rnn = _cudnn_rnn(layers, f_in, hidden, torch.float32, dev, cell)
        hx = torch.stack([s[0] if lstm else s for s in states])
        hx = (hx, torch.stack([s[1] for s in states])) if lstm else hx

        def cudnn():
            y, _ = rnn(x, hx)
            return y if fc is None else y @ fc["weight"].t() + fc["bias"]

        cudnn_err = float((cudnn() - want).abs().max())
        stack = lambda: ops.fused_subband_lstm_step(x, *layers, fc, states=states)  # noqa: E731
        ms = _device_ms(stack)
        walk_ms = _device_ms(lambda: walk(*walk_args))
        plain_ms = _device_ms(lambda: ops.step_stages(ops.plain_fwd_gemm, plain_walk, x, layers,
                                                      fc, states, hidden))
        cudnn_ms = _device_ms(cudnn)
        wall_ms = cuda_ms(stack, reps=50, warmup=5)
        rows, kr, clusters = walk.tile(n, width, dev)
    state_elems = num_layers * n * hidden * (2 if lstm else 1)
    nbytes = 4 * (n * f_in + weight_elems(f_in, hidden, out_dim, num_layers, cell)
                  + n * (out_dim or hidden) + 2 * state_elems)
    bound_ms, bound_by = bound(stack_flops(1, n, f_in, hidden, out_dim, num_layers, cell),
                               nbytes, "fp32")
    launches = {k: sum(by.values()) for k, by in launched.items()}
    print(f"K1{'' if lstm else '-GRU'} at T = 1, {label} (F_in {f_in}, H {hidden}"
          f"{f' at {width}' if width != hidden else ''}, OUT {out_dim or 'none'}, N {n}, "
          f"{num_layers} layer{'s' if num_layers > 1 else ''}, (h0, c0) carried) [{card}]: "
          f"device time a call (queued behind a spin): stack {1e3 * ms:.1f} us, walk alone "
          f"{1e3 * walk_ms:.1f} us (tile {rows} rows, KR {kr}, {clusters} clusters in flight), "
          f"plain {1e3 * plain_ms:.1f} us, cuDNN + Linear {1e3 * cudnn_ms:.1f} us, bound "
          f"{1e3 * bound_ms:.2f} us ({bound_by}); stack wall a call back to back (CUDA events) "
          f"{1e3 * wall_ms:.1f} us; max|stack-plain| {err:.3e} (output and final states), "
          f"max|walk-plain| {walk_err:.3e} (h stream, h_T, c_T), max|plain-cuDNN| "
          f"{cudnn_err:.3e} (tol {KERNEL_ATOL:g}); launches of the compared call {launched}")
    check(launched == want_launches,
          f"K1 ({cell}) at T = 1, {label}: launches {launched} != {want_launches}")
    check(bool(torch.isfinite(got).all()) and max(err, walk_err, cudnn_err) <= KERNEL_ATOL,
          f"K1 ({cell}) at T = 1, {label}: vs plain {err:.3e}, walk {walk_err:.3e}, cuDNN "
          f"{cudnn_err:.3e} > {KERNEL_ATOL:g}")
    return {"name": f"{label}: F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T 1, "
                    f"{num_layers} layers, {cell}",
            "max_abs_err": max(err, walk_err), "ms": ms, "walk_ms": walk_ms, "wall_ms": wall_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": cudnn_ms, "launches_a_call": launches,
            "launches_by_shape": _str_shapes(launched),
            "tile": {"rows": rows, "kr": kr, "clusters": clusters}}


def _counted(fn):
    """``fn()`` with every wrapper's counts set to 0 just before and read
    just after, the plain stages refused: (its result, the launches by
    kernel and shape, :func:`_launched`)."""
    import torch

    for kernel in _wrappers().values():
        kernel.reset_counts()
    with _plain_stages_refused():
        result = fn()
    torch.cuda.synchronize()
    return result, _launched()


def _str_shapes(launches: dict) -> dict:
    """Launches by kernel and shape with the shapes as strings (JSON's)."""
    return {k: {str(s): v for s, v in by.items()} for k, by in launches.items()}


def _timed_stream(enhancer, wave, hop: int):
    """Push ``wave`` hop by hop, then flush: (the whole enhanced stream, the
    wall of each push that ran exactly one hop, the hops run). Each push
    ends with the enhanced hop on the host."""
    import numpy as np

    ran = [0]
    dev_hop = enhancer._dev_hop

    def counted(*args):
        ran[0] += 1
        return dev_hop(*args)

    enhancer._dev_hop = counted
    state, chunks, walls = enhancer.init_state(), [], []
    try:
        for i in range(0, len(wave), hop):
            before = ran[0]
            t0 = time.perf_counter()
            state, out = enhancer.push(state, wave[i : i + hop])
            wall = time.perf_counter() - t0
            if ran[0] - before == 1:
                walls.append(wall)
            chunks.append(out)
        state, out = enhancer.flush(state)
        chunks.append(out)
    finally:
        del enhancer._dev_hop
    return np.concatenate(chunks), walls, ran[0]


def _lockstep(ms, waves, hop: int = 256):
    """``waves`` through a multi-stream host, one slot each, pushed in
    lockstep a hop a tick, the tails by ``finish``: (each stream's whole
    output, the ticks run, the wall of each poll that ran one tick)."""
    import numpy as np

    ticks = [0]
    dev_hop = ms._dev_hop_batch

    def counted(*args):
        ticks[0] += 1
        return dev_hop(*args)

    ms._dev_hop_batch = counted
    try:
        state = ms.init_state()
        slots = [ms.open_stream(state) for _ in waves]
        got = {slot: [] for slot in slots}
        walls = []
        for i in range(0, len(waves[0]), hop):
            for slot in slots:
                ms.push(state, slot, waves[slot][i : i + hop])
            before = ticks[0]
            t0 = time.perf_counter()
            out = ms.poll(state)
            if ticks[0] - before == 1:
                walls.append(time.perf_counter() - t0)
            for slot, samples in out.items():
                got[slot].append(samples)
        for slot in slots:
            ms.finish(state, slot)
        for slot, samples in ms.poll(state).items():
            got[slot].append(samples)
    finally:
        del ms._dev_hop_batch
    check(all(s is None for s in state["slots"]), "finished lanes were not freed")
    return [np.concatenate(got[slot]) for slot in slots], ticks[0], walls


def _stream_wave(sr: int, seconds: float, seed: int):
    """A tone in noise at ``sr`` from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _peak_err(got, want) -> float:
    import numpy as np

    n = min(len(got), len(want))
    return float(np.max(np.abs(got[:n] - want[:n])) / max(float(np.max(np.abs(want[:n]))), 1e-30))


def _launches_per_hop(counts: dict, hops: int) -> dict:
    return {k: {str(s): v / hops for s, v in by.items()} for k, by in counts.items()}


def _stream_flagship(work: Path, card: str) -> dict:
    """The cumulative-norm recipe at full width (``inference_cum.toml``,
    random weights from a seed) built by the port's Inferencer on the card,
    ``inferencer.model`` wrapped in ``StreamingEnhancer``: 10 s pushed in
    256-sample hops with the plain stages refused; K1's launches a hop from
    the wrappers' counts; the per-hop wall (push to the enhanced hop on the
    host) and the real-time factor; a profile of a 50-push stream (device
    busy and launches a hop); the stream against the same stream on
    the CPU and against the card's offline ``full_band_crm_mask`` in the
    interior, as shares of the peak. Returns the numbers and the card's
    Inferencer for the multi-stream runs."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import StreamingEnhancer
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    noisy_dir = work / "stream_flagship"
    noisy_dir.mkdir()
    write_wav(noisy_dir / "wave10.wav", _stream_wave(16000, STREAM_SECONDS, SEED + 22), 16000)
    wave = read_wav(noisy_dir / "wave10.wav")[0]
    cfg = _inference_config(work, noisy_dir, "LSTM", recipe=CUM_RECIPE)
    ckpt = work / "flagship_cum_random.tar"
    _write_flagship_checkpoint(ckpt, cfg)
    config = load_config(cfg)
    inferencer = Inferencer(config, str(ckpt), None, device="cuda")
    hop = inferencer.acoustics["hop_length"]
    enhancer = StreamingEnhancer(inferencer.model, inferencer.acoustics["n_fft"], hop)
    _timed_stream(enhancer, wave[:16000], hop)  # warm-up: 1 s
    (stream, walls, hops), launched = _counted(lambda: _timed_stream(enhancer, wave, hop))
    want = _scaled(_family_launches([(257, 512, 257, 2, 1, 1), (32, 384, 2, 2, 257, 1)],
                                    "infer"), hops)
    check(launched == want, f"streaming launches {launched} != {want} ({hops} hops)")
    per_hop = sum(w.launches for w in _wrappers().values()) / hops
    check(per_hop == 10, f"K1 launches a hop {per_hop}, not 10")
    # where a hop's time goes: the device's busy and idle share and its
    # kernels (and so its launches) over a stream of 50 pushes and the flush
    profiled = {}

    def profiled_stream():
        profiled["hops"] = _timed_stream(enhancer, wave[: 50 * hop], hop)[2]
        torch.cuda.synchronize()

    rows = _profile(profiled_stream, "a streamed 50-push wave", card)
    busy_us = sum(r[0] for r in rows)
    print(f"  over its {profiled['hops']} hops: device busy {busy_us / profiled['hops']:.1f} us "
          f"a hop, {sum(r[2] for r in rows) / profiled['hops']:.1f} kernel launches a hop")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    t0 = time.perf_counter()
    cpu_stream, _, _ = _timed_stream(StreamingEnhancer(cpu.model, 512, hop), wave, hop)
    cpu_s = time.perf_counter() - t0
    offline = inferencer.full_band_crm_mask(torch.from_numpy(wave)[None].cuda())
    # the stream drains with zeros where the offline STFT reflects the tail,
    # and the last frames' cRMs read it through the look-ahead: the last
    # n_fft // 2 + (1 + look_ahead) hops of samples differ
    interior = len(wave) - (256 + 3 * hop)
    err_cpu = _peak_err(stream, cpu_stream)
    err_offline = _peak_err(stream[:interior], offline[:interior])
    q = _quantiles_us(walls)
    rtf = q["median_us"] / (1e3 * STREAM_HOP_MS)
    print(f"streaming flagship (inference_cum.toml, full width, LSTM) [{card}]: {STREAM_SECONDS} s "
          f"in {hop}-sample hops, {hops} hops with the flush; per-hop wall (push to the "
          f"enhanced hop on the host) median {q['median_us']:.1f} us, p99 {q['p99_us']:.1f} us "
          f"over {q['count']} hops after a 1 s warm-up stream, real-time factor {rtf:.4f} of "
          f"the {STREAM_HOP_MS:g} ms hop; K1 launches a hop {per_hop:g} (fwd_gemm "
          f"{sum(launched['fwd_gemm'].values()) / hops:g}, lstm_fwd_walk "
          f"{sum(launched['lstm_fwd_walk'].values()) / hops:g}), no plain stage; "
          f"stream vs the CPU stream max|diff| / peak {err_cpu:.3e}, vs the card's offline "
          f"full_band_crm_mask (first {interior} samples) {err_offline:.3e} (tol "
          f"{VAL_WAVE_RTOL:g}); the CPU stream took {cpu_s:.1f} s")
    check(bool(np.isfinite(stream).all()) and len(stream) >= len(wave),
          f"streamed {len(stream)} samples for {len(wave)}")
    check(max(err_cpu, err_offline) <= VAL_WAVE_RTOL,
          f"streaming flagship: vs CPU {err_cpu:.3e}, vs offline {err_offline:.3e}")
    return {"hops": hops, **q, "rtf": rtf, "launches_per_hop": _launches_per_hop(launched, hops),
            "k1_launches_per_hop": per_hop, "err_cpu": err_cpu, "err_offline": err_offline,
            "inferencer": inferencer}


def _stream_lanes(card: str, model, lanes: int, seconds: float) -> dict:
    """``MultiStreamEnhancer`` with ``lanes`` streams of ``seconds`` each,
    pushed in lockstep one hop a tick (the tails by ``finish``, riding the
    shared ticks): the wall of each poll that ran one tick, the real-time
    factor of a tick, K1's launches a tick, and each lane against its own
    ``StreamingEnhancer`` stream on the card."""
    from fullsubnet_tpu_torch.infer import MultiStreamEnhancer, StreamingEnhancer

    hop = 256
    waves = [_stream_wave(16000, seconds, SEED + 100 + j) for j in range(lanes)]
    ms = MultiStreamEnhancer(model, 512, hop, max_streams=lanes)
    (outs, ticks, walls), launched = _counted(lambda: _lockstep(ms, waves, hop))
    want = _scaled(_family_launches([(257, 512, 257, 2, lanes, 1),
                                     (32, 384, 2, 2, 257 * lanes, 1)], "infer"), ticks)
    check(launched == want, f"{lanes} lanes: launches {launched} != {want}")
    walls = walls[5:]  # the first ticks warm the lanes' shapes up
    errs = []
    for out, wave in zip(outs, waves, strict=True):
        single, _, _ = _timed_stream(StreamingEnhancer(model, 512, hop), wave, hop)
        errs.append(_peak_err(out, single))
    q = _quantiles_us(walls)
    rtf = q["median_us"] / (1e3 * STREAM_HOP_MS)
    per_tick = sum(w.launches for w in _wrappers().values()) / ticks
    print(f"MultiStreamEnhancer, {lanes} lanes x {seconds:g} s [{card}]: {ticks} ticks; "
          f"tick wall median {q['median_us'] / 1e3:.3f} ms, p99 {q['p99_us'] / 1e3:.3f} ms "
          f"over {q['count']} ticks, real-time factor of a tick {rtf:.4f} ({rtf / lanes:.5f} "
          f"a stream); K1 launches a tick {per_tick:g} "
          f"(full band N = {lanes}, sub band N = {257 * lanes}); every lane against its own "
          f"StreamingEnhancer stream max|diff| / peak {max(errs):.3e} (tol {BATCH_RTOL:g})")
    check(max(errs) <= BATCH_RTOL, f"{lanes} lanes vs single streams {max(errs):.3e}")
    return {"lanes": lanes, "ticks": ticks, **q, "rtf": rtf,
            "launches_per_tick": _launches_per_hop(launched, ticks), "err_single": max(errs)}


def _stream_family(work: Path, card: str, family: str) -> dict:
    """A family's engine at its recipe's width with the cumulative norm
    written into a copy of its TOML (the full-band baseline's and Fast's
    inference TOMLs; Improved FullSubNet's written from its train recipe),
    random weights from a seed: 3 s through ``StreamingEnhancer`` on the card
    in its recipe's hops, the plain stages refused; K1's launches a hop
    held to the family's stacks at T = 1; the per-hop wall; the stream
    against the same stream on the CPU."""
    import numpy as np

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import StreamingEnhancer
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    sr = _family_sr(family)
    noisy_dir = work / f"stream_{family}"
    noisy_dir.mkdir()
    write_wav(noisy_dir / "wave.wav", _stream_wave(sr, STREAM_FAMILY_SECONDS, SEED + 23), sr)
    wave = read_wav(noisy_dir / "wave.wav")[0]
    if family.startswith("improved"):
        cfg = _written_inference_config(work, family, noisy_dir, "time_domain", 1)
    else:
        cfg = _inference_config(work, noisy_dir, recipe=_recipe(family, "infer"))
    toml, n_sub = re.subn(r'(?m)^norm_type = ".*"$', 'norm_type = "cumulative_laplace_norm"',
                          cfg.read_text())
    check(n_sub >= 1, f"{family}: no norm_type line")
    cfg.write_text(toml)
    ckpt = work / f"{family}_stream_random.tar"
    _write_family_checkpoint(ckpt, cfg)
    config = load_config(cfg)
    gpu = Inferencer(config, str(ckpt), None, device="cuda")
    n_fft, hop = gpu.acoustics["n_fft"], gpu.acoustics["hop_length"]
    enhancer = StreamingEnhancer(gpu.model, n_fft, hop)
    _timed_stream(enhancer, wave[: 20 * hop], hop)  # warm-up
    (stream, walls, hops), launched = _counted(lambda: _timed_stream(enhancer, wave, hop))
    want = _scaled(_family_launches(_family_stacks(family, 1, 1, False), "infer"), hops)
    check(launched == want, f"{family} streaming launches {launched} != {want}")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    cpu_stream, _, _ = _timed_stream(StreamingEnhancer(cpu.model, n_fft, hop), wave, hop)
    err = _peak_err(stream, cpu_stream)
    q = _quantiles_us(walls)
    hop_ms = 1e3 * hop / sr
    per_hop = sum(w.launches for w in _wrappers().values()) / hops
    print(f"streaming {family} (cumulative norm, recipe width; n_fft {n_fft}, hop {hop} at "
          f"{sr} Hz) [{card}]: {hops} hops; per-hop wall median {q['median_us']:.1f} us, p99 "
          f"{q['p99_us']:.1f} us over {q['count']} hops, real-time factor "
          f"{q['median_us'] / (1e3 * hop_ms):.4f} of the {hop_ms:g} ms hop; K1 launches a hop "
          f"{per_hop:g}; card vs CPU stream max|diff| / peak {err:.3e} (tol {VAL_WAVE_RTOL:g})")
    check(bool(np.isfinite(stream).all()) and err <= VAL_WAVE_RTOL,
          f"{family} stream card vs CPU {err:.3e}")
    return {"hops": hops, **q, "rtf": q["median_us"] / (1e3 * hop_ms), "hop_ms": hop_ms,
            "launches_per_hop": _launches_per_hop(launched, hops), "err_cpu": err}


def phase_streaming(work: Path, card: str) -> dict:
    """Phase 22: K1 and K1-GRU at T = 1 from carried states at every stack
    shape a hop runs; the flagship's cumulative-norm recipe streamed; the
    multi-stream host at 8 and 64 lanes; the other families' engines."""
    import torch

    t1 = {cell: [_stream_step_case(card, cell, *case) for case in STREAM_WALK_CASES]
          for cell in ("lstm", "gru")}
    flagship = _stream_flagship(work, card)
    inferencer = flagship.pop("inferencer")
    lanes = {str(s): _stream_lanes(card, inferencer.model, s, secs)
             for s, secs in STREAM_LANES.items()}
    del inferencer
    torch.cuda.empty_cache()
    families = {f: _stream_family(work, card, f) for f in STREAM_FAMILIES}
    return {"t1": t1, "flagship": flagship, "lanes": lanes, "families": families}


# -- phase 23: serving ---------------------------------------------------------------------

# the offline artifact's buckets: a 10 s utterance needs one of at least
# 10 s + n_fft // 2 samples, and 11 s is the Inferencer's own bucket for it
SERVE_SECONDS = (2, 11)
SERVE_BUCKET = 11 * 16000
SERVE_BATCH = 8
# the batched program's utterances (one bucket) and the short one (2 s)
SERVE_BATCH_SECONDS = (3, 4, 5, 6, 7, 8, 9, 10)
SERVE_SHORT_SECONDS = 1.5
SERVE_LANES = 8
SERVE_LANE_SECONDS = 2
SERVE_GRU_SECONDS = 3
# a served program against the live eager path on the same card, as a share
# of the live output's peak: the same kernels on the same inputs
SERVE_RTOL = 1e-5
# what the child may not import: loading and serving need no model code
SERVE_REFUSED = ("jax", "jaxlib", "fullsubnet_tpu", "fullsubnet_tpu_torch.models",
                 "fullsubnet_tpu_torch.infer.streaming", "fullsubnet_tpu_torch.infer.inferencer",
                 "fullsubnet_tpu_torch.train")
# the child: import the served classes behind a finder that refuses
# SERVE_REFUSED, serve the artifacts (_serve_in_child) and fail if a
# refused module was imported after all
SERVE_CHILD = """
import importlib.abc, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as smoke

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if smoke._refused(name):
            raise ModuleNotFoundError(f"{name} is blocked in the serving process")

sys.meta_path.insert(0, Refuse())
smoke._serve_in_child(json.loads(sys.argv[2]))
bad = sorted(m for m in sys.modules if smoke._refused(m))
sys.exit(f"the serving process imported {bad}" if bad else 0)
"""


def _refused(name: str) -> bool:
    return any(name == r or name.startswith(r + ".") for r in SERVE_REFUSED)




def _serve_runs(offline, offline_batch, stream, lanes, gru_stream, inputs: dict) -> dict:
    """The phase's runs on served or live objects alike: the B=1 program on
    the 10 s wave (counted once after a warm-up, then 3 timed calls) and on
    the short wave, the batched program on its utterances, the flagship
    stream (a 1 s warm-up stream, then 10 s counted), the lanes in lockstep
    and the GRU stream; ``offline`` and ``offline_batch`` map a list of
    waves to their outputs. Returns the outputs, launches and walls."""
    import numpy as np

    runs = {}
    wave10 = inputs["wave10"]
    offline([wave10])  # warm-up
    (out,), launches = _counted(lambda: offline([wave10]))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        offline([wave10])
        walls.append(time.perf_counter() - t0)
    runs["b1"] = {"out": out, "launches": launches, "rtf": float(np.median(walls)) / 10}
    (out,), launches = _counted(lambda: offline([inputs["short"]]))
    runs["short"] = {"out": out, "launches": launches}
    offline_batch(inputs["batch"])  # warm-up
    outs, launches = _counted(lambda: offline_batch(inputs["batch"]))
    runs["batch"] = {"outs": outs, "launches": launches}
    _timed_stream(stream, wave10[:16000], 256)  # warm-up
    (out, walls, hops), launches = _counted(lambda: _timed_stream(stream, wave10, 256))
    runs["stream"] = {"out": out, "launches": launches, "hops": hops, **_quantiles_us(walls)}
    _lockstep(lanes, [w[: 16 * 256] for w in inputs["lanes"]])  # warm-up
    (outs, ticks, walls), launches = _counted(lambda: _lockstep(lanes, inputs["lanes"]))
    runs["lanes"] = {"outs": outs, "launches": launches, "ticks": ticks,
                     **_quantiles_us(walls[5:])}
    _timed_stream(gru_stream, inputs["gru"][:16000], 256)  # warm-up
    (out, walls, hops), launches = _counted(lambda: _timed_stream(gru_stream, inputs["gru"], 256))
    runs["gru"] = {"out": out, "launches": launches, "hops": hops, **_quantiles_us(walls)}
    return runs


def _serve_inputs(arrays: dict) -> dict:
    """The runs' inputs from the arrays of ``inputs.npz``: the numbered
    batch utterances and lane waves as lists, in order."""
    def numbered(prefix):
        return [arrays[f"{prefix}{i}"] for i in range(sum(k.startswith(prefix) for k in arrays))]

    return {"wave10": arrays["wave10"], "short": arrays["short"], "gru": arrays["gru"],
            "batch": numbered("batch"), "lanes": numbered("lane")}


def _serve_in_child(spec: dict) -> None:
    """Run in the serving process (``SERVE_CHILD``): load the artifacts of
    ``spec`` with the port's serving classes alone, run
    :func:`_serve_runs` on them, and write the outputs and one JSON file of
    launches and walls into ``spec["out"]``."""
    import numpy as np

    from fullsubnet_tpu_torch.serving import (
        MultiStreamServingModel,
        ServingModel,
        StreamingServingModel,
    )

    out = Path(spec["out"])
    inputs = _serve_inputs(dict(np.load(out / "inputs.npz")))
    t0 = time.perf_counter()
    b1 = ServingModel.load(spec["b1"])
    b8 = ServingModel.load(spec["b8"])
    loaded = [b1, b8, StreamingServingModel.load(spec["stream"]),
              MultiStreamServingModel.load(spec["lanes"]),
              StreamingServingModel.load(spec["gru"])]
    load_s = time.perf_counter() - t0
    runs = _serve_runs(lambda waves: [b1.enhance(w) for w in waves], b8.enhance_batch, *loaded[2:],
                       inputs)
    for run in runs.values():
        run["launches"] = _str_shapes(run["launches"])
    arrays = {"b1": runs["b1"].pop("out"), "short": runs["short"].pop("out"),
              "stream": runs["stream"].pop("out"), "gru": runs["gru"].pop("out")}
    arrays.update({f"batch{i}": v for i, v in enumerate(runs["batch"].pop("outs"))})
    arrays.update({f"lane{i}": v for i, v in enumerate(runs["lanes"].pop("outs"))})
    np.savez(out / "served.npz", **arrays)
    (out / "served.json").write_text(json.dumps({"load_s": load_s, **runs}))


def phase_serving(work: Path, card: str) -> dict:
    """Phase 23: the flagship exported and served (``serving.py``).

    On the card, from random full-width weights: ``inference.toml``
    exported bucketed at 2 s and 11 s (batch 1) and at 11 s for batch 8;
    ``inference_cum.toml`` as a stream and as 8 lanes; its GRU copy as a
    stream. A child process loads and serves them with the port's serving
    classes alone, behind a finder that refuses jax, the JAX package and
    the port's model, engine, Inferencer and trainer modules; the plain
    stages are refused there and here. The same runs on the live eager
    path here: the Inferencer's ``enhance_bucket`` on the same buckets,
    ``StreamingEnhancer``, ``MultiStreamEnhancer``. Each served output is
    held to the live one within ``SERVE_RTOL`` of its peak, and the served
    launches of K1 / K1-GRU by shape to the live path's (10 a flagship
    hop); the served hop's median and p99 wall and the served RTF at B=1 x
    10 s are printed beside the live path's."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.infer import MultiStreamEnhancer, StreamingEnhancer
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer
    from fullsubnet_tpu_torch.serving import export_enhancer, export_streaming_enhancer

    root = work / "serving"
    root.mkdir()
    cfgs, ckpts = {}, {}
    for key, cell, recipe in (("offline", "LSTM", RECIPE), ("cum", "LSTM", CUM_RECIPE),
                              ("gru", "GRU", CUM_RECIPE)):
        cfgs[key] = _inference_config(root, root, cell, recipe=recipe)
        ckpts[key] = root / f"{key}_random.tar"
        _write_flagship_checkpoint(ckpts[key], cfgs[key])
    configs = {k: load_config(v) for k, v in cfgs.items()}
    dirs = {k: root / f"artifact_{k}" for k in ("b1", "b8", "stream", "lanes", "gru")}
    t0 = time.perf_counter()
    export_enhancer(configs["offline"], str(ckpts["offline"]), dirs["b1"], seconds=SERVE_SECONDS)
    export_enhancer(configs["offline"], str(ckpts["offline"]), dirs["b8"],
                    seconds=SERVE_SECONDS[-1:], batch=SERVE_BATCH)
    export_streaming_enhancer(configs["cum"], str(ckpts["cum"]), dirs["stream"])
    export_streaming_enhancer(configs["cum"], str(ckpts["cum"]), dirs["lanes"],
                              streams=SERVE_LANES)
    export_streaming_enhancer(configs["gru"], str(ckpts["gru"]), dirs["gru"])
    export_s = time.perf_counter() - t0
    nbytes = {k: sum(p.stat().st_size for p in d.iterdir()) for k, d in dirs.items()}
    weight_bytes = (dirs["b1"] / "weights.pt").stat().st_size
    program_bytes = {f"{k}/{p.name}": p.stat().st_size for k, d in dirs.items()
                     for p in d.glob("*.pt2")}
    # the weights are stored once, in weights.pt: no program holds a copy
    check(max(program_bytes.values()) < weight_bytes / 4,
          f"a program as large as the weights ({weight_bytes} bytes): {program_bytes}")

    inputs = {"wave10": _stream_wave(16000, 10, SEED + 30),
              "short": _stream_wave(16000, SERVE_SHORT_SECONDS, SEED + 31),
              "gru": _stream_wave(16000, SERVE_GRU_SECONDS, SEED + 32)}
    inputs.update({f"batch{i}": _stream_wave(16000, s, SEED + 40 + i)
                   for i, s in enumerate(SERVE_BATCH_SECONDS)})
    inputs.update({f"lane{i}": _stream_wave(16000, SERVE_LANE_SECONDS, SEED + 50 + i)
                   for i in range(SERVE_LANES)})
    np.savez(root / "inputs.npz", **inputs)

    # the child serves while this process holds no model yet
    spec = {"out": str(root), **{k: str(d) for k, d in dirs.items()}}
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", SERVE_CHILD, str(REPO), json.dumps(spec)],
                           capture_output=True, text=True, timeout=600, cwd=REPO)
    child_s = time.perf_counter() - t0
    check(child.returncode == 0, f"the serving process failed ({child.returncode}):\n"
                                 f"{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
    served = json.loads((root / "served.json").read_text())
    served_out = dict(np.load(root / "served.npz"))

    # the live eager path on the same inputs
    offline = Inferencer(configs["offline"], str(ckpts["offline"]), None, device="cuda")
    cum = Inferencer(configs["cum"], str(ckpts["cum"]), None, device="cuda")
    gru = Inferencer(configs["gru"], str(ckpts["gru"]), None, device="cuda")

    def live_offline(waves):  # each wave alone, in the bucket the served model picks
        buckets = [int(s * 16000) for s in SERVE_SECONDS]
        return [offline.enhance_bucket([w], next(b for b in buckets if b >= len(w) + 256))[0]
                for w in waves]

    live = _serve_runs(
        live_offline, lambda waves: offline.enhance_bucket(waves, SERVE_BUCKET),
        StreamingEnhancer(cum.model, 512, 256),
        MultiStreamEnhancer(cum.model, 512, 256, max_streams=SERVE_LANES),
        StreamingEnhancer(gru.model, 512, 256), _serve_inputs(inputs))
    pairs = {"b1": (served_out["b1"], live["b1"]["out"]),
             "short": (served_out["short"], live["short"]["out"]),
             "stream": (served_out["stream"], live["stream"]["out"]),
             "gru": (served_out["gru"], live["gru"]["out"])}
    pairs.update({f"batch{i}": (served_out[f"batch{i}"], w)
                  for i, w in enumerate(live["batch"]["outs"])})
    pairs.update({f"lane{i}": (served_out[f"lane{i}"], w)
                  for i, w in enumerate(live["lanes"]["outs"])})
    errs = {}
    for key, (got, want) in pairs.items():
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"served {key}: {got.shape} vs live {want.shape}")
        errs[key] = _peak_err(got, want)
    for key in ("b1", "short", "batch", "stream", "lanes", "gru"):
        live[key]["launches"] = _str_shapes(live[key]["launches"])
        check(served[key]["launches"] == live[key]["launches"],
              f"served {key} launches {served[key]['launches']} != live "
              f"{live[key]['launches']}")
    per_hop = {key: sum(sum(by.values()) for by in served[key]["launches"].values())
               / served[key]["hops"] for key in ("stream", "gru")}
    check(per_hop["stream"] == 10 and per_hop["gru"] == 10,
          f"served K1 launches a hop {per_hop}, not 10")
    check(set(served["stream"]["launches"]) == {"fwd_gemm", "lstm_fwd_walk"}
          and set(served["gru"]["launches"]) == {"fwd_gemm", "gru_fwd_walk"},
          f"served streams launched {set(served['stream']['launches'])}, "
          f"{set(served['gru']['launches'])}")
    worst = max(errs.values())
    hop_us = 1e3 * STREAM_HOP_MS
    print(f"serving (phase 23) [{card}]: exported 5 artifacts in {export_s:.1f} s (bytes: "
          f"{nbytes}; the weights {weight_bytes} once in each, the largest program "
          f"{max(program_bytes.values())}); the serving process (jax, the "
          f"JAX package, models, engines, Inferencer, trainer refused) loaded them in "
          f"{served['load_s']:.1f} s and ran {child_s:.1f} s in all")
    print(f"  served vs live eager, max|diff| / peak: {json.dumps(errs)} (tol {SERVE_RTOL:g})")
    print(f"  B=1 x 10 s ({SERVE_BUCKET}-sample bucket): served RTF {served['b1']['rtf']:.5f}, "
          f"live RTF {live['b1']['rtf']:.5f}; K1 launches a call served "
          f"{served['b1']['launches']}, live the same")
    for key, label in (("stream", "flagship stream (inference_cum.toml, LSTM)"),
                       ("gru", "GRU stream (inference_cum.toml with sequence_model = GRU)")):
        print(f"  {label}: per-hop wall served median {served[key]['median_us']:.1f} us, p99 "
              f"{served[key]['p99_us']:.1f} us (RTF {served[key]['median_us'] / hop_us:.4f}); "
              f"live median {live[key]['median_us']:.1f} us, p99 {live[key]['p99_us']:.1f} us "
              f"(RTF {live[key]['median_us'] / hop_us:.4f}); {served[key]['hops']} hops, K1 "
              f"launches a hop {per_hop[key]:g}, no plain stage")
    print(f"  {SERVE_LANES} lanes x {SERVE_LANE_SECONDS} s: tick wall served median "
          f"{served['lanes']['median_us'] / 1e3:.3f} ms, p99 {served['lanes']['p99_us'] / 1e3:.3f}"
          f" ms; live median {live['lanes']['median_us'] / 1e3:.3f} ms, p99 "
          f"{live['lanes']['p99_us'] / 1e3:.3f} ms; {served['lanes']['ticks']} ticks")
    check(worst <= SERVE_RTOL, f"served vs live {worst:.3e} > {SERVE_RTOL:g}")
    strip = ("out", "outs")
    return {"export_s": export_s, "child_s": child_s, "load_s": served["load_s"],
            "bytes": nbytes, "weight_bytes": weight_bytes, "program_bytes": program_bytes,
            "errs": errs,
            "served": served, "per_hop": per_hop,
            "live": {k: {kk: vv for kk, vv in v.items() if kk not in strip}
                     for k, v in live.items()}}


# ---------------------------------------------------------------------------
# phase 24: training at scale: gradient accumulation, device synthesis and
# data-parallel training over torch.distributed
# ---------------------------------------------------------------------------

SCALE_BATCH = 32
SCALE_ACCUM = 2
# the loader's steady rate: the 64 clips listed this many times over, 128
# batches of 32 at the recipe's num_workers; the first num_workers x
# prefetch_factor batches are made at once, so the rate is timed over the
# batches after them (LOADER_PREFETCH is torch's default)
LOADER_REPEAT = 64
LOADER_PREFETCH = 2
# device-synthesised batches against the host mixer, each row within this
# share of its peak: f32 components (cuFFT against scipy's FFT, float32
# rounding); int16 components (the smoke's wavs are 16-bit PCM, so the
# transfer is exact and only the arithmetic differs; the bound allows for
# a source off the int16 grid)
SYNTH_RTOL = {"f32": 1e-5, "int16": 1e-4}
# the accumulated step against the monolithic one: the loss, and each
# gradient within this share of its largest magnitude
ACCUM_RTOL = {"bf16": (STEP_LOSS_RTOL_BF16, GRAD_RTOL_BF16), "fp32": (STEP_LOSS_RTOL, STEP_GRAD_RTOL)}
SCALE_CHILD_TIMEOUT = 420
# a gloo rank's parameter update against one clip and optimizer step
# replayed on its gradients, max error in units of the learning rate
UPDATE_TOL_OF_LR = 1e-3


def _errors_by_key(got: dict, want: dict) -> dict:
    """Each tensor's max|g - w| / max|w| (``_rel_errs``), by key."""
    return dict(zip(want, _rel_errs([got[k] for k in want], want.values())))


def _stage_launches(counts: dict, cell: str = "LSTM") -> dict:
    """The training kernels' launches by the stage they served: the
    tensor-core GEMM split into the forward's and the backward's shapes,
    the fwd_gemm (fp32) likewise, and the walks and the dW stage whole."""
    fwd_keys = set(_tc_launches_by_shape(cell, 1)[0])
    f32_fwd_keys = _f32_fwd_gemm_shapes(cell)
    tc = counts.get("tc_gemm", (0, {}))[1]
    f32 = counts.get("fwd_gemm", (0, {}))[1]
    out = {"tc_gemm_fwd": sum(v for k, v in tc.items() if k in fwd_keys),
           "tc_gemm_bwd": sum(v for k, v in tc.items() if k not in fwd_keys),
           "fwd_gemm_fwd": sum(v for k, v in f32.items() if k in f32_fwd_keys),
           "fwd_gemm_bwd": sum(v for k, v in f32.items() if k not in f32_fwd_keys)}
    c = cell.lower()
    for name in (f"{c}_train_walk", f"{c}_walk", f"{c}_train_walk_f32", f"{c}_walk_f32",
                 "dw_tma", "dw_gemm"):
        out[name] = counts.get(name, (0, {}))[0]
    forms = counts.get(f"{c}_train_walk_f32", (0, {}, {}))[2:]
    for form in ("streaming", "cluster"):
        out[f"{c}_train_walk_f32 {form}"] = forms[0].get(form, 0) if forms else 0
    return out


def _named_counts() -> dict:
    """Every training wrapper's (launches, by shape, by form) by name."""
    own, others = _training_kernels("LSTM")
    return {k: (w.launches, dict(w.launches_by_shape), dict(w.launches_by_form))
            for k, w in {**own, **others}.items()}


def _scale_accumulation(work: Path, lists: dict, card: str) -> dict:
    """(a) One optimizer step at B = 32 x 3.072 s with G = 2 against the
    monolithic step, same weights and batch, bf16 and fp32: loss and
    pre-clip gradients, the launches by shape (twice the stacks of a
    microbatch of 16), then each step's median wall and peak memory."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    out, launches = {}, {}
    for dtype, amp in (("bf16", "true"), ("fp32", "false")):
        gc.collect()
        torch.cuda.empty_cache()
        trainers = {g: Trainer(load_config(_train_config(
            work, lists, f"scale_{dtype}_g{g}", use_amp=amp, num_workers=0,
            grad_accum_steps=g)), output_dir=str(work / f"scale_{dtype}_g{g}"), device="cuda")
            for g in (1, SCALE_ACCUM)}
        noisy, clean = (v.cuda() for v in _first_batch(trainers[1], SCALE_BATCH))
        losses, grads, counts = {}, {}, {}
        for g, trainer in trainers.items():
            check(trainer.accum_split(SCALE_BATCH) == g, f"split {trainer.accum_split(SCALE_BATCH)}")
            for kernel in _wrappers().values():
                kernel.reset_counts()
            loss = trainer.loss_and_grads(noisy, clean)
            torch.cuda.synchronize()
            counts[g] = _named_counts()
            losses[g] = float(loss)
            grads[g] = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
            if trainer.clip:
                torch.nn.utils.clip_grad_norm_(trainer.model.parameters(), trainer.clip)
            trainer.optimizer.step()
        loss_tol, grad_tol = ACCUM_RTOL[dtype]
        rel = _errors_by_key(grads[SCALE_ACCUM], grads[1])
        worst = max(rel, key=rel.get)
        loss_rel = abs(losses[SCALE_ACCUM] - losses[1]) / abs(losses[1])
        micro = SCALE_BATCH // SCALE_ACCUM
        if dtype == "bf16":
            _check_step_launches(counts[SCALE_ACCUM], "LSTM", SCALE_ACCUM,
                                 f"the accumulated bf16 step (G={SCALE_ACCUM})", batch=micro)
            _check_step_launches(counts[1], "LSTM", 1, "the monolithic bf16 step")
        else:
            per = _stage_launches(counts[SCALE_ACCUM])
            want = {"fwd_gemm_fwd": 6 * SCALE_ACCUM, "fwd_gemm_bwd": 8 * SCALE_ACCUM,
                    "lstm_train_walk_f32": 4 * SCALE_ACCUM, "lstm_walk_f32": 4 * SCALE_ACCUM,
                    "dw_tma": 4 * SCALE_ACCUM}
            check({k: per[k] for k in want} == want
                  and not any(per[k] for k in ("tc_gemm_fwd", "tc_gemm_bwd", "lstm_walk",
                                               "lstm_train_walk")),
                  f"the accumulated fp32 step's launches {per}, want {want}")
            walk_keys = set(counts[SCALE_ACCUM]["lstm_walk_f32"][1])
            check(walk_keys == {(micro, 512), (micro * 128, 384)},
                  f"the accumulated fp32 step's walks ran at {walk_keys}")
        launches[f"accumulated step G={SCALE_ACCUM}, {dtype}"] = _stage_launches(counts[SCALE_ACCUM])
        print(f"accumulated step, flagship LSTM B={SCALE_BATCH} x 3.072 s, {dtype}: G="
              f"{SCALE_ACCUM} loss {losses[SCALE_ACCUM]:.8e} vs G=1 {losses[1]:.8e} (rel "
              f"{loss_rel:.2e}, tol {loss_tol:g}); gradient error / max, worst {rel[worst]:.2e} "
              f"at {worst} (tol {grad_tol:g}); launches G={SCALE_ACCUM} "
              f"{_stage_launches(counts[SCALE_ACCUM])}, G=1 {_stage_launches(counts[1])} [{card}]")
        check(loss_rel <= loss_tol, f"{dtype} accumulated loss vs monolithic {loss_rel:.2e}")
        check(rel[worst] <= grad_tol, f"{dtype} accumulated gradient {worst} {rel[worst]:.2e}")

        for g, trainer in trainers.items():
            def step():
                trainer.train_step(noisy, clean)
                torch.cuda.synchronize()

            for _ in range(2):
                step()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                step()
                times.append(time.perf_counter() - t0)
            median = sorted(times)[len(times) // 2]
            peak = torch.cuda.max_memory_allocated() / 2**30
            audio_s = SCALE_BATCH * noisy.shape[1] / 16000
            out[f"{dtype} G={g}"] = {"ms": median * 1e3, "peak_gib": peak,
                                     "audio_s_per_s": audio_s / median}
            print(f"train step B={SCALE_BATCH} x 3.072 s, {dtype}, G={g}: median "
                  f"{median * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
                  f"{audio_s / median:.2f} audio-s/s, peak memory {peak:.2f} GiB [{card}]")
        del trainers
    return {"steps": out, "launches": launches}


def _loader_rate(dataset, workers: int) -> dict:
    """The port's loader over the whole epoch of ``dataset`` in batches of
    SCALE_BATCH: the seconds to the first batch, and the seconds a batch
    in the steady state. The workers start num_workers x prefetch_factor
    batches at once, which then arrive together; the rate is timed from
    the last of them to the last batch, a multiple of num_workers batches
    later, so that both ends fall at the same point of the workers'
    round."""
    from fullsubnet_tpu_torch.data.loader import DataLoader

    loader = DataLoader(dataset, batch_size=SCALE_BATCH, shuffle=True, drop_last=True,
                        num_workers=workers, seed=SEED)
    loader.set_epoch(1)
    warm = workers * LOADER_PREFETCH
    check((len(loader) - warm) % workers == 0 and len(loader) >= 4 * warm,
          f"{len(loader)} batches do not time {workers} workers' steady rate")
    t0 = time.perf_counter()
    stamps = []
    for _ in loader:
        stamps.append(time.perf_counter())
    check(len(stamps) == len(loader), f"the loader gave {len(stamps)} of {len(loader)} batches")
    return {"first_batch_s": stamps[0] - t0, "burst_s": stamps[warm - 1] - t0,
            "s_per_batch": (stamps[-1] - stamps[warm - 1]) / (len(stamps) - warm),
            "timed_batches": len(stamps) - warm, "batches": len(stamps)}


def _scale_synthesis(work: Path, lists: dict, card: str) -> dict:
    """(b) 32 items at the same (seed, epoch, index) mixed on the card
    (``device_synthesis``, f32 and int16 transfers) against the port's host
    mixer; the loader's seconds a batch at the recipe's num_workers for
    device synthesis (phase 28 times host mixing); the synthesis's device
    time."""
    import torch

    from fullsubnet_tpu_torch.config import build_dataset, load_config
    from fullsubnet_tpu_torch.data.device_mixer import make_device_synthesis

    repeated = dict(lists)
    repeated["clean"] = work / "clean_repeated.txt"
    repeated["clean"].write_text(lists["clean"].read_text() * LOADER_REPEAT)
    config = load_config(_train_config(work, repeated, "scale_synthesis"))
    section = config["train_dataset"]
    workers = int(section["dataloader"]["num_workers"])

    def dataset(**args):
        return build_dataset({**section, "args": {**section["args"], **args}}, "train")

    host = dataset()
    host.set_epoch(1)
    t0 = time.perf_counter()
    want = [host[i] for i in range(SCALE_BATCH)]
    item_s = {"host mixing": (time.perf_counter() - t0) / SCALE_BATCH}
    result = {"workers": workers, "cores": len(os.sched_getaffinity(0)),
              "host mixing": {"item_s": item_s["host mixing"]}}
    for transfer in ("f32", "int16"):
        ds = dataset(device_synthesis=True, device_synthesis_transfer=transfer)
        ds.set_epoch(1)
        t0 = time.perf_counter()
        items = [ds[i] for i in range(SCALE_BATCH)]
        item_s[f"device synthesis ({transfer})"] = (time.perf_counter() - t0) / SCALE_BATCH
        batch = torch.utils.data.default_collate(items)
        check(batch[0].dtype == (torch.int16 if transfer == "int16" else torch.float32),
              f"the {transfer} transfer shipped {batch[0].dtype}")
        batch = [x.cuda() for x in batch]
        synthesize = make_device_synthesis(target_db_fs=float(ds.target_dB_FS))
        noisy, clean = synthesize(batch)
        errs = []
        for i, (n, c) in enumerate(want):
            for got, ref in ((noisy[i], n), (clean[i], c)):
                ref = torch.from_numpy(ref).cuda()
                errs.append(float((got - ref).abs().max() / ref.abs().max()))
        ms = cuda_ms(lambda: synthesize(batch), reps=10)
        result[transfer] = {"max_err_of_peak": max(errs), "synthesis_ms": ms,
                            "rir_samples": ds.rir_samples,
                            "bytes": sum(x.numel() * x.element_size() for x in batch)}
        print(f"device synthesis, {SCALE_BATCH} items x 3.072 s, {transfer} transfer: noisy and "
              f"clean vs the host mixer, worst error / row peak {max(errs):.2e} (tol "
              f"{SYNTH_RTOL[transfer]:g}); the batch's {result[transfer]['bytes']} bytes (RIR "
              f"buffer {ds.rir_samples} taps); synthesis {ms:.3f} ms of device time [{card}]")
        check(max(errs) <= SYNTH_RTOL[transfer], f"{transfer} synthesis vs host {max(errs):.2e}")
    # the host-mixing loader is phase 28's, beside the numpy mix
    for label, ds in (("device synthesis (f32)", dataset(device_synthesis=True)),):
        rate = _loader_rate(ds, workers)
        # one worker's item time, serially in this process; spread over the
        # cores the workers share, it gives the rate they could reach
        ideal = item_s[label] * SCALE_BATCH / min(workers, result["cores"])
        result[label] = {**rate, "item_s": item_s[label], "cores_bound_s_per_batch": ideal}
        print(f"loader, {label}, num_workers={workers} on {result['cores']} cores, batch "
              f"{SCALE_BATCH} x 3.072 s: first batch {rate['first_batch_s']:.3f} s, the "
              f"{workers * LOADER_PREFETCH} batches in flight by {rate['burst_s']:.3f} s, then "
              f"{rate['s_per_batch'] * 1e3:.2f} ms a batch over the next "
              f"{rate['timed_batches']} batches; one item {item_s[label] * 1e3:.2f} ms in one "
              f"process, so {ideal * 1e3:.2f} ms a batch over the cores [{card}]")
    return result


def _replayed_step(trainer, weights: dict, grads: dict) -> dict:
    """The parameters (on the host) that one step of ``trainer``'s
    optimizer kind and settings makes from ``weights`` with ``grads``,
    clipped as the Trainer clips them, on the card."""
    import torch

    params = {k: weights[k].cuda().requires_grad_() for k, _ in trainer.model.named_parameters()}
    for k, p in params.items():
        p.grad = grads[k].cuda()
    if trainer.clip:
        torch.nn.utils.clip_grad_norm_(params.values(), trainer.clip)
    type(trainer.optimizer)(params.values(), **trainer.optimizer.defaults).step()
    return {k: p.detach().cpu() for k, p in params.items()}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _scale_cli_child(spec: dict) -> None:
    """Under ``torch.distributed.run``: the port's train CLI for 2 epochs
    with G = 2 and device synthesis (NCCL), then ``-P model_0002.pth -V``
    in the same process group; checks the steps' launches (read from the
    start of the first ``train_step`` to the end of the last), that they
    and the validation epoch's make up the run's, the validation epochs
    and the checkpoints, and writes a summary to ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from fullsubnet_tpu_torch.train import cli as train_cli
    from fullsubnet_tpu_torch.train.trainer import Trainer

    train_step, marks = Trainer.train_step, []

    def marked_step(self, noisy, clean):
        # every wrapper's counts before the first step and after each step
        if not marks:
            marks.append(_launch_counts())
        loss = train_step(self, noisy, clean)
        marks.append(_launch_counts())
        return loss

    for kernel in _wrappers().values():
        kernel.reset_counts()
    Trainer.train_step = marked_step
    try:
        with _watch_validation() as validations:
            trainer = train_cli.main(["-C", spec["config"], "-O", spec["runs"]])
    finally:
        Trainer.train_step = train_step
    torch.cuda.synchronize()
    total = _launch_counts()
    check(dist.is_initialized() and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "the train CLI did not join an NCCL group of one")
    check(len(marks) == trainer.steps + 1, f"{len(marks) - 1} marked steps of {trainer.steps}")
    own, others = _training_kernels("LSTM")
    counts = {}
    for k, wrapper in {**own, **others}.items():
        first, last = marks[0][wrapper], marks[-1][wrapper]
        n, by_shape = last[0] - first[0], last[1] - first[1]
        counts[k] = (n, dict(by_shape))
        # the steps' and the validation epochs' launches make up the run's
        vn = sum(r["launches"].get(wrapper, (0, None))[0] for r in validations)
        check(first[0] == 0 and n + vn == total[wrapper][0],
              f"{k}: {first[0]} launches before the first step, {n} in the steps, {vn} in "
              f"validation, {total[wrapper][0]} in the run")
    steps = trainer.steps
    check(steps == 4, f"{steps} steps, not 2 epochs x 2 batches")
    _check_step_launches(counts, "LSTM", steps * SCALE_ACCUM, "the torchrun train CLI",
                         batch=SCALE_BATCH // SCALE_ACCUM)
    check([r["epoch"] for r in validations] == [2], "the torchrun run did not validate at 2")
    ckpt = Path(spec["runs"]) / Path(spec["config"]).stem / "checkpoints"
    names = sorted(p.name for p in ckpt.iterdir())
    check(names == ["best_model.tar", "latest_model.tar", "model_0001.pth", "model_0002.pth"],
          f"the torchrun run's checkpoints {names}")
    for record in validations:
        _check_validation(record, "LSTM", "torchrun train CLI")
    with _watch_validation() as only:
        train_cli.main(["-C", spec["config"], "-O", spec["runs_v"], "-P",
                        str(ckpt / "model_0002.pth"), "-V"])
    check(len(only) == 1, "-V ran no validation epoch")
    _check_validation(only[0], "LSTM", "torchrun -V")
    best = Path(spec["runs_v"]) / Path(spec["config"]).stem / "checkpoints" / "best_model.tar"
    check(best.is_file(), "-V wrote no best_model.tar")
    Path(spec["out"]).write_text(json.dumps({
        "steps": steps, "epoch_losses": trainer.epoch_losses,
        "score": validations[0]["score"], "score_v": only[0]["score"],
        "launches": _stage_launches(counts), "backend": dist.get_backend(),
        "world": dist.get_world_size(), "checkpoints": names,
    }))
    dist.destroy_process_group()


def _scale_gloo_child(spec: dict) -> None:
    """One of two ranks on the one card, in a gloo group the smoke sets up:
    the bf16 step on its half of the global batch; writes its loss, its
    pre-clip (all-reduced) gradients and its parameters after the Adam
    step to ``spec["out"]``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    rank, world = spec["rank"], spec["world"]
    dist.init_process_group("gloo", init_method=spec["init"], rank=rank, world_size=world)
    trainer = Trainer(load_config(spec["config"]), output_dir=spec["runs"], device="cuda")
    check((trainer.rank, trainer.world) == (rank, world), "the Trainer did not see the group")
    trainer.model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    data = np.load(spec["batch"])
    rows = slice(rank * SCALE_BATCH // world, (rank + 1) * SCALE_BATCH // world)
    noisy, clean = (torch.from_numpy(data[k][rows]).cuda() for k in ("noisy", "clean"))
    for kernel in _wrappers().values():
        kernel.reset_counts()
    loss = trainer.loss_and_grads(noisy, clean)
    grads = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
    if trainer.clip:
        torch.nn.utils.clip_grad_norm_(trainer.model.parameters(), trainer.clip)
    trainer.optimizer.step()
    torch.cuda.synchronize()
    torch.save({"loss": float(loss), "grads": grads,
                "params": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
                "launches": _stage_launches(_named_counts())}, spec["out"])
    dist.barrier()
    dist.destroy_process_group()


def _scale_child(spec: dict) -> int:
    """Entry of the smoke's own child processes (``--scale-child``)."""
    try:
        (_scale_cli_child if spec["kind"] == "cli" else _scale_gloo_child)(spec)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def _scale_data_parallel(work: Path, lists: dict, card: str) -> dict:
    """(c) The train CLI under ``torch.distributed.run --nproc_per_node 1``
    over NCCL, 2 epochs with validation, G = 2 and device synthesis; then
    two gloo ranks on the one card, each with half of a global batch of 32,
    against one process's step on the same weights and batch."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    result = {}
    cfg = _train_config(work, lists, "scale_torchrun", epochs=2, save_checkpoint_interval=1,
                        grad_accum_steps=SCALE_ACCUM, device_synthesis="true")
    spec = {"kind": "cli", "config": str(cfg), "runs": str(work / "scale_runs"),
            "runs_v": str(work / "scale_runs_v"), "out": str(work / "scale_cli.json")}
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
         str(REPO / "chip_smoke.py"), "--scale-child", json.dumps(spec)],
        capture_output=True, text=True, timeout=SCALE_CHILD_TIMEOUT, cwd=REPO)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"the torchrun train CLI failed ({run.returncode}):\n"
                               f"{run.stdout[-3000:]}\n{run.stderr[-5000:]}")
    summary = json.loads(Path(spec["out"]).read_text())
    result["torchrun"] = {**summary, "wall_s": wall}
    print(f"train CLI under torch.distributed.run --nproc_per_node 1 ({summary['backend']}, world "
          f"{summary['world']}), flagship LSTM, B={SCALE_BATCH}, grad_accum_steps={SCALE_ACCUM}, "
          f"device synthesis, 2 epochs: {summary['steps']} steps, losses "
          f"{summary['epoch_losses']}, validation score {summary['score']:.6f}, -V score "
          f"{summary['score_v']:.6f}, checkpoints {summary['checkpoints']}, launches of the "
          f"steps {summary['launches']}; {wall:.1f} s wall incl. start-up [{card}]")

    # two gloo ranks on the card against one process
    name = "scale_gloo"
    cfg = _train_config(work, lists, name, num_workers=0)
    single = Trainer(load_config(cfg), output_dir=str(work / f"{name}_single"), device="cuda")
    noisy, clean = _first_batch(single, SCALE_BATCH)
    np.savez(work / f"{name}.npz", noisy=noisy.numpy(), clean=clean.numpy())
    torch.save(single.model.state_dict(), work / f"{name}_weights.pt")
    init = f"tcp://127.0.0.1:{_free_port()}"
    children = []
    t0 = time.perf_counter()
    for rank in range(2):
        spec = {"kind": "gloo", "rank": rank, "world": 2, "init": init, "config": str(cfg),
                "runs": str(work / f"{name}_rank{rank}"), "weights": str(work / f"{name}_weights.pt"),
                "batch": str(work / f"{name}.npz"), "out": str(work / f"{name}_rank{rank}.pt")}
        children.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--scale-child", json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    loss = single.loss_and_grads(noisy.cuda(), clean.cuda())
    want_grads = {k: p.grad.detach().cpu() for k, p in single.model.named_parameters()}
    torch.nn.utils.clip_grad_norm_(single.model.parameters(), single.clip)
    single.optimizer.step()
    want_params = {k: v.detach().cpu() for k, v in single.model.state_dict().items()}
    want_loss = float(loss)
    logs = []
    try:
        for child in children:
            logs.append(child.communicate(timeout=SCALE_CHILD_TIMEOUT)[0])
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    wall = time.perf_counter() - t0
    for child, log in zip(children, logs):
        check(child.returncode == 0, f"a gloo rank failed ({child.returncode}):\n{log[-5000:]}")
    ranks = [torch.load(work / f"{name}_rank{r}.pt", weights_only=True) for r in range(2)]
    check(ranks[0]["loss"] == ranks[1]["loss"], "the two ranks logged other losses")
    for key in want_params:
        check(torch.equal(ranks[0]["params"][key], ranks[1]["params"][key]),
              f"the two ranks hold other {key}")
    loss_rel = abs(ranks[0]["loss"] - want_loss) / abs(want_loss)
    grad_rel = _errors_by_key(ranks[0]["grads"], want_grads)
    worst_g = max(grad_rel, key=grad_rel.get)
    # the rank's update against one clip and one optimizer step of the
    # Trainer's kind from the same weights with the rank's gradients, in
    # units of the learning rate: 0 when the step is the optimizer's, about
    # 1 when a rank's state is left unchanged or stepped twice (Adam's
    # first step moves each weight by about lr)
    before = torch.load(work / f"{name}_weights.pt", map_location="cpu", weights_only=True)
    replayed = _replayed_step(single, before, ranks[0]["grads"])
    lr = single.optimizer.defaults["lr"]
    update_err = {k: float((ranks[0]["params"][k] - replayed[k]).abs().max()) / lr
                  for k in replayed}
    worst_u = max(update_err, key=update_err.get)
    # beside it, the update against one process's: Adam's first step is
    # about lr times the gradient's sign, which flips where the bf16
    # gradients are near 0, so this is printed and not held
    single_rel = {k: float((ranks[0]["params"][k] - before[k]).sub(want_params[k] - before[k])
                           .norm() / (want_params[k] - before[k]).norm().clamp_min(1e-30))
                  for k in replayed}
    worst_s = max(single_rel, key=single_rel.get)
    result["gloo"] = {"loss": ranks[0]["loss"], "single_loss": want_loss, "loss_rel": loss_rel,
                      "grad_rel": grad_rel[worst_g], "update_err_of_lr": update_err[worst_u],
                      "update_l2_rel_vs_single": single_rel[worst_s],
                      "launches": ranks[0]["launches"], "wall_s": wall}
    print(f"two gloo ranks on the card (bf16, 16 rows each of a global batch of {SCALE_BATCH}) vs "
          f"one process: loss {ranks[0]['loss']:.8e} vs {want_loss:.8e} (rel {loss_rel:.2e}, tol "
          f"{STEP_LOSS_RTOL_BF16:g}); pre-clip gradient error / max, worst {grad_rel[worst_g]:.2e} "
          f"at {worst_g} (tol {GRAD_RTOL_BF16:g}); the update vs one clip + Adam step replayed "
          f"on the rank's gradients, max error / lr {update_err[worst_u]:.2e} at {worst_u} (tol "
          f"{UPDATE_TOL_OF_LR:g}); the update vs one process's, |d|_2 / |update|_2 worst "
          f"{single_rel[worst_s]:.2e} at {worst_s} (not held); rank 0's launches "
          f"{ranks[0]['launches']}; {wall:.1f} s wall incl. start-up [{card}]")
    check(loss_rel <= STEP_LOSS_RTOL_BF16, f"gloo ranks' loss vs one process {loss_rel:.2e}")
    check(grad_rel[worst_g] <= GRAD_RTOL_BF16, f"gloo gradient {worst_g} {grad_rel[worst_g]:.2e}")
    check(update_err[worst_u] <= UPDATE_TOL_OF_LR,
          f"gloo update {worst_u} {update_err[worst_u]:.2e} of lr vs the replayed step")
    del single
    torch.cuda.empty_cache()
    return result


def phase_train_scale(work: Path, card: str, lists=None) -> dict:
    """Phase 24: training at scale on the flagship recipe at full width:
    (a) gradient accumulation, (b) device synthesis, (c) data parallel;
    returns each path's launches by stage and the numbers."""
    if lists is None:
        lists = _write_train_data(work / "train_data")
    t0 = time.perf_counter()
    accum = _scale_accumulation(work, lists, card)
    synthesis = _scale_synthesis(work, lists, card)
    parallel = _scale_data_parallel(work, lists, card)
    wall = time.perf_counter() - t0
    launches = dict(accum["launches"])
    launches[f"torchrun train CLI (NCCL, G={SCALE_ACCUM}, device synthesis), 4 steps"] = (
        parallel["torchrun"]["launches"])
    launches["gloo rank 0 of 2 on the card, one bf16 step"] = parallel["gloo"]["launches"]
    print(f"phase 24 (training at scale) took {wall:.1f} s [{card}]")
    return {"launches": launches, "steps": accum["steps"], "synthesis": synthesis,
            "torchrun": parallel["torchrun"], "gloo": parallel["gloo"], "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 25: K1-bf16, the inference forward on a bf16 x (tc_gemm and the bf16
# walk in its tensor-core, cluster or streaming form), and the path that runs
# it: Improved FullSubNet with compute_dtype = "bfloat16"
# ---------------------------------------------------------------------------

BF16_FWD_CASES = (
    # name, F_in, H, OUT, N, T: Improved FullSubNet's stacks at 16 kHz over
    # 10 s (1,251 frames at hop 128), at B = 1 and 16 (section 0 at 64 too),
    # the flagship's sub-band stack at the fp32 K1 rows' shapes (phase 3),
    # and the chunked training forward's sub-band stage at the recipe's crop
    ("Improved full-band B=1", 256, 512, 256, 1, 1251),
    ("Improved full-band B=16", 256, 512, 256, 16, 1251),
    ("Improved section 0 B=1", 62, 384, 2, 20, 1251),
    ("Improved section 1 B=1", 68, 384, 8, 15, 1251),
    ("Improved section 2 B=1", 76, 384, 16, 22, 1251),
    ("Improved section 0 B=16", 62, 384, 2, 320, 1251),
    ("Improved section 1 B=16", 68, 384, 8, 240, 1251),
    ("Improved section 2 B=16", 76, 384, 16, 352, 1251),
    ("Improved section 0 B=64", 62, 384, 2, 1280, 1251),
    ("flagship sub-band N=257", 32, 384, 2, 257, 400),
    ("flagship sub-band N=2056", 32, 384, 2, 2056, 400),
    ("chunked training forward N=4096", 32, 384, 2, 4096, 195),
)
# K1-bf16 (and each of its stages) vs its plain version on the card, both
# rounding at the same points: an h value on the other side of a bf16
# rounding boundary (the sums run in another order) is one bf16 step (2^-8
# relative) apart, and the recurrence carries it on
K1_BF16_ATOL = 1e-2
# the GEMM stage (fp32 sums of the same bf16 products in another order): its
# fp32 output within this share of its largest value
K1_BF16_GEMM_RTOL = 1e-5
# Improved FullSubNet with compute_dtype, the card's waveform against the
# port's plain CPU path (the same roundings; flips as above, through the
# full-band stack, the sections and the iSTFT), as a share of the peak
IMPROVED_BF16_WAVE_RTOL = 2e-2
# the plain stages of K1-bf16, which the card's path must not run
PLAIN_BF16_STAGES = ("plain_tc_gemm", "plain_lstm_fwd_walk_bf16", "plain_gru_fwd_walk_bf16")
IMPROVED_16K = "improved_fullsubnet_16k"
BF16_SECONDS = 10
# the batches of K1-bf16's main path, Improved FullSubNet's forward
BF16_PATH_BATCHES = (1, 16, 64)


def _bf16_walk_forms(hidden: int, cell: str) -> tuple:
    """The forms K1-bf16's walk takes at H: the tensor-core walk where H is
    one of ``FWD_TC_HIDDEN``, the cluster walk always, the streaming walk
    where H is a multiple of 4 up to 512."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    return ((("tc",) if ops.fwd_tc_takes(hidden, cell) else ()) + ("cluster",)
            + (("streaming",) if hidden % 4 == 0 and hidden <= ops.TRAIN_WALK_MAX_HIDDEN
               else ()))


def _tc_sweep(walk, args, n: int, hidden: int, cell: str) -> dict:
    """The tensor-core walk on one layer's operands at every tile that fits
    (``rows`` a tile, as many tiles a cluster as one wave of clusters needs,
    as fit): ms of one call by "rows x tiles a cluster", the numbers that
    set ``FWD_TC_TILE_COST_ROWS`` and ``FWD_TC_ONE_SLICE_COST``."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    out = {}
    if n <= 64:
        return out
    for rows in ops.FWD_TC_ROWS:
        most = ops.fwd_tc_max_tiles(rows, hidden, cell)
        if not most:
            continue
        clusters = max(1, walk.max_clusters_tc(hidden, rows, 1, args[0].device))
        tiles = min(-(-(-(-n // rows)) // clusters), most)
        out[f"{rows}x{tiles}"] = cuda_ms(
            lambda: walk(*args, form="tc", rows=rows, tiles=tiles), reps=1)
    return out


# the dispatched K1-bf16 walk against the fastest form at each case, at most
PICKED_WALK_RATIO = 1.05
# the form sweep behind FWD_BF16_FORM_BOUNDS: N on a grid 2^(1/2) apart (the
# bounds were read off a grid 2^(1/4) apart; the coarser one keeps the
# whole smoke within its time) from 1 to the flagship's B=32 sub-band rows
# (8,224), at every H and cell
# the tensor-core walk takes, one layer's walk in each form from random
# operands over BF16_SWEEP_T steps a call, about the chunked training
# forward's T (195): past one wave of clusters the tensor-core walk pays
# each wave's start (W_hh into shared memory) once a call. The cluster
# walk, whose waves of tiles of at most 40 rows only grow with N, is not
# timed past the first N of 512 or more at which it takes twice the
# fastest form's time.
BF16_SWEEP_N = tuple(sorted({round(2 ** (k / 2)) for k in range(27)} | {8224}))
BF16_SWEEP_T = 200
BF16_SWEEP_CLUSTER_DROP = (512, 2.0)


def _bf16_form_sweep(card: str) -> dict:
    """Each form of K1-bf16's walk at ``BF16_SWEEP_N`` for every (H, cell)
    the tensor-core walk takes: µs a step by N and form, the fastest and the
    picked form; the runs of N over which one form is the fastest (the
    measured crossovers) beside ``FWD_BF16_FORM_BOUNDS``, and how far the
    picked form is from the fastest."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    out = {}
    for hidden in ops.FWD_TC_HIDDEN:
        for cell in ("lstm", "gru"):
            if not ops.fwd_tc_takes(hidden, cell):
                continue
            walk = ops.lstm_fwd_walk_bf16 if cell == "lstm" else ops.gru_fwd_walk_bf16
            gh = GATES[cell] * hidden
            gen = torch.Generator(device=dev).manual_seed(SEED + hidden + (cell == "gru"))
            w = (torch.randn(gh, hidden, generator=gen, device=dev) / hidden ** 0.5
                 ).to(torch.bfloat16)
            b_hh = 0.1 * torch.randn(gh, generator=gen, device=dev)
            by_n, runs, forms = {}, [], _bf16_walk_forms(hidden, cell)
            t = BF16_SWEEP_T
            for n in BF16_SWEEP_N:
                p = torch.randn(t, n, gh, generator=gen, device=dev)
                h0 = torch.zeros(n, hidden, device=dev)
                state = (h0, torch.zeros_like(h0)) if cell == "lstm" else (b_hh, h0)
                us = {form: 1e3 * cuda_ms(lambda: walk(p, w, *state, form=form), reps=2) / t
                      for form in forms}
                fastest = min(us, key=us.get)
                picked = walk.form(n, hidden, dev)[0]
                by_n[n] = {**{f: round(v, 3) for f, v in us.items()}, "fastest": fastest,
                           "picked": picked,
                           "ratio": round(us[picked] / us[fastest], 3) if picked in us else None}
                if (n >= BF16_SWEEP_CLUSTER_DROP[0] and "cluster" in us
                        and us["cluster"] > BF16_SWEEP_CLUSTER_DROP[1] * us[fastest]):
                    forms = tuple(f for f in forms if f != "cluster")
                if runs and runs[-1][1] == fastest:
                    runs[-1][0] = n
                else:
                    runs.append([n, fastest])
                del p, h0, state
            timed = [n for n, r in by_n.items() if r["ratio"] is not None]
            worst = max(timed, key=lambda n: by_n[n]["ratio"])
            row = {"fastest_runs": runs, "bounds": ops.FWD_BF16_FORM_BOUNDS[hidden, cell],
                   "worst_ratio": by_n[worst]["ratio"], "worst_at": worst,
                   "over_5pct": [n for n in timed if by_n[n]["ratio"] > PICKED_WALK_RATIO],
                   "picked_untimed": [n for n, r in by_n.items() if r["ratio"] is None]}
            print(f"K1-bf16 form sweep {cell} H={hidden}, T={t} [{card}]: us a step of one layer "
                  f"by N {json.dumps(by_n)}; the fastest form up to N (runs) {json.dumps(runs)}; "
                  f"the picker's bounds {json.dumps(row['bounds'])}; the picked form at most "
                  f"{row['worst_ratio']:.3f}x the fastest (at N={worst}), above "
                  f"{PICKED_WALK_RATIO} at {row['over_5pct']}, untimed at {row['picked_untimed']}")
            out[f"{cell} H={hidden}"] = row
            del w, b_hh
            torch.cuda.empty_cache()
    return out


def _bf16_case(card: str, cell: str, rng, name: str, f_in: int, hidden: int, out_dim: int,
               n: int, t: int) -> dict:
    """K1-bf16 at one stack shape: the dispatched forward (as
    ``fused_subband_lstm`` runs it on a bf16 x) and each stage, the GEMM and
    both forms of the walk, against their plain versions on the card; times
    of each, of the fp32 K1 on the same (rounded) input, of the plain
    version and of cuDNN at bf16 + the Linear; the bounds."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    lstm = cell == "lstm"
    gh = GATES[cell] * hidden
    walk = ops.lstm_fwd_walk_bf16 if lstm else ops.gru_fwd_walk_bf16
    plain_walk = ops.plain_lstm_fwd_walk_bf16 if lstm else ops.plain_gru_fwd_walk_bf16
    layers, fc = _stack(rng, f_in, hidden, out_dim, dev, cell)
    x = torch.from_numpy(np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32) * 1.25
                         ).to(dev).to(torch.bfloat16)
    rnn = _cudnn_rnn(layers, f_in, hidden, torch.bfloat16, dev, cell)
    wfc, bfc = fc["weight"].to(torch.bfloat16), fc["bias"].to(torch.bfloat16)
    # the stages' operands as the main path gives them (the input width
    # padded for the GEMM's 16-byte loads), recorded from forward_stages
    xp, lp = ops.pad_input(x, layers, ops.TC_INPUT_MULTIPLE)
    gemms, walks, plain_out = [], [], []

    def rec_gemm(*args):
        gemms.append(args)
        return ops.tc_gemm(*args)

    def rec_walk(*args):
        walks.append(args)
        return walk(*args)

    with torch.no_grad():
        for k in _wrappers().values():
            k.reset_counts()
        got = ops.fused_subband_lstm(x, *layers, fc)
        torch.cuda.synchronize()
        forms = dict(walk.launches_by_form)
        plain_ms = cuda_ms(lambda: plain_out.append(ops.plain_fused_forward(x, layers, fc)),
                           reps=1, warmup=0)
        plain = plain_out.pop()
        fp32 = ops.fused_subband_lstm(x.float(), *layers, fc)
        ops.forward_stages(rec_gemm, rec_walk, xp, lp, fc, chunk=t)
        torch.cuda.synchronize()
        gemm_err = max(float((ops.tc_gemm(*g) - ops.plain_tc_gemm(*g)).abs().max()
                             / ops.plain_tc_gemm(*g).abs().max()) for g in gemms)
        plain_walk_ms = cuda_ms(lambda: plain_out.append([plain_walk(*w) for w in walks]),
                                reps=1, warmup=0)
        plain_walks = plain_out.pop()
        walk_err, walk_ms, walk_clk = {}, {}, {}
        clocks = torch.zeros(3, dtype=torch.int64, device=dev)
        for form in _bf16_walk_forms(hidden, cell):
            walk_err[form] = max(float((a.float() - b.float()).abs().max())
                                 for w, want in zip(walks, plain_walks)
                                 for a, b in zip(walk(*w, form=form), want))
            walk_ms[form] = cuda_ms(lambda: [walk(*w, form=form) for w in walks], reps=2)
            clocks.zero_()
            walk(*walks[0], form=form, clocks=clocks)
            total = max(1, int(clocks.sum()))
            walk_clk[form] = {k: round(int(v) / total, 3) for k, v in zip(
                ("product", "cell", "other") if form == "streaming"
                else ("exchange", "product", "cell"), clocks.tolist())}
            walk_clk[form]["cycles"] = int(clocks.sum())
        # the dispatched form against the fastest: where it is more than
        # PICKED_WALK_RATIO slower, both re-timed alternately, the least of 3
        picked, picked_rows = walk.form(n, hidden, dev)
        fastest = min(walk_ms, key=walk_ms.get)
        if walk_ms[picked] > PICKED_WALK_RATIO * walk_ms[fastest]:
            for _ in range(3):
                for form in (picked, fastest):
                    walk_ms[form] = min(walk_ms[form], cuda_ms(
                        lambda: [walk(*w, form=form) for w in walks], reps=2))
            fastest = min(walk_ms, key=walk_ms.get)
        # the tile sweep past 64 rows
        sweep_tc = _tc_sweep(walk, walks[0], n, hidden, cell) if "tc" in walk_ms else {}
        err = float((got - plain).abs().max())
        gap = float((got - fp32).abs().max())
        cudnn_err = float((got - ((rnn(x)[0] @ wfc.t()).float() + bfc.float())).abs().max())
        ms = cuda_ms(lambda: ops.fused_subband_lstm(x, *layers, fc), reps=2)
        fp32_ms = cuda_ms(lambda: ops.fused_subband_lstm(x.float(), *layers, fc), reps=2)
        gemm_ms = cuda_ms(lambda: [ops.tc_gemm(*g) for g in gemms])
        cublas_ms = cuda_ms(lambda: [torch.matmul(g[0], g[1]) for g in gemms])
        plain_gemm_ms = cuda_ms(lambda: [ops.plain_tc_gemm(*g) for g in gemms], reps=1)
        cudnn_ms = cuda_ms(lambda: rnn(x)[0] @ wfc.t() + bfc, reps=2)
    plan = walk.tc_plan(n, hidden, dev) if "tc" in walk_ms else None
    check(got.shape == (t, n, out_dim) and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()), f"K1-bf16 {cell} {name}: output {got.dtype} "
          f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    launches = len(layers) * -(-t // ops.fwd_chunk_steps(t, n, hidden, cell))
    check(forms == {picked: launches}, f"K1-bf16 {cell} {name}: walk launches by form "
          f"{forms}, want {launches} {picked}")
    for what, e, tol in (("forward vs plain", err, K1_BF16_ATOL),
                         ("GEMM vs plain (of its largest)", gemm_err, K1_BF16_GEMM_RTOL),
                         *((f"{form} walk vs plain", e, K1_BF16_ATOL)
                           for form, e in walk_err.items())):
        check(e <= tol, f"K1-bf16 {cell} {name}: {what} {e:.3e} > {tol:g}")
    picked_ratio = walk_ms[picked] / walk_ms[fastest]
    check(picked_ratio <= PICKED_WALK_RATIO, f"K1-bf16 {cell} {name}: the dispatched walk "
          f"({picked}) {walk_ms[picked]:.3f} ms, {picked_ratio:.3f}x the fastest ({fastest}) "
          f"{walk_ms[fastest]:.3f} ms, above {PICKED_WALK_RATIO}")
    # bf16 operands on the tensor cores' type: x and the weights read once
    # in bf16, the output written in fp32
    flops = stack_flops(t, n, f_in, hidden, out_dim, cell=cell)
    nbytes = 2 * (t * n * f_in + weight_elems(f_in, hidden, out_dim, cell=cell)) + 4 * t * n * out_dim
    bound_ms, bound_by = bound(flops, nbytes, "bf16")
    walk_flops = roofline.walk_flops(t, n, hidden, cell=cell)
    walk_bound = bound(walk_flops, 2 * (4 * t * n * gh + 2 * t * n * hidden + 2 * hidden * gh),
                       "bf16")
    gemm_bound = bound(flops - walk_flops,
                       2 * t * n * (f_in + hidden) + 4 * t * n * (2 * gh + out_dim)
                       + 2 * (f_in * gh + hidden * gh + hidden * out_dim), "bf16")
    sweep = ", ".join(f"{form} {v:.3f} ms ({1e3 * v / (2 * t):.2f} us a step)"
                      for form, v in walk_ms.items())
    print(f"K1-bf16 {cell} {name} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}) "
          f"[{card}]:\n"
          f"  forward {ms:.3f} ms (fp32 K1 on the same input {fp32_ms:.3f} ms, {fp32_ms / ms:.2f}x); "
          f"GEMMs {gemm_ms:.3f} ms ({(flops - walk_flops) / (gemm_ms * 1e9):.1f} TFLOP/s, bound "
          f"{gemm_bound[0]:.4f}, cuBLAS bf16 {cublas_ms:.3f}); walks by form: {sweep}, bound "
          f"{walk_bound[0]:.4f} ({walk_bound[1]}); picked {picked} at {picked_rows} rows"
          + (f" (tc plan: {plan[0]} rows x {plan[1]} tiles a cluster, {plan[2]} clusters in "
             f"flight)" if plan else "")
          + f", {picked_ratio:.3f}x the fastest ({fastest}); block 0's "
          f"cycles of layer 0's walk by form {json.dumps(walk_clk)}"
          + (f"; tc sweep (one layer, ms by rows x tiles a cluster) {json.dumps(sweep_tc)}"
             if sweep_tc else "")
          + f"; plain {plain_ms:.3f} ms (GEMMs "
          f"{plain_gemm_ms:.3f}, walks {plain_walk_ms:.3f}); cuDNN bf16 + Linear {cudnn_ms:.3f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by})\n"
          f"  max|forward-plain| {err:.3e}, GEMM vs plain {gemm_err:.3e} of its largest, walks vs "
          f"plain {json.dumps({k: float(f'{v:.3e}') for k, v in walk_err.items()})} (tol "
          f"{K1_BF16_ATOL:g}); max|bf16-fp32 K1| {gap:.3e}; max|forward-cuDNN bf16| "
          f"{cudnn_err:.3e}")
    picked_ms = walk_ms[picked]
    del x, got, plain, fp32, gemms, walks, plain_walks, rnn
    torch.cuda.empty_cache()
    return {"name": f"{name}: F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}",
            "err": err, "ms": ms, "fp32_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": cudnn_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "picked": picked, "gap_fp32": gap, "fastest": fastest,
            "picked_ratio": picked_ratio, "tc_sweep": sweep_tc,
            "clocks": walk_clk,
            "gemm": {"err": gemm_err, "ms": gemm_ms, "plain_ms": plain_gemm_ms,
                     "library_ms": cublas_ms, "bound_ms": gemm_bound[0],
                     "bound_by": gemm_bound[1]},
            "walk": {form: {"err": walk_err[form], "ms": walk_ms[form],
                            "plain_ms": plain_walk_ms, "library_ms": None,
                            "bound_ms": walk_bound[0], "bound_by": walk_bound[1]}
                     for form in walk_ms},
            "walk_ms": picked_ms}


def _improved_bf16_config(work: Path, cell: str, compute_dtype: bool,
                          noisy_dir: Path | None = None) -> Path:
    """Improved FullSubNet's 16 kHz recipe with ``sequence_model = cell`` and,
    where ``compute_dtype``, ``compute_dtype = "bfloat16"`` in its
    [model.args]; with ``noisy_dir`` an inference TOML written from it
    (``time_domain``, batch 1)."""
    if noisy_dir is not None:
        src = _written_inference_config(work, IMPROVED_16K, noisy_dir, "time_domain", 1)
    else:
        src = _recipe(IMPROVED_16K, "train")
    toml = _set_cell(src.read_text(), cell)
    if compute_dtype:
        toml, n_sub = re.subn(r"(?m)^\[model\.args\]\n", '[model.args]\ncompute_dtype = "bfloat16"\n',
                              toml)
        check(n_sub == 1, "Improved recipe has no single [model.args]")
    cfg = work / f"improved_{cell}_{'bf16' if compute_dtype else 'fp32'}"\
                 f"{'_infer' if noisy_dir else ''}.toml"
    cfg.write_text(toml)
    return cfg


def _improved_bf16_model(work: Path, cell: str, compute_dtype: bool):
    """The recipe-width model (random weights from a seed, the same for both
    dtypes) on the card, and its checkpoint's path."""
    import torch

    from fullsubnet_tpu_torch.config import build_model, load_config

    ckpt = work / f"improved_{cell}_bf16_weights.tar"
    if not ckpt.exists():
        _write_family_checkpoint(ckpt, _improved_bf16_config(work, cell, False))
    model, _ = build_model(load_config(_improved_bf16_config(work, cell, compute_dtype)))
    model.load_state_dict(torch.load(ckpt)["model"])
    return model.cuda().eval(), ckpt


def _bf16_waves(batch: int, seconds: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(150, 500) * t)
                     + 0.05 * rng.standard_normal(t.size) for _ in range(batch)]).astype(np.float32)


def _improved_bf16_path(work: Path, card: str, cell: str) -> dict:
    """The main path of K1-bf16: Improved FullSubNet with compute_dtype on
    the card, exact length, at B = 1, 16 and 64 x 10 s. Every wrapper's
    counts set to 0 just before and read just after (K1-bf16's GEMM and walk
    alone, its walk by form as ``pick_fwd_bf16_form`` picks for each stack;
    the plain stages refused); the card's waveform against the port's plain
    CPU path on 1 s; the RTF at B = 1, 16 and 64 of the fp32 model and of
    compute_dtype on the same weights (median of 3 after a warm-up, in
    turns)."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    model, ckpt = _improved_bf16_model(work, cell, True)
    fp32, _ = _improved_bf16_model(work, cell, False)
    walk = ops.lstm_fwd_walk_bf16 if cell == "LSTM" else ops.gru_fwd_walk_bf16
    waves = {b: torch.from_numpy(_bf16_waves(b, BF16_SECONDS, SEED + 30 + b)).cuda()
             for b in BF16_PATH_BATCHES}
    frames = BF16_SECONDS * 16000 // 128 + 1
    want_forms, stacks = collections.Counter(), 0
    for b in waves:
        for _, hidden, _, layers, n, t in _family_stacks(IMPROVED_16K, b, frames, False):
            chunks = -(-t // ops.fwd_chunk_steps(t, n, hidden, cell.lower()))
            want_forms[walk.form(n, hidden, dev)[0]] += layers * chunks
            stacks += chunks  # a stack's GEMMs and walks, once a chunk
    with torch.inference_mode(), _plain_stages_refused(PLAIN_STAGES + PLAIN_BF16_STAGES):
        for k in _wrappers().values():
            k.reset_counts()
        outs = {b: model(w) for b, w in waves.items()}
        torch.cuda.synchronize()
        launched = _launched()
        forms = dict(walk.launches_by_form)
    walk_name = "lstm_fwd_walk_bf16" if cell == "LSTM" else "gru_fwd_walk_bf16"
    want = {"tc_gemm": 3 * stacks, walk_name: 2 * stacks}
    got = {k: sum(v.values()) for k, v in launched.items()}
    check(got == want and forms == dict(want_forms),
          f"Improved {cell} compute_dtype B={BF16_PATH_BATCHES}: launches {got} by form {forms}, "
          "want "
          f"{want} by form {dict(want_forms)}")
    for b, out in outs.items():
        check(out.shape == (b, 1, BF16_SECONDS * 16000) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"Improved {cell} compute_dtype B={b}: output "
              f"{out.dtype} {tuple(out.shape)}")
    with torch.inference_mode():
        gap = float((outs[1] - fp32(waves[1])).abs().max() / outs[1].abs().max())
    # the card against the plain CPU path, 1 s
    wave1 = waves[1][:, :16000].cpu()
    cpu_model, _ = _improved_bf16_model(work, cell, True)
    cpu_model = cpu_model.cpu()
    with torch.inference_mode():
        w_cpu = cpu_model(wave1)
        w_gpu = model(wave1.cuda()).cpu()
    err = float((w_gpu - w_cpu).abs().max() / w_cpu.abs().max())
    check(err <= IMPROVED_BF16_WAVE_RTOL, f"Improved {cell} compute_dtype: card vs CPU "
          f"{err:.3e} of the peak > {IMPROVED_BF16_WAVE_RTOL:g}")
    # RTF at each batch x 10 s, fp32 and compute_dtype in turns
    rtf, times = {}, {}
    with torch.inference_mode():
        for b in BF16_PATH_BATCHES:
            times[b] = {"fp32": [], "bf16": []}
            for m in (fp32, model):
                m(waves[b])
            torch.cuda.synchronize()
            for key in ("fp32", "bf16", "bf16", "fp32", "fp32", "bf16"):
                t0 = time.perf_counter()
                (model if key == "bf16" else fp32)(waves[b])
                torch.cuda.synchronize()
                times[b][key].append(time.perf_counter() - t0)
            rtf[b] = {k: sorted(v)[1] / (b * BF16_SECONDS) for k, v in times[b].items()}
    print(f"Improved FullSubNet 16 kHz ({cell}) compute_dtype bfloat16, B={BF16_PATH_BATCHES} x "
          f"10 s on the card: launches {got}, walk by form {forms}, none of the fp32 K1 or the plain stages; "
          f"max|bf16-fp32| / peak {gap:.3e}; card vs plain CPU (1 s) {err:.3e} of the peak (tol "
          f"{IMPROVED_BF16_WAVE_RTOL:g}); "
          + "; ".join(f"RTF at B={b} x 10 s (forward wall over audio): fp32 "
                      f"{rtf[b]['fp32']:.5f} ({[round(v * 1e3, 2) for v in times[b]['fp32']]} "
                      f"ms), compute_dtype {rtf[b]['bf16']:.5f} "
                      f"({[round(v * 1e3, 2) for v in times[b]['bf16']]} ms)" for b in rtf)
          + f" [{card}]")
    del model, fp32, cpu_model, outs
    torch.cuda.empty_cache()
    return {"launches": got, "forms": forms, "wave_err": err, "gap_fp32": gap, "rtf": rtf,
            "ckpt": ckpt}


def _improved_bf16_served(work: Path, card: str, ckpt: Path) -> dict:
    """Improved FullSubNet (LSTM) with compute_dtype exported bucketed at
    11 s (``serving.export_enhancer``, ``time_domain``) and served on 10 s:
    against the live ``enhance_bucket`` of the same bucket (within SERVE_RTOL
    of the peak), the served call's launches, and its RTF beside the live
    one (median of 3, in turns). Bucketed, the model takes ``valid_samples``:
    its masked norm's fp32 count promotes the bf16 magnitude's normalised
    input to fp32 in both packages, so the stacks run the fp32 K1."""
    import torch

    from fullsubnet_tpu_torch import serving
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    noisy_dir = work / "noisy_improved_bf16"
    noisy_dir.mkdir(exist_ok=True)
    config = load_config(_improved_bf16_config(work, "LSTM", True, noisy_dir))
    out = work / "served_improved_bf16"
    t0 = time.perf_counter()
    serving.export_enhancer(config, str(ckpt), out, seconds=(11,), batch=1, device="cuda")
    export_s = time.perf_counter() - t0
    served = serving.ServingModel.load(out)
    live = Inferencer(config, str(ckpt), None, device="cuda")
    wave = _bf16_waves(1, BF16_SECONDS, SEED + 40)[0]
    for k in _wrappers().values():
        k.reset_counts()
    got = served.enhance(wave)
    torch.cuda.synchronize()
    launched = {k: sum(v.values()) for k, v in _launched().items()}
    want = live.enhance_bucket([wave], 11 * 16000)[0]
    err = float(abs(got - want).max() / abs(want).max())
    check(err <= SERVE_RTOL, f"Improved compute_dtype served vs live {err:.3e} of the peak")
    times = {"served": [], "live": []}
    for key in ("served", "live", "live", "served", "served", "live"):
        t0 = time.perf_counter()
        served.enhance(wave) if key == "served" else live.enhance_bucket([wave], 11 * 16000)
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
    rtf = {k: sorted(v)[1] / BF16_SECONDS for k, v in times.items()}
    print(f"Improved FullSubNet 16 kHz compute_dtype served (bucketed at 11 s, exported in "
          f"{export_s:.1f} s) on 10 s: vs live {err:.3e} of the peak (tol {SERVE_RTOL:g}); "
          f"launches {launched} (the masked norm promotes the stacks' inputs to fp32); RTF served "
          f"{rtf['served']:.5f}, live bucketed {rtf['live']:.5f} [{card}]")
    del served, live
    torch.cuda.empty_cache()
    return {"err": err, "launches": launched, "rtf": rtf, "export_s": export_s}


def _improved_bf16_step(work: Path, lists: dict, card: str) -> dict:
    """The recipe's train step (``use_amp`` as shipped, B=16 x 3.072 s) with
    compute_dtype and as shipped, in one call: median of 5 after 2 warm-ups
    each, audio-s/s, peak memory; with compute_dtype the stacks take the
    bf16 K2/K3/dW stages (tc_gemm, the bf16 walks, dw_tma) and none of the
    fp32 ones."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    batch = FAMILIES[IMPROVED_16K]["step_batch"]
    result = {}
    fp32_stages = ("fwd_gemm", "lstm_train_walk_f32", "lstm_walk_f32")
    bf16_stages = ("tc_gemm", "lstm_train_walk", "lstm_walk", "dw_tma")
    for key in ("compute_dtype", "as shipped"):
        gc.collect()
        torch.cuda.empty_cache()
        name = f"improved_step_{key.replace(' ', '_')}"
        cfg = _train_config(work, lists, name, recipe=_recipe(IMPROVED_16K, "train"),
                            num_workers=0)
        if key == "compute_dtype":
            cfg.write_text(cfg.read_text().replace(
                "[model.args]\n", '[model.args]\ncompute_dtype = "bfloat16"\n', 1))
        trainer = Trainer(load_config(cfg), output_dir=str(work / name), device="cuda")
        noisy, clean = (v.cuda() for v in _first_batch(trainer, batch))
        for _ in range(2):
            trainer.train_step(noisy, clean)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in _wrappers().values():
            k.reset_counts()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            trainer.train_step(noisy, clean)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launched = {k: sum(v.values()) // 5 for k, v in _launched().items()}
        median = sorted(times)[2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        audio_s = batch * noisy.shape[1] / 16000
        if key == "compute_dtype":
            check(all(k in launched for k in bf16_stages)
                  and not any(k in launched for k in fp32_stages),
                  f"Improved compute_dtype step: launches a step {launched}")
        print(f"Improved FullSubNet 16 kHz train step B={batch} x 3.072 s, use_amp, {key}: median "
              f"{median * 1e3:.1f} ms of {[round(v * 1e3, 1) for v in times]}, "
              f"{audio_s / median:.2f} audio-s/s, peak memory {peak:.2f} GiB; launches a step "
              f"{launched} [{card}]")
        result[key] = {"ms": median * 1e3, "audio_s_per_s": audio_s / median, "peak_gib": peak,
                       "launches": launched}
        del trainer
    torch.cuda.empty_cache()
    return result


def phase_bf16_forward(work: Path, card: str, lists=None) -> dict:
    """Phase 25: the sweep of K1-bf16's walk forms behind its picker
    (``BF16_SWEEP_N``); K1-bf16 and K1-GRU-bf16 against their plain versions at
    ``BF16_FWD_CASES`` (every walk form timed at each, with block 0's
    cycles, the dispatched form held within ``PICKED_WALK_RATIO`` of the
    fastest, the tensor-core walk at each tile, beside the fp32 K1,
    the plain version and cuDNN at bf16 + Linear); the main path, Improved
    FullSubNet with compute_dtype at B = 1 and 16 x 10 s on the card for
    both cells (launches by kernel and form, card vs CPU, RTF beside fp32);
    the same model served; the recipe's train step with compute_dtype beside
    the recipe as shipped."""
    import numpy as np

    if lists is None:
        lists = _write_train_data(work / "train_data")
    sweep = _bf16_form_sweep(card)
    rows = {}
    for cell in ("lstm", "gru"):
        rng = np.random.default_rng(SEED + 25 + (cell == "gru"))
        rows[cell] = [_bf16_case(card, cell, rng, *case) for case in BF16_FWD_CASES]
        # the sweep that sets pick_fwd_bf16_form's crossovers: both layers'
        # walks in each form by case, the picked form and the fastest
        print(f"K1-bf16 {cell} walk forms by case (ms, both layers) [{card}]: " + json.dumps(
            {r["name"].split(":")[0]: {**{f: round(v["ms"], 3) for f, v in r["walk"].items()},
                                        "picked": r["picked"], "fastest": r["fastest"]}
             for r in rows[cell]}))
    paths = {cell: _improved_bf16_path(work, card, cell) for cell in ("LSTM", "GRU")}
    served = _improved_bf16_served(work, card, paths["LSTM"].pop("ckpt"))
    paths["GRU"].pop("ckpt")
    step = _improved_bf16_step(work, lists, card)
    return {"form_sweep": sweep, "cases": rows, "paths": paths, "served": served, "step": step}


# ---------------------------------------------------------------------------
# phase 26: the time-chunked training stash (K1's stages forward chunk by
# chunk, K2 re-run from each chunk's boundary state and K3/K4 with their
# carries chained backward) and the fused sub-band input
# ---------------------------------------------------------------------------

# the batched Inferencer's peak at B=128 x 30 s with the unfused sub-band
# input (PERF.md §5), beside phases 8 and 8b's fused one
UNFUSED_B128_PEAK_GIB = 24.14
# the forced chunk of (1): T = 195 frames take chunks of 64, 64, 64 and 3
CHUNKED_FORCED = 64
# (cell, storage, batch) of (1)'s steps, chunked against unchunked
CHUNKED_CASES = (("LSTM", "bf16", 32), ("GRU", "bf16", 32), ("LSTM", "fp32", 8))
# the chunked step against the unchunked one, same batch and weights: the
# loss, and each gradient within this share of its largest magnitude. fp32:
# the forward's K1 stages against K2's and every sum in another order, as a
# step card vs CPU (phase 10's tolerances); bf16: the re-run restarts from
# boundary states rounded to bf16, a bf16 step (2^-8 relative) the
# recurrence carries on, as the bf16 step card vs CPU (GRAD_RTOL_BF16)
CHUNKED_RTOL = {"bf16": (STEP_LOSS_RTOL_BF16, GRAD_RTOL_BF16),
                "fp32": (STEP_LOSS_RTOL, STEP_GRAD_RTOL)}
# (2): the flagship bf16 step at B=32 x 30 s crops, median of 3 after a warm-up
LONG_BATCH, LONG_SECONDS, LONG_STEPS = 32, 30, 3
# the step's peak above what it starts from, against the accounting's
# prediction for the sub-band stage's call (``ops.train_bwd_peak_bytes``)
CHUNKED_MEMORY_RTOL = 0.15
# (3): the fused stage against the unfused route at inference, B=8 x 10 s:
# the same K1 stages on inputs normalised in another order (the mean summed
# another way), fp32
FUSED_BATCH = 8


def _all_counts() -> dict:
    """Every kernel wrapper's (launches, by shape, by form), by name."""
    return {k: (w.launches, dict(w.launches_by_shape), dict(w.launches_by_form))
            for k, w in _wrappers().items()}


def _chunked_step_launches(cell: str, dtype: str, chunks: int) -> dict:
    """What one flagship step launches by wrapper name when its sub-band
    stage's stash is chunked over time in ``chunks`` chunks (0: not), the
    full-band stage's never, fixed here and not read from the code under
    test. An unchunked stage of two layers with a head: 3 forward GEMMs, 2
    training walks, 4 backward GEMMs, 2 backward walks, 2 dW stages (GRU: 4).
    A chunked one, each chunk: K1's 3 GEMMs and 2 walks forward (K1-bf16's at
    bf16), then K2's 3 GEMMs and 2 training walks re-run, and the backward's
    4 GEMMs, 2 walks and dW stages. Every other wrapper: 0."""
    c = cell.lower()
    bf16 = dtype == "bf16"
    gemm = "tc_gemm" if bf16 else "fwd_gemm"
    train_walk, walk = (f"{c}_train_walk", f"{c}_walk") if bf16 else (f"{c}_train_walk_f32",
                                                                      f"{c}_walk_f32")
    dw = 1 if c == "lstm" else 2
    whole = 1 if chunks else 2  # stages that keep the full stash
    want = {gemm: 7 * whole + 10 * chunks, train_walk: 2 * (whole + chunks),
            walk: 2 * (whole + chunks), "dw_tma": 2 * dw * (whole + chunks)}
    if chunks:
        want[f"{c}_fwd_walk" + ("_bf16" if bf16 else "")] = 2 * chunks
    return want


def _check_chunked_launches(counts: dict, cell: str, dtype: str, chunks: int, where: str):
    want = _chunked_step_launches(cell, dtype, chunks)
    got = {k: v[0] for k, v in counts.items() if v[0]}
    check(got == want, f"{where} launched {got}, want {want} (the formula at {chunks} chunks)")


def _chunked_vs_full(work: Path, lists: dict, card: str) -> dict:
    """(1) Each of CHUNKED_CASES at 3.072 s: the step's loss and gradients
    with the sub-band stage's chunk forced to CHUNKED_FORCED against the
    same step unchunked (the budget's pick, 0 here), same weights and batch;
    both steps' launches against the formula."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.ops import subband_lstm as ops
    from fullsubnet_tpu_torch.train.trainer import Trainer

    out = {}
    for cell, dtype, batch in CHUNKED_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        name = f"chunked_{cell}_{dtype}_{batch}"
        trainer = Trainer(load_config(_train_config(
            work, lists, name, cell, use_amp="true" if dtype == "bf16" else "false",
            num_workers=0)), output_dir=str(work / name), device="cuda")
        noisy, clean = (v.cuda() for v in _first_batch(trainer, batch))
        frames = _frames(noisy.shape[1])
        chunks = -(-frames // CHUNKED_FORCED)
        runs = {}
        for forced in (None, CHUNKED_FORCED):
            trainer.model.subband_time_chunk = forced
            for kernel in _wrappers().values():
                kernel.reset_counts()
            ops.train_chunks.clear()
            loss = float(trainer.loss_and_grads(noisy, clean))
            torch.cuda.synchronize()
            grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
            runs[forced] = (loss, grads, _all_counts(), dict(ops.train_chunks))
        (full_loss, full, full_counts, full_chunks), (loss, got, counts, took) = runs.values()
        label = f"{cell} {dtype} B={batch} x 3.072 s"
        check(full_chunks == {0: 2}, f"the unchunked {label} step took chunks {full_chunks}")
        check(took == {0: 1, CHUNKED_FORCED: 1}, f"the chunked {label} step took chunks {took}")
        _check_chunked_launches(full_counts, cell, dtype, 0, f"the unchunked {label} step")
        _check_chunked_launches(counts, cell, dtype, chunks, f"the chunked {label} step")
        rel = _errors_by_key(got, full)
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss - full_loss) / abs(full_loss)
        loss_tol, grad_tol = CHUNKED_RTOL[dtype]
        print(f"chunked step, flagship {label} (sub-band N={batch * 128}, T={frames}), chunk "
              f"{CHUNKED_FORCED} ({chunks} chunks, the last {frames - (chunks - 1) * CHUNKED_FORCED}"
              f" steps) vs the full stash: loss {loss:.8e} vs {full_loss:.8e} (rel "
              f"{loss_rel:.2e}, tol {loss_tol:g}); gradient error / max, worst {rel[worst]:.2e} "
              f"at {worst} (tol {grad_tol:g}); launches chunked "
              f"{ {k: v[0] for k, v in counts.items() if v[0]} }, unchunked "
              f"{ {k: v[0] for k, v in full_counts.items() if v[0]} } [{card}]")
        check(loss_rel <= loss_tol, f"{label} chunked loss vs unchunked {loss_rel:.2e}")
        check(rel[worst] <= grad_tol, f"{label} chunked gradient {worst} {rel[worst]:.2e}")
        out[label] = {"loss_rel": loss_rel, "grad_rel_worst": rel[worst], "chunks": chunks,
                      "counts": counts}
        del trainer, runs, full, got
    return out


def _train_op_bound(t: int, n: int, f_in: int, hidden: int, out_dim: int,
                    cell: str) -> tuple[float, str]:
    """The bound of one training call of a two-layer bf16 stack, forward and
    backward: the forward's FLOPs and the layer backward's (its two GEMMs
    and the dW products, 3x the forward's a layer), each input (x, the
    weights, the cotangent) read once and each output (out, dx, the fp32
    weight gradients) written once. What the chunked scheme computes again
    is not work the function needs."""
    flops = (stack_flops(t, n, f_in, hidden, out_dim, cell=cell)
             + roofline.layer_bwd_flops(t, n, f_in, hidden, cell=cell))
    weights = weight_elems(f_in, hidden, out_dim, cell=cell)
    nbytes = 2 * (2 * t * n * f_in + weights) + 4 * (2 * t * n * out_dim + weights)
    return bound(flops, nbytes, "bf16")


@contextlib.contextmanager
def _plain_dispatch():
    """The op's device dispatch sends CUDA tensors to the plain versions:
    the plain stages composed as on the CPU, run on the card."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    device_of = ops._device_of
    ops._device_of = lambda x: "cpu"
    try:
        yield
    finally:
        ops._device_of = device_of


def _chunked_op_times(card: str) -> dict:
    """(1b) The training op alone at the flagship sub-band stage's shape
    (N = 4,096, T = 195, bf16), forward and backward, both cells: chunked
    (CHUNKED_FORCED) on the kernels, unchunked on the kernels, chunked on
    the plain stages on the card, and cuDNN (nn.LSTM / nn.GRU at bf16 +
    Linear) on the same weights; the chunked kernels held to the plain
    chunked op (GRAD_RTOL_BF16 of each gradient's largest) and timed beside
    the bound."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    t, n, f_in, hidden, out_dim = 195, 4096, 32, 384, 2
    bf16, out = torch.bfloat16, {}
    for cell in ("lstm", "gru"):
        rng = np.random.default_rng(SEED + 26)
        layers, fc = _stack(rng, f_in, hidden, out_dim, "cuda", cell)
        x = torch.from_numpy(rng.standard_normal((t, n, f_in)).astype(np.float32)).cuda()
        target = torch.from_numpy(rng.standard_normal((t, n, out_dim)).astype(np.float32)).cuda()

        def run(chunk):
            return _op_loss_grads(lambda xr, s, h: ops.fused_subband_lstm(
                xr, *s, h, time_chunk=chunk), x, layers, fc, target, bf16)

        got = run(CHUNKED_FORCED)  # each first call here is its warm-up
        with _plain_dispatch():
            want = run(CHUNKED_FORCED)
            plain_ms = cuda_ms(lambda: run(CHUNKED_FORCED), reps=1, warmup=0)
        err = max(_rel_errs(got[1], want[1]))
        ms = cuda_ms(lambda: run(CHUNKED_FORCED), warmup=0)
        full_ms = cuda_ms(lambda: run(0))
        rnn = _cudnn_rnn(layers, f_in, hidden, bf16, x.device, cell)
        head_w, head_b = fc["weight"].to(bf16), fc["bias"].to(bf16)

        def cudnn():
            xr = x.to(bf16).requires_grad_()
            y = torch.nn.functional.linear(rnn(xr)[0], head_w, head_b)
            loss = torch.mean((y.float() - target) ** 2)
            return torch.autograd.grad(loss, [xr, *rnn.parameters()])

        library_ms = cuda_ms(cudnn)
        bound_ms, bound_by = _train_op_bound(t, n, f_in, hidden, out_dim, cell)
        print(f"chunked training op, {cell.upper()} bf16, N={n}, T={t}, chunk {CHUNKED_FORCED}, "
              f"forward and backward: {ms:.2f} ms (unchunked {full_ms:.2f} ms), the plain chunked "
              f"op on the card {plain_ms:.1f} ms, cuDNN + Linear {library_ms:.2f} ms, bound "
              f"{bound_ms:.3f} ms ({bound_by}); gradients vs the plain chunked op: worst "
              f"{err:.2e} of the largest (tol {GRAD_RTOL_BF16:g}) [{card}]")
        check(err <= GRAD_RTOL_BF16, f"chunked {cell} op vs plain {err:.2e}")
        out[cell] = {"max_abs_err": err, "ms": ms, "unchunked_ms": full_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        del rnn, got, want, x, target
        torch.cuda.empty_cache()
    return out


def _chunked_long_step(work: Path, lists: dict, card: str) -> dict:
    """(2) The flagship bf16 step at B=32 x 30 s crops: the chunk the
    sub-band stage's share picks, finite loss and gradients, the launches
    against the formula at that chunk, the median of LONG_STEPS steps after a
    warm-up, the peak memory beside the accounting's prediction and the
    card's memory, and the unchunked route's predicted bytes (not run)."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.models.fullsubnet import FullSubNet
    from fullsubnet_tpu_torch.ops import subband_lstm as ops
    from fullsubnet_tpu_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(load_config(_train_config(work, lists, "chunked_long", "LSTM",
                                                num_workers=0)),
                      output_dir=str(work / "chunked_long"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    samples = LONG_SECONDS * 16000
    clean = 0.05 * torch.randn(LONG_BATCH, samples, device="cuda", generator=gen)
    noisy = clean + 0.05 * torch.randn(LONG_BATCH, samples, device="cuda", generator=gen)
    frames, rows = _frames(samples), LONG_BATCH * 128
    budget = ops.stash_budget_bytes(FullSubNet._TRAIN_STASH_SHARE, "cuda")
    shape = (frames, rows, 384, 32, 2, "lstm", 2, budget, 2)
    predicted = ops.train_bwd_peak_bytes(*shape)
    unchunked = ops.train_bwd_peak_bytes(*shape, time_chunk=0)
    total = torch.cuda.get_device_properties(0).total_memory

    for kernel in _wrappers().values():
        kernel.reset_counts()
    ops.train_chunks.clear()
    loss = float(trainer.loss_and_grads(noisy, clean))
    torch.cuda.synchronize()
    counts, took = _all_counts(), dict(ops.train_chunks)
    finite = all(bool(torch.isfinite(p.grad).all()) for p in trainer.model.parameters())
    check(math.isfinite(loss) and finite, f"B=32 x 30 s loss {loss} or a gradient not finite")
    chunk = max(took)
    check(chunk > 0 and took == {0: 1, chunk: 1},
          f"B=32 x 30 s: the sub-band stage did not chunk its stash ({took})")
    chunks = -(-frames // chunk)
    _check_chunked_launches(counts, "LSTM", "bf16", chunks, "the B=32 x 30 s step")

    def step():
        trainer.train_step(noisy, clean)
        torch.cuda.synchronize()

    step()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    median = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated()
    audio_s = LONG_BATCH * LONG_SECONDS
    off = (peak - held) / predicted - 1
    dw_ms = _dw_ms_of(step)
    op = _long_op_ms(frames, rows, budget)
    print(f"chunked step, flagship LSTM bf16 B={LONG_BATCH} x {LONG_SECONDS} s (sub-band N={rows}, "
          f"T={frames}): chunk {chunk} ({chunks} chunks), loss {loss:.6e}, gradients finite; "
          f"median {median * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]}, "
          f"{audio_s / median:.2f} audio-s/s; peak memory {peak / 2**30:.2f} GiB of the card's "
          f"{total / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held between steps, against the accounting's "
          f"{predicted / 2**30:.2f} GiB for the sub-band stage's call ({off:+.3f}, tol "
          f"{CHUNKED_MEMORY_RTOL:g}); the unchunked route would hold {unchunked / 2**30:.2f} GiB "
          f"(not run); the sub-band stage's budget {budget / 2**30:.2f} GiB; launches "
          f"{ {k: v[0] for k, v in counts.items() if v[0]} }; the sub-band stage's op alone, "
          f"forward and backward at chunk {op['chunk']}: {op['ms']:.1f} ms, bound "
          f"{op['bound_ms']:.2f} ms ({op['bound_by']}); cuDNN bf16 nn.LSTM + Linear over the "
          f"same chunks of {op['library_chunk']} frames ((h, c) carried, each chunk under "
          f"torch.utils.checkpoint), forward and backward: {op['library_ms']:.1f} ms; the dW "
          f"stage (dw_tma, {dw_ms['launches']} launches) {dw_ms['ms']:.1f} ms of a step, "
          f"{dw_ms['ms'] / (median * 1e3):.1%} of the median step [{card}]")
    check(abs(off) <= CHUNKED_MEMORY_RTOL,
          f"B=32 x 30 s peak {(peak - held) / 2**30:.2f} GiB above the held memory is "
          f"{off:+.3f} off the accounting's {predicted / 2**30:.2f} GiB")
    check(peak < total, "B=32 x 30 s peak memory over the card's")
    del trainer, noisy, clean
    gc.collect()
    torch.cuda.empty_cache()
    return {"chunk": chunk, "chunks": chunks, "ms": median * 1e3, "op": op, "dw": dw_ms,
            "audio_s_per_s": audio_s / median, "peak_gib": peak / 2**30,
            "step_gib": (peak - held) / 2**30, "predicted_gib": predicted / 2**30,
            "unchunked_predicted_gib": unchunked / 2**30, "counts": counts}


def _dw_ms_of(step) -> dict:
    """The dW stage's device time in one run of ``step``: CUDA events around
    each ``weight_grads`` call the backward makes, summed (ms), and its
    launches of ``dw_tma``."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    events = []
    inner = ops.weight_grads

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args)
        end.record()
        events.append((start, end))
        return out

    ops.dw_tma.reset_counts()
    ops.weight_grads = timed
    try:
        step()
    finally:
        ops.weight_grads = inner
    torch.cuda.synchronize()
    return {"ms": sum(a.elapsed_time(b) for a, b in events), "calls": len(events),
            "launches": ops.dw_tma.launches}


def _cudnn_chunked_ms(frames: int, rows: int, chunk: int, layers, fc) -> float:
    """cuDNN bf16 ``nn.LSTM`` + Linear over chunks of ``chunk`` frames,
    (h, c) carried, each chunk under ``torch.utils.checkpoint`` (its
    backward re-runs the chunk, as the port's chunked stash does), forward
    and backward of the mean squared error: ms (one call after a warm-up).
    A yardstick the port never calls."""
    import torch
    from torch.utils.checkpoint import checkpoint

    rnn = _cudnn_rnn(layers, 32, 384, torch.bfloat16, "cuda")
    w_fc, b_fc = fc["weight"].to(torch.bfloat16), fc["bias"].to(torch.bfloat16)
    x = torch.randn(frames, rows, 32, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    target = torch.randn(frames, rows, 2, device="cuda")

    def chunk_fn(xc, h, c):
        out, (h2, c2) = rnn(xc, (h, c))
        return out @ w_fc.t() + b_fc, h2, c2

    def run():
        h = torch.zeros(2, rows, 384, device="cuda", dtype=torch.bfloat16)
        c = torch.zeros_like(h)
        outs = []
        for t0 in range(0, frames, chunk):
            y, h, c = checkpoint(chunk_fn, x[t0 : t0 + chunk], h, c, use_reentrant=False)
            outs.append(y)
        loss = torch.mean((torch.cat(outs).float() - target) ** 2)
        return torch.autograd.grad(loss, [x, *rnn.parameters()])

    try:
        return cuda_ms(run, reps=1)
    finally:
        del rnn, x, target
        torch.cuda.empty_cache()


def _long_op_ms(frames: int, rows: int, budget: int) -> dict:
    """The sub-band stage's training op alone at the B=32 x 30 s shape (bf16
    LSTM, random weights and input), forward and backward under the
    stage's budget: ms (one call after a warm-up) and the bound."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    rng = np.random.default_rng(SEED + 27)
    layers, fc = _stack(rng, 32, 384, 2, "cuda")
    x = torch.randn(frames, rows, 32, device="cuda")
    target = torch.randn(frames, rows, 2, device="cuda")

    def run():
        return _op_loss_grads(lambda xr, s, h: ops.fused_subband_lstm(
            xr, *s, h, stash_budget=budget), x, layers, fc, target, torch.bfloat16)

    ops.train_chunks.clear()
    ms = cuda_ms(run, reps=1)
    bound_ms, bound_by = _train_op_bound(frames, rows, 32, 384, 2, "lstm")
    chunk = max(ops.train_chunks)
    del x, target
    torch.cuda.empty_cache()
    # the library yardstick over the same chunks; where one chunk's cuDNN
    # workspace does not fit, the largest chunk (halving) that does
    library_chunk = chunk
    while True:
        try:
            library_ms = _cudnn_chunked_ms(frames, rows, library_chunk, layers, fc)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            check(library_chunk > 1, "cuDNN fits no chunk at the B=32 x 30 s shape")
            library_chunk //= 2
    return {"ms": ms, "chunk": chunk, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_chunk": library_chunk}


def _fused_vs_unfused(card: str) -> dict:
    """(3) The fused sub-band stage forced at inference (threshold 0)
    against the unfused route at B=8 x 10 s, full width, random weights from
    the seed, both fusable norms: the cRM, the peak memory, and equal K1
    launches by shape."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex
    from fullsubnet_tpu_torch.models.fullsubnet import FullSubNet

    wave = np.random.default_rng(SEED + 26).standard_normal(160000).astype(np.float32) * 0.1
    spec = stft_complex(torch.from_numpy(wave).cuda(), 512, 256, 512)
    mag = spec.abs()[None, None].expand(FUSED_BATCH, 1, -1, -1).contiguous()
    out = {}
    for norm in ("offline_laplace_norm", "cumulative_laplace_norm"):
        model = FullSubNet(norm_type=norm, generator=torch.Generator().manual_seed(SEED)).cuda()
        runs = {}
        for route, threshold in (("unfused", FullSubNet._FUSED_SB_THRESHOLD), ("fused", 0)):
            model._FUSED_SB_THRESHOLD = threshold
            for kernel in _wrappers().values():
                kernel.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.inference_mode():
                crm = model(mag, dropping_band=False)
                torch.cuda.synchronize()
            runs[route] = (crm, (torch.cuda.max_memory_allocated() - base) / 2**30,
                           {k: dict(w.launches_by_shape) for k, w in _wrappers().items()
                            if w.launches})
        err = float((runs["fused"][0] - runs["unfused"][0]).abs().max())
        print(f"fused sub-band stage vs the unfused route, {norm}, B={FUSED_BATCH} x 10 s "
              f"(inference, forced): max|cRM difference| {err:.3e} (tol {KERNEL_ATOL:g}); "
              f"the forward's peak above its input {runs['fused'][1]:.3f} GiB fused, "
              f"{runs['unfused'][1]:.3f} GiB unfused [{card}]")
        check(err <= KERNEL_ATOL, f"fused vs unfused {norm}: {err:.3e}")
        check(runs["fused"][2] == runs["unfused"][2],
              f"fused vs unfused {norm}: launches {runs['fused'][2]} vs {runs['unfused'][2]}")
        out[norm] = {"err": err, "fused_gib": runs["fused"][1], "unfused_gib": runs["unfused"][1]}
        del model, runs
    return out


def _chunked_summary(chunked: dict) -> dict:
    """Phase 26's result without its launch counts (the kernels line has them)."""
    return {"forced": {k: {x: y for x, y in v.items() if x != "counts"}
                       for k, v in chunked["forced"].items()},
            "op": chunked["op"],
            "long": {k: v for k, v in chunked["long"].items() if k != "counts"},
            "fused": chunked["fused"]}


def phase_chunked_train(work: Path, card: str, lists=None) -> dict:
    """Phase 26: (1) chunked against unchunked steps at 3.072 s, and the
    chunked op alone against its plain version; (2) the flagship bf16 step
    at B=32 x 30 s, which needs the chunked stash; (3) the fused sub-band
    stage against the unfused route on the card."""
    if lists is None:
        lists = _write_train_data(work / "train_data")
    return {"forced": _chunked_vs_full(work, lists, card),
            "op": _chunked_op_times(card),
            "long": _chunked_long_step(work, lists, card),
            "fused": _fused_vs_unfused(card)}


# ---------------------------------------------------------------------------
# phase 27: the multi-card enhancer (parallel/inference.py): the flagship's
# batch split over a mesh's data axis, one host thread a slice, the slices
# gathered on the mesh's first card; --parallel-enhance times it on 1, 2 and
# 4 cards
# ---------------------------------------------------------------------------

# phase 27's batches: B=8 x 10 s (the plain form, fp32 and compute_dtype
# bf16) and B=8 over seeded lengths of 2-10 s in one bucket (bucketed)
ENHANCE_BATCH, ENHANCE_SECONDS, ENHANCE_SPAN = 8, 10, (2, 10)
# the enhancer against the one-card path (the model with full_band_crm_mask
# or bucketed_enhance) on the same rows a call, as a share of that output's
# peak: the same kernels on the same operands (the bits equal, as run); at
# fp32 also against the whole batch in one call, where only the GEMMs' and
# walks' tiles follow the rows
ENHANCER_RTOL = 1e-5
# compute_dtype bf16 against the whole batch in one call: the bf16 walk's
# form and tile plan follow its rows (pick_fwd_bf16_form, fwd_tc_plan), so
# a slice sums h . W_hh^T in another order and rounds h to bf16 at other
# values, which the recurrence carries as far as a bf16 model is from the
# fp32 one (3.87e-3 of the peak measured at data = 2, LSTM; the tests'
# BF16_VS_FP32_WAVE_RTOL)
ENHANCER_BF16_SPLIT_RTOL = 2e-2
# --parallel-enhance: the flagship LSTM at B=128 x 30 s on meshes of 1, 2
# and 4 cards (as many as the machine has), each median of 3 after a
# warm-up; the bucketed form over seeded lengths of 2-30 s
CARDS_BATCH, CARDS_SECONDS, CARDS_SPAN = 128, 30, (2, 30)
CARDS_MESHES = (1, 2, 4)


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _enhancer_setup(work: Path, cell: str):
    """The flagship inference recipe's model with ``cell`` (a template on the
    CPU), its seeded full-width weights as a state dict (as
    ``_write_flagship_checkpoint`` writes them) and its acoustics."""
    from fullsubnet_tpu_torch import config as config_lib
    from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict

    cfg = _inference_config(work, work, cell)
    ckpt = work / f"enhancer_{cell}.tar"
    _write_flagship_checkpoint(ckpt, cfg)
    config = config_lib.load_config(cfg)
    model, _ = config_lib.build_model(config)
    a = config_lib.acoustics_args(config)
    return (model.eval(), load_torch_state_dict(ckpt),
            {k: a[k] for k in ("n_fft", "hop_length", "win_length")})


def _bucket_batch(batch: int, span: tuple, seed: int):
    """``batch`` tones in noise of seeded lengths in ``span`` seconds,
    zero-padded into one bucket (the longest plus one FFT frame, rounded up
    to a second): (padded [B, bucket], lengths [B] int64), numpy."""
    import numpy as np

    sr = 16000
    lengths = np.random.default_rng(seed).integers(span[0] * sr, span[1] * sr + 1, batch)
    waves = _bf16_waves(batch, span[1], seed)
    bucket = -(-(span[1] * sr + 512) // sr) * sr
    padded = np.zeros((batch, bucket), np.float32)
    for i, n in enumerate(lengths):
        padded[i, :n] = waves[i, :n]
    return padded, lengths.astype(np.int64)


def _enhancer_launches(cell: str, bf16: bool, rows: int, frames: int, slices: int) -> dict:
    """What the enhancer's ``slices`` slices of ``rows`` utterances of
    ``frames`` frames (the look-ahead included) launch, by wrapper and
    shape: per slice and stage (full-band: N = rows of 257; sub-band: N =
    257 rows of 32), in the stage's time chunks (``ops.fwd_chunk_steps``:
    P [Tc, N, G·H] fp32 under 4 GiB), a GEMM for each layer's input
    projection and the head and a walk per layer: K1's (``fwd_gemm``, the
    cell's walk) at fp32, K1-bf16's (``tc_gemm`` at widths padded to 8, the
    bf16 walk) under compute_dtype."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    c = cell.lower()
    gates = GATES[c]
    gemm = "tc_gemm" if bf16 else "fwd_gemm"
    walk = f"{c}_fwd_walk" + ("_bf16" if bf16 else "")
    pad8 = lambda v: -(-v // 8) * 8  # noqa: E731
    want = collections.defaultdict(collections.Counter)
    for f_in, hidden, out_dim, n in ((257, 512, 257, rows), (32, 384, 2, 257 * rows)):
        chunks = -(-frames // ops.fwd_chunk_steps(frames, n, hidden, c)) * slices
        keys = ([(pad8(f_in), 0, gates * hidden), (hidden, 0, gates * hidden),
                 (hidden, 0, pad8(out_dim))] if bf16 else
                [(f_in, gates * hidden), (hidden, gates * hidden), (hidden, out_dim)])
        for key in keys:
            want[gemm][key] += chunks
        want[walk][(n, hidden)] += 2 * chunks
    return {k: dict(v) for k, v in want.items()}


def _enhancer_counted(fn, state, args):
    """``fn(state, *args)`` with every wrapper's counts set to 0 just before
    and read just after, the plain stages refused: (output, launches by
    wrapper and shape, launches by wrapper and card, the bf16 walks' by
    form)."""
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    for kernel in _wrappers().values():
        kernel.reset_counts()
    with _plain_stages_refused(PLAIN_STAGES + PLAIN_BF16_STAGES):
        out = fn(state, *args)
        _sync_all()
    by_card = {k: dict(w.launches_by_device) for k, w in _wrappers().items() if w.launches}
    forms = {k: dict(getattr(ops, k).launches_by_form)
             for k in ("lstm_fwd_walk_bf16", "gru_fwd_walk_bf16") if getattr(ops, k).launches}
    return out, _launched(), by_card, forms


def _check_enhancer_launches(label: str, launched: dict, by_card: dict, want: dict,
                             cards: dict) -> None:
    """The launches by shape equal ``want``; by card, each card's share:
    ``cards`` maps a card's index to the slices it ran."""
    check(launched == want, f"{label}: launches by shape {launched}, want {want}")
    slices = sum(cards.values())
    for name, shapes in want.items():
        total = sum(shapes.values())
        want_card = {i: total * k // slices for i, k in cards.items()}
        check(by_card.get(name) == want_card,
              f"{label}: {name} launches by card {by_card.get(name)}, want {want_card}")


def phase_parallel_enhancer(work: Path, card: str) -> dict:
    """Phase 27: ``make_parallel_enhancer`` on the flagship recipe at full
    width, LSTM and GRU, on a mesh of the card (data = 1) and of the card
    twice (data = 2: the split, the threads and the gather), the plain form
    at B=8 x 10 s, fp32 and compute_dtype bf16, and the bucketed form at B=8
    over 2-10 s: each output against the one-card path on the same rows a
    call (within ENHANCER_RTOL of its peak; whether the bits are equal) and
    on the whole batch in one call (ENHANCER_RTOL, at bf16
    ENHANCER_BF16_SPLIT_RTOL), K1's or K1-bf16's launches by shape and by
    card as the slices need, the plain stages refused, the weights on the
    card once."""
    import copy

    import torch

    from fullsubnet_tpu_torch.infer.inferencer import bucketed_enhance, full_band_crm_mask
    from fullsubnet_tpu_torch.parallel import make_mesh
    from fullsubnet_tpu_torch.parallel.inference import make_parallel_enhancer

    dev = torch.device("cuda", 0)
    noisy = torch.from_numpy(_bf16_waves(ENHANCE_BATCH, ENHANCE_SECONDS, SEED + 70))
    padded, lengths = map(torch.from_numpy, _bucket_batch(ENHANCE_BATCH, ENHANCE_SPAN,
                                                          SEED + 71))
    forms = {"fp32": ({}, (noisy,)), "bf16": ({"compute_dtype": torch.bfloat16}, (noisy,)),
             "bucketed": ({"bucketed": True}, (padded, lengths))}
    frames = {"fp32": _frames(noisy.shape[1]), "bf16": _frames(noisy.shape[1]),
              "bucketed": _frames(padded.shape[1])}
    meshes = {1: make_mesh(1, devices=[dev]), 2: make_mesh(2, devices=[dev, dev])}
    result = {}
    for cell in ("LSTM", "GRU"):
        model, state, acoustics = _enhancer_setup(work, cell)
        one = copy.deepcopy(model).to(dev)
        one.load_state_dict(state)

        def one_card(form, data):
            """The one-card path over the batch in ``data`` calls of its rows."""
            with torch.inference_mode():
                if form == "bucketed":
                    return torch.cat([bucketed_enhance(one, acoustics, w.to(dev), n.to(dev))
                                      for w, n in zip(padded.chunk(data), lengths.chunk(data))])
                return torch.cat([full_band_crm_mask(one, acoustics, w.to(dev),
                                                     torch.bfloat16 if form == "bf16" else None)
                                  for w in noisy.chunk(data)])

        whole = {form: one_card(form, 1) for form in forms}
        rows = {}
        for data, mesh in meshes.items():
            for form, (kwargs, args) in forms.items():
                label = f"enhancer {cell} data = {data} {form}"
                ref = whole[form] if data == 1 else one_card(form, data)
                fn = make_parallel_enhancer(model, mesh, **acoustics, **kwargs)
                out, launched, by_card, walk_forms = _enhancer_counted(fn, state, args)
                want = _enhancer_launches(cell, form == "bf16", ENHANCE_BATCH // data,
                                          frames[form], data)
                _check_enhancer_launches(label, launched, by_card, want, {0: data})
                check(out.device == dev and out.shape == ref.shape
                      and out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
                      f"{label}: output {out.dtype} {tuple(out.shape)} on {out.device}")
                err = float((out - ref).abs().max() / ref.abs().max())
                check(err <= ENHANCER_RTOL, f"{label}: {err:.3e} of the one-card path's peak "
                      f"on the same rows a call > {ENHANCER_RTOL:g}")
                split = float((out - whole[form]).abs().max() / whole[form].abs().max())
                tol = ENHANCER_BF16_SPLIT_RTOL if form == "bf16" else ENHANCER_RTOL
                check(split <= tol, f"{label}: {split:.3e} of the one-card path's peak on the "
                      f"whole batch > {tol:g}")
                fn(state, *args)
                check(fn.weight_loads == 1, f"{label}: the weights crossed {fn.weight_loads} "
                      "times for one weight set")
                rows[f"data = {data} {form}"] = {
                    "err": err, "bits_equal": bool(torch.equal(out, ref)),
                    "err_whole": split, "bits_equal_whole": bool(torch.equal(out, whole[form])),
                    "launches": {k: sum(v.values()) for k, v in launched.items()},
                    "by_card": by_card, "walk_forms": walk_forms}
                del fn, out
        print(f"multi-card enhancer, flagship {cell}, B={ENHANCE_BATCH} x {ENHANCE_SECONDS} s "
              f"(plain fp32 and compute_dtype bf16) and B={ENHANCE_BATCH} over "
              f"{ENHANCE_SPAN[0]}-{ENHANCE_SPAN[1]} s in a {padded.shape[1] / 16000:g} s bucket, "
              "against the one-card path on the same rows a call (tol "
              f"{ENHANCER_RTOL:g} of the peak) and on the whole batch (tol {ENHANCER_RTOL:g}, "
              f"bf16 {ENHANCER_BF16_SPLIT_RTOL:g}): "
              + "; ".join(f"{k}: {r['err']:.3e}, bits {'equal' if r['bits_equal'] else 'differ'}"
                          f"; whole batch {r['err_whole']:.3e}, bits "
                          f"{'equal' if r['bits_equal_whole'] else 'differ'}"
                          f", launches {r['launches']}, by card {r['by_card']}"
                          + (f", walk forms {r['walk_forms']}" if r["walk_forms"] else "")
                          for k, r in rows.items())
              + f"; the plain stages refused, the weights on the card once a weight set [{card}]")
        result[cell] = rows
        del one, whole
        gc.collect()
        torch.cuda.empty_cache()
    return result


def _busy_by_card(fn) -> tuple[float, dict]:
    """torch.profiler over one call of ``fn``: (its wall ms, each card's
    busy ms: the union of its device events' spans)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    spans = collections.defaultdict(list)
    for evt in prof.events():
        rng = evt.time_range
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and rng.end > rng.start:
            spans[evt.device_index].append((rng.start, rng.end))
    busy = {}
    for index, intervals in sorted(spans.items()):
        intervals.sort()
        total, (lo, hi) = 0, intervals[0]
        for s, e in intervals[1:]:
            if s > hi:
                total, lo, hi = total + hi - lo, s, e
            else:
                hi = max(hi, e)
        busy[index] = (total + hi - lo) / 1e3
    return wall, busy


def _scaling_case(label: str, fn, state, args, cell: str, bf16: bool, frames: int) -> dict:
    """One mesh's numbers for --parallel-enhance: a counted warm-up (the
    launches by shape and card), 3 timed calls (median), each card's peak
    memory, the gather alone after the slices finished, each slice's host
    time, each card's busy time from a profiled call; the output of the
    last timed call."""
    import torch

    out, launched, by_card, walk_forms = _enhancer_counted(fn, state, args)
    slice_devices = [d.index for d in fn.mesh.data_devices]
    cards = {i: slice_devices.count(i) for i in slice_devices}
    want = _enhancer_launches(cell, bf16, args[0].shape[0] // len(slice_devices), frames,
                              len(slice_devices))
    _check_enhancer_launches(label, launched, by_card, want, cards)
    del out
    gc.collect()
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    times = []
    for _ in range(3):
        out = None
        t0 = time.perf_counter()
        out = fn(state, *args)
        _sync_all()
        times.append(time.perf_counter() - t0)
    peaks = [torch.cuda.max_memory_allocated(i) / 2**30 for i in cards]
    slices = fn.shards(state, *args)
    _sync_all()
    enqueue = list(fn.enqueue_seconds)
    t0 = time.perf_counter()
    fn.gather(slices)
    _sync_all()
    gather_ms = (time.perf_counter() - t0) * 1e3
    del slices
    wall_ms, busy = _busy_by_card(lambda: fn(state, *args))
    return {"out": out, "median_s": sorted(times)[1], "times_s": times, "peak_gib": peaks,
            "gather_ms": gather_ms, "enqueue_s": enqueue, "profiled_wall_ms": wall_ms,
            "busy_ms": busy, "launches": {k: sum(v.values()) for k, v in launched.items()},
            "by_card": by_card, "walk_forms": walk_forms}


def phase_parallel_scaling(work: Path, card: str) -> dict:
    """``--parallel-enhance``: the flagship LSTM's enhancer at B=128 x 30 s
    on meshes of 1, 2 and 4 cards (those the machine has), fp32 then
    compute_dtype bf16: audio-s/s (median of 3 after a warm-up), the
    scaling efficiency against one card, each card's busy time and peak
    memory, the gather's time, each slice's host time, the launches by
    shape and card, and the output against the one-card mesh's (within
    ENHANCER_RTOL of its peak; bf16: ENHANCER_BF16_SPLIT_RTOL, and within
    ENHANCER_RTOL of the one-card path on the same rows a call); then the
    bucketed form at B=128 over 2-30 s on the most cards against one."""
    import copy

    import torch

    from fullsubnet_tpu_torch.infer.inferencer import full_band_crm_mask
    from fullsubnet_tpu_torch.parallel import make_mesh
    from fullsubnet_tpu_torch.parallel.inference import make_parallel_enhancer

    cards = torch.cuda.device_count()
    names = [torch.cuda.get_device_name(i) for i in range(cards)]
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(cards) for j in range(cards) if i != j}
    print(f"cards: {cards} ({names}); peer access {peer} [{card}]")
    meshes = [d for d in CARDS_MESHES if d <= cards]
    model, state, acoustics = _enhancer_setup(work, "LSTM")
    dev0 = torch.device("cuda", 0)
    one = copy.deepcopy(model).to(dev0)
    one.load_state_dict(state)
    noisy = torch.from_numpy(_bf16_waves(CARDS_BATCH, CARDS_SECONDS, SEED + 80))
    padded, lengths = map(torch.from_numpy, _bucket_batch(CARDS_BATCH, CARDS_SPAN, SEED + 81))
    result = {"cards": cards, "peer_access": peer}
    cases = [("fp32", {}, (noisy,), meshes), ("bf16", {"compute_dtype": torch.bfloat16},
                                               (noisy,), meshes),
             ("bucketed", {"bucketed": True}, (padded, lengths), sorted({1, meshes[-1]}))]
    for form, kwargs, args, datas in cases:
        rows, base = {}, None
        for data in datas:
            label = f"enhancer LSTM {form} on {data} card{'s' if data > 1 else ''}"
            fn = make_parallel_enhancer(model, make_mesh(data), **acoustics, **kwargs)
            run = _scaling_case(label, fn, state, args, "LSTM", form == "bf16",
                                _frames(args[0].shape[1]))
            out = run.pop("out")
            check(out.shape == args[0].shape and bool(torch.isfinite(out).all()),
                  f"{label}: output {tuple(out.shape)} not finite or misshapen")
            if base is None:
                base, run["err"], run["bits_equal"] = out, 0.0, True
            else:
                run["err"] = float((out - base).abs().max() / base.abs().max())
                run["bits_equal"] = bool(torch.equal(out, base))
                tol = ENHANCER_BF16_SPLIT_RTOL if form == "bf16" else ENHANCER_RTOL
                check(run["err"] <= tol, f"{label}: {run['err']:.3e} of the one-card mesh's "
                      f"peak > {tol:g}")
                if form == "bf16":
                    # and the one-card path on the same rows a call
                    with torch.inference_mode():
                        ref = torch.cat([full_band_crm_mask(one, acoustics, w.to(dev0),
                                                            torch.bfloat16)
                                         for w in noisy.chunk(data)])
                    run["err_slices"] = float((out - ref).abs().max() / ref.abs().max())
                    run["bits_equal_slices"] = bool(torch.equal(out, ref))
                    del ref
                    check(run["err_slices"] <= ENHANCER_RTOL, f"{label}: "
                          f"{run['err_slices']:.3e} of the one-card path's peak on the same rows "
                          f"a call > {ENHANCER_RTOL:g}")
            audio = (float(lengths.sum()) / 16000 if form == "bucketed"
                     else CARDS_BATCH * CARDS_SECONDS)
            run["audio_s_per_s"] = audio / run["median_s"]
            run["efficiency"] = (run["audio_s_per_s"]
                                 / (data * rows[1]["audio_s_per_s"]) if data > 1 else 1.0)
            rows[data] = run
            print(f"{label}: B={CARDS_BATCH}, {audio:.1f} audio-s: median "
                  f"{run['median_s'] * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in run['times_s']]}"
                  f", {run['audio_s_per_s']:.1f} audio-s/s, scaling efficiency "
                  f"{run['efficiency']:.3f}; each card's busy ms "
                  f"{ {k: round(v, 1) for k, v in run['busy_ms'].items()} } in a profiled call of "
                  f"{run['profiled_wall_ms']:.1f} ms; the gather {run['gather_ms']:.2f} ms; each "
                  f"slice's host launches {[round(s * 1e3, 1) for s in run['enqueue_s']]} ms; peak "
                  f"memory by card {[round(p, 2) for p in run['peak_gib']]} GiB; launches "
                  f"{run['launches']} by card {run['by_card']}"
                  + (f", walk forms {run['walk_forms']}" if run["walk_forms"] else "")
                  + f"; against one card {run['err']:.3e} of the peak, bits "
                  f"{'equal' if run['bits_equal'] else 'differ'}"
                  + (f"; against the one-card path on the same rows a call "
                     f"{run['err_slices']:.3e}, bits "
                     f"{'equal' if run['bits_equal_slices'] else 'differ'}"
                     if "err_slices" in run else "") + f" [{card}]")
            del fn, out
            gc.collect()
            for i in range(cards):
                with torch.cuda.device(i):
                    torch.cuda.empty_cache()
        del base
        result[form] = rows
    return result


# ---------------------------------------------------------------------------
# phase 28: the last modules of the JAX package in the port: the host mixer
# (native/), the roofline counts (roofline.py) and the tracing and timing
# (profiling.py)
# ---------------------------------------------------------------------------

# the host mixer's items against the numpy mix: tests/test_native.py's
# tolerances (the mixer sums and scales in double, numpy in float32)
MIX_ATOL, MIX_RTOL = 2e-4, 1e-3
MIX_ITEMS = 32
MIX_REVERB = 0.5
# K1's fp32 walk as the profiler names its kernel
K1_WALK_KERNEL = "rnn_fwd_walk_kernel"
# a measured share of the card's peak: above 1 only by the clock's error
SHARE_LIMIT = 1.05


def _mixer_datasets(section: dict, **args):
    """The training set of ``section`` with ``args``, mixing in the host
    mixer, and the same set mixing in numpy (``plain_snr_mix``)."""
    from fullsubnet_tpu_torch.config import build_dataset
    from fullsubnet_tpu_torch.data.datasets import TrainDataset

    def dataset():
        return build_dataset({**section, "args": {**section["args"], **args}}, "train")

    mixed, plain = dataset(), dataset()
    plain.snr_mix = TrainDataset.plain_snr_mix  # an instance's function: not bound
    return mixed, plain


def _last_mixer(work: Path, lists: dict, card: str) -> dict:
    """(a) The host mixer built on this host into a folder of its own (its
    seconds), and MIX_ITEMS seeded items of the flagship's training set at
    reverb MIX_REVERB against the same items mixed in numpy."""
    import numpy as np

    from fullsubnet_tpu_torch import native
    from fullsubnet_tpu_torch.config import load_config

    t0 = time.perf_counter()
    path = native.build_library(build_dir=work / "native_build")
    build_s = time.perf_counter() - t0
    section = load_config(_train_config(work, lists, "last_modules"))["train_dataset"]
    mixed, plain = _mixer_datasets(section, reverb_proportion=MIX_REVERB)
    mixed.set_epoch(1)
    plain.set_epoch(1)
    err, excess = 0.0, -1.0
    for i in range(MIX_ITEMS):
        for got, want in zip(mixed[i], plain[i], strict=True):
            check(got.dtype == np.float32 and got.shape == want.shape,
                  f"item {i}: {got.dtype} {got.shape} against {want.shape}")
            diff = np.abs(got.astype(np.float64) - want)
            err = max(err, float(diff.max()))
            excess = max(excess, float((diff - MIX_ATOL - MIX_RTOL * np.abs(want)).max()))
    print(f"host mixer: built by g++ in {build_s:.2f} s ({path.name}); {MIX_ITEMS} items of the "
          f"flagship's training set at reverb {MIX_REVERB} against the numpy mix: max|diff| "
          f"{err:.3e} (atol {MIX_ATOL:g}, rtol {MIX_RTOL:g}) [{card}]")
    check(excess <= 0, f"the host mixer's items against numpy: {excess:.3e} past the tolerance")
    return {"build_s": build_s, "items": MIX_ITEMS, "max_abs_err": err}


def _last_loader(work: Path, lists: dict, card: str, step_s: float) -> dict:
    """(b) The loader's steady ms a batch at the recipe's workers mixing in
    the host mixer (the path) and in numpy, over the same batches (the
    same epoch of the same lists), beside the bf16 step's ms."""
    from fullsubnet_tpu_torch.config import load_config

    repeated = dict(lists)
    repeated["clean"] = work / "clean_repeated_mixers.txt"
    repeated["clean"].write_text(lists["clean"].read_text() * LOADER_REPEAT)
    section = load_config(_train_config(work, repeated, "last_modules_loader"))["train_dataset"]
    workers = int(section["dataloader"]["num_workers"])
    mixed, plain = _mixer_datasets(section)
    rates = {}
    for label, ds in (("host mixer", mixed), ("numpy", plain)):
        rates[label] = _loader_rate(ds, workers)
    print(f"loader, num_workers={workers}, batch {SCALE_BATCH} x 3.072 s, steady ms a batch over "
          f"{rates['numpy']['timed_batches']} batches: host mixer "
          f"{rates['host mixer']['s_per_batch'] * 1e3:.2f}, numpy "
          f"{rates['numpy']['s_per_batch'] * 1e3:.2f}, beside the bf16 step's "
          f"{step_s * 1e3:.1f} ms [{card}]")
    return {"workers": workers, "step_ms": step_s * 1e3,
            **{label: r["s_per_batch"] * 1e3 for label, r in rates.items()}}


@contextlib.contextmanager
def _stage_spans(model):
    """``profiling.annotate`` spans "fullband" and "subband" around the
    flagship's two stacks, by module hooks (the model is not changed)."""
    from fullsubnet_tpu_torch import profiling

    hooks, open_spans = [], []
    for name, stack in (("fullband", model.fb_model), ("subband", model.sb_model)):
        def enter(module, args, name=name):
            span = profiling.annotate(name)
            span.__enter__()
            open_spans.append(span)

        def leave(module, args, out):
            open_spans.pop().__exit__(None, None, None)

        hooks += [stack.register_forward_pre_hook(enter), stack.register_forward_hook(leave)]
    try:
        yield
    finally:
        for hook in hooks:
            hook.remove()


def _traced_forward(model, wave10, logdir: Path) -> dict:
    """``profiling.trace`` around one forward of ``model`` on ``wave10`` (B=1)
    with the stages' spans, then ``timed`` and the allocator's peak: the
    trace file, its event names and its events by category."""
    import torch

    from fullsubnet_tpu_torch import profiling
    from fullsubnet_tpu_torch.acoustics.stft import stft_complex

    mag = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512).abs()[None, None]

    def forward():
        with torch.inference_mode():
            return model(mag, dropping_band=False)

    with _stage_spans(model):
        forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profiling.trace(logdir):
            forward()
            torch.cuda.synchronize()
    files = sorted(Path(logdir).glob("*.pt.trace.json"))
    check(len(files) == 1, f"the trace wrote {[f.name for f in files]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    return {"file": files[0].name, "bytes": files[0].stat().st_size,
            "names": sorted({e.get("name", "") for e in events}),
            "by_category": dict(collections.Counter(e.get("cat", "") for e in events)),
            "peak_bytes": profiling.device_memory_stats()["cuda:0"]["allocated_bytes.all.peak"],
            "frames": mag.shape[-1], "forward_s": profiling.timed(forward, iters=5, warmup=1)}


def _trace_child(spec: dict) -> int:
    """Entry of phase 28's tracing process (``--trace-child``): the flagship
    model from ``spec``'s TOML and weights, its forward traced as
    ``_traced_forward`` does; the result as JSON into ``spec["out"]``."""
    try:
        import numpy as np

        from fullsubnet_tpu_torch.config import load_config
        from fullsubnet_tpu_torch.infer.inferencer import Inferencer

        model = Inferencer(load_config(spec["cfg"]), spec["ckpt"], None, device="cuda").model
        result = _traced_forward(model, np.load(spec["wave"]), Path(spec["logdir"]))
        Path(spec["out"]).write_text(json.dumps(result))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def _last_trace(work: Path, card: str, cfg: Path, ckpt: Path, model, wave10,
                rtf_phase8) -> dict:
    """(c) ``profiling.trace`` around one flagship forward at B=1 x 10 s
    with the stages' spans, in a fresh process: the trace file holds both
    spans and K1's walk; ``timed``'s RTF beside phase 8's;
    ``device_memory_stats``'s peak. The same trace in this process beside
    it, its events by category recorded (late in the whole smoke this
    process's traces have held the spans but no kernel)."""
    import numpy as np

    seconds = wave10.size / 16000
    here = _traced_forward(model, wave10, work / "last_modules_trace_here")
    print(f"trace of one B=1 x {seconds:g} s forward in this process: {here['bytes']} bytes, "
          f"events by category {here['by_category']}; K1's walk named "
          f"{any(K1_WALK_KERNEL in n for n in here['names'])} [{card}]")
    np.save(work / "last_modules_wave.npy", wave10)
    spec = {"cfg": str(cfg), "ckpt": str(ckpt),
            "wave": str(work / "last_modules_wave.npy"),
            "logdir": str(work / "last_modules_trace"), "out": str(work / "last_modules.json")}
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--trace-child",
                            json.dumps(spec)], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(child.returncode == 0, f"the tracing process failed ({child.returncode}):\n"
          f"{child.stderr[-4000:]}")
    traced = json.loads(Path(spec["out"]).read_text())
    names = set(traced["names"])
    walks = sorted(n for n in names if K1_WALK_KERNEL in n)
    fwd_s = traced["forward_s"]
    phase8 = "not run" if rtf_phase8 is None else f"{rtf_phase8:.5f}"
    print(f"trace of one B=1 x {seconds:g} s forward in a fresh process ({child_s:.1f} s with "
          f"its start): {traced['file']}, {traced['bytes']} bytes, events by category "
          f"{traced['by_category']}; spans fullband {'fullband' in names}, subband "
          f"{'subband' in names}; K1's walk {walks[0][:70] if walks else None}; peak "
          f"{traced['peak_bytes'] / 2**20:.1f} MiB; timed {fwd_s * 1e3:.2f} ms, RTF "
          f"{fwd_s / seconds:.5f} (this process: {here['forward_s'] / seconds:.5f}; phase 8: "
          f"{phase8}) [{card}]")
    check({"fullband", "subband"} <= names, "the trace lacks a stage's span")
    check(bool(walks), f"the trace names no {K1_WALK_KERNEL}")
    return {"trace_bytes": traced["bytes"], "by_category": traced["by_category"],
            "frames": traced["frames"], "forward_s": fwd_s, "rtf": fwd_s / seconds,
            "rtf_here": here["forward_s"] / seconds, "rtf_phase8": rtf_phase8,
            "peak_bytes": traced["peak_bytes"], "here_by_category": here["by_category"],
            "here_names_walk": any(K1_WALK_KERNEL in n for n in here["names"])}


def _last_shares(card: str, model, frames: int, fwd_s: float, step_s: float) -> dict:
    """(d) ``roofline_fields`` of the flagship forward at B=1 x 10 s (fp32)
    and of the bf16 train step at B=32 x 3.072 s (drop_band's 2 groups),
    each in (0, SHARE_LIMIT]."""
    from fullsubnet_tpu_torch.acoustics.stft import num_stft_frames
    from fullsubnet_tpu_torch.config import build_model, load_config

    step_model, _ = build_model(load_config(TRAIN_RECIPE))
    shares = {
        "forward B=1 x 10 s": roofline.roofline_fields(model, 1, frames, fwd_s, itemsize=4),
        "bf16 step B=32 x 3.072 s": roofline.roofline_fields(
            step_model, 32, num_stft_frames(49152, 256, 512), step_s, itemsize=2,
            drop_groups=step_model.num_groups_in_drop_band, train=True),
    }
    for label, fields in shares.items():
        check(bool(fields), f"roofline_fields has no peaks for {card}")
        print(f"{label}: {fields['analytic_tflops']:.4f} TFLOP counted, mfu {fields['mfu']:.5f}, "
              f"hbm_bw_util_lb {fields['hbm_bw_util_lb']:.3e}, roofline_ratio "
              f"{fields['roofline_ratio']:.5f} (peak {fields['peak_tflops']:g} TFLOP/s) [{card}]")
        for key in ("mfu", "hbm_bw_util_lb", "roofline_ratio"):
            check(0 < fields[key] <= SHARE_LIMIT, f"{label}: {key} {fields[key]} outside "
                  f"(0, {SHARE_LIMIT}]")
    return shares


def phase_last_modules(work: Path, card: str, lists: dict, ckpt: Path, wave10,
                       step_s: float, rtf_phase8: float | None = None) -> dict:
    """Phase 28: the host mixer (a), the loader on it (b), a trace of the
    flagship forward (c), and the shares of the card's peak (d)."""
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer

    mixer = _last_mixer(work, lists, card)
    loader = _last_loader(work, lists, card, step_s)
    cfg = _inference_config(work, work, "LSTM")
    model = Inferencer(load_config(cfg), str(ckpt), None, device="cuda").model
    traced = _last_trace(work, card, cfg, ckpt, model, wave10, rtf_phase8)
    shares = _last_shares(card, model, traced["frames"], traced["forward_s"], step_s)
    return {"mixer": mixer, "loader_ms_a_batch": loader, "trace": traced, "shares": shares}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch finds no CUDA card; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "fullsubnet_tpu_torch").is_dir() or not TRAIN_RECIPE.is_file():
        print(f"FAIL: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--trace-child"]:
        # phase 28's tracing process
        return _trace_child(json.loads(sys.argv[2]))
    if sys.argv[1:2] == ["--scale-child"]:
        # phase 24's own child processes (a torchrun worker, a gloo rank)
        return _scale_child(json.loads(sys.argv[2]))
    if sys.argv[1:] == ["--parallel-enhance"]:
        # the multi-card enhancer on 1, 2 and 4 cards, after building its
        # libraries alone; run it on the machine with four cards
        from fullsubnet_tpu_torch.parallel.inference import kernel_libraries

        card = phase_environment()
        phase_build([library.NAME for library in kernel_libraries()])
        try:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                scaling = phase_parallel_scaling(Path(tmp), card)
                print(f"[--parallel-enhance: {time.perf_counter() - t0:.1f} s]")
        except Exception:
            traceback.print_exc()
            print("FAIL", file=sys.stderr)
            return 1
        print(json.dumps({"parallel_enhance": scaling}, default=str))
        print(card_line())
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--last-modules"]:
        # phase 28 alone, after the build: the flagship's weights and 10 s
        # wave as phase 7 makes them, and the bf16 step as phase 11 times it
        card = phase_environment()
        phase_build()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                work = Path(tmp)
                lists = _write_train_data(work / "train_data")
                ckpt = work / "flagship_LSTM_random.tar"
                _write_flagship_checkpoint(ckpt, _inference_config(work, work, "LSTM"))
                step_s = phase_train_step_numbers(work, lists, card)
                t0 = time.perf_counter()
                last = phase_last_modules(work, card, lists, ckpt, _flagship_wave10(work), step_s)
                print(f"[phase 28: last modules: {time.perf_counter() - t0:.1f} s]")
        except Exception:
            traceback.print_exc()
            print("FAIL", file=sys.stderr)
            return 1
        print(json.dumps({"last_modules": last}, default=str))
        print(card_line())
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--train-scale"]:
        # phase 24 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            scale = phase_train_scale(Path(tmp), card)
        print(json.dumps({"train_scale": scale}, default=str))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--validation-epoch"]:
        # one validation epoch of each cell at the DNS synthetic test set's
        # size, alone; the inference forward's library built first, so
        # that no epoch's forward holds the build
        import numpy as np

        from fullsubnet_tpu_torch.ops.subband_lstm import fwd_library

        card = phase_environment()
        fwd_library()
        with tempfile.TemporaryDirectory() as tmp:
            lists = _write_train_data(Path(tmp) / "train_data")
            t0 = time.perf_counter()
            lists["val"] = _write_validation_dirs(Path(tmp) / "val_at_size",
                                                  np.random.default_rng(SEED + 6),
                                                  (10,) * DNS_VAL_CLIPS)
            print(f"wrote 2 x {DNS_VAL_CLIPS} validation clips in {time.perf_counter() - t0:.1f} s")
            rows = [phase_validation_at_size(Path(tmp), lists, card, c) for c in ("LSTM", "GRU")]
        print(json.dumps({"validation_epoch": rows}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--families"]:
        # phases 17-20 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            lists = _write_train_data(Path(tmp) / "train_data")
            families = {}
            for f in FAMILIES:
                t0 = time.perf_counter()
                families[f] = phase_family(Path(tmp), lists, card, f)
                print(f"[phase {FAMILIES[f]['phase']}: {f}: {time.perf_counter() - t0:.1f} s]")
            t0 = time.perf_counter()
            families["tools"] = phase_tools(Path(tmp), card,
                                            families["subband_baseline"]["strategies"])
            print(f"[phase 21: tools: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"families": families}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--streaming"]:
        # phase 22 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            streaming = phase_streaming(Path(tmp), card)
            print(f"[phase 22: streaming: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"streaming": streaming}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--dw"]:
        # the dW stage alone, after the build
        card = phase_environment()
        phase_build()
        t0 = time.perf_counter()
        dw = phase_dw_alone(card)
        print(f"[dW stage alone: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"dw": dw}, default=str))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--chunked-train"]:
        # phase 26 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            chunked = phase_chunked_train(Path(tmp), card)
            print(f"[phase 26: chunked training stash: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"chunked_train": _chunked_summary(chunked)}, default=str))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--bf16-forward"]:
        # phase 25 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            bf16 = phase_bf16_forward(Path(tmp), card)
            print(f"[phase 25: K1-bf16: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"bf16_forward": bf16}, default=str))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--serving"]:
        # phase 23 alone, after the build
        card = phase_environment()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            served = phase_serving(Path(tmp), card)
            print(f"[phase 23: serving: {time.perf_counter() - t0:.1f} s]")
        print(json.dumps({"serving": served}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--batched-throughput"]:
        # phase 8b alone, for the checkout this script sits in (an earlier
        # commit's package, too): the flagship's weights and 10 s wave as
        # phase 7 makes them, the inference forward's library built first
        from fullsubnet_tpu_torch.ops.subband_lstm import fwd_library

        card = phase_environment()
        fwd_library()
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            cfg = _inference_config(work, work, "LSTM")
            ckpt = work / "flagship_LSTM_random.tar"
            _write_flagship_checkpoint(ckpt, cfg)
            result = phase_batched_throughput(work, _flagship_wave10(work), card, ckpt, None)
        print(json.dumps({"batched_throughput": result}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--fp32-step"]:
        # the fp32 train step's numbers alone, for the checkout this script
        # sits in (an earlier commit's package, too)
        card = phase_environment()
        with tempfile.TemporaryDirectory() as tmp:
            lists = _write_train_data(Path(tmp) / "train_data")
            for c in ("LSTM", "GRU"):
                phase_fp32_step_numbers(Path(tmp), lists, card, c)
        return 0
    try:
        t_start = time.perf_counter()

        def timed(label, fn, *args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            print(f"[phase {label}: {time.perf_counter() - t0:.1f} s]")
            return result

        card = timed("environment", phase_environment)
        timed("build", phase_build)
        k1 = timed("K1", phase_kernel_vs_plain, card)
        lstm_kernels = timed("K2/K3", phase_train_kernels, card)
        k1_gru = timed("K1-GRU", phase_kernel_vs_plain, card, "gru")
        gru_kernels = timed("K2-GRU/K4", phase_train_kernels, card, "gru")
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            e2e = timed("infer CLI", phase_end_to_end, work, card)
            forward = timed("RTF and B=128 x 30 s", phase_rtf, e2e["model"], e2e["wave10"], card)
            timed("inference profile", phase_profile, e2e["model"], e2e["wave10"], card)
            del e2e["model"]
            e2e["batched"] = timed("batched infer CLI", phase_batched_infer, work, card, "LSTM",
                                   e2e["ckpt"])
            timed("batched Inferencer B=128 x 30 s", phase_batched_throughput, work,
                  e2e["wave10"], card, e2e["ckpt"], forward)
            train = timed("train CLI", phase_train_end_to_end, work, card)
            lists = train["lists"]
            e2e["validation"] = timed("validation", phase_validation, work, lists, card)
            train["fp32_launches"] = timed("fp32 step card vs CPU", phase_card_vs_cpu_step, work,
                                           lists, card)
            step_s = timed("train step numbers", phase_train_step_numbers, work, lists, card)
            e2e_gru = timed("GRU infer CLI", phase_end_to_end, work, card, "GRU")
            del e2e_gru["model"]
            e2e_gru["batched"] = timed("GRU batched infer CLI", phase_batched_infer, work, card,
                                       "GRU", e2e_gru["ckpt"])
            train_gru = timed("GRU train CLI", phase_train_end_to_end, work, card, "GRU", lists)
            e2e_gru["validation"] = timed("GRU validation", phase_validation, work, lists, card,
                                          "GRU")
            train_gru["fp32_launches"] = timed("GRU fp32 step card vs CPU", phase_card_vs_cpu_step,
                                               work, lists, card, "GRU")
            timed("GRU train step numbers", phase_train_step_numbers, work, lists, card, "GRU")
            for c in ("LSTM", "GRU"):
                timed(f"{c} fp32 train step numbers", phase_fp32_step_numbers, work, lists, card, c)
            families = {f: timed(f"{FAMILIES[f]['phase']}: {f}", phase_family, work, lists, card, f)
                        for f in FAMILIES}
            families["tools"] = timed("21: tools", phase_tools, work, card,
                                      families["subband_baseline"]["strategies"])
            families["streaming"] = timed("22: streaming", phase_streaming, work, card)
            families["serving"] = timed("23: serving", phase_serving, work, card)
            families["train_scale"] = timed("24: training at scale", phase_train_scale, work,
                                            card, lists)
            bf16_fwd = timed("25: K1-bf16", phase_bf16_forward, work, card, lists)
            # every training call of phases 9-25 in this process kept the full stash
            from fullsubnet_tpu_torch.ops.subband_lstm import train_chunks

            print(f"training calls of the op in phases 9-25 by time chunk (0: the full stash): "
                  f"{dict(train_chunks)} [{card}]")
            check(set(train_chunks) == {0},
                  f"a recipe-shaped training call chunked its stash: {dict(train_chunks)}")
            chunked = timed("26: chunked training stash", phase_chunked_train, work, card, lists)
            parallel = timed("27: multi-card enhancer", phase_parallel_enhancer, work, card)
            last = timed("28: last modules", phase_last_modules, work, card, lists, e2e["ckpt"],
                         e2e["wave10"], step_s, forward["rtf_b1"])
        print(f"smoke phases took {time.perf_counter() - t_start:.1f} s")
    except Exception:  # every failed phase ends the run non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    def entry(name, source, replaces, launches, err, at, m):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": m["library_ms"], "at": at}

    stream = families["streaming"]
    served = families["serving"]["served"]
    at_scale = families.pop("train_scale")
    print(json.dumps({"train_scale": {k: v for k, v in at_scale.items() if k != "launches"}},
                     default=str))

    def scale_of(stage, lstm):
        """Phase 24's launches of a training kernel's stage by path (the
        LSTM's: phase 24 trains the flagship recipe)."""
        if not lstm:
            return {}
        return {"launches_train_at_scale": {path: c[stage]
                                            for path, c in at_scale["launches"].items()}}

    def enhancer_path(cell, kernel, forms, walk_form=None):
        """Phase 27's launches of ``kernel`` (the multi-card enhancer on the
        card and on the card twice, B=8) in its runs of ``forms``, where it
        launched; ``walk_form``: a bf16 walk's launches in that form."""
        got = {}
        for key, row in parallel[cell].items():
            if key.split()[-1] in forms:
                n = (row["walk_forms"].get(kernel, {}).get(walk_form, 0) if walk_form
                     else row["launches"].get(kernel, 0))
                if n:
                    got[f"multi-card enhancer (phase 27), {key}, B={ENHANCE_BATCH}"] = n
        return got

    def by_path(e2e_run, kernel):
        """The inference forward's launches on each path that runs it; the
        streaming recipe's (LSTM) a hop, and K1 at T = 1 at every shape a
        hop runs (phase 22); the served programs' (phase 23): the bucketed
        program on 10 s, the batched one on 8 utterances, the stream a hop
        (the GRU copy's for K1-GRU)."""
        cell = "lstm" if e2e_run is e2e else "gru"
        per_hop = stream["flagship"]["launches_per_hop"]
        launched = lambda run: sum(served[run]["launches"].get(kernel, {}).values())  # noqa: E731
        stream_run = "stream" if cell == "lstm" else "gru"
        serving_paths = {
            f"served stream ({'inference_cum.toml' if cell == 'lstm' else 'its GRU copy'}), a "
            "hop": launched(stream_run) / served[stream_run]["hops"]}
        if cell == "lstm":
            serving_paths.update({
                "served bucketed program, B=1 x 10 s": launched("b1"),
                f"served batched program, {SERVE_BATCH} utterances": launched("batch"),
                f"served {SERVE_LANES} lanes, a tick": launched("lanes") / served["lanes"]["ticks"]})
        return {"launches_by_path": {"infer CLI": e2e_run["launches"][kernel],
                                     "batched infer CLI": e2e_run["batched"][kernel],
                                     **enhancer_path(cell.upper(), kernel, ("fp32", "bucketed")),
                                     "validation (-V)": e2e_run["validation"][kernel],
                                     "streaming, a hop (inference_cum.toml)":
                                         sum(per_hop.get(kernel, {}).values()),
                                     **serving_paths},
                "at_t1_carried_state": [{k: r[k] for k in ("name", "max_abs_err", "ms", "walk_ms",
                                                           "wall_ms", "plain_ms", "bound_ms",
                                                           "bound_by", "library_ms",
                                                           "launches_a_call")}
                                        for r in stream["t1"][cell]]}

    at_fwd = ("sub-band float32, N=4096, T=195, both layers and the head (the fp32 storage "
              "route of the earlier design; launches from the fp32 B=4 step); max_abs_err over "
              "the fp32 cases; plain_ms, bound_ms and library_ms those of the whole forward")
    at_fwd_f32 = ("sub-band float32, N=4096, T=195, both layers (and the head, for the GEMM); "
                  "launches from the fp32 B=4 step; max_abs_err over both training shapes")
    at_fwd_f32_cluster = ("full-band float32, N=32, T=195, both layers; launches from the fp32 "
                          "B=4 step (its full-band stage, N=4); max_abs_err over both training "
                          "shapes")
    at_bwd = ("sub-band float32, N=4096, T=195, both layers with the dW products; launches from "
              "the fp32 B=4 step; max_abs_err over both training shapes")
    at_tc = ("sub-band bfloat16, N=4096, T=195, both layers; launches from the bf16 train CLI "
             "run; max_abs_err over both training shapes")
    at_f32 = ("sub-band float32, N=4096, T=195, both layers; launches from the fp32 B=4 step; "
              "max_abs_err over both training shapes")
    at_dw = ("sub-band bfloat16, N=4096, T=195, both layers; launches from the bf16 train CLI "
             "run; max_abs_err over both training shapes and both dtypes; library_ms is cuBLAS "
             "bf16 torch.matmul on the same stored operands; under fp32 the fp32 instance at "
             "sub-band float32 (library_ms cuBLAS fp32), launches from the fp32 B=4 step")
    tc_src = "fullsubnet_tpu_torch/ops/csrc/rnn_bwd_tc.cu"

    def chunked_paths(cell):
        """Phase 26's steps with the chunked stash, by path: their counts."""
        paths = {f"chunked step {label} (chunk {CHUNKED_FORCED})": run["counts"]
                 for label, run in chunked["forced"].items() if label.startswith(cell)}
        if cell == "LSTM":
            long = chunked["long"]
            paths[f"chunked step LSTM bf16 B={LONG_BATCH} x {LONG_SECONDS} s (chunk "
                  f"{long['chunk']})"] = long["counts"]
        return paths

    def chunked_of(stage, cell, form=None):
        """Phase 26's launches of a training kernel's stage (a stage of
        ``_stage_launches``, else a wrapper's name, by ``form`` where given),
        by chunked path, where it launched."""
        got = {}
        for label, counts in chunked_paths(cell).items():
            by_stage = _stage_launches(counts, cell)
            if stage in by_stage:
                n = by_stage[stage]
            elif form is not None:
                n = counts.get(stage, (0, {}, {}))[2].get(form, 0)
            else:
                n = counts.get(stage, (0,))[0]
            if n:
                got[label] = n
        return {"launches_chunked_train": got} if got else {}

    kernels = []
    for cell, k1_rows, e2e_run, train_run, trained, names in (
        ("LSTM", k1, e2e, train, lstm_kernels, ("K1", "K2", "K3")),
        ("GRU", k1_gru, e2e_gru, train_gru, gru_kernels, ("K1-GRU", "K2-GRU", "K4")),
    ):
        lstm = cell == "LSTM"
        fwd_src = "lstm_train_fwd.cu" if lstm else "gru_forward.cu"
        body = "" if lstm else " (_gru_layer_bwd_kernel :632)"
        walk_name = "lstm_walk" if lstm else "gru_walk"
        train_walk = "lstm_train_walk" if lstm else "gru_train_walk"
        tc, ftc, f32, dws = trained["tc"], trained["fwd_tc"], trained["f32"], trained["dw"]
        ff32 = trained["fwd_f32"]
        train_walk_f32 = "lstm_train_walk_f32" if lstm else "gru_train_walk_f32"
        fwd_walk = "lstm_fwd_walk" if lstm else "gru_fwd_walk"
        old_name = "lstm_scan" if lstm else "gru_scan"
        first = k1_rows[0]  # sub-band B=1, T=400
        k1_at = f"{first['name']}; max_abs_err over {len(k1_rows)} shapes, vs plain and cuDNN"
        replaces = "fullsubnet_tpu/ops/subband_lstm.py:184" + ("" if lstm else " (_gru_step :60)")
        k2_replaces = "fullsubnet_tpu/ops/subband_lstm.py:483" + ("" if lstm else " (GRU branch)")
        kernels += [
            {**entry(f"fwd_gemm ({names[0]} stages: each layer's input projection and the head, "
                     f"fp32; {cell} stack)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu", replaces,
                     e2e_run["launches"]["fwd_gemm"], max(r["gemm"]["err"] for r in k1_rows),
                     k1_at + "; library_ms is cuBLAS fp32 addmm of the same products",
                     first["gemm"]),
             **by_path(e2e_run, "fwd_gemm")},
            {**entry(f"{fwd_walk} ({names[0]} stage: the walk over time, h . W_hh^T resident "
                     "over a 16-CTA cluster, fp32)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu",
                     replaces, e2e_run["launches"][fwd_walk],
                     max(r["walk"]["err"] for r in k1_rows), k1_at, first["walk"]),
             **by_path(e2e_run, fwd_walk)},
            entry(f"{old_name} ({names[0]} of the earlier design, one block per "
                  "tile of rows; off the main path, timed beside its redesign)",
                  f"fullsubnet_tpu_torch/ops/csrc/{'subband_lstm.cu' if lstm else 'gru_forward.cu'}",
                  replaces, e2e_run["launches"][old_name], max(r["old"]["err"] for r in k1_rows),
                  k1_at, first["old"]),
            entry(f"tc_gemm ({names[1]} at bf16, stages 1 and 3: each layer's input projection "
                  "and the head on the tensor cores)", tc_src, k2_replaces,
                  train_run["launches"]["tc_gemm_fwd"],
                  max(v["gemm"]["err"] for v in ftc.values()),
                  at_tc + "; library_ms is cuBLAS bf16 of the same products",
                  ftc["sub-band bfloat16"]["gemm"]),
            entry(f"{train_walk} ({names[1]} at bf16, stage 2: the walk over time, h . W_hh^T on "
                  "the tensor cores, W_hh^T streamed from L2 or split over a 16-CTA cluster)",
                  "fullsubnet_tpu_torch/ops/csrc/rnn_train_fwd_tc.cu", k2_replaces,
                  train_run["launches"][train_walk], max(v["walk"]["err"] for v in ftc.values()),
                  at_tc, ftc["sub-band bfloat16"]["walk"]),
            entry(f"fwd_gemm ({names[1]} at fp32, stages 1 and 3: each layer's input projection "
                  "and the head, B W_ih and W_fc in PyTorch's layout)",
                  "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu", k2_replaces,
                  train_run["fp32_launches"]["fwd_gemm_fwd"],
                  max(v["gemm"]["err"] for v in ff32.values()),
                  at_fwd_f32 + "; library_ms is cuBLAS fp32 of the same products",
                  ff32["sub-band float32"]["gemm"]),
            entry(f"{train_walk_f32}, streaming form ({names[1]} at fp32, stage 2 for many rows: "
                  "blocks of 32 rows stream W_hh^T from L2, the product one group of 96 units at "
                  "a time)", "fullsubnet_tpu_torch/ops/csrc/rnn_train_fwd_f32.cu", k2_replaces,
                  train_run["fp32_launches"]["train_walk_streaming"],
                  max(v["walk"]["err"] for v in ff32.values()), at_fwd_f32,
                  ff32["sub-band float32"]["walk"]),
            entry(f"{train_walk_f32}, cluster form ({names[1]} at fp32, stage 2 for few rows: "
                  f"the {fwd_walk} cluster walk{' with its c stream' if lstm else ''}, W_hh^T "
                  "resident over a 16-CTA cluster)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu",
                  k2_replaces, train_run["fp32_launches"]["train_walk_cluster"],
                  max(v["walk"]["err"] for v in ff32.values()), at_fwd_f32_cluster,
                  ff32["full-band float32"]["walk"]),
            entry(f"{'lstm' if lstm else 'gru'}_stash_forward ({names[1]} at fp32 storage of the "
                  f"earlier design: training forward with {'h/c' if lstm else 'h'} stashes; off "
                  "the main path, timed beside its redesign)",
                  f"fullsubnet_tpu_torch/ops/csrc/{fwd_src}", k2_replaces,
                  train_run["fp32_launches"]["fwd"],
                  max(v["old"]["err"] for v in ff32.values()), at_fwd,
                  {**trained["fwd"]["sub-band float32"],
                   "ms": ff32["sub-band float32"]["old"]["ms"]}),
            entry(f"fwd_gemm ({names[2]} at fp32, stages 1 and 3: the gate pre-activations, A's "
                  "second K segment the h stash one block back, and dx)",
                  "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu",
                  "fullsubnet_tpu/ops/subband_lstm.py:844" + body,
                  train_run["fp32_launches"]["fwd_gemm_bwd"],
                  max(v["gemm"]["err"] for v in f32.values()),
                  at_f32 + "; library_ms is cuBLAS fp32 of the same products",
                  f32["sub-band float32"]["gemm"]),
            entry(f"{walk_name}_f32 ({names[2]} at fp32, stage 2: the walk over time, dgates . "
                  "W_hh on the fp32 cores: for many rows, as at the sub-band stage timed here, "
                  "blocks of 16 rows streaming W_hh from L2; for few rows W_hh resident over a "
                  "16-CTA cluster)",
                  "fullsubnet_tpu_torch/ops/csrc/rnn_bwd_f32.cu",
                  "fullsubnet_tpu/ops/subband_lstm.py:844" + body,
                  train_run["fp32_launches"]["walk"], max(v["walk"]["err"] for v in f32.values()),
                  at_f32, f32["sub-band float32"]["walk"]),
            entry(f"{'lstm' if lstm else 'gru'}_layer_backward ({names[2]} at fp32 storage of the "
                  "earlier design: one layer's backward, split dW; off the main path, timed "
                  "beside its redesign)",
                  f"fullsubnet_tpu_torch/ops/csrc/{'lstm_layer_bwd.cu' if lstm else 'gru_layer_bwd.cu'}",
                  "fullsubnet_tpu/ops/subband_lstm.py:844" + body,
                  train_run["fp32_launches"]["bwd"], max(v["old"]["err"] for v in f32.values()),
                  at_bwd, {**trained["bwd"]["sub-band float32"],
                           "ms": f32["sub-band float32"]["old"]["ms"]
                           + trained["bwd"]["sub-band float32"]["dw_ms"]}),
            entry(f"tc_gemm ({names[2]} at bf16, stages 1 and 3: the gate pre-activations and dx "
                  "on the tensor cores)", tc_src,
                  "fullsubnet_tpu/ops/subband_lstm.py:844" + body,
                  train_run["launches"]["tc_gemm_bwd"], max(v["gemm"]["err"] for v in tc.values()),
                  at_tc, tc["sub-band bfloat16"]["gemm"]),
            entry(f"{walk_name} ({names[2]} at bf16, stage 2: the walk over time, dgates . "
                  "W_hh^T on the tensor cores)", tc_src,
                  "fullsubnet_tpu/ops/subband_lstm.py:844" + body,
                  train_run["launches"][walk_name], max(v["walk"]["err"] for v in tc.values()),
                  at_tc, tc["sub-band bfloat16"]["walk"]),
            {**entry(f"dw_tma ({names[2]}'s dW stage, either dtype: "
                     + ("[x | h_prev | 1]^T . dgates" if lstm
                        else "[x | 1]^T . dxw and [h_prev | 1]^T . dhw")
                     + " over all T*N rows; a persistent CTA an SM over the plan's units (C "
                     "tile, k range), a TMA ring (bf16 4 stages, fp32 6), partials summed in "
                     "the plan's order; bf16 on wgmma, fp32 on the fp32 cores)",
                     "fullsubnet_tpu_torch/ops/csrc/rnn_dw_tma.cu",
                     "fullsubnet_tpu/ops/subband_lstm.py:844 (the fused dW in the body, "
                     + (":609-626" if lstm else ":710-727") + ", summed :896-901)",
                     train_run["launches"]["dw_tma"], max(v["err"] for v in dws.values()),
                     at_dw, dws["sub-band bfloat16"]),
             "fp32": {**{k: dws["sub-band float32"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                      "launches": train_run["fp32_launches"]["dw_tma"]}},
            {**entry(f"dw_gemm ({names[2]}'s dW stage of the earlier design: split-K on "
                     "mma.sync, partials summed in slice order; off the main path, timed beside "
                     "its redesign)", "fullsubnet_tpu_torch/ops/csrc/rnn_dw.cu",
                     "fullsubnet_tpu/ops/subband_lstm.py:844 (the fused dW in the body, "
                     + (":609-626" if lstm else ":710-727") + ", summed :896-901)",
                     train_run["launches"]["dw_gemm"],
                     max(v["old"]["err"] for v in dws.values()), at_dw,
                     dws["sub-band bfloat16"]["old"]),
             "fp32": {**{k: dws["sub-band float32"]["old"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                      "launches": train_run["fp32_launches"]["dw_gemm"]}},
        ]
        # phase 24's launches of each training stage, by path, on the rows
        # from the bf16 training forward's tc_gemm on (None: the earlier
        # fp32 kernels)
        stages = ("tc_gemm_fwd", "lstm_train_walk", "fwd_gemm_fwd",
                  "lstm_train_walk_f32 streaming", "lstm_train_walk_f32 cluster", None,
                  "fwd_gemm_bwd", "lstm_walk_f32", None, "tc_gemm_bwd", "lstm_walk", "dw_tma",
                  None)
        block = kernels[-16:]
        for row, stage in zip(kernels[-len(stages):], stages):
            if stage is not None:
                row.update(scale_of(stage, lstm))
                row.update(chunked_of(stage.replace("lstm", cell.lower()), cell))
        block[1].update(chunked_of(fwd_walk, cell))  # K1's walk: the chunked fp32 forward
    # phase 25: K1-bf16 and K1-GRU-bf16, their launches from the main path's
    # run (Improved FullSubNet with compute_dtype at B = 1, 16 and 64 x 10 s)
    for cell, label in (("LSTM", "K1-bf16"), ("GRU", "K1-GRU-bf16")):
        rows, path = bf16_fwd["cases"][cell.lower()], bf16_fwd["paths"][cell]
        by_name = {r["name"].split(":")[0]: r for r in rows}
        few, many = by_name["Improved section 2 B=1"], by_name["Improved section 2 B=16"]
        walk_name = f"{cell.lower()}_fwd_walk_bf16"
        replaces = ("fullsubnet_tpu/ops/subband_lstm.py:184 (_infer_impl :163 on a bf16 x, "
                    "compute_dtype :169" + (")" if cell == "LSTM" else "; _gru_step :60)"))
        k1b_at = (f"; max_abs_err over {len(rows)} shapes vs the plain version; launches from "
                  "Improved FullSubNet with compute_dtype, B = 1, 16 and 64 x 10 s")
        kernels += [
            {**entry(f"tc_gemm ({label} stages: each layer's input projection and the head, "
                     f"bf16 in, fp32 out; {cell} stack)", tc_src, replaces,
                     path["launches"]["tc_gemm"], max(r["gemm"]["err"] for r in rows),
                     many["name"] + k1b_at + " (err as a share of the largest output); "
                     "library_ms is cuBLAS bf16 torch.matmul of the same products", many["gemm"]),
             "launches_by_path": enhancer_path(cell, "tc_gemm", ("bf16",))},
            {**entry(f"{walk_name}, cluster form ({label} stage: the walk over time, bf16 "
                     "W_hh^T resident over a 16-CTA cluster, h gathered in bf16, fp32 sums and "
                     "state)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu", replaces,
                     path["forms"].get("cluster", 0),
                     max(r["walk"]["cluster"]["err"] for r in rows), few["name"] + k1b_at,
                     few["walk"]["cluster"]),
             **chunked_of(walk_name, cell, "cluster"),
             "launches_by_path": enhancer_path(cell, walk_name, ("bf16",), "cluster")},
            {**entry(f"{walk_name}, tc form ({label} stage: the walk over time on the tensor "
                     "cores, bf16 W_hh^T resident over a 16-CTA cluster, h . W_hh^T on mma.sync "
                     "with h_{t-1} gathered through L2, one cluster barrier a step, a persistent "
                     "wave of clusters walking bands of row tiles, fp32 sums and state)",
                     "fullsubnet_tpu_torch/ops/csrc/rnn_fwd_tc.cu", replaces,
                     path["forms"].get("tc", 0),
                     max(r["walk"]["tc"]["err"] for r in rows), many["name"] + k1b_at,
                     many["walk"]["tc"]),
             **chunked_of(walk_name, cell, "tc"),
             "launches_by_path": enhancer_path(cell, walk_name, ("bf16",), "tc")},
            {**entry(f"{walk_name}, streaming form ({label} stage for many rows: the bf16 "
                     "training walk's inference form, W_hh^T streamed from L2, h . W_hh^T on the "
                     "tensor cores, fp32 state in and out, no c stash)",
                     "fullsubnet_tpu_torch/ops/csrc/rnn_train_fwd_tc.cu", replaces,
                     path["forms"].get("streaming", 0),
                     max(r["walk"]["streaming"]["err"] for r in rows), many["name"] + k1b_at,
                     many["walk"]["streaming"]),
             **chunked_of(walk_name, cell, "streaming"),
             "launches_by_path": enhancer_path(cell, walk_name, ("bf16",), "streaming")},
        ]
    # phases 17-20: each family's launches by kernel on its paths
    print(json.dumps({"families": families}))
    print(json.dumps({"bf16_forward": {k: v for k, v in bf16_fwd.items() if k != "cases"}},
                     default=str))
    print(json.dumps({"chunked_train": _chunked_summary(chunked)}, default=str))
    print(json.dumps({"last_modules": last}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
