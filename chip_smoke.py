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
split-K GEMM of rnn_dw.cu over the cotangent streams). The inference
kernels of the earlier design (lstm_scan, gru_scan), the earlier fp32
training forward (stash_fwd, gru_stash_fwd) and layer backward (layer_bwd,
gru_layer_bwd) and the earlier training kernels' bf16 instances are
checked and timed beside their redesign.

    python3 chip_smoke.py              # from the root of a checkout, one card
    python3 chip_smoke.py --fp32-step  # the fp32 train step's numbers alone

Phases, in the order they run (each one that fails ends the run with exit
code 1):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN;
2. build: compile the nine kernel libraries from
   ``fullsubnet_tpu_torch/ops/csrc``, one nvcc per source, all started
   together, and print ptxas's registers, shared memory and spills;
3. K1 at the flagship inference shapes (T = 400 and 625), fp32: the main
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
   kernels' bf16 instances; the dW stage against its plain version on the
   same streams (ms, TFLOP/s, the slices S, a sweep of S, the bound, and
   cuBLAS on the same stored operands: torch.matmul in the storage type,
   and at bf16 the fp32 sgemm on upcast operands that it replaced);
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
   B=128 x 30 s (median of 3 after a warm-up: audio-s/s, peak memory,
   finite output); at that shape each stage through K1's stages, through
   the earlier kernel (lstm_scan) and through cuDNN ``nn.LSTM`` + Linear
   over the stages' time chunks with (h, c) carried, on the inputs the
   forward gives it (median of 3 calls each, taken in turn), all held to
   each other; then a torch.profiler breakdown of the B=1 forward;
9. training end to end: 64 clean wavs, 4 noise wavs and 2 RIRs written from
   a seed, a copy of the flagship train TOML pointed at them (no
   validation set, 2 epochs), and the port's train CLI on the card; finite
   losses, launch counts by shape (a step: the GEMM 6 times in the
   forward and 8 in the backward, the LSTM training walk 4, the LSTM
   walk 4 times and the dW stage 4, by shape; no other kernel, the earlier
   K2 none), the checkpoint
   set, ``-R`` resuming at epoch 3, and the infer CLI on the epoch-2
   weights;
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
13. GRU: the train CLI on a GRU copy of the train TOML, 1 epoch and ``-R``:
    the launches of phase 9 with the GRU walks (the dW stage 8: two
    problems a layer), none of the LSTM's and no K2-GRU;
14. GRU: one fp32 step at B=4, card vs CPU; fwd_gemm 14, the fp32 GRU
    training walk 4, the fp32 GRU walk 4 times and the dW stage 8, no
    earlier K2-GRU or K4;
15. GRU: the train step's numbers, as phase 11;
16. the flagship train step at fp32 storage (``use_amp = false``), B=32 x
    3.072 s, both cells: median of 5 after 2 warm-ups, audio-s/s, peak
    memory, launches a step and the profile's top kernels (library GEMMs
    no more than the head backward's 4); then the same
    step with the earlier fp32 training forward in the dispatch, in the same
    run.

Each path's launch counts are set to 0 just before it runs and read just
after; the LSTM paths must launch no GRU kernel and the GRU paths no LSTM
kernel. The last line of stdout is ``{"ok": true, "device": {...}}``; the
line before it the card's name and power limit, and before that one JSON
line with each kernel's launches on its main path, error and times.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
# written wavs are int16: the 0.8 peak is within one quantisation step
PEAK_ATOL = 1.0 / 32768
# the H100 SXM data sheet: dense peaks and the HBM rate
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


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


def bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the peak for their type and the bytes over the HBM
    rate; and which of the two it is."""
    t_ops = flops / PEAK_FLOPS[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


GATES = {"lstm": 4, "gru": 3}


def stack_flops(t: int, n: int, f_in: int, hidden: int, out_dim: int, layers: int = 2,
                cell: str = "lstm") -> int:
    """FLOPs of the fused LSTM or GRU stack + head forward: two per
    multiply-add."""
    per_row_step, in_dim = 0, f_in
    for _ in range(layers):
        per_row_step += 2 * (in_dim + hidden) * GATES[cell] * hidden
        in_dim = hidden
    return (per_row_step + 2 * hidden * out_dim) * t * n


def weight_elems(f_in: int, hidden: int, out_dim: int, layers: int = 2, cell: str = "lstm") -> int:
    """Elements of the kernels' weight operands: the LSTM's biases fused
    ([4H]), the GRU's a pair ([2, 3H])."""
    gh = GATES[cell] * hidden
    elems, in_dim = 0, f_in
    for _ in range(layers):
        elems += (in_dim + hidden) * gh + (gh if cell == "lstm" else 2 * gh)
        in_dim = hidden
    return elems + hidden * out_dim + out_dim


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


def phase_build() -> None:
    from fullsubnet_tpu_torch.ops import build
    from fullsubnet_tpu_torch.ops.subband_lstm import (
        bwd_f32_library,
        dw_library,
        fwd_library,
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
    }
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


def _stack(rng, f_in: int, hidden: int, out_dim: int, device, cell: str = "lstm"):
    import numpy as np
    import torch

    def u(shape, bound_):
        return torch.from_numpy(rng.uniform(-bound_, bound_, shape).astype(np.float32)).to(device)

    b = 1.0 / hidden**0.5
    gh = GATES[cell] * hidden
    layers = []
    in_dim = f_in
    for _ in range(2):
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
# steps of each case: 4 s, and 10 s of audio (625 STFT frames)
KERNEL_STEPS = (400, 625)


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
            walk_flops = 2 * 2 * t * n * hidden * gh
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
            bwd_flops = bwd_bytes = 0
            for in_dim in (f_in, hidden):
                bwd_flops += 3 * 2 * (in_dim + hidden) * gates * hidden * t * n
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


def _dw_stage(tag: str, card: str, x, hs, zeros, streams) -> dict:
    """The dW stage of both layers as ``weight_grads`` runs it on the card:
    ``dw_gemm`` on each problem (the LSTM's [x | h_prev | 1]^T . dgates, the
    GRU's [x | 1]^T . dxw and [h_prev | 1]^T . dhw) against
    ``plain_dw_gemm`` on the same stored operands; times of the kernel, the
    plain version and cuBLAS on the same stored operands ([x | h_prev | 1]
    made beforehand: torch.matmul in the storage type, and at bf16 also the
    fp32 sgemm on upcast operands that the port ran before); the slices S
    it picks and, at the sub-band stage, a sweep of S; the bound."""
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    t, n, hidden = hs[0].shape
    k = t * n
    problems = []
    for li, st in zip((1, 0), streams):
        a = (x if li == 0 else hs[0]).reshape(k, -1)
        prev = {"prev": hs[li].reshape(k, hidden), "head": zeros}
        if len(st) == 1:
            problems.append({"a": a, "b": st[0].reshape(k, -1), **prev})
        else:
            problems += [{"a": a, "b": st[0].reshape(k, -1)},
                         {"a": None, "b": st[1].reshape(k, -1), **prev}]
    err = rel = 0.0
    for p in problems:
        got, want = ops.dw_gemm(**p), ops.plain_dw_gemm(**p)
        err = max(err, float((got - want).abs().max()))
        rel = max(rel, *_rel_errs([got], [want]))
        del got, want
    ms = cuda_ms(lambda: [ops.dw_gemm(**p) for p in problems])
    ms_plain = cuda_ms(lambda: [ops.plain_dw_gemm(**p) for p in problems], reps=1)

    def widths(p):
        return ((0 if p["a"] is None else p["a"].shape[1]) + (hidden if "prev" in p else 0) + 1,
                p["b"].shape[1])

    sms = ops.dw_gemm.sms(x.device)
    splits = [ops.pick_dw_splits(*widths(p), k, sms) for p in problems]
    ms_lib = ms_sgemm = 0.0
    for p in problems:
        cols = [] if p["a"] is None else [p["a"]]
        if "prev" in p:
            cols.append(torch.cat([p["head"], p["prev"][: k - n]]))
        a_t = torch.cat([*cols, p["b"].new_ones(k, 1)], dim=1).t()
        ms_lib += cuda_ms(lambda: a_t @ p["b"])
        if x.dtype == torch.bfloat16:
            a32, b32 = a_t.float(), p["b"].float()
            ms_sgemm += cuda_ms(lambda: a32 @ b32)
            del a32, b32
        del a_t
    sweep = {}
    if n > 1024:  # the sub-band stage: layer 2's first problem at other S
        for s in sorted({1, max(1, splits[0] // 4), max(1, splits[0] // 2), splits[0],
                         2 * splits[0], 4 * splits[0]}):
            sweep[s] = round(cuda_ms(lambda: ops.dw_gemm(**problems[0], splits=s)), 3)
    size = x.element_size()
    flops = sum(2 * k * m * ncols for m, ncols in map(widths, problems))
    nbytes = sum(size * k * (m - 1 + ncols) + 4 * m * ncols for m, ncols in map(widths, problems))
    kind = "fp32" if x.dtype == torch.float32 else "bf16"
    dw_bound = bound(flops, nbytes, kind)
    sgemm_txt = (f"; cuBLAS fp32 sgemm on the upcast operands (the port's dW before) "
                 f"{ms_sgemm:.3f} ms" if kind == "bf16" else "")
    print(f"  dW stage, {tag}, both layers ({len(problems)} GEMMs, S {splits} on {sms} SMs) "
          f"[{card}]: {ms:.3f} ms = {flops / (ms * 1e9):.1f} TFLOP/s ({flops / 1e12:.3f} TFLOP, "
          f"{nbytes / 1e9:.2f} GB); plain {ms_plain:.3f} ms; cuBLAS {kind} on the same stored "
          f"operands {ms_lib:.3f} ms{sgemm_txt}; bound {dw_bound[0]:.3f} ms ({dw_bound[1]}); "
          f"max|kernel-plain| {err:.3e} ({rel:.2e} of the largest value, tol "
          f"{DW_RTOL_OF_MAX:g}); sweep of S (layer 2, first GEMM) {sweep} ms")
    check(rel <= DW_RTOL_OF_MAX,
          f"dw_gemm {tag}: kernel vs plain {rel:.2e} of max > {DW_RTOL_OF_MAX:g}")
    return {"err": err, "ms": ms, "plain_ms": ms_plain, "library_ms": ms_lib,
            "bound_ms": dw_bound[0], "bound_by": dw_bound[1]}


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
        gemm_flops += 2 * m * (f_in + hidden) * gates + 2 * m * gates * f_in
        gemm_bytes += (2 * m * (f_in + hidden) + 2 * (f_in + hidden) * g4 + 4 * m * g4
                       + 2 * m * gates + 2 * gates * f_in + 2 * m * f_in)
        walk_flops += 2 * m * gates * hidden
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
        gemm_flops += 2 * m * (f_in + hidden) * gates + 2 * m * gates * f_in
        gemm_bytes += 4 * (m * (f_in + hidden) + (f_in + hidden) * g4 + g4 + m * g4
                           + m * gates + gates * f_in + m * f_in)
        walk_flops += 2 * m * gates * hidden
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
        gemm_flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        gemm_bytes += 2 * a.numel() + 2 * b.numel() + 4 * bias.numel() + 4 * a.shape[0] * b.shape[1]
    n_states = 2 if lstm else 1
    walk_flops = 2 * 2 * m * hidden * gates
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
        gemm_flops += 2 * a.shape[0] * a.shape[1] * b.shape[0]
        gemm_bytes += 4 * (a.numel() + b.numel() + bias.numel() + a.shape[0] * b.shape[0])
    n_states = 2 if lstm else 1
    walk_flops = 2 * 2 * m * hidden * gates
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


def _inference_config(work: Path, noisy_dir: Path, cell: str = "LSTM") -> Path:
    """The flagship inference TOML pointed at ``noisy_dir``, with ``cell``."""
    toml = _set_cell(RECIPE.read_text(), cell)
    toml, n_sub = re.subn(r"(?m)^dataset_dir_list = .*$",
                          f"dataset_dir_list = [{json.dumps(str(noisy_dir))}]", toml)
    check(n_sub == 1, "recipe has no dataset_dir_list line to point at the wavs")
    cfg = work / f"inference_{cell}_{noisy_dir.name}.toml"
    cfg.write_text(toml)
    return cfg


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


def _infer_launches_by_shape(cell: str, utterances: int) -> tuple[dict, dict]:
    """What the inference path launches for ``utterances`` utterances of at
    most 10 s at B = 1 (one chunk each), by shape key: per stage a GEMM for
    each layer's input projection (F or H, G·H) and the head (H, OUT), two
    walks (N, H)."""
    gemm, walk = {}, {}
    for f_in, hidden, out_dim, n in ((257, 512, 257, 1), (32, 384, 2, 257)):
        gh = GATES[cell.lower()] * hidden
        for key in ((f_in, gh), (hidden, gh), (hidden, out_dim)):
            gemm[key] = utterances
        walk[(n, hidden)] = 2 * utterances
    return gemm, walk


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
    want_gemm, want_walk = _infer_launches_by_shape(cell, len(inputs))
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
            "wave10": inputs["utt_10s"]}


def phase_rtf(model, wave10, card: str) -> dict:
    """The model forward's real-time factor at B=1 and B=8 x 10 s (median
    of 3), then at B=128 x 30 s (the wave tiled three times; median of 3
    after one warm-up): audio-s/s, peak memory, finite output; and at that
    shape each stage through the main path (K1's stages) beside the kernel
    of the earlier design (lstm_scan) and cuDNN (nn.LSTM + Linear over the
    stages' time chunks, (h, c) carried: one call's output would not fit),
    on the inputs the forward gives it."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex
    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    spec = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512)
    seconds = wave10.size / 16000
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
        times = []
        for _ in range(3):
            out = None
            t0 = time.perf_counter()
            out = model(mag, dropping_band=False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    wall = sorted(times)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(out).all())
    print(f"model forward B={batch} x {seconds:g} s ({mag.shape[-1]} frames; the sub-band stage "
          f"N = {batch * mag.shape[2]}): median {wall * 1e3:.1f} ms of "
          f"{[round(t * 1e3, 1) for t in times]}, {batch * seconds / wall:.1f} audio-s/s, peak "
          f"memory {peak_gb:.2f} GiB, output {tuple(out.shape)} finite {finite} [{card}]")
    check(out.shape[0] == batch and out.shape[-1] == mag.shape[-1], "B=128 output shape")
    check(finite, "B=128 x 30 s output not finite")
    del out

    # each stage's input as the forward hands it to fused_subband_lstm
    stage_inputs = {}
    stages = {"full-band": model.fb_model, "sub-band": model.sb_model}
    hooks = [module.register_forward_pre_hook(
        lambda _, args, name=name: stage_inputs.__setitem__(name, args[0].permute(2, 0, 1)
                                                            .contiguous()))
        for name, module in stages.items()]
    try:
        with torch.inference_mode():
            model(mag, dropping_band=False)
    finally:
        for hook in hooks:
            hook.remove()
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

        with torch.inference_mode():
            new = ops.fused_subband_lstm(x, *layers, fc)
            old = ops.lstm_scan(x, layers, fc)
            err = float((new - old).abs().max())
            del old
            lib = cudnn_forward()
            err_cudnn = float((new - lib).abs().max())
            del new, lib
            # the untimed calls above are the warm-up; a sub-band call takes
            # seconds, so one call a sample, the three in turn
            stage_times = {"stages": [], "lstm_scan": [], "cuDNN": []}
            for _ in range(3):
                stage_times["stages"].append(
                    cuda_ms(lambda: ops.fused_subband_lstm(x, *layers, fc), reps=1, warmup=0))
                stage_times["lstm_scan"].append(
                    cuda_ms(lambda: ops.lstm_scan(x, layers, fc), reps=1, warmup=0))
                stage_times["cuDNN"].append(cuda_ms(cudnn_forward, reps=1, warmup=0))
        ms, old_ms, cudnn_ms = (sorted(v)[1] for v in stage_times.values())
        del rnn
        rows, kr, in_flight = ops.lstm_fwd_walk.tile(n, hidden, x.device)
        chunks = -(-t // steps)
        samples = {k: [round(v, 1) for v in vs] for k, vs in stage_times.items()}
        print(f"  {name} stage at B={batch} x {seconds:g} s (N {n}, T {t}), medians of 3 taken "
              f"in turn {samples}: K1's stages {ms:.1f} ms ({chunks} chunk(s) of {steps} steps; "
              f"walk tile {rows} rows, {-(-n // rows)} cluster(s), {in_flight} in flight), earlier "
              f"kernel (lstm_scan) {old_ms:.1f} ms ({old_ms / ms:.3f}x the stages' time), cuDNN "
              f"nn.LSTM + Linear over the same chunks {cudnn_ms:.1f} ms ({cudnn_ms / ms:.3f}x); "
              f"max|stages - earlier| {err:.3e}, max|stages - cuDNN| {err_cudnn:.3e} (tol "
              f"{KERNEL_ATOL:g}) [{card}]")
        check(err <= KERNEL_ATOL, f"B=128 {name} stage vs lstm_scan {err:.3e} > {KERNEL_ATOL:g}")
        check(err_cudnn <= KERNEL_ATOL,
              f"B=128 {name} stage vs cuDNN {err_cudnn:.3e} > {KERNEL_ATOL:g}")
        stage_ms[name] = {"ms": ms, "old_ms": old_ms, "cudnn_ms": cudnn_ms, "err": err}
        del x
    torch.cuda.empty_cache()
    return {"ms": wall * 1e3, "audio_s_per_s": batch * seconds / wall, "peak_gib": peak_gb,
            "stages": stage_ms}


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


def _check_library_gemms(rows, label: str) -> None:
    gemms = {key[:90]: (count, round(us / 1e3, 3)) for us, key, count in rows
             if re.search(r"gemm|gemv|nvjet", key, re.I) and "anonymous namespace" not in key}
    launches = sum(count for count, _ in gemms.values())
    print(f"  library GEMM kernels in {label} (launches, ms): {gemms}")
    check(launches <= HEAD_BWD_GEMMS,
          f"{label}: {launches} library GEMM launches, more than the head backward's "
          f"{HEAD_BWD_GEMMS}: {gemms}")


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


def _write_train_data(root: Path) -> dict:
    """64 clean wavs of 4 s (amplitude-modulated tones), 4 noise wavs and
    2 short RIRs from a numpy seed, and their list files."""
    import numpy as np

    from fullsubnet_tpu_torch.data.wavio import write_wav

    sr = 16000
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
    return out


# the section of the train recipe each key that the smoke changes lives in
_TRAIN_KEYS = {
    "use_amp": "meta",
    "batch_size": "train_dataset.dataloader",
    "num_workers": "train_dataset.dataloader",
    "epochs": "trainer.train",
    "save_checkpoint_interval": "trainer.train",
}


def _train_config(work: Path, lists: dict, name: str, cell: str = "LSTM", **changes) -> Path:
    """The flagship train TOML with the dataset lists pointed at ``lists``,
    no validation set, ``sequence_model = cell``, and ``changes``
    (key = value) made in their sections; everything else as the recipe
    has it."""
    toml = _set_cell(TRAIN_RECIPE.read_text(), cell)
    for kind in ("clean", "noise", "rir"):
        toml, n_sub = re.subn(rf"(?m)^{kind}_dataset = .*$",
                              f"{kind}_dataset = {json.dumps(str(lists[kind]))}", toml)
        check(n_sub == 1, f"train recipe has no {kind}_dataset line")
    toml, n_sub = re.subn(r"(?ms)^\[validation_dataset\].*?(?=^\[model\])", "", toml)
    check(n_sub == 1, "train recipe has no [validation_dataset] section before [model]")
    for key, value in changes.items():
        header = f"[{_TRAIN_KEYS[key]}]\n"
        start = toml.index(header) + len(header)
        end = toml.find("\n[", start)
        end = len(toml) if end < 0 else end
        section, n_sub = re.subn(rf"(?m)^{key} = [^#\n]*", f"{key} = {value} ", toml[start:end])
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
             "gru_train_walk_f32": ops.gru_train_walk_f32, "dw_gemm": ops.dw_gemm}
    own = (("tc_gemm", "lstm_walk", "lstm_train_walk", "dw_gemm") if cell == "LSTM"
           else ("tc_gemm", "gru_walk", "gru_train_walk", "dw_gemm"))
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


def _tc_launches_by_shape(cell: str, steps: int) -> tuple[dict, dict, dict]:
    """What one bf16 flagship step launches of the tensor-core GEMM, by shape
    key (K0, K1, Ncols), times ``steps``: the training forward's (per layer
    an input projection (F_in, 0, G·H); the head (H, 0, OUT rounded up to
    8)), the layer backward's (per layer a pre-activation GEMM (F_in, H,
    4H) and a dx GEMM (G·H, 0, F_in)); and of either walk, by (N, H): two
    a stage (one a layer)."""
    fwd, bwd, walk = {}, {}, {}
    for f_in, hidden, out_dim, n in ((257, 512, 257, 32), (32, 384, 2, 32 * 128)):
        gh = GATES[cell.lower()] * hidden
        for f in (f_in, hidden):
            fwd[(f, 0, gh)] = steps
            bwd[(f, hidden, 4 * hidden)] = steps
            bwd[(gh, 0, f)] = steps
        fwd[(hidden, 0, -(-out_dim // 8) * 8)] = steps
        walk[(n, hidden)] = 2 * steps
    return fwd, bwd, walk


def _dw_launches_by_shape(cell: str, steps: int) -> dict:
    """What ``steps`` flagship steps launch of the dW stage, by shape key (F,
    H, Ncols): per stage and layer one (F_in or H, H, 4H) for the LSTM, a
    (F_in or H, 0, 3H) and a (0, H, 3H) for the GRU."""
    want = {}
    for f_in, hidden in ((257, 512), (32, 384)):
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


def phase_train_end_to_end(work: Path, card: str, cell: str = "LSTM", lists=None) -> dict:
    """The flagship train step through the port's train CLI: the LSTM
    for 2 epochs, the GRU for 1, then ``-R`` for one more epoch, and the
    infer CLI on the last weights."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli as infer_cli
    from fullsubnet_tpu_torch.train import cli as train_cli

    if lists is None:
        lists = _write_train_data(work / "train_data")
    epochs = 2 if cell == "LSTM" else 1
    name = f"flagship_train_{cell}"
    cfg = _train_config(work, lists, name, cell, epochs=epochs, save_checkpoint_interval=1)
    out = work / "runs"
    own, others = _training_kernels(cell)
    _, walk_name, train_walk_name, _ = own
    for kernel in (*own.values(), *others.values()):
        kernel.reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (kernel.launches, dict(kernel.launches_by_shape))
              for k, kernel in (*own.items(), *others.items())}
    steps = trainer.steps
    print(f"train CLI, flagship recipe with {cell} (B=32 x 3.072 s, bf16, clip 10), {epochs} "
          f"epoch(s) over 64 clips: {steps} steps in {wall:.2f} s wall incl. set-up and data; "
          f"losses by epoch {trainer.epoch_losses}; launches {counts} [{card}]")
    check(steps == 2 * epochs, f"{steps} steps, not {epochs} epoch(s) x 2 batches")
    check(all(np.isfinite(v) for v in trainer.epoch_losses.values()), "a training loss is not finite")
    # the fp32-storage training kernels (K2, K2-GRU, K3, K4) serve fp32
    # only: the bf16 step launches none of them
    for other in others:
        check(counts[other][0] == 0, f"{other} launched {counts[other][0]} times in {cell} training")
    want_fwd, want_bwd, want_walk = _tc_launches_by_shape(cell, steps)
    check(counts["tc_gemm"][1] == {**want_fwd, **want_bwd},
          f"tc_gemm launches by shape {counts['tc_gemm'][1]}")
    for walk in (walk_name, train_walk_name):
        check(counts[walk][1] == want_walk, f"{walk} launches by shape {counts[walk][1]}")
    check(counts["dw_gemm"][1] == _dw_launches_by_shape(cell, steps),
          f"dw_gemm launches by shape {counts['dw_gemm'][1]}")
    ckpt = out / name / "checkpoints"
    for file in ("latest_model.tar", *(f"model_{e:04d}.pth" for e in range(1, epochs + 1))):
        check((ckpt / file).is_file(), f"no {file} after {epochs} epoch(s)")

    # -R with one more epoch resumes there
    cfg_resume = _train_config(work, lists, name, cell, epochs=epochs + 1,
                               save_checkpoint_interval=1)
    resumed = train_cli.main(["-C", str(cfg_resume), "-O", str(out), "--device", "cuda", "-R"])
    print(f"train CLI -R ({cell}): epochs run {sorted(resumed.epoch_losses)}, {resumed.steps} "
          f"steps, losses {resumed.epoch_losses}")
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
    launches["tc_gemm_fwd"] = sum(counts["tc_gemm"][1].get(k, 0) for k in want_fwd)
    launches["tc_gemm_bwd"] = sum(counts["tc_gemm"][1].get(k, 0) for k in want_bwd)
    return {"lists": lists, "launches": launches, "steps": steps}


def _first_batch(trainer, size: int):
    import numpy as np
    import torch

    ds = trainer.train_dataset
    ds.set_epoch(1)
    items = [ds[i] for i in range(size)]
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
        for kernel in (ops.fwd_gemm, walk, train_walk, ops.dw_gemm, *unused.values()):
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
                        "walk": walk.launches, "dw_gemm": ops.dw_gemm.launches}
            stray = {k: v.launches for k, v in unused.items() if v.launches}
            want = {"fwd": 0, "bwd": 0, "fwd_gemm": 14, "fwd_gemm_fwd": 6, "fwd_gemm_bwd": 8,
                    "train_walk": 4, "train_walk_cluster": 2, "train_walk_streaming": 2,
                    "walk": 4, "dw_gemm": dw_per_step(cell)}
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


def phase_train_step_numbers(work: Path, lists: dict, card: str, cell: str = "LSTM") -> None:
    """audio-s/s of the flagship train step, its peak memory, and where one
    step's device time goes."""
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
        want = {"fwd_gemm": 14, train_walk: 4, walk: 4, "dw_gemm": dw_per_step(cell)}
        check({k: result["launches"].get(k) for k in want} == want
              and not {"stash_fwd", "gru_stash_fwd", "layer_bwd", "gru_layer_bwd"}
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
            timed("RTF and B=128 x 30 s", phase_rtf, e2e["model"], e2e["wave10"], card)
            timed("inference profile", phase_profile, e2e["model"], e2e["wave10"], card)
            del e2e["model"]
            train = timed("train CLI", phase_train_end_to_end, work, card)
            lists = train["lists"]
            train["fp32_launches"] = timed("fp32 step card vs CPU", phase_card_vs_cpu_step, work,
                                           lists, card)
            timed("train step numbers", phase_train_step_numbers, work, lists, card)
            e2e_gru = timed("GRU infer CLI", phase_end_to_end, work, card, "GRU")
            del e2e_gru["model"]
            train_gru = timed("GRU train CLI", phase_train_end_to_end, work, card, "GRU", lists)
            train_gru["fp32_launches"] = timed("GRU fp32 step card vs CPU", phase_card_vs_cpu_step,
                                               work, lists, card, "GRU")
            timed("GRU train step numbers", phase_train_step_numbers, work, lists, card, "GRU")
            for c in ("LSTM", "GRU"):
                timed(f"{c} fp32 train step numbers", phase_fp32_step_numbers, work, lists, card, c)
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
            entry(f"fwd_gemm ({names[0]} stages: each layer's input projection and the head, "
                  f"fp32; {cell} stack)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu", replaces,
                  e2e_run["launches"]["fwd_gemm"], max(r["gemm"]["err"] for r in k1_rows),
                  k1_at + "; library_ms is cuBLAS fp32 addmm of the same products", first["gemm"]),
            entry(f"{fwd_walk} ({names[0]} stage: the walk over time, h . W_hh^T resident over "
                  "a 16-CTA cluster, fp32)", "fullsubnet_tpu_torch/ops/csrc/rnn_fwd.cu", replaces,
                  e2e_run["launches"][fwd_walk], max(r["walk"]["err"] for r in k1_rows), k1_at,
                  first["walk"]),
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
            {**entry(f"dw_gemm ({names[2]}'s dW stage, either dtype: "
                     + ("[x | h_prev | 1]^T . dgates" if lstm
                        else "[x | 1]^T . dxw and [h_prev | 1]^T . dhw")
                     + " over all T*N rows, split-K, partials summed in slice order; bf16 on the "
                     "tensor cores, fp32 on the fp32 cores)",
                     "fullsubnet_tpu_torch/ops/csrc/rnn_dw.cu",
                     "fullsubnet_tpu/ops/subband_lstm.py:844 (the fused dW in the body, "
                     + (":609-626" if lstm else ":710-727") + ", summed :896-901)",
                     train_run["launches"]["dw_gemm"], max(v["err"] for v in dws.values()),
                     at_dw, dws["sub-band bfloat16"]),
             "fp32": {**{k: dws["sub-band float32"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                      "launches": train_run["fp32_launches"]["dw_gemm"]}},
        ]
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
