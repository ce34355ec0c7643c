#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship inference path once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (each one that fails ends the run with exit code 1):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN;
2. build: compile the LSTM-scan kernel from ``fullsubnet_tpu_torch/ops/csrc``;
3. kernel vs plain PyTorch (and vs cuDNN ``nn.LSTM`` as a third oracle) at
   the flagship's shapes, fp32, with times;
4. end to end: random full-width FullSubNet weights from a seed, three
   noisy wavs, the flagship inference TOML, and the port's CLI
   (``fullsubnet_tpu_torch.infer.cli``) on the card; the outputs, the
   kernel's launch counts for both stages, and the card's cIRM against
   the plain CPU path;
5. the model forward's real-time factor at B=1 and B=8 x 10 s, and a
   torch.profiler breakdown of the B=1 forward (not a pass/fail phase
   when the profiler records no device time).

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit, and before that one JSON
line with the kernel's launches, error and times.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
RECIPE = REPO / "recipes" / "dns_interspeech_2020" / "fullsubnet" / "inference.toml"
SEED = 0
# fp32 kernel vs fp32 plain PyTorch on the card after T steps: the sums
# run in another order, nothing else differs
KERNEL_ATOL = 1e-4
# FullSubNet's compressed cIRM (|m| < 10), card vs CPU, after both stages
CRM_ATOL = 1e-3
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


def phase_build() -> None:
    from fullsubnet_tpu_torch.ops import build
    from fullsubnet_tpu_torch.ops.subband_lstm import lstm_scan

    lib = build.library_path("fsn_lstm_scan", list(lstm_scan._SOURCES))
    lib.unlink(missing_ok=True)  # always build from the checkout's sources
    t0 = time.perf_counter()
    lstm_scan.library()
    print(f"build: {lib.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if re.search(r"registers|spill|smem", line):
            print(f"  ptxas: {line.strip()}")


def _stack(rng, f_in: int, hidden: int, out_dim: int, device):
    import numpy as np
    import torch

    def u(shape, bound):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32)).to(device)

    b = 1.0 / hidden**0.5
    layers = []
    in_dim = f_in
    for _ in range(2):
        layers.append({
            "w_ih": u((4 * hidden, in_dim), b), "w_hh": u((4 * hidden, hidden), b),
            "b_ih": u((4 * hidden,), b), "b_hh": u((4 * hidden,), b),
        })
        in_dim = hidden
    fc = {"weight": u((out_dim, hidden), b), "bias": u((out_dim,), b)}
    return layers, fc


KERNEL_CASES = (
    # name, F_in, H, OUT, N, T
    ("sub-band B=1", 32, 384, 2, 257, 400),
    ("sub-band B=8", 32, 384, 2, 8 * 257, 400),
    ("full-band B=1", 257, 512, 257, 1, 400),
    ("full-band B=8", 257, 512, 257, 8, 400),
)


def phase_kernel_vs_plain(card: str) -> list[dict]:
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops.subband_lstm import (
        ROWS_PER_BLOCK,
        fused_subband_lstm,
        pick_rows_per_block,
        plain_fused_subband_lstm,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = []
    for name, f_in, hidden, out_dim, n, t in KERNEL_CASES:
        layers, fc = _stack(rng, f_in, hidden, out_dim, dev)
        x = torch.from_numpy(
            np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32) * 1.25
        ).to(dev)
        with torch.no_grad():
            got = fused_subband_lstm(x, *layers, fc)
            torch.cuda.synchronize()
            plain = plain_fused_subband_lstm(x, layers, fc)
            torch.cuda.synchronize()
            lstm = torch.nn.LSTM(f_in, hidden, num_layers=2).to(dev)
            for k, layer in enumerate(layers):
                for key, v in layer.items():
                    kind = "weight" if key.startswith("w_") else "bias"
                    getattr(lstm, f"{kind}_{key[2:]}_l{k}").copy_(v)
            cudnn = lstm(x)[0] @ fc["weight"].t() + fc["bias"]
            torch.cuda.synchronize()
        check(got.shape == (t, n, out_dim), f"{name}: kernel output shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
        err = float((got - plain).abs().max())
        err_cudnn = float((got - cudnn).abs().max())
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_subband_lstm(x, *layers, fc))
            plain_ms = cuda_ms(lambda: plain_fused_subband_lstm(x, layers, fc))
            cudnn_ms = cuda_ms(lambda: lstm(x)[0] @ fc["weight"].t() + fc["bias"])
            sweep = {
                r: cuda_ms(lambda r=r: fused_subband_lstm(x, *layers, fc, rows_per_block=r),
                           reps=2)
                for r in ROWS_PER_BLOCK
            }
        rows = pick_rows_per_block(n, f_in, hidden, 2)
        print(f"{name} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}): "
              f"max|kernel-plain| {err:.3e}, max|kernel-cuDNN| {err_cudnn:.3e} "
              f"(tol {KERNEL_ATOL:g}); kernel {ms:.3f} ms (rows/block {rows}), "
              f"plain {plain_ms:.3f} ms, cuDNN {cudnn_ms:.3f} ms [{card}]")
        print("  kernel ms by rows/block: "
              + ", ".join(f"{r}: {v:.3f}" for r, v in sweep.items()))
        check(err <= KERNEL_ATOL, f"{name}: kernel vs plain {err:.3e} > {KERNEL_ATOL:g}")
        check(err_cudnn <= KERNEL_ATOL, f"{name}: kernel vs cuDNN {err_cudnn:.3e} > {KERNEL_ATOL:g}")
        results.append({"name": name, "err": err, "ms": ms, "plain_ms": plain_ms})
    return results


def _write_flagship_checkpoint(path: Path) -> None:
    """Full-width flagship weights from a numpy seed, torch-default scale,
    saved with the reference keys."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import build_model, load_config

    model, _ = build_model(load_config(RECIPE))
    rng = np.random.default_rng(SEED + 1)
    state = {}
    for key, v in model.state_dict().items():
        # LSTM and head weights alike: U(±1/sqrt(H)) of their stage
        hidden = model.get_submodule(key.split(".")[0]).hidden_size
        bound = 1.0 / hidden**0.5
        state[key] = torch.from_numpy(
            rng.uniform(-bound, bound, tuple(v.shape)).astype(np.float32)
        )
    torch.save({"model": state, "epoch": 0}, path)


def phase_end_to_end(work: Path, card: str) -> dict:
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli
    from fullsubnet_tpu_torch.infer.inferencer import Inferencer
    from fullsubnet_tpu_torch.ops.subband_lstm import lstm_scan

    sr = 16000
    rng = np.random.default_rng(SEED + 2)
    noisy_dir = work / "noisy_in"
    noisy_dir.mkdir()
    inputs = {}
    for seconds in (1, 4, 10):
        t = np.arange(seconds * sr) / sr
        wave = (0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        name = f"utt_{seconds:02d}s"
        write_wav(noisy_dir / f"{name}.wav", wave, sr)
        inputs[name] = read_wav(noisy_dir / f"{name}.wav")[0]
    ckpt = work / "flagship_random.tar"
    _write_flagship_checkpoint(ckpt)
    toml = RECIPE.read_text()
    toml, n_sub = re.subn(r"(?m)^dataset_dir_list = .*$",
                          f"dataset_dir_list = [{json.dumps(str(noisy_dir))}]", toml)
    check(n_sub == 1, "recipe has no dataset_dir_list line to point at the wavs")
    cfg = work / "inference.toml"
    cfg.write_text(toml)
    out_dir = work / "out"

    lstm_scan.reset_counts()
    t0 = time.perf_counter()
    cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_scan.launches
    by_shape = dict(lstm_scan.launches_by_shape)
    print(f"CLI on {len(inputs)} wavs (1 s, 4 s, 10 s): {wall:.2f} s wall incl. first-call "
          f"set-up; kernel launches {launches}, by (F_in, H, OUT) {by_shape} [{card}]")

    for name, noisy in inputs.items():
        out, got_sr = read_wav(out_dir / "enhanced" / f"{name}.wav")
        check(got_sr == sr, f"{name}: sample rate {got_sr}")
        check(out.shape == noisy.shape, f"{name}: length {out.shape} != {noisy.shape}")
        check(bool(np.isfinite(out).all()), f"{name}: enhanced audio not finite")
        peak = float(np.max(np.abs(out)))
        check(abs(peak - 0.8) <= PEAK_ATOL, f"{name}: peak {peak} is not 0.8")
    print(f"outputs: {len(inputs)} enhanced wavs, finite, input length and rate, peak 0.8 "
          f"(tol {PEAK_ATOL:.2e})")
    check(by_shape.get((257, 512, 257), 0) == len(inputs),
          f"full-band stage launches {by_shape.get((257, 512, 257), 0)} != {len(inputs)}")
    check(by_shape.get((32, 384, 2), 0) == len(inputs),
          f"sub-band stage launches {by_shape.get((32, 384, 2), 0)} != {len(inputs)}")

    # the card's cIRM against the port's plain CPU path, same input
    config = load_config(cfg)
    gpu = Inferencer(config, str(ckpt), None, device="cuda")
    cpu = Inferencer(config, str(ckpt), None, device="cpu")
    wave = torch.from_numpy(inputs["utt_01s"][None])
    crm_cpu, spec = cpu.predict_crm(wave)
    crm_gpu, _ = gpu.predict_crm(wave.cuda())
    with torch.inference_mode():
        mag = spec.abs()[:, None]  # one spectrogram for both: compare the model alone
        m_cpu = cpu.model(mag)
        m_gpu = gpu.model(mag.cuda()).cpu()
    err = float((m_gpu - m_cpu).abs().max())
    err_dec = float((crm_gpu.cpu() - crm_cpu).abs().max())
    print(f"cIRM card vs plain CPU (1 s utterance): max|diff| {err:.3e} compressed "
          f"(tol {CRM_ATOL:g}), {err_dec:.3e} after decompression")
    check(bool(torch.isfinite(m_gpu).all()), "card cIRM not finite")
    check(err <= CRM_ATOL, f"cIRM card vs CPU {err:.3e} > {CRM_ATOL:g}")
    return {"launches": launches, "model": gpu.model, "wave10": inputs["utt_10s"]}


def phase_rtf(model, wave10, card: str) -> None:
    import torch

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex

    spec = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512)
    seconds = wave10.size / 16000
    for batch in (1, 8):
        mag = spec.abs()[None, None].expand(batch, 1, -1, -1).contiguous()
        with torch.inference_mode():
            model(mag)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                model(mag)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        best = sorted(times)[len(times) // 2]
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        print(f"model forward B={batch} x {seconds:g} s: median {best * 1e3:.1f} ms of "
              f"{[round(t * 1e3, 1) for t in times]}, RTF {best / (batch * seconds):.5f} "
              f"(s of compute per s of audio), peak memory {peak_gb:.2f} GiB [{card}]")


def phase_profile(model, wave10, card: str) -> None:
    """Where the time of one B=1 x 10 s forward goes on the card, by
    torch.profiler: device time by kernel and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fullsubnet_tpu_torch.acoustics.stft import stft_complex

    spec = stft_complex(torch.from_numpy(wave10).cuda(), 512, 256, 512)
    mag = spec.abs()[None, None]
    with torch.inference_mode():
        model(mag)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(mag)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile of one B=1 x {wave10.size / 16000:g} s forward: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, idle share {max(0.0, 1 - busy / wall_us):.3f} "
          f"[{card}]")
    for dev_us, key, count in rows[:6]:
        print(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / busy:5.1f}%  x{count}  {key[:90]}")


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
    if not (REPO / "fullsubnet_tpu_torch").is_dir() or not RECIPE.is_file():
        print(f"FAIL: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        card = phase_environment()
        phase_build()
        kernel_results = phase_kernel_vs_plain(card)
        with tempfile.TemporaryDirectory() as tmp:
            e2e = phase_end_to_end(Path(tmp), card)
        phase_rtf(e2e["model"], e2e["wave10"], card)
        phase_profile(e2e["model"], e2e["wave10"], card)
    except Exception:  # every failed phase ends the run non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1

    main_case = kernel_results[0]
    print(json.dumps({"kernels": [{
        "name": "lstm_scan (fused 2-layer LSTM + Linear head, fp32)",
        "route": "cuda",
        "source": "fullsubnet_tpu_torch/ops/csrc/subband_lstm.cu",
        "replaces": "fullsubnet_tpu/ops/subband_lstm.py:184",
        "launches": e2e["launches"],
        "max_abs_err": max(r["err"] for r in kernel_results),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "at": f"{main_case['name']}, T=400",
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
