#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship paths once on one NVIDIA GPU and
check them: inference (kernel K1) and a training step (kernels K2, K3).

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (each one that fails ends the run with exit code 1):

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
   TF32 off for matmuls and cuDNN;
2. build: compile both kernel libraries from ``fullsubnet_tpu_torch/ops/csrc``,
   one nvcc per source, all started together;
3. K1 vs plain PyTorch (and vs cuDNN ``nn.LSTM`` as a third oracle) at the
   flagship inference shapes, fp32, with times;
4. K2 and K3 vs plain at the flagship training shapes (both stages at
   B = 32 x 3.072 s), fp32 and bf16: the forward output and stashes, K3's
   outputs, and the gradients of a fixed loss through ``LstmScanFunction``
   against autograd of the plain version; times of K2, K3, the dW
   products, the plain version and cuDNN;
5. inference end to end: random full-width FullSubNet weights from a seed,
   three noisy wavs, the flagship inference TOML, and the port's CLI on the
   card; the outputs, K1's launch counts for both stages, and the card's
   cIRM against the plain CPU path;
6. the model forward's real-time factor at B=1 and B=8 x 10 s, and a
   torch.profiler breakdown of the B=1 forward;
7. training end to end: 64 clean wavs, 4 noise wavs and 2 RIRs written from
   a seed, a copy of the flagship train TOML pointed at them (no
   validation set, 2 epochs), and the port's train CLI on the card; finite
   losses, K2/K3 launch counts for both stages, no K1 launch, the
   checkpoint set, ``-R`` resuming at epoch 3, and the infer CLI on the
   epoch-2 weights;
8. one fp32 step at B=4 x 3.072 s, full width: the loss and every gradient
   on the card against the port's plain CPU path;
9. the train step's audio-seconds per second at B=32 x 3.072 s (median of
   5 after 2 warm-ups), its peak memory, and a torch.profiler breakdown of
   one step.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit, and before that one JSON line
with each kernel's launches on its main path, error and times.
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


def stack_flops(t: int, n: int, f_in: int, hidden: int, out_dim: int, layers: int = 2) -> int:
    """FLOPs of the fused LSTM stack + head forward: two per multiply-add."""
    per_row_step, in_dim = 0, f_in
    for _ in range(layers):
        per_row_step += 2 * (in_dim + hidden) * 4 * hidden
        in_dim = hidden
    return (per_row_step + 2 * hidden * out_dim) * t * n


def weight_elems(f_in: int, hidden: int, out_dim: int, layers: int = 2) -> int:
    elems, in_dim = 0, f_in
    for _ in range(layers):
        elems += (in_dim + hidden) * 4 * hidden + 4 * hidden
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
    from fullsubnet_tpu_torch.ops.subband_lstm import lstm_scan, train_library

    libraries = {
        "fsn_lstm_scan": (list(lstm_scan._SOURCES), lstm_scan.library),
        train_library.NAME: (list(train_library.SOURCES), train_library),
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


def _stack(rng, f_in: int, hidden: int, out_dim: int, device):
    import numpy as np
    import torch

    def u(shape, bound_):
        return torch.from_numpy(rng.uniform(-bound_, bound_, shape).astype(np.float32)).to(device)

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


def _cudnn_lstm(layers, f_in: int, hidden: int, dtype, device):
    """``nn.LSTM`` holding the stack's weights: the library yardstick."""
    import torch

    lstm = torch.nn.LSTM(f_in, hidden, num_layers=len(layers)).to(device, dtype)
    with torch.no_grad():
        for k, layer in enumerate(layers):
            for key, v in layer.items():
                kind = "weight" if key.startswith("w_") else "bias"
                getattr(lstm, f"{kind}_{key[2:]}_l{k}").copy_(v)
    lstm.flatten_parameters()
    return lstm


KERNEL_CASES = (
    # name, F_in, H, OUT, N, T
    ("sub-band B=1", 32, 384, 2, 257, 400),
    ("sub-band B=8", 32, 384, 2, 8 * 257, 400),
    ("full-band B=1", 257, 512, 257, 1, 400),
    ("full-band B=8", 257, 512, 257, 8, 400),
)


def phase_kernel_vs_plain(card: str) -> list[dict]:
    """K1 at the flagship inference shapes."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops.subband_lstm import (
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
        lstm = _cudnn_lstm(layers, f_in, hidden, torch.float32, dev)
        with torch.no_grad():
            got = fused_subband_lstm(x, *layers, fc)
            torch.cuda.synchronize()
            plain = plain_fused_subband_lstm(x, layers, fc)
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
        # fp32 outside the tensor cores: TF32 would change the results
        nbytes = 4 * (t * n * f_in + weight_elems(f_in, hidden, out_dim) + t * n * out_dim)
        bound_ms, bound_by = bound(stack_flops(t, n, f_in, hidden, out_dim), nbytes, "fp32")
        rows = pick_rows_per_block(n, f_in, hidden, 2)
        print(f"K1 {name} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}): "
              f"max|kernel-plain| {err:.3e}, max|kernel-cuDNN| {err_cudnn:.3e} "
              f"(tol {KERNEL_ATOL:g}); kernel {ms:.3f} ms (rows/block {rows}), "
              f"plain {plain_ms:.3f} ms, cuDNN {cudnn_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}) [{card}]")
        check(err <= KERNEL_ATOL, f"{name}: kernel vs plain {err:.3e} > {KERNEL_ATOL:g}")
        check(err_cudnn <= KERNEL_ATOL, f"{name}: kernel vs cuDNN {err_cudnn:.3e} > {KERNEL_ATOL:g}")
        results.append({"name": name, "err": err, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": cudnn_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        del x, got, plain, cudnn, lstm
    torch.cuda.empty_cache()
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


def phase_train_kernels(card: str) -> dict:
    """K2 and K3 against their plain versions at the flagship training
    shapes, fp32 and bf16, with times and bounds."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.ops import subband_lstm as ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    fp32, bf16 = torch.float32, torch.bfloat16
    found = {"k2": {}, "k3": {}}
    for name, f_in, hidden, out_dim, n, t in TRAIN_CASES:
        layers32, fc32 = _stack(rng, f_in, hidden, out_dim, dev)
        x32 = torch.from_numpy(
            np.abs(rng.standard_normal((t, n, f_in))).astype(np.float32) * 1.25).to(dev)
        target = torch.from_numpy(
            rng.standard_normal((t, n, out_dim)).astype(np.float32) * 0.1).to(dev)

        def plain_op(xr, stack, head):
            return ops.plain_fused_subband_lstm(
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
            states = ([zeros] * 2, [zeros] * 2)

            # K2: the head output and the stashes
            out, hs, cs = ops.stash_fwd(x, ws, bs, wfc, bfc, *states)
            torch.cuda.synchronize()
            p_out, p_hs, p_cs = ops.plain_stash_forward(x, ws, bs, wfc, bfc, *states)
            k2_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip([out, *hs, *cs], [p_out, *p_hs, *p_cs]))
            check(all(bool(torch.isfinite(v).all()) for v in [out, *hs, *cs]),
                  f"K2 {tag}: output not finite")

            # K3, both layers, from a head cotangent of order one (the
            # loss's own, 2 (out - target) / numel, is about 1e-8 here)
            g = out - target
            dh = (g.to(dtype).float() @ fc32["weight"].to(dtype).float()).to(dtype)
            zero_f = torch.zeros((n, hidden), device=dev)
            wts = [w.t().contiguous() for w in ws]

            def k3_both(backward):
                d, dgs = dh, []
                for li in (1, 0):
                    x_seq = x if li == 0 else hs[0]
                    d, dg, _, _ = backward(d, x_seq, hs[li], cs[li], ws[li], wts[li], bs[li],
                                           zeros, zeros, zero_f, zero_f)
                    dgs.append(dg)
                return d, dgs

            k3_dx, k3_dgs = k3_both(ops.layer_bwd)
            torch.cuda.synchronize()
            p_dx, p_dgs = k3_both(ops.plain_layer_backward)
            k3_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip([k3_dx, *k3_dgs], [p_dx, *p_dgs]))
            k3_rel = max(_rel_errs([k3_dx, *k3_dgs], [p_dx, *p_dgs]))

            def dw_both(dgs):
                for li, dg in zip((1, 0), dgs):
                    ops.layer_weight_grads(x if li == 0 else hs[0], hs[li], zeros, dg)

            # the gradients of the loss through LstmScanFunction (K2 + K3)
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

            ms_k2 = cuda_ms(lambda: ops.stash_fwd(x, ws, bs, wfc, bfc, *states))
            ms_plain_fwd = cuda_ms(lambda: ops.plain_stash_forward(x, ws, bs, wfc, bfc, *states),
                                   reps=1)
            ms_k3 = cuda_ms(lambda: k3_both(ops.layer_bwd))
            ms_dw = cuda_ms(lambda: dw_both(k3_dgs))
            ms_plain_bwd = cuda_ms(lambda: dw_both(k3_both(ops.plain_layer_backward)[1]), reps=1)
            ms_cudnn_fwd = ms_cudnn_bwd = None
            try:  # the library yardstick: cuDNN's training forward and its backward
                lstm = _cudnn_lstm(layers32, f_in, hidden, dtype, dev)
                xr = x.detach().requires_grad_()
                wfc_c, bfc_c = fc32["weight"].to(dtype), fc32["bias"].to(dtype)
                ms_cudnn_fwd = cuda_ms(lambda: lstm(xr)[0] @ wfc_c.t() + bfc_c)
                y = lstm(xr)[0]
                dy = torch.randn_like(y)
                ms_cudnn_bwd = cuda_ms(lambda: torch.autograd.grad(
                    y, [xr, *lstm.parameters()], dy, retain_graph=True))
                del lstm, xr, y, dy
            except RuntimeError as e:  # not measured: the port never calls cuDNN
                print(f"  cuDNN {tag}: not measured ({str(e).splitlines()[0][:120]})")

            kind = "fp32" if dtype == fp32 else "bf16"
            s = 4 if dtype == fp32 else 2
            k2_bytes = (s * (t * n * f_in + 4 * n * hidden + 4 * t * n * hidden)
                        + s * weight_elems(f_in, hidden, out_dim) + 4 * t * n * out_dim)
            k2_bound = bound(stack_flops(t, n, f_in, hidden, out_dim), k2_bytes, kind)
            # K3 + dW products, both layers: the layer backward of
            # _pallas_layer_bwd; its inputs dh, x, h and c stashes, its
            # outputs dx and the fp32 weight gradients (dgates stay inside)
            k3_flops = k3_bytes = 0
            for in_dim in (f_in, hidden):
                k3_flops += 3 * 2 * (in_dim + hidden) * 4 * hidden * t * n
                k3_bytes += s * t * n * (3 * hidden + 2 * in_dim)
                k3_bytes += (s + 4) * (in_dim + hidden) * 4 * hidden
            k3_bound = bound(k3_flops, k3_bytes, kind)
            cudnn_txt = ("not measured" if ms_cudnn_fwd is None else
                         f"fwd {ms_cudnn_fwd:.3f} ms, bwd {ms_cudnn_bwd:.3f} ms")
            print(f"K2/K3 {tag} (F_in {f_in}, H {hidden}, OUT {out_dim}, N {n}, T {t}) [{card}]:\n"
                  f"  K2 max|kernel-plain| {k2_err:.3e} over out and stashes; "
                  f"K2 {ms_k2:.3f} ms, plain {ms_plain_fwd:.3f} ms, bound {k2_bound[0]:.3f} ms "
                  f"({k2_bound[1]})\n"
                  f"  K3 max|kernel-plain| {k3_err:.3e} ({k3_rel:.2e} of the largest value) "
                  f"over dx and dgates; K3 both layers "
                  f"{ms_k3:.3f} ms + dW products {ms_dw:.3f} ms, plain {ms_plain_bwd:.3f} ms, "
                  f"bound {k3_bound[0]:.3f} ms ({k3_bound[1]})\n"
                  f"  cuDNN nn.LSTM: {cudnn_txt}\n"
                  f"  loss {loss:.6e} (plain fp32 {ref_loss:.6e}); gradient errors / max vs "
                  f"{vs}: {max(errs):.2e} (tol {grad_tol:g}); vs fp32 plain: "
                  f"{max(errs_fp32):.2e}")
            atol = KERNEL_ATOL if dtype == fp32 else BF16_ATOL
            check(k2_err <= atol, f"K2 {tag}: kernel vs plain {k2_err:.3e} > {atol:g}")
            k3_tol = K3_RTOL_FP32 if dtype == fp32 else GRAD_RTOL_BF16
            check(k3_rel <= k3_tol, f"K3 {tag}: kernel vs plain {k3_rel:.2e} > {k3_tol:g} of max")
            check(max(errs) <= grad_tol, f"{tag}: gradients vs {vs} {max(errs):.2e} > {grad_tol:g}")
            check(max(errs_fp32) <= GRAD_RTOL_BF16,
                  f"{tag}: gradients vs fp32 plain {max(errs_fp32):.2e} > {GRAD_RTOL_BF16:g}")
            found["k2"][tag] = {"err": k2_err, "ms": ms_k2, "plain_ms": ms_plain_fwd,
                                "library_ms": ms_cudnn_fwd, "bound_ms": k2_bound[0],
                                "bound_by": k2_bound[1]}
            found["k3"][tag] = {"err": k3_err, "ms": ms_k3 + ms_dw, "kernel_ms": ms_k3,
                                "dw_ms": ms_dw, "plain_ms": ms_plain_bwd,
                                "library_ms": ms_cudnn_bwd, "bound_ms": k3_bound[0],
                                "bound_by": k3_bound[1]}
            del out, hs, cs, p_out, p_hs, p_cs, k3_dx, k3_dgs, p_dx, p_dgs, grads
            torch.cuda.empty_cache()
    return found


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
        bound_ = 1.0 / hidden**0.5
        state[key] = torch.from_numpy(
            rng.uniform(-bound_, bound_, tuple(v.shape)).astype(np.float32)
        )
    torch.save({"model": state, "epoch": 0}, path)


def _inference_config(work: Path, noisy_dir: Path) -> Path:
    toml = RECIPE.read_text()
    toml, n_sub = re.subn(r"(?m)^dataset_dir_list = .*$",
                          f"dataset_dir_list = [{json.dumps(str(noisy_dir))}]", toml)
    check(n_sub == 1, "recipe has no dataset_dir_list line to point at the wavs")
    cfg = work / f"inference_{noisy_dir.name}.toml"
    cfg.write_text(toml)
    return cfg


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
    cfg = _inference_config(work, noisy_dir)
    out_dir = work / "out"

    lstm_scan.reset_counts()
    t0 = time.perf_counter()
    cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_scan.launches
    by_shape = dict(lstm_scan.launches_by_shape)
    print(f"infer CLI on {len(inputs)} wavs (1 s, 4 s, 10 s): {wall:.2f} s wall incl. first-call "
          f"set-up; K1 launches {launches}, by (F_in, H, OUT) {by_shape} [{card}]")

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
        m_cpu = cpu.model(mag, dropping_band=False)
        m_gpu = gpu.model(mag.cuda(), dropping_band=False).cpu()
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


def _profile(fn, label: str, card: str) -> None:
    """torch.profiler over one call of ``fn`` (which synchronises): device
    time by kernel and the device's idle share."""
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
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_us):.3f} [{card}]")
    for dev_us, key, count in rows[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  {100 * dev_us / busy:5.1f}%  x{count}  {key[:90]}")


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


def _train_config(work: Path, lists: dict, name: str, **changes) -> Path:
    """The flagship train TOML with the dataset lists pointed at ``lists``,
    no validation set, and ``changes`` (key = value) made in their
    sections; everything else as the recipe has it."""
    toml = TRAIN_RECIPE.read_text()
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


def phase_train_end_to_end(work: Path, card: str) -> dict:
    """The flagship train step through the port's train CLI."""
    import numpy as np
    import torch

    from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
    from fullsubnet_tpu_torch.infer import cli as infer_cli
    from fullsubnet_tpu_torch.ops.subband_lstm import layer_bwd, lstm_scan, stash_fwd
    from fullsubnet_tpu_torch.train import cli as train_cli

    lists = _write_train_data(work / "train_data")
    cfg = _train_config(work, lists, "flagship_train", epochs=2, save_checkpoint_interval=1)
    out = work / "runs"
    for kernel in (lstm_scan, stash_fwd, layer_bwd):
        kernel.reset_counts()
    t0 = time.perf_counter()
    trainer = train_cli.main(["-C", str(cfg), "-O", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (kernel.launches, dict(kernel.launches_by_shape))
              for k, kernel in (("K1", lstm_scan), ("K2", stash_fwd), ("K3", layer_bwd))}
    steps = trainer.steps
    print(f"train CLI, flagship recipe (B=32 x 3.072 s, bf16, clip 10), 2 epochs over 64 "
          f"clips: {steps} steps in {wall:.2f} s wall incl. set-up and data; losses by epoch "
          f"{trainer.epoch_losses}; launches {counts} [{card}]")
    check(steps == 4, f"{steps} steps, not 2 epochs x 2 batches")
    check(all(np.isfinite(v) for v in trainer.epoch_losses.values()), "a training loss is not finite")
    check(counts["K1"][0] == 0, f"K1 launched {counts['K1'][0]} times in training")
    check(counts["K2"][0] == 2 * steps, f"K2 launches {counts['K2'][0]} != 2 x {steps} steps")
    check(counts["K2"][1] == {(257, 512, 257): steps, (32, 384, 2): steps},
          f"K2 launches by stage {counts['K2'][1]}")
    check(counts["K3"][0] == 4 * steps, f"K3 launches {counts['K3'][0]} != 4 x {steps} steps")
    check(counts["K3"][1] == {(257, 512): steps, (512, 512): steps, (32, 384): steps,
                              (384, 384): steps}, f"K3 launches by layer {counts['K3'][1]}")
    ckpt = out / "flagship_train" / "checkpoints"
    for file in ("latest_model.tar", "model_0001.pth", "model_0002.pth"):
        check((ckpt / file).is_file(), f"no {file} after two epochs")

    # -R with epochs = 3 resumes at epoch 3
    cfg_resume = _train_config(work, lists, "flagship_train", epochs=3, save_checkpoint_interval=1)
    resumed = train_cli.main(["-C", str(cfg_resume), "-O", str(out), "--device", "cuda", "-R"])
    print(f"train CLI -R: epochs run {sorted(resumed.epoch_losses)}, {resumed.steps} steps, "
          f"losses {resumed.epoch_losses}")
    check(sorted(resumed.epoch_losses) == [3] and resumed.steps == 2, "-R did not resume at epoch 3")
    check((ckpt / "model_0003.pth").is_file(), "no model_0003.pth after the resumed epoch")
    del trainer, resumed

    # the infer CLI enhances one wav with the epoch-2 weights
    noisy_dir = work / "noisy_train_check"
    noisy_dir.mkdir()
    sr = 16000
    clean_y = read_wav(Path(lists["clean"].read_text().split()[0]))[0][: 2 * sr]
    noise_y = read_wav(Path(lists["noise"].read_text().split()[0]))[0][: 2 * sr]
    write_wav(noisy_dir / "mix.wav", (clean_y + noise_y).astype(np.float32), sr)
    infer_cli.main(["-C", str(_inference_config(work, noisy_dir)), "-M",
                    str(ckpt / "model_0002.pth"), "-O", str(work / "out_trained"), "--device", "cuda"])
    enhanced, got_sr = read_wav(work / "out_trained" / "enhanced" / "mix.wav")
    check(got_sr == sr and enhanced.shape == (2 * sr,) and bool(np.isfinite(enhanced).all()),
          "the infer CLI on model_0002.pth gave no finite 2 s wav")
    print("infer CLI on model_0002.pth: one 2 s wav enhanced, finite, input length")
    torch.cuda.empty_cache()
    return {"lists": lists, "launches": {k: v[0] for k, v in counts.items()}, "steps": steps}


def _first_batch(trainer, size: int):
    import numpy as np
    import torch

    ds = trainer.train_dataset
    ds.set_epoch(1)
    items = [ds[i] for i in range(size)]
    return tuple(torch.from_numpy(np.stack([it[k] for it in items])) for k in (0, 1))


def phase_card_vs_cpu_step(work: Path, lists: dict, card: str) -> None:
    """One fp32 step at B=4 x 3.072 s, full width: loss and gradients on the
    card against the port's plain CPU path, same weights and batch."""
    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    cfg = load_config(_train_config(work, lists, "step_b4_fp32", use_amp="false",
                                    batch_size=4, num_workers=0))
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(cfg, output_dir=str(work / f"step_{device}"), device=device)
        noisy, clean = _first_batch(trainer, 4)
        loss = trainer.compute_loss(noisy.to(device), clean.to(device))
        loss.backward()
        losses[device] = float(loss.detach())
        grads[device] = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
        del trainer
    rel = {k: float((grads["cuda"][k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for k, w in grads["cpu"].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"one fp32 step B=4 x 3.072 s, card vs plain CPU: loss {losses['cuda']:.8e} vs "
          f"{losses['cpu']:.8e} (rel {loss_rel:.2e}, tol {STEP_LOSS_RTOL:g}); gradient error / "
          f"max, worst {rel[worst]:.2e} at {worst} (tol {STEP_GRAD_RTOL:g}) [{card}]")
    check(loss_rel <= STEP_LOSS_RTOL, f"step loss card vs CPU {loss_rel:.2e}")
    check(rel[worst] <= STEP_GRAD_RTOL, f"step gradient {worst} card vs CPU {rel[worst]:.2e}")


def phase_train_step_numbers(work: Path, lists: dict, card: str) -> None:
    """audio-s/s of the flagship train step, its peak memory, and where one
    step's device time goes."""
    import torch

    from fullsubnet_tpu_torch.config import load_config
    from fullsubnet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_config(_train_config(work, lists, "step_numbers", num_workers=0)),
                      output_dir=str(work / "step_numbers"), device="cuda")
    noisy, clean = (v.cuda() for v in _first_batch(trainer, 32))
    audio_s = noisy.shape[0] * noisy.shape[1] / 16000

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
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step B=32 x 3.072 s (bf16, the batch on the card): median {median * 1e3:.1f} ms "
          f"of {[round(t * 1e3, 1) for t in times]}, {audio_s / median:.2f} audio-s/s, peak "
          f"memory {peak_gb:.2f} GiB [{card}]")
    _profile(step, "one train step B=32 x 3.072 s", card)


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
    try:
        t_start = time.perf_counter()
        card = phase_environment()
        phase_build()
        k1 = phase_kernel_vs_plain(card)
        train_kernels = phase_train_kernels(card)
        with tempfile.TemporaryDirectory() as tmp:
            e2e = phase_end_to_end(Path(tmp), card)
            phase_rtf(e2e["model"], e2e["wave10"], card)
            phase_profile(e2e["model"], e2e["wave10"], card)
            del e2e["model"]
            train = phase_train_end_to_end(Path(tmp), card)
            phase_card_vs_cpu_step(Path(tmp), train["lists"], card)
            phase_train_step_numbers(Path(tmp), train["lists"], card)
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

    k2, k3 = train_kernels["k2"], train_kernels["k3"]
    print(json.dumps({"kernels": [
        entry("lstm_scan (K1: fused 2-layer LSTM + Linear head, inference forward, fp32)",
              "fullsubnet_tpu_torch/ops/csrc/subband_lstm.cu",
              "fullsubnet_tpu/ops/subband_lstm.py:184", e2e["launches"],
              max(r["err"] for r in k1), f"{k1[0]['name']}, T=400", k1[0]),
        entry("lstm_stash_forward (K2: training forward with h/c stashes)",
              "fullsubnet_tpu_torch/ops/csrc/lstm_train_fwd.cu",
              "fullsubnet_tpu/ops/subband_lstm.py:483", train["launches"]["K2"],
              max(v["err"] for k, v in k2.items() if k.endswith("float32")),
              "sub-band bfloat16, N=4096, T=195; max_abs_err over the fp32 cases",
              k2["sub-band bfloat16"]),
        entry("lstm_layer_backward (K3: one layer's backward, split dW)",
              "fullsubnet_tpu_torch/ops/csrc/lstm_layer_bwd.cu",
              "fullsubnet_tpu/ops/subband_lstm.py:844", train["launches"]["K3"],
              max(v["err"] for k, v in k3.items() if k.endswith("float32")),
              "sub-band bfloat16, N=4096, T=195, both layers with the dW products; "
              "max_abs_err over the fp32 cases", k3["sub-band bfloat16"]),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
