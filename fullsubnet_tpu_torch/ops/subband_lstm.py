"""Fused N-layer LSTM scan + Linear head (counterpart of
``fullsubnet_tpu/ops/subband_lstm.py:fused_subband_lstm``, inference
forward only).

Three pieces:

* :func:`plain_fused_subband_lstm` — the plain PyTorch version
  (``nn.rnn.lstm_forward`` and the head). A CPU tensor goes here.
* :data:`lstm_scan` — the wrapper of the hand-written CUDA kernel
  ``csrc/subband_lstm.cu`` (see the note at its top), with its launch
  counts. A CUDA tensor goes here: the kernel launches or the call raises.
* :func:`fused_subband_lstm` — the public function, with the JAX
  signature: ``fused_subband_lstm(x, l1, l2, fc)`` returns [T, N, OUT]
  float32.

Layer dicts are in the torch layout ({w_ih [4H, in], w_hh [4H, H],
b_ih, b_hh}, gate order i, f, g, o); the head is {weight [OUT, H], bias}.
The training forward and the backward kernels (ROADMAP B.2, B.3) and the
GRU cell (B.1, B.4) are not ported yet.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from fullsubnet_tpu_torch.nn.rnn import lstm_forward
from fullsubnet_tpu_torch.ops.build import CSRC, build_library

MAX_LAYERS = 3
# an H100 block may use 227 KB of shared memory (232,448 bytes)
_MAX_SMEM_BYTES = 232_448
# tile sizes the kernel is built for; 1 and 4 rows were never the
# fastest at the flagship shapes (PERF.md, rows-per-block sweep)
ROWS_PER_BLOCK = (2, 8)


def _check_stack(x: torch.Tensor, layers, fc) -> None:
    """Validate the shapes of x [T, N, F] and of a torch-layout stack."""
    if x.ndim != 3:
        raise ValueError(f"x must be [T, N, F], got shape {tuple(x.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers supported, got {len(layers)}")
    hidden = layers[0]["w_hh"].shape[1]
    in_dim = x.shape[2]
    for li, layer in enumerate(layers):
        if layer["w_ih"].shape != (4 * hidden, in_dim):
            raise ValueError(
                f"layer {li}: w_ih {tuple(layer['w_ih'].shape)} is not "
                f"[4H, in] = [{4 * hidden}, {in_dim}] (LSTM cells only)"
            )
        if layer["w_hh"].shape != (4 * hidden, hidden):
            raise ValueError(f"layer {li}: w_hh is not [4H, H]")
        if layer["b_ih"].shape != (4 * hidden,) or layer["b_hh"].shape != (4 * hidden,):
            raise ValueError(f"layer {li}: biases are not [4H]")
        in_dim = hidden
    if fc["weight"].ndim != 2 or fc["weight"].shape[1] != hidden:
        raise ValueError("fc weight must be [OUT, H]")
    out_dim = fc["weight"].shape[0]
    if fc["bias"].shape != (out_dim,):
        raise ValueError("fc bias must be [OUT]")


def plain_fused_subband_lstm(x: torch.Tensor, layers, fc) -> torch.Tensor:
    """Plain PyTorch version: x [T, N, F] -> [T, N, OUT] float32."""
    h = lstm_forward(layers, x)
    return (h @ fc["weight"].t() + fc["bias"]).float()


def prep_weights(layers, fc):
    """Torch-layout stack -> the kernel's operands: per layer
    [W_ih^T ; W_hh^T] as [in + H, 4H] and b_ih + b_hh as [4H]; the head
    as W_fc^T [H, OUT] and its bias. All contiguous, dtype kept."""
    ws = [torch.cat([l["w_ih"], l["w_hh"]], dim=1).t().contiguous() for l in layers]
    bs = [(l["b_ih"] + l["b_hh"]).contiguous() for l in layers]
    return ws, bs, fc["weight"].t().contiguous(), fc["bias"].contiguous()


def smem_bytes(f_in: int, hidden: int, num_layers: int, rows: int) -> int:
    """Dynamic shared memory of one block: the x_t tile, h by step parity
    and c, for every layer."""
    return 4 * (rows * f_in + 3 * num_layers * rows * hidden)


def pick_rows_per_block(n: int, f_in: int, hidden: int, num_layers: int) -> int:
    """Rows per block. More rows amortise each weight read from L2 over
    more sequences; fewer rows make more blocks, and so more SMs pulling
    weights. Measured on an H100 at the flagship shapes (PERF.md): 8 rows
    is best once it still gives a block for each of the 132 SMs (the
    sub-band stage at B = 8), 2 rows below that (B = 1 and the full-band
    stage). 2 rows where 8 would exceed the shared-memory limit."""
    if -(-n // 8) >= 132 and smem_bytes(f_in, hidden, num_layers, 8) <= _MAX_SMEM_BYTES:
        return 8
    return 2


class LstmScanKernel:
    """ctypes wrapper of ``fsn_lstm_scan_forward`` (csrc/subband_lstm.cu).

    ``launches`` counts the kernel launches this wrapper made;
    ``launches_by_shape`` splits them by (F_in, H, OUT), which tells the
    flagship's full-band stage (257, 512, 257) from its sub-band stage
    (32, 384, 2). Both count only where the kernel is launched.
    """

    _SOURCES = (CSRC / "subband_lstm.cu",)

    def __init__(self):
        self._lib = None
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()

    def library(self) -> ctypes.CDLL:
        """Build (first use only) and load the kernel library."""
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library("fsn_lstm_scan", list(self._SOURCES))))
            lib.fsn_lstm_scan_forward.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            )
            lib.fsn_lstm_scan_forward.restype = ctypes.c_int
            lib.fsn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fsn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, layers, fc, rows_per_block: int | None = None):
        """x [T, N, F] and a torch-layout stack, fp32 on one CUDA device
        -> out [T, N, OUT] fp32."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        _check_stack(x, layers, fc)
        ws, bs, wfc, bfc = prep_weights(layers, fc)
        for tensor in [x, *ws, *bs, wfc, bfc]:
            if tensor.device != x.device:
                raise ValueError("all operands must be on the device of x")
            if tensor.dtype != torch.float32:
                raise TypeError(f"the kernel takes float32, got {tensor.dtype}")
        if not x.is_contiguous():
            raise ValueError("the kernel takes a contiguous x")
        t, n, f_in = x.shape
        num_layers = len(layers)
        hidden = ws[0].shape[1] // 4
        out_dim = wfc.shape[1]
        if rows_per_block is None:
            rows_per_block = pick_rows_per_block(n, f_in, hidden, num_layers)
        if rows_per_block not in ROWS_PER_BLOCK:
            raise ValueError(f"rows_per_block must be one of {ROWS_PER_BLOCK}")
        if smem_bytes(f_in, hidden, num_layers, rows_per_block) > _MAX_SMEM_BYTES:
            raise ValueError(
                f"F={f_in}, H={hidden}, L={num_layers} at {rows_per_block} rows "
                "per block needs more shared memory than a block may use"
            )

        lib = self.library()
        out = torch.empty((t, n, out_dim), device=x.device, dtype=torch.float32)
        wb = [p for w, b in zip(ws, bs) for p in (w.data_ptr(), b.data_ptr())]
        wb += [None] * (2 * (MAX_LAYERS - num_layers))  # NULL for absent layers
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_lstm_scan_forward(
                x.data_ptr(), *wb, wfc.data_ptr(), bfc.data_ptr(), out.data_ptr(),
                t, n, f_in, hidden, out_dim, num_layers, rows_per_block, stream,
            )
        if err != 0:
            msg = lib.fsn_cuda_error_string(err).decode()
            raise RuntimeError(f"fsn_lstm_scan_forward failed: CUDA error {err} ({msg})")
        self.launches += 1
        self.launches_by_shape[(f_in, hidden, out_dim)] += 1
        return out


lstm_scan = LstmScanKernel()


def fused_subband_lstm(
    x: torch.Tensor,
    *layers_and_fc: dict,
    time_major_features: bool = False,
    rows_per_block: int | None = None,
) -> torch.Tensor:
    """Run the fused N-layer LSTM + Linear over x.

    Args:
        x: [T, N, F_in] (or [T, F_in, N] if ``time_major_features``);
            N = B·F frequency-batched rows.
        *layers_and_fc: one to three layer dicts, then the head dict.
        rows_per_block: CUDA only; None picks :func:`pick_rows_per_block`.

    Returns:
        [T, N, OUT] float32. A CPU tensor runs the plain version; a CUDA
        tensor runs the kernel (inference only: it has no backward yet,
        so a call that autograd would record raises).
    """
    layers, fc = tuple(layers_and_fc[:-1]), layers_and_fc[-1]
    if time_major_features:
        x = x.transpose(1, 2)  # -> [T, N, F_in]
    if x.device.type == "cpu":
        _check_stack(x, layers, fc)
        return plain_fused_subband_lstm(x, layers, fc)
    if x.device.type != "cuda":
        raise ValueError(f"no fused LSTM path for device {x.device}")
    operands = [x, fc["weight"], fc["bias"], *(v for l in layers for v in l.values())]
    if torch.is_grad_enabled() and any(v.requires_grad for v in operands):
        raise RuntimeError(
            "the CUDA LSTM-scan kernel has no backward yet (ROADMAP B.3); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )
    return lstm_scan(x.contiguous(), layers, fc, rows_per_block)
