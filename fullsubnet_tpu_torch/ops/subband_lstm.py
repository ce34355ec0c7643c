"""Fused N-layer LSTM or GRU scan + Linear head (counterpart of
``fullsubnet_tpu/ops/subband_lstm.py:fused_subband_lstm``), inference
forward and training (forward with state stashes, per-layer backward).

The pieces, each kernel beside its plain PyTorch version:

* K1, the LSTM inference forward: :data:`lstm_scan` wraps
  ``csrc/subband_lstm.cu``; :func:`plain_fused_subband_lstm`. fp32.
* K2, the LSTM training forward: :data:`stash_fwd` wraps
  ``csrc/lstm_train_fwd.cu``; :func:`plain_stash_forward`. fp32 or bf16
  storage.
* K3, one LSTM layer's backward: :data:`layer_bwd` wraps
  ``csrc/lstm_layer_bwd.cu``; :func:`plain_layer_backward`. fp32 or bf16.
* K1-GRU, the GRU inference forward: :data:`gru_scan` wraps
  ``csrc/gru_forward.cu``; :func:`plain_fused_subband_gru`. fp32.
* K2-GRU, the GRU training forward: :data:`gru_stash_fwd` wraps
  ``csrc/gru_forward.cu``; :func:`plain_stash_forward` without c0s. fp32
  or bf16.
* K4, one GRU layer's backward: :data:`gru_layer_bwd` wraps
  ``csrc/gru_layer_bwd.cu``; :func:`plain_gru_layer_backward`. fp32 or
  bf16.
* :class:`RnnScanFunction`, the ``torch.autograd.Function`` that joins
  the training forward and the layer backward of either cell (the
  counterpart of ``_train_vjp_fn`` with ``_bwd_direct``): the head
  backward and the weight gradients are plain products here, the
  recurrences are the kernels'.
* :func:`fused_subband_lstm`, the public function with the JAX signature:
  ``fused_subband_lstm(x, l1, l2, fc)`` returns [T, N, OUT] float32; the
  cell follows from the weights' gate count, as in the JAX package.

Device dispatch happens only in :func:`stash_forward`,
:func:`layer_backward`, :func:`gru_layer_backward` and
:func:`fused_subband_lstm`: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. The wrappers themselves refuse CPU
tensors.

Layer dicts are in the torch layout ({w_ih [G·H, in], w_hh [G·H, H],
b_ih, b_hh}; LSTM: G = 4, gate order i, f, g, o; GRU: G = 3, gate order
r, z, n); the head is {weight [OUT, H], bias}. The time-chunked backward
(ROADMAP B.5) is not ported yet.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from fullsubnet_tpu_torch.nn.rnn import gru_forward, lstm_forward
from fullsubnet_tpu_torch.ops.build import CSRC, build_library

MAX_LAYERS = 3
# an H100 block may use 227 KB of shared memory (232,448 bytes)
_MAX_SMEM_BYTES = 232_448
# tile sizes the kernels are built for; 1 and 4 rows were never the
# fastest for K1 at the flagship shapes (PERF.md, rows-per-block sweep)
ROWS_PER_BLOCK = (2, 8)
# storage types of the training kernels, by their code in the C interface
TRAIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_GATES = {"lstm": 4, "gru": 3}


def _cell_of(layer: dict) -> tuple[int, str]:
    """(H, cell) of a torch-layout layer: the cell from the gate count
    ``w_ih.shape[0] // H`` (counterpart of the JAX package's ``_cell_of``)."""
    hidden = layer["w_hh"].shape[1]
    gates = layer["w_ih"].shape[0] // hidden
    for cell, g in _GATES.items():
        if g == gates:
            return hidden, cell
    raise ValueError(
        f"w_ih {tuple(layer['w_ih'].shape)} holds {gates} gates of H = {hidden}: "
        "neither an LSTM (4) nor a GRU (3) layer"
    )


def _check_stack(x: torch.Tensor, layers, fc) -> str:
    """Validate the shapes of x [T, N, F] and of a torch-layout stack;
    returns its cell, "lstm" or "gru"."""
    if x.ndim != 3:
        raise ValueError(f"x must be [T, N, F], got shape {tuple(x.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers supported, got {len(layers)}")
    hidden, cell = _cell_of(layers[0])
    gh = _GATES[cell] * hidden
    in_dim = x.shape[2]
    for li, layer in enumerate(layers):
        if layer["w_ih"].shape != (gh, in_dim):
            raise ValueError(
                f"layer {li}: w_ih {tuple(layer['w_ih'].shape)} is not "
                f"[G·H, in] = [{gh}, {in_dim}] ({cell} stack)"
            )
        if layer["w_hh"].shape != (gh, hidden):
            raise ValueError(f"layer {li}: w_hh is not [G·H, H] = [{gh}, {hidden}]")
        if layer["b_ih"].shape != (gh,) or layer["b_hh"].shape != (gh,):
            raise ValueError(f"layer {li}: biases are not [G·H] = [{gh}]")
        in_dim = hidden
    if fc["weight"].ndim != 2 or fc["weight"].shape[1] != hidden:
        raise ValueError("fc weight must be [OUT, H]")
    out_dim = fc["weight"].shape[0]
    if fc["bias"].shape != (out_dim,):
        raise ValueError("fc bias must be [OUT]")
    return cell


def plain_fused_subband_lstm(x: torch.Tensor, layers, fc) -> torch.Tensor:
    """Plain PyTorch version of K1: x [T, N, F] -> [T, N, OUT] float32."""
    h = lstm_forward(layers, x)
    return (h @ fc["weight"].t() + fc["bias"]).float()


def plain_fused_subband_gru(x: torch.Tensor, layers, fc) -> torch.Tensor:
    """Plain PyTorch version of K1-GRU: x [T, N, F] -> [T, N, OUT] float32."""
    h = gru_forward(layers, x)
    return (h @ fc["weight"].t() + fc["bias"]).float()


def prep_weights(layers, fc, dtype: torch.dtype | None = None):
    """Torch-layout stack -> the kernels' operands: per layer
    [W_ih^T ; W_hh^T] as [in + H, G·H]; the LSTM's biases fused as
    b_ih + b_hh [4H], the GRU's kept as the pair [2, 3H] (rows b_ih,
    b_hh: the reset gate scales W_hn h + b_hn), as the JAX package's
    ``_prep_weights`` does; the head as W_fc^T [H, OUT] and its bias. With
    ``dtype`` (the training kernels) the weights are cast to it and the
    biases to float32; without it every dtype is kept. All contiguous."""
    ws = [torch.cat([l["w_ih"], l["w_hh"]], dim=1).t().contiguous() for l in layers]
    if _cell_of(layers[0])[1] == "lstm":
        bs = [(l["b_ih"] + l["b_hh"]).contiguous() for l in layers]
    else:
        bs = [torch.stack([l["b_ih"], l["b_hh"]]).contiguous() for l in layers]
    wfc, bfc = fc["weight"].t().contiguous(), fc["bias"].contiguous()
    if dtype is not None:
        ws = [w.to(dtype) for w in ws]
        bs = [b.float() for b in bs]
        wfc, bfc = wfc.to(dtype), bfc.float()
    return ws, bs, wfc, bfc


def smem_bytes(f_in: int, hidden: int, num_layers: int, rows: int, cell: str = "lstm",
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one forward block (K1, K2, K1-GRU,
    K2-GRU): the x_t tile and, for every layer, h by step parity and c
    (LSTM) or, for a GRU at bf16 storage, the fp32 h carry beside the
    rounded h (at fp32 the parity buffers are the carry)."""
    planes = 3 if cell == "lstm" or dtype != torch.float32 else 2
    return 4 * (rows * f_in + planes * num_layers * rows * hidden)


def bwd_smem_bytes(f_in: int, hidden: int, rows: int, cell: str = "lstm") -> int:
    """Dynamic shared memory of one layer-backward block: [x_t | h_{t-1}]
    and the dh carry; K3 adds dgates [4H] and the dc carry, K4 dxw [3H]
    and the n part of dhw [H]."""
    rest = 4 * hidden + hidden if cell == "lstm" else 3 * hidden + hidden
    return 4 * rows * ((f_in + hidden) + rest + hidden)


def _pick_rows(n: int, smem_at_8_rows: int) -> int:
    if -(-n // 8) >= 132 and smem_at_8_rows <= _MAX_SMEM_BYTES:
        return 8
    return 2


def pick_rows_per_block(n: int, f_in: int, hidden: int, num_layers: int, cell: str = "lstm",
                        dtype: torch.dtype = torch.float32) -> int:
    """Rows per block of the forward kernels. More rows amortise each
    weight read from L2 over more sequences; fewer rows make more blocks,
    and so more SMs pulling weights. Measured on an H100 at the flagship
    LSTM shapes (PERF.md): 8 rows is best once it still gives a block for
    each of the 132 SMs (the sub-band stage at B = 8), 2 rows below that
    (B = 1 and the full-band stage). 2 rows where 8 would exceed the
    shared-memory limit. The GRU kernels share the rule."""
    return _pick_rows(n, smem_bytes(f_in, hidden, num_layers, 8, cell, dtype))


def pick_bwd_rows_per_block(n: int, f_in: int, hidden: int, cell: str = "lstm") -> int:
    """Rows per block of K3 and K4, by the same rule."""
    return _pick_rows(n, bwd_smem_bytes(f_in, hidden, 8, cell))


def _check_rows(rows_per_block: int, smem: int, what: str) -> None:
    if rows_per_block not in ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block must be one of {ROWS_PER_BLOCK}")
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} at {rows_per_block} rows per block needs more shared "
            "memory than a block may use"
        )


def _check_operands(device: torch.device, named: dict, dtypes: dict) -> None:
    """Every operand on ``device``, contiguous, of the dtype ``dtypes``
    names for it."""
    for name, tensor in named.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, not on {device}")
        if tensor.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _Counts:
    """Launch counts of a kernel wrapper. ``launches`` counts the kernel
    launches the wrapper made; ``launches_by_shape`` splits them by the
    shape key the wrapper names (for the flagship, (F_in, H, OUT) tells
    the full-band stage (257, 512, 257) from the sub-band stage
    (32, 384, 2)). Both count only where the kernel is launched."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()

    def _count(self, key) -> None:
        self.launches += 1
        self.launches_by_shape[key] += 1


def _raise_on(err: int, fn: str, error_string) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


class LstmScanKernel(_Counts):
    """ctypes wrapper of ``fsn_lstm_scan_forward`` (csrc/subband_lstm.cu),
    K1; counted by (F_in, H, OUT)."""

    _SOURCES = (CSRC / "subband_lstm.cu",)

    def __init__(self):
        super().__init__()
        self._lib = None

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
        if _check_stack(x, layers, fc) != "lstm":
            raise ValueError("K1 takes an LSTM stack; a GRU stack runs K1-GRU (gru_scan)")
        ws, bs, wfc, bfc = prep_weights(layers, fc)
        named = {"x": x, "wfc": wfc, "bfc": bfc}
        named.update({f"w{li}": w for li, w in enumerate(ws)})
        named.update({f"b{li}": b for li, b in enumerate(bs)})
        _check_operands(x.device, named, dict.fromkeys(named, torch.float32))
        t, n, f_in = x.shape
        num_layers = len(layers)
        hidden = ws[0].shape[1] // 4
        out_dim = wfc.shape[1]
        if rows_per_block is None:
            rows_per_block = pick_rows_per_block(n, f_in, hidden, num_layers)
        _check_rows(rows_per_block, smem_bytes(f_in, hidden, num_layers, rows_per_block),
                    f"F={f_in}, H={hidden}, L={num_layers}")

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
        _raise_on(err, "fsn_lstm_scan_forward", lib.fsn_cuda_error_string)
        self._count((f_in, hidden, out_dim))
        return out


lstm_scan = LstmScanKernel()


class TrainKernelLibrary:
    """The library of the two training kernels, K2 (csrc/lstm_train_fwd.cu)
    and K3 (csrc/lstm_layer_bwd.cu), built from their sources and the
    header they share at first use, and loaded with ctypes."""

    SOURCES = (
        CSRC / "lstm_train_fwd.cu",
        CSRC / "lstm_layer_bwd.cu",
        CSRC / "lstm_train_common.cuh",
    )
    NAME = "fsn_lstm_train"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, ptrs, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
            lib.fsn_lstm_stash_forward.argtypes = (
                [ptr, ptrs, ptrs, ptr, ptr, ptrs, ptrs, ptr, ptrs, ptrs] + [i] * 8 + [ptr]
            )
            lib.fsn_lstm_stash_forward.restype = i
            lib.fsn_lstm_layer_backward.argtypes = [ptr] * 15 + [i] * 6 + [ptr]
            lib.fsn_lstm_layer_backward.restype = i
            lib.fsn_train_error_string.argtypes = [i]
            lib.fsn_train_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


train_library = TrainKernelLibrary()


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * MAX_LAYERS)(*[t.data_ptr() for t in tensors])


class StashForwardKernel(_Counts):
    """ctypes wrapper of ``fsn_lstm_stash_forward`` (csrc/lstm_train_fwd.cu),
    K2; counted by (F_in, H, OUT)."""

    def __call__(self, x, ws, bs, wfc, bfc, h0s, c0s, rows_per_block: int | None = None):
        """x [T, N, F]; per layer w [in + H, 4H], b [4H] fp32, h0 and c0
        [N, H]; wfc [H, OUT], bfc [OUT] fp32. x, w, wfc, h0 and c0 share
        one storage type, fp32 or bf16. Returns (out [T, N, OUT] fp32,
        h stashes, c stashes), each stash [T, N, H] in the storage type."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype not in TRAIN_DTYPES:
            raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
        if not 1 <= len(ws) <= MAX_LAYERS or not len(ws) == len(bs) == len(h0s) == len(c0s):
            raise ValueError(f"1..{MAX_LAYERS} layers, with w, b, h0 and c0 for each")
        t, n, f_in = x.shape
        num_layers = len(ws)
        hidden = ws[0].shape[1] // 4
        out_dim = wfc.shape[1]
        named = {"x": x, "wfc": wfc, "bfc": bfc}
        in_dim = f_in
        for li in range(num_layers):
            if ws[li].shape != (in_dim + hidden, 4 * hidden) or bs[li].shape != (4 * hidden,):
                raise ValueError(f"layer {li}: w must be [in + H, 4H] and b [4H]")
            if h0s[li].shape != (n, hidden) or c0s[li].shape != (n, hidden):
                raise ValueError(f"layer {li}: h0 and c0 must be [N, H]")
            named.update({f"w{li}": ws[li], f"b{li}": bs[li], f"h0{li}": h0s[li],
                          f"c0{li}": c0s[li]})
            in_dim = hidden
        if wfc.shape != (hidden, out_dim) or bfc.shape != (out_dim,):
            raise ValueError("wfc must be [H, OUT] and bfc [OUT]")
        _check_operands(x.device, named, {
            k: torch.float32 if k[0] == "b" else x.dtype for k in named
        })
        if rows_per_block is None:
            rows_per_block = pick_rows_per_block(n, f_in, hidden, num_layers)
        _check_rows(rows_per_block, smem_bytes(f_in, hidden, num_layers, rows_per_block),
                    f"F={f_in}, H={hidden}, L={num_layers}")

        lib = train_library()
        out = torch.empty((t, n, out_dim), device=x.device, dtype=torch.float32)
        hs = [torch.empty((t, n, hidden), device=x.device, dtype=x.dtype) for _ in ws]
        cs = [torch.empty((t, n, hidden), device=x.device, dtype=x.dtype) for _ in ws]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_lstm_stash_forward(
                x.data_ptr(), _ptr_array(ws), _ptr_array(bs), wfc.data_ptr(), bfc.data_ptr(),
                _ptr_array(h0s), _ptr_array(c0s), out.data_ptr(), _ptr_array(hs),
                _ptr_array(cs), t, n, f_in, hidden, out_dim, num_layers, rows_per_block,
                TRAIN_DTYPES[x.dtype], stream,
            )
        _raise_on(err, "fsn_lstm_stash_forward", lib.fsn_train_error_string)
        self._count((f_in, hidden, out_dim))
        return out, hs, cs


stash_fwd = StashForwardKernel()


class LayerBackwardKernel(_Counts):
    """ctypes wrapper of ``fsn_lstm_layer_backward``
    (csrc/lstm_layer_bwd.cu), K3; counted by (F_in, H)."""

    def __call__(self, dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in,
                 rows_per_block: int | None = None):
        """One layer's backward over T steps. dh, hs, cs [T, N, H];
        x [T, N, F]; w [F + H, 4H] and wt [4H, F + H] (the same weights in
        both layouts); b [4H] fp32; h0, c0 [N, H]; dh_in, dc_in [N, H]
        fp32. All but the fp32 ones in one storage type, fp32 or bf16.
        Returns (dx [T, N, F], dgates [T, N, 4H], both in the storage
        type; dh0, dc0 [N, H] fp32)."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype not in TRAIN_DTYPES:
            raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
        t, n, f_in = x.shape
        hidden = hs.shape[2]
        shapes = {
            "dh": (t, n, hidden), "hs": (t, n, hidden), "cs": (t, n, hidden),
            "w": (f_in + hidden, 4 * hidden), "wt": (4 * hidden, f_in + hidden),
            "b": (4 * hidden,), "h0": (n, hidden), "c0": (n, hidden),
            "dh_in": (n, hidden), "dc_in": (n, hidden),
        }
        # in the order of the C interface
        named = {"dh": dh, "x": x, "hs": hs, "cs": cs, "h0": h0, "c0": c0,
                 "dh_in": dh_in, "dc_in": dc_in, "w": w, "wt": wt, "b": b}
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        fp32 = ("b", "dh_in", "dc_in")
        _check_operands(x.device, named, {
            k: torch.float32 if k in fp32 else x.dtype for k in named
        })
        if rows_per_block is None:
            rows_per_block = pick_bwd_rows_per_block(n, f_in, hidden)
        _check_rows(rows_per_block, bwd_smem_bytes(f_in, hidden, rows_per_block),
                    f"F={f_in}, H={hidden}")

        lib = train_library()
        dx = torch.empty_like(x)
        dg = torch.empty((t, n, 4 * hidden), device=x.device, dtype=x.dtype)
        dh0 = torch.empty((n, hidden), device=x.device, dtype=torch.float32)
        dc0 = torch.empty_like(dh0)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_lstm_layer_backward(
                *(v.data_ptr() for v in named.values()), dx.data_ptr(), dg.data_ptr(),
                dh0.data_ptr(), dc0.data_ptr(), t, n, f_in, hidden, rows_per_block,
                TRAIN_DTYPES[x.dtype], stream,
            )
        _raise_on(err, "fsn_lstm_layer_backward", lib.fsn_train_error_string)
        self._count((f_in, hidden))
        return dx, dg, dh0, dc0


layer_bwd = LayerBackwardKernel()


class GruKernelLibrary:
    """The library of the three GRU kernels, K1-GRU and K2-GRU
    (csrc/gru_forward.cu) and K4 (csrc/gru_layer_bwd.cu), built from their
    sources and the header they share with the LSTM training kernels at
    first use, and loaded with ctypes."""

    SOURCES = (
        CSRC / "gru_forward.cu",
        CSRC / "gru_layer_bwd.cu",
        CSRC / "lstm_train_common.cuh",
    )
    NAME = "fsn_gru"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, ptrs, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
            lib.fsn_gru_scan_forward.argtypes = [ptr, ptrs, ptrs, ptr, ptr, ptr] + [i] * 7 + [ptr]
            lib.fsn_gru_scan_forward.restype = i
            lib.fsn_gru_stash_forward.argtypes = (
                [ptr, ptrs, ptrs, ptr, ptr, ptrs, ptr, ptrs] + [i] * 8 + [ptr]
            )
            lib.fsn_gru_stash_forward.restype = i
            lib.fsn_gru_layer_backward.argtypes = [ptr] * 12 + [i] * 6 + [ptr]
            lib.fsn_gru_layer_backward.restype = i
            lib.fsn_gru_error_string.argtypes = [i]
            lib.fsn_gru_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


gru_library = GruKernelLibrary()


def _check_gru_weights(ws, bs, wfc, bfc, f_in: int) -> tuple[int, int]:
    """Shapes of the GRU forward kernels' prepped weights; returns (H, OUT)."""
    if not 1 <= len(ws) <= MAX_LAYERS or len(ws) != len(bs):
        raise ValueError(f"1..{MAX_LAYERS} layers, with w and b for each")
    hidden = bs[0].shape[-1] // 3
    in_dim = f_in
    for li, (w, b) in enumerate(zip(ws, bs)):
        if w.shape != (in_dim + hidden, 3 * hidden) or b.shape != (2, 3 * hidden):
            raise ValueError(f"layer {li}: w must be [in + H, 3H] and b [2, 3H] (b_ih, b_hh)")
        in_dim = hidden
    out_dim = wfc.shape[-1]
    if wfc.shape != (hidden, out_dim) or bfc.shape != (out_dim,):
        raise ValueError("wfc must be [H, OUT] and bfc [OUT]")
    return hidden, out_dim


class GruScanKernel(_Counts):
    """ctypes wrapper of ``fsn_gru_scan_forward`` (csrc/gru_forward.cu),
    K1-GRU; counted by (F_in, H, OUT)."""

    def __call__(self, x: torch.Tensor, layers, fc, rows_per_block: int | None = None):
        """x [T, N, F] and a torch-layout GRU stack, fp32 on one CUDA
        device -> out [T, N, OUT] fp32."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        if _check_stack(x, layers, fc) != "gru":
            raise ValueError("K1-GRU takes a GRU stack; an LSTM stack runs K1 (lstm_scan)")
        ws, bs, wfc, bfc = prep_weights(layers, fc)
        named = {"x": x, "wfc": wfc, "bfc": bfc}
        named.update({f"w{li}": w for li, w in enumerate(ws)})
        named.update({f"b{li}": b for li, b in enumerate(bs)})
        _check_operands(x.device, named, dict.fromkeys(named, torch.float32))
        t, n, f_in = x.shape
        num_layers = len(layers)
        hidden, out_dim = _check_gru_weights(ws, bs, wfc, bfc, f_in)
        if rows_per_block is None:
            rows_per_block = pick_rows_per_block(n, f_in, hidden, num_layers, "gru")
        _check_rows(rows_per_block, smem_bytes(f_in, hidden, num_layers, rows_per_block, "gru"),
                    f"F={f_in}, H={hidden}, L={num_layers}")

        lib = gru_library()
        out = torch.empty((t, n, out_dim), device=x.device, dtype=torch.float32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_gru_scan_forward(
                x.data_ptr(), _ptr_array(ws), _ptr_array(bs), wfc.data_ptr(), bfc.data_ptr(),
                out.data_ptr(), t, n, f_in, hidden, out_dim, num_layers, rows_per_block, stream,
            )
        _raise_on(err, "fsn_gru_scan_forward", lib.fsn_gru_error_string)
        self._count((f_in, hidden, out_dim))
        return out


gru_scan = GruScanKernel()


class GruStashForwardKernel(_Counts):
    """ctypes wrapper of ``fsn_gru_stash_forward`` (csrc/gru_forward.cu),
    K2-GRU; counted by (F_in, H, OUT)."""

    def __call__(self, x, ws, bs, wfc, bfc, h0s, rows_per_block: int | None = None):
        """x [T, N, F]; per layer w [in + H, 3H], b [2, 3H] fp32 (rows
        b_ih, b_hh), h0 [N, H]; wfc [H, OUT], bfc [OUT] fp32. x, w, wfc and
        h0 share one storage type, fp32 or bf16. Returns (out [T, N, OUT]
        fp32, h stashes [T, N, H] in the storage type)."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype not in TRAIN_DTYPES:
            raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
        if len(h0s) != len(ws):
            raise ValueError("one h0 for each layer")
        t, n, f_in = x.shape
        num_layers = len(ws)
        hidden, out_dim = _check_gru_weights(ws, bs, wfc, bfc, f_in)
        named = {"x": x, "wfc": wfc, "bfc": bfc}
        for li in range(num_layers):
            if h0s[li].shape != (n, hidden):
                raise ValueError(f"layer {li}: h0 must be [N, H]")
            named.update({f"w{li}": ws[li], f"b{li}": bs[li], f"h0{li}": h0s[li]})
        _check_operands(x.device, named, {
            k: torch.float32 if k[0] == "b" else x.dtype for k in named
        })
        if rows_per_block is None:
            rows_per_block = pick_rows_per_block(n, f_in, hidden, num_layers, "gru", x.dtype)
        _check_rows(rows_per_block,
                    smem_bytes(f_in, hidden, num_layers, rows_per_block, "gru", x.dtype),
                    f"F={f_in}, H={hidden}, L={num_layers}")

        lib = gru_library()
        out = torch.empty((t, n, out_dim), device=x.device, dtype=torch.float32)
        hs = [torch.empty((t, n, hidden), device=x.device, dtype=x.dtype) for _ in ws]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_gru_stash_forward(
                x.data_ptr(), _ptr_array(ws), _ptr_array(bs), wfc.data_ptr(), bfc.data_ptr(),
                _ptr_array(h0s), out.data_ptr(), _ptr_array(hs), t, n, f_in, hidden, out_dim,
                num_layers, rows_per_block, TRAIN_DTYPES[x.dtype], stream,
            )
        _raise_on(err, "fsn_gru_stash_forward", lib.fsn_gru_error_string)
        self._count((f_in, hidden, out_dim))
        return out, hs


gru_stash_fwd = GruStashForwardKernel()


class GruLayerBackwardKernel(_Counts):
    """ctypes wrapper of ``fsn_gru_layer_backward`` (csrc/gru_layer_bwd.cu),
    K4; counted by (F_in, H)."""

    def __call__(self, dh, x, hs, w, wt, b, h0, dh_in, rows_per_block: int | None = None):
        """One GRU layer's backward over T steps. dh, hs [T, N, H];
        x [T, N, F]; w [F + H, 3H] and wt [3H, F + H] (the same weights in
        both layouts); b [2, 3H] fp32 (rows b_ih, b_hh); h0 [N, H]; dh_in
        [N, H] fp32. All but the fp32 ones in one storage type, fp32 or
        bf16. Returns (dx [T, N, F], dxw [T, N, 3H], dhw [T, N, 3H], all
        in the storage type; dh0 [N, H] fp32)."""
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
        if x.dtype not in TRAIN_DTYPES:
            raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
        t, n, f_in = x.shape
        hidden = hs.shape[2]
        shapes = {
            "dh": (t, n, hidden), "hs": (t, n, hidden),
            "w": (f_in + hidden, 3 * hidden), "wt": (3 * hidden, f_in + hidden),
            "b": (2, 3 * hidden), "h0": (n, hidden), "dh_in": (n, hidden),
        }
        # in the order of the C interface
        named = {"dh": dh, "x": x, "hs": hs, "h0": h0, "dh_in": dh_in, "w": w, "wt": wt, "b": b}
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        _check_operands(x.device, named, {
            k: torch.float32 if k in ("b", "dh_in") else x.dtype for k in named
        })
        if rows_per_block is None:
            rows_per_block = pick_bwd_rows_per_block(n, f_in, hidden, "gru")
        _check_rows(rows_per_block, bwd_smem_bytes(f_in, hidden, rows_per_block, "gru"),
                    f"F={f_in}, H={hidden}")

        lib = gru_library()
        dx = torch.empty_like(x)
        dxw = torch.empty((t, n, 3 * hidden), device=x.device, dtype=x.dtype)
        dhw = torch.empty_like(dxw)
        dh0 = torch.empty((n, hidden), device=x.device, dtype=torch.float32)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.fsn_gru_layer_backward(
                *(v.data_ptr() for v in named.values()), dx.data_ptr(), dxw.data_ptr(),
                dhw.data_ptr(), dh0.data_ptr(), t, n, f_in, hidden, rows_per_block,
                TRAIN_DTYPES[x.dtype], stream,
            )
        _raise_on(err, "fsn_gru_layer_backward", lib.fsn_gru_error_string)
        self._count((f_in, hidden))
        return dx, dxw, dhw, dh0


gru_layer_bwd = GruLayerBackwardKernel()


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """v (fp32) rounded to ``dtype`` and back: the cast the kernels make
    before a product or a store."""
    return v.to(dtype).float()


def plain_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """Plain PyTorch version of K2 (with ``c0s``) and of K2-GRU (without),
    with their signatures and roundings: the products and the cell in fp32
    from the stored values. LSTM: h rounded to the storage type where it is
    produced, c stashed rounded; returns (out [T, N, OUT] fp32, h stashes,
    c stashes). GRU: an fp32 h carry for the update h = (1 - z) n + z h,
    and h rounded for the W_hh product, the next layer's input and the
    stash; returns (out, h stashes)."""
    if c0s is None:
        return _plain_gru_stash_forward(x, ws, bs, wfc, bfc, h0s)
    cdt = x.dtype
    seq = x.float()
    hs, cs = [], []
    for w, b, h0, c0 in zip(ws, bs, h0s, c0s):
        in_dim = seq.shape[-1]
        wf = w.float()
        x_proj = seq @ wf[:in_dim] + b  # [T, N, 4H]
        w_hh = wf[in_dim:]
        h, c = h0.float(), c0.float()
        h_steps, c_steps = [], []
        for step in range(x.shape[0]):
            i, f, g, o = (x_proj[step] + h @ w_hh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = _round(torch.sigmoid(o) * torch.tanh(c), cdt)
            h_steps.append(h)
            c_steps.append(c)
        seq = torch.stack(h_steps)
        hs.append(seq.to(cdt))
        cs.append(torch.stack(c_steps).to(cdt))
    out = seq @ wfc.float() + bfc
    return out, hs, cs


def _plain_gru_stash_forward(x, ws, bs, wfc, bfc, h0s):
    cdt = x.dtype
    seq = x.float()
    hs = []
    for w, b, h0 in zip(ws, bs, h0s):
        in_dim = seq.shape[-1]
        hidden = h0.shape[-1]
        wf = w.float()
        x_proj = seq @ wf[:in_dim] + b[0]  # [T, N, 3H], with b_ih
        w_hh = wf[in_dim:]
        h = h0.float()  # the fp32 carry; h0 is stored, so already rounded
        h_steps = []
        for step in range(x.shape[0]):
            hw = _round(h, cdt) @ w_hh + b[1]
            r, z = torch.sigmoid(x_proj[step, :, : 2 * hidden] + hw[:, : 2 * hidden]).chunk(2, -1)
            n = torch.tanh(x_proj[step, :, 2 * hidden :] + r * hw[:, 2 * hidden :])
            h = (1.0 - z) * n + z * h
            h_steps.append(_round(h, cdt))
        seq = torch.stack(h_steps)
        hs.append(seq.to(cdt))
    out = seq @ wfc.float() + bfc
    return out, hs


def plain_layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """Plain PyTorch version of K3, with K3's signature and roundings
    (``wt`` is accepted for the signature; the plain version transposes
    ``w``). Returns (dx, dgates, dh0, dc0)."""
    del wt
    cdt = x.dtype
    t, _, f_in = x.shape
    wf = w.float()
    h_prev = torch.cat([h0[None], hs[:-1]]).float()
    c_prev = torch.cat([c0[None], cs[:-1]]).float()
    # the gate recompute does not depend on the carries: all steps at once
    gates = x.float() @ wf[:f_in] + h_prev @ wf[f_in:] + b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    tanh_c = torch.tanh(cs.float())
    dh_c, dc_c = dh_in.float(), dc_in.float()
    w_hh_t = wf[f_in:].t()
    dgs = [None] * t
    for step in reversed(range(t)):
        dh_tot = dh[step].float() + dh_c
        do = dh_tot * tanh_c[step]
        dc = dc_c + dh_tot * o[step] * (1.0 - tanh_c[step] * tanh_c[step])
        dgates = torch.cat([
            (dc * g[step]) * i[step] * (1.0 - i[step]),
            (dc * c_prev[step]) * f[step] * (1.0 - f[step]),
            (dc * i[step]) * (1.0 - g[step] * g[step]),
            do * o[step] * (1.0 - o[step]),
        ], dim=-1)
        dgs[step] = _round(dgates, cdt)
        dh_c = dgs[step] @ w_hh_t
        dc_c = dc * f[step]
    dg = torch.stack(dgs)
    dx = (dg @ wf[:f_in].t()).to(cdt)
    return dx, dg.to(cdt), dh_c, dc_c


def plain_gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in):
    """Plain PyTorch version of K4, with K4's signature and roundings
    (``wt`` is accepted for the signature; the plain version transposes
    ``w``): h_{t-1} from the stash in the recompute and in dz, dxw and
    dhw rounded to the storage type before the products. Returns
    (dx, dxw, dhw, dh0)."""
    del wt
    cdt = x.dtype
    t, _, f_in = x.shape
    hidden = hs.shape[-1]
    wf = w.float()
    h_prev = torch.cat([h0[None], hs[:-1]]).float()
    # the gate recompute does not depend on the carry: all steps at once
    xw = x.float() @ wf[:f_in] + b[0]
    hw = h_prev @ wf[f_in:] + b[1]
    r = torch.sigmoid(xw[..., :hidden] + hw[..., :hidden])
    z = torch.sigmoid(xw[..., hidden : 2 * hidden] + hw[..., hidden : 2 * hidden])
    hn_pre = hw[..., 2 * hidden :]
    n = torch.tanh(xw[..., 2 * hidden :] + r * hn_pre)
    dh_c = dh_in.float()
    w_hh_t = wf[f_in:].t()
    dxws, dhws = [None] * t, [None] * t
    for step in reversed(range(t)):
        dh_tot = dh[step].float() + dh_c
        dz = dh_tot * (h_prev[step] - n[step])
        dn = (dh_tot * (1.0 - z[step])) * (1.0 - n[step] * n[step])
        dr = (dn * hn_pre[step]) * r[step] * (1.0 - r[step])
        dz = dz * z[step] * (1.0 - z[step])
        dxws[step] = _round(torch.cat([dr, dz, dn], dim=-1), cdt)
        dhws[step] = _round(torch.cat([dr, dz, dn * r[step]], dim=-1), cdt)
        dh_c = dh_tot * z[step] + dhws[step] @ w_hh_t
    dxw, dhw = torch.stack(dxws), torch.stack(dhws)
    dx = (dxw @ wf[:f_in].t()).to(cdt)
    return dx, dxw.to(cdt), dhw.to(cdt), dh_c


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no training path for device {x.device}")
    return x.device.type


def stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """K2 (with ``c0s``) or K2-GRU (without) on a CUDA tensor, their plain
    version on a CPU tensor."""
    if _device_of(x) == "cpu":
        return plain_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s)
    if c0s is None:
        return gru_stash_fwd(x, ws, bs, wfc, bfc, h0s)
    return stash_fwd(x, ws, bs, wfc, bfc, h0s, c0s)


def layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if _device_of(x) == "cpu":
        return plain_layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in)
    return layer_bwd(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in)


def gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in):
    """K4 on a CUDA tensor, its plain version on a CPU tensor."""
    if _device_of(x) == "cpu":
        return plain_gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in)
    return gru_layer_bwd(dh, x, hs, w, wt, b, h0, dh_in)


def layer_weight_grads(x, hs, h0, dxw, dhw=None):
    """The split-dW products of one layer (``_pallas_layer_bwd``'s einsums
    :869-895), as fp32 matrix products over T*N: dW_ih^T [F, G·H] =
    sum_t x_t^T dxw_t, dW_hh^T [H, G·H] = sum_t h_{t-1}^T dhw_t (h0 at
    t = 0), db_ih = sum dxw and db_hh = sum dhw. The LSTM streams one
    cotangent, dgates: ``dhw`` None takes ``dxw`` for both, and the two
    bias gradients are one tensor. Returns (dW_ih^T, dW_hh^T, db_ih,
    db_hh). Each stream is upcast to fp32 for its own products only, so
    one fp32 copy is alive at a time."""
    gates = dxw.shape[-1]
    dxw32 = dxw.float()
    dwih = x.float().reshape(-1, x.shape[-1]).t() @ dxw32.reshape(-1, gates)
    db_ih = dxw32.sum(dim=(0, 1))
    if dhw is None:
        dhw32, db_hh = dxw32, db_ih
    else:
        del dxw32
        dhw32 = dhw.float()
        db_hh = dhw32.sum(dim=(0, 1))
    dwhh = (hs[:-1].float().reshape(-1, hs.shape[-1]).t() @ dhw32[1:].reshape(-1, gates)
            + h0.float().t() @ dhw32[0])
    return dwih, dwhh, db_ih, db_hh


def _stack_from_flat(params, num_layers):
    layers = [
        dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), params[4 * li : 4 * li + 4]))
        for li in range(num_layers)
    ]
    return layers, {"weight": params[-2], "bias": params[-1]}


class RnnScanFunction(torch.autograd.Function):
    """The differentiable fused scan of an LSTM or GRU stack (counterpart
    of ``_train_vjp_fn`` with ``_bwd_direct``). ``apply(x, num_layers,
    *params)`` with x [T, N, F] (its dtype is the compute dtype: the
    weights are cast to it) and params = (w_ih, w_hh, b_ih, b_hh) per
    layer, then the head's weight and bias; returns [T, N, OUT] fp32. The
    cell follows from the weights' gate count.

    forward: the training forward (K2 or K2-GRU) from zero initial
    states, keeping the stashes (h and c, or h).
    backward: the head backward as two products; then the layers last to
    first through the layer backward (K3 or K4), each layer's input being
    the previous layer's h stash (x for layer 0), with the weight
    gradients as products over the streamed cotangents; grads in each
    parameter's dtype.
    """

    @staticmethod
    def forward(ctx, x, num_layers, *params):
        layers, fc = _stack_from_flat(params, num_layers)
        hidden, cell = _cell_of(layers[0])
        ws, bs, wfc, bfc = prep_weights(layers, fc, x.dtype)
        zeros = x.new_zeros(x.shape[1], hidden)
        if cell == "lstm":
            out, hs, cs = stash_forward(x, ws, bs, wfc, bfc, [zeros] * num_layers,
                                        [zeros] * num_layers)
        else:
            (out, hs), cs = stash_forward(x, ws, bs, wfc, bfc, [zeros] * num_layers), []
        ctx.num_layers = num_layers
        ctx.cell = cell
        ctx.save_for_backward(x, zeros, *params, *ws, *bs, *hs, *cs)
        return out

    @staticmethod
    def backward(ctx, g):
        num_layers = ctx.num_layers
        x, zeros, *rest = ctx.saved_tensors
        params = rest[: 4 * num_layers + 2]
        ws, bs, hs, cs = (
            rest[4 * num_layers + 2 + k * num_layers : 4 * num_layers + 2 + (k + 1) * num_layers]
            for k in range(4)
        )  # cs is empty for a GRU
        layers, fc = _stack_from_flat(params, num_layers)
        cdt = x.dtype
        t, n, _ = x.shape
        out_dim, hidden = fc["weight"].shape

        # head backward: two products, the cotangent cast to the compute
        # dtype first, as the JAX package does
        gc = g.to(cdt).float()
        dfc_w = gc.reshape(-1, out_dim).t() @ hs[-1].float().reshape(-1, hidden)
        dfc_b = g.float().sum(dim=(0, 1))
        dh = (gc @ fc["weight"].to(cdt).float()).to(cdt)

        zero_f = torch.zeros((n, hidden), device=x.device, dtype=torch.float32)
        grads = [None] * (4 * num_layers)
        for li in reversed(range(num_layers)):
            x_seq = x if li == 0 else hs[li - 1]
            wt = ws[li].t().contiguous()
            if ctx.cell == "lstm":
                dh, dg, _, _ = layer_backward(dh, x_seq, hs[li], cs[li], ws[li], wt, bs[li],
                                              zeros, zeros, zero_f, zero_f)
                weight_grads = layer_weight_grads(x_seq, hs[li], zeros, dg)
            else:
                dh, dxw, dhw, _ = gru_layer_backward(dh, x_seq, hs[li], ws[li], wt, bs[li],
                                                     zeros, zero_f)
                weight_grads = layer_weight_grads(x_seq, hs[li], zeros, dxw, dhw)
            layer = layers[li]
            grads[4 * li : 4 * li + 4] = [
                (v.t() if k.startswith("w_") else v).to(layer[k].dtype)
                for k, v in zip(("w_ih", "w_hh", "b_ih", "b_hh"), weight_grads)
            ]
        return (dh.to(x.dtype), None, *grads,
                dfc_w.to(fc["weight"].dtype), dfc_b.to(fc["bias"].dtype))


def fused_subband_lstm(
    x: torch.Tensor,
    *layers_and_fc: dict,
    time_major_features: bool = False,
    rows_per_block: int | None = None,
) -> torch.Tensor:
    """Run the fused N-layer LSTM or GRU + Linear over x.

    Args:
        x: [T, N, F_in] (or [T, F_in, N] if ``time_major_features``);
            N = B·F frequency-batched rows.
        *layers_and_fc: one to three layer dicts of one cell (4H gate
            rows: LSTM; 3H: GRU), then the head dict.
        rows_per_block: K1 / K1-GRU on CUDA only; None picks
            :func:`pick_rows_per_block`.

    Returns:
        [T, N, OUT] float32. Differentiable: when autograd records the
        call (grad enabled and x or a weight requires grad) it runs
        :class:`RnnScanFunction`, which launches K2 and K3 (LSTM) or
        K2-GRU and K4 (GRU) on a CUDA tensor (fp32 or bf16) and their
        plain versions on a CPU tensor. Otherwise a CPU tensor runs the
        plain version and a CUDA tensor K1 or K1-GRU (fp32).
    """
    layers, fc = tuple(layers_and_fc[:-1]), layers_and_fc[-1]
    if time_major_features:
        x = x.transpose(1, 2)  # -> [T, N, F_in]
    cell = _check_stack(x, layers, fc)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused scan path for device {x.device}")
    params = [*(l[k] for l in layers for k in ("w_ih", "w_hh", "b_ih", "b_hh")),
              fc["weight"], fc["bias"]]
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, *params)):
        return RnnScanFunction.apply(x.contiguous(), len(layers), *params)
    if x.device.type == "cpu":
        plain = plain_fused_subband_lstm if cell == "lstm" else plain_fused_subband_gru
        return plain(x, layers, fc)
    kernel = lstm_scan if cell == "lstm" else gru_scan
    return kernel(x.contiguous(), layers, fc, rows_per_block)
