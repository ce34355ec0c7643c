"""Fused N-layer LSTM or GRU scan + Linear head (counterpart of
``fullsubnet_tpu/ops/subband_lstm.py:fused_subband_lstm``), inference
forward and training (forward with state stashes, per-layer backward).

The pieces, each kernel beside its plain PyTorch version:

* K1 and K1-GRU, the inference forward of either cell, as the main path
  runs it: stages in ``csrc/rnn_fwd.cu``, composed by
  :func:`forward_stages` per chunk of steps (:func:`fwd_chunk_steps`):
  :data:`fwd_gemm` takes each layer's input projection and the head off
  the time chain (:func:`plain_fwd_gemm`), and :data:`lstm_fwd_walk` /
  :data:`gru_fwd_walk` walk the steps with W_hh^T resident over a cluster
  of 16 CTAs (:func:`plain_lstm_fwd_walk`, :func:`plain_gru_fwd_walk`);
  :func:`plain_fused_forward` composes the plain versions. fp32.
* K1-bf16 and K1-GRU-bf16, the same forward on a bf16 x (the JAX kernel's
  ``compute_dtype = x.dtype``): W_ih, W_hh and W_fc rounded to bf16, each
  product on bf16 operands with fp32 sums, c and the carried h in fp32, the
  h stream passed on in bf16, the output fp32. :func:`forward_stages` at
  bf16: :data:`tc_gemm` (``csrc/rnn_bwd_tc.cu``) for the input projections
  and the head, and :data:`lstm_fwd_walk_bf16` / :data:`gru_fwd_walk_bf16`
  in one of three forms (:func:`pick_fwd_bf16_form`): the tensor-core walk
  of ``csrc/rnn_fwd_tc.cu`` (W_hh^T resident over a 16-CTA cluster, h . W_hh^T
  on ``mma.sync``, one persistent wave of clusters walking bands of row
  tiles), the cluster walk of ``csrc/rnn_fwd.cu`` at bf16 (the product on
  the fp32 FMA units), or the inference form of ``csrc/rnn_train_fwd_tc.cu``'s
  streaming walk (:func:`plain_lstm_fwd_walk_bf16`,
  :func:`plain_gru_fwd_walk_bf16`).
* K1 of the earlier design, one block per tile of rows with the weights
  streamed from L2: :data:`lstm_scan` wraps ``csrc/subband_lstm.cu``;
  :func:`plain_fused_subband_lstm`. fp32. No path runs it now.
* K2 and K2-GRU, the training forward of either cell, with every layer's
  state stashes: :func:`plain_stash_forward`. At bf16 storage three stages
  on the tensor cores, composed by :func:`_train_forward_stages`:
  :data:`tc_gemm` takes each layer's input projection over all steps and,
  last, the head; :data:`lstm_train_walk` / :data:`gru_train_walk`
  (``csrc/rnn_train_fwd_tc.cu``) walk the steps with only h · W_hh^T on the
  chain (:func:`plain_lstm_train_walk`, :func:`plain_gru_train_walk`);
  :func:`plain_stash_forward` is the composition of the plain versions. At
  fp32 storage the same three stages on the fp32 cores, with B in PyTorch's
  layout (``out_in``): :data:`fwd_gemm` (``csrc/rnn_fwd.cu``) and
  :data:`lstm_train_walk_f32` / :data:`gru_train_walk_f32`, K1's cluster
  walk with a c stream for few rows and the streaming walk of
  ``csrc/rnn_train_fwd_f32.cu`` for many (:func:`train_f32_streams`);
  :func:`plain_f32_stash_forward` composes their plain versions. The
  kernels of the earlier design, :data:`stash_fwd` (``csrc/lstm_train_fwd.cu``)
  and :data:`gru_stash_fwd` (``csrc/gru_forward.cu``), run on no path.
* K3, one LSTM layer's backward: :func:`plain_layer_backward`, three
  stages composed by :func:`_lstm_backward_stages`. At bf16 on the tensor
  cores, both kernels in ``csrc/rnn_bwd_tc.cu``: :data:`tc_gemm` computes
  the gate pre-activations over all steps (:func:`plain_tc_gemm`),
  :data:`lstm_walk` walks back in time (:func:`plain_lstm_walk`), and
  :data:`tc_gemm` again takes dx. At fp32 on the fp32 cores:
  :data:`fwd_gemm` (``csrc/rnn_fwd.cu``, A's second K segment the h stash
  one block back) for both GEMMs and :data:`lstm_walk_f32`
  (``csrc/rnn_bwd_f32.cu``, W_hh resident over a cluster of 16 CTAs);
  :func:`plain_f32_layer_backward` composes their plain versions.
  :func:`plain_layer_backward` is the composition of the plain versions of
  the bf16 stages (at fp32 its roundings are no-ops). The earlier fp32
  kernel :data:`layer_bwd` (``csrc/lstm_layer_bwd.cu``) runs on no path.
* K1-GRU of the earlier design: :data:`gru_scan` wraps
  ``csrc/gru_forward.cu``; :func:`plain_fused_subband_gru`. fp32. No
  path runs it now.
* K4, one GRU layer's backward: :func:`plain_gru_layer_backward`, the
  three stages of K3 with :data:`gru_walk` (:func:`plain_gru_walk`) and
  the weights packed by :func:`pack_gru_weights` at bf16, with
  :data:`gru_walk_f32` and the weights packed in PyTorch's layout by
  :func:`pack_gru_weights_t` at fp32 (:func:`plain_f32_gru_layer_backward`).
  The earlier fp32 kernel :data:`gru_layer_bwd` (``csrc/gru_layer_bwd.cu``)
  runs on no path.
* The dW stage of K3 and K4, the weight gradients the TPU kernel sums in
  its own body: ``[x | h_prev | 1]^T · dgates`` (GRU: ``[x | 1]^T · dxw``
  and ``[h_prev | 1]^T · dhw``) over all steps, at either storage type,
  from the cotangent streams as stored. On the path :data:`dw_tma`
  (``csrc/rnn_dw_tma.cu``): a persistent GEMM, one CTA an SM, over the work
  units of :func:`plan_dw` (:class:`DwPlan`), fed by a TMA ring, wgmma at
  bf16 and FFMA at fp32; :func:`plain_dw_plan` composes the plan unit by
  unit. :data:`dw_gemm` (``csrc/rnn_dw.cu``), the split-K GEMM of the
  earlier design, runs on no path. :func:`plain_dw_gemm`, composed by
  :func:`layer_weight_grads`; :func:`weight_grads` dispatches.
* :class:`RnnScanFunction`, the ``torch.autograd.Function`` that joins
  the training forward, the layer backward and its dW stage of either
  cell (the counterpart of ``_train_vjp_fn`` with ``_bwd_direct``); the
  head backward is two plain products.
* :class:`ChunkedRnnScanFunction`, the time-chunked stash (the counterpart
  of K2's ``boundary_chunk`` mode and ``_bwd_chunked``): the forward runs
  K1's stages chunk by chunk (:func:`boundary_forward`) and keeps only the
  states entering each chunk; the backward walks the chunks last to first,
  re-running K2 over each from its boundary states, the layer backward from
  the carries of the chunk after it and the dW stage, summed over the
  chunks. :func:`train_chunk` picks the chunk (:func:`pick_chunk`, the rule
  of ``_pick_chunk``) from what the port holds a step
  (:func:`train_step_bytes`) against a budget, a share of the card
  (:func:`stash_budget_bytes`); :func:`train_bwd_peak_bytes` and
  :func:`train_stash_bytes` are its accounting.
* :func:`fused_subband_lstm`, the public function with the JAX signature:
  ``fused_subband_lstm(x, l1, l2, fc)`` returns [T, N, OUT] float32; the
  cell follows from the weights' gate count, as in the JAX package;
  ``stash_budget`` and ``time_chunk`` keep the JAX meaning.
* :func:`fused_subband_lstm_step`, its stateful form for the streaming
  engines: the stack from carried per-layer (h, c) states, which come back
  at the stack's H (:func:`step_stages`: K1's stages, or their plain
  versions, with the states carried into the walks).
* K1's stages as registered operators, ``torch.ops.fsn.fwd_gemm``,
  ``tc_gemm`` (K1-bf16's GEMM), ``lstm_fwd_walk`` and ``gru_fwd_walk``
  (either type, by W_hh's) (:data:`fwd_gemm_op`, :data:`tc_gemm_op`,
  :data:`lstm_fwd_walk_op`, :data:`gru_fwd_walk_op`), which the no-grad
  forward of :func:`fused_subband_lstm` and :func:`fused_subband_lstm_step`
  calls on both devices (:func:`_op_stages`): their CPU kernels are the
  plain versions, their CUDA kernels the wrappers, and ``torch.export``
  keeps each call as one node of a program (``serving.py``).

Device dispatch happens only in :func:`stash_forward`,
:func:`layer_backward`, :func:`gru_layer_backward`, :func:`weight_grads`,
:func:`boundary_forward`, :func:`fused_subband_lstm` and :func:`fused_subband_lstm_step` (through
the operators' dispatch by device): a CPU tensor takes the plain version,
a CUDA tensor launches the kernels or raises. The training forward and the layer
backward on a CUDA tensor pick their kernels by storage type: bf16 the
tensor-core stages, anything else the fp32 stages (which raise on a type
they do not take). The wrappers themselves refuse CPU tensors.

Layer dicts are in the torch layout ({w_ih [G·H, in], w_hh [G·H, H],
b_ih, b_hh}; LSTM: G = 4, gate order i, f, g, o; GRU: G = 3, gate order
r, z, n); the head is {weight [OUT, H], bias}, or None for a head-less
stack (Fast FullSubNet's), whose output is the top layer's h: no head GEMM
in any path, and the incoming gradient is the top layer's dh. On the card a
stack of H units that is not a multiple of 16 runs zero-padded
(:func:`pad_stack`).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
import weakref

import torch
import torch.nn.functional as F

from fullsubnet_tpu_torch.nn.rnn import gru_forward, gru_step, lstm_forward, lstm_step
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
    if fc is None:  # a head-less stack: the top layer's h is the output
        return cell
    if fc["weight"].ndim != 2 or fc["weight"].shape[1] != hidden:
        raise ValueError("fc weight must be [OUT, H]")
    out_dim = fc["weight"].shape[0]
    if fc["bias"].shape != (out_dim,):
        raise ValueError("fc bias must be [OUT]")
    return cell


def _plain_head(h: torch.Tensor, fc) -> torch.Tensor:
    if fc is None:
        return h.float()
    return (h @ fc["weight"].t() + fc["bias"]).float()


def plain_fused_subband_lstm(x: torch.Tensor, layers, fc) -> torch.Tensor:
    """Plain PyTorch version of K1: x [T, N, F] -> [T, N, OUT] float32
    (``fc`` None: the top layer's h [T, N, H])."""
    return _plain_head(lstm_forward(layers, x), fc)


def plain_fused_subband_gru(x: torch.Tensor, layers, fc) -> torch.Tensor:
    """Plain PyTorch version of K1-GRU: x [T, N, F] -> [T, N, OUT] float32
    (``fc`` None: the top layer's h [T, N, H])."""
    return _plain_head(gru_forward(layers, x), fc)


def padded_hidden(hidden: int) -> int:
    """The width the walks run a stack of H units at: H rounded up to a
    multiple of :data:`FWD_CTAS` (16), which every walk takes (the cluster
    walks split the units over 16 CTAs). Fast FullSubNet's H = 257 runs at
    272."""
    return _round_up(hidden, FWD_CTAS)


# the bf16 training stages' input widths are padded to a multiple of this
# many features: tc_gemm reads A, B and its output 16 bytes (8 bf16) at a
# time only where every width is one, and takes element loads elsewhere
TC_INPUT_MULTIPLE = 8


def pad_input(x: torch.Tensor, layers, multiple: int):
    """x [T, N, F] and the stack's first W_ih [G·H, F] zero-padded to F
    rounded up to ``multiple`` features: the padded features are zero and
    their weights too, so every product is the unpadded one. Differentiable
    (``F.pad``): the padded entries' gradients are dropped on the way back.
    The sub-band baseline's 31-wide units and the full-band 257 bins take
    the tensor-core GEMM's 16-byte loads this way at bf16."""
    pad = -x.shape[2] % multiple
    if not pad:
        return x, layers
    first = {**layers[0], "w_ih": F.pad(layers[0]["w_ih"], (0, pad))}
    return F.pad(x, (0, pad)), (first, *layers[1:])


def pad_stack(layers, fc, width: int):
    """A torch-layout stack of H units zero-padded to ``width`` units: each
    gate block of W_ih, W_hh (rows and, for W_hh and the layers above the
    first, W_ih's columns) and both biases, and the head's columns. A
    padded unit's gates are all zero from zero states, so the LSTM's is
    (0.5, 0.5, 0, 0.5) and its c and h stay 0, the GRU's (0.5, 0.5, 0) and
    its h stays 0.5 · h_prev = 0; the columns that read it multiply zeros.
    So the padded stack's real units, and its head, equal the original
    stack's exactly. Differentiable (``F.pad``): the padded entries'
    gradients are dropped on the way back."""
    hidden, cell = _cell_of(layers[0])
    gates, pad = _GATES[cell], width - hidden
    out = []
    for li, layer in enumerate(layers):
        in_pad = 0 if li == 0 else pad  # layer 0 reads x; the others the padded h
        w_ih = F.pad(layer["w_ih"].unflatten(0, (gates, hidden)), (0, in_pad, 0, pad))
        w_hh = F.pad(layer["w_hh"].unflatten(0, (gates, hidden)), (0, pad, 0, pad))
        out.append({
            "w_ih": w_ih.flatten(0, 1), "w_hh": w_hh.flatten(0, 1),
            "b_ih": F.pad(layer["b_ih"].view(gates, hidden), (0, pad)).flatten(),
            "b_hh": F.pad(layer["b_hh"].view(gates, hidden), (0, pad)).flatten(),
        })
    if fc is not None:
        fc = {"weight": F.pad(fc["weight"], (0, pad)), "bias": fc["bias"]}
    return out, fc


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
    wfc = bfc = None  # a head-less stack
    if fc is not None:
        wfc, bfc = fc["weight"].t().contiguous(), fc["bias"].contiguous()
    if dtype is not None:
        ws = [w.to(dtype) for w in ws]
        bs = [b.float() for b in bs]
        if fc is not None:
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
    """Dynamic shared memory of one block of the earlier layer backward
    (lstm_layer_bwd.cu, gru_layer_bwd.cu): [x_t | h_{t-1}] and
    the dh carry; K3 adds dgates [4H] and the dc carry, K4 dxw [3H] and
    the n part of dhw [H]. The bf16 walk has :func:`walk_smem_bytes`."""
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
    """Rows per block of the fp32-storage K3 and K4, by the same rule."""
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
    (32, 384, 2)). A wrapper whose kernel has more than one form (the fp32
    training and backward walks: "cluster" or "streaming") also counts by
    form in ``launches_by_form`` and by (shape key, form) in
    ``forms_by_shape``. ``launches_by_device`` splits the launches by the
    index of the card they ran on. All count only where the kernel is
    launched, under one lock: the multi-card enhancer launches from a host
    thread for each card."""

    _lock = threading.Lock()

    def __init__(self):
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self.launches_by_form: collections.Counter = collections.Counter()
        self.forms_by_shape: collections.Counter = collections.Counter()
        self.launches_by_device: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        with self._lock:
            self.launches = 0
            self.launches_by_shape.clear()
            self.launches_by_form.clear()
            self.forms_by_shape.clear()
            self.launches_by_device.clear()

    def _count(self, device: torch.device, key, form: str | None = None) -> None:
        with self._lock:
            self.launches += 1
            self.launches_by_shape[key] += 1
            self.launches_by_device[device.index] += 1
            if form is not None:
                self.launches_by_form[form] += 1
                self.forms_by_shape[key, form] += 1


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
        self._count(x.device, (f_in, hidden, out_dim))
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
        self._count(x.device, (f_in, hidden, out_dim))
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
        self._count(x.device, (f_in, hidden))
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
        self._count(x.device, (f_in, hidden, out_dim))
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
        self._count(x.device, (f_in, hidden, out_dim))
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
        self._count(x.device, (f_in, hidden))
        return dx, dxw, dhw, dh0


gru_layer_bwd = GruLayerBackwardKernel()


class TcKernelLibrary:
    """The library of the bf16 layer backward's two tensor-core kernels,
    the GEMM and the walk (csrc/rnn_bwd_tc.cu), built at first use and
    loaded with ctypes."""

    SOURCES = (CSRC / "rnn_bwd_tc.cu", CSRC / "lstm_train_common.cuh", CSRC / "mma_common.cuh")
    NAME = "fsn_rnn_bwd_tc"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_tc_gemm.argtypes = [ptr] * 6 + [i] * 9 + [ptr]
            lib.fsn_tc_gemm.restype = i
            lib.fsn_rnn_bwd_walk.argtypes = [i] + [ptr] * 12 + [i] * 7 + [ptr]
            lib.fsn_rnn_bwd_walk.restype = i
            lib.fsn_rnn_bwd_walk_split.argtypes = [i] + [ptr] * 12 + [i] * 3 + [ptr]
            lib.fsn_rnn_bwd_walk_split.restype = i
            lib.fsn_tc_error_string.argtypes = [i]
            lib.fsn_tc_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


tc_library = TcKernelLibrary()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _shifted(prev: torch.Tensor, head: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows [0, rows) of the second K segment: head's rows, then prev's
    from its first on (for the recompute: h_{t-1} over all steps, h0 first)."""
    return torch.cat([head, prev[: max(rows - head.shape[0], 0)]])[:rows]


def plain_tc_gemm(a, b, bias=None, prev=None, head=None, out_dtype=torch.float32):
    """Plain PyTorch version of :data:`tc_gemm`: ``[a | a_prev] · b + bias``
    in fp32 from the stored values, cast to ``out_dtype``. a [M, K0];
    b [K0 (+ K1), Ncols]; prev [>= M - S, K1] and head [S, K1] give
    a_prev (row m is head[m] for m < S, else prev[m - S]); bias [Ncols]."""
    k0 = a.shape[1]
    out = a.float() @ b[:k0].float()
    if prev is not None:
        out = out + _shifted(prev, head, a.shape[0]).float() @ b[k0:].float()
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


class TcGemmKernel(_Counts):
    """ctypes wrapper of ``fsn_tc_gemm`` (csrc/rnn_bwd_tc.cu), the bf16
    tensor-core GEMM of the layer backward's first and last stage;
    counted by (K0, K1, Ncols): (F, H, G·H) for the pre-activations,
    (G·H, 0, F) for dx."""

    def __call__(self, a, b, bias=None, prev=None, head=None, out_dtype=torch.float32):
        """``[a | a_prev] · b + bias`` as :func:`plain_tc_gemm` takes it:
        a, prev, head bf16 and contiguous; b bf16 [K, Ncols] with unit
        stride along Ncols (a column slice is fine); bias fp32 or None;
        out [M, Ncols] in ``out_dtype``, float32 or bfloat16."""
        if a.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError("a must be [M, K0] and b [K, Ncols]")
        if out_dtype not in TRAIN_DTYPES:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
        m, k0 = a.shape
        k1 = 0
        named = {"a": a}
        if prev is not None:
            if head is None or prev.ndim != 2 or head.ndim != 2:
                raise ValueError("prev [rows, K1] needs head [S, K1]")
            k1 = prev.shape[1]
            shift = head.shape[0]
            if head.shape[1] != k1 or prev.shape[0] < m - shift:
                raise ValueError(f"prev {list(prev.shape)} and head {list(head.shape)} do not "
                                 f"give {m} rows of one width")
            named.update(prev=prev, head=head)
        ncols = b.shape[1]
        if b.shape[0] != k0 + k1 or b.stride(1) != 1:
            raise ValueError(f"b must be [K0 + K1, Ncols] = [{k0 + k1}, {ncols}] with unit "
                             f"column stride, got {list(b.shape)} strides {b.stride()}")
        _check_operands(a.device, named, dict.fromkeys(named, torch.bfloat16))
        if b.device != a.device or b.dtype != torch.bfloat16:
            raise TypeError(f"b must be bfloat16 on {a.device}")
        if bias is not None:
            if bias.shape != (ncols,):
                raise ValueError(f"bias must be [{ncols}]")
            _check_operands(a.device, {"bias": bias}, {"bias": torch.float32})

        lib = tc_library()
        out = torch.empty((m, ncols), device=a.device, dtype=out_dtype)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.fsn_tc_gemm(
                a.data_ptr(), prev.data_ptr() if k1 else None, head.data_ptr() if k1 else None,
                b.data_ptr(), bias.data_ptr() if bias is not None else None, out.data_ptr(),
                m, ncols, k0 + k1, k0, head.shape[0] if k1 else 0, k0, k1, b.stride(0),
                int(out_dtype == torch.float32), stream,
            )
        _raise_on(err, "fsn_tc_gemm", lib.fsn_tc_error_string)
        self._count(a.device, (k0, k1, ncols))
        return out


tc_gemm = TcGemmKernel()

# the walk: 16 warps, each owning 1 to 4 mma tiles of 8 hidden units
WALK_ROWS = (16, 32, 64)
WALK_MAX_HIDDEN = 512
_WALK_K = 32  # rows of W_hh^T in one slot of the ring
_SMS = 132


def walk_widths(gates: int, hidden: int) -> tuple[int, int]:
    """(Gp, Hp) of the walk: the dgates width (4H, GRU 3H) rounded up to
    64 and H to 128, the shape of the zero-padded W_hh^T it streams."""
    return _round_up(gates, 64), _round_up(hidden, 128)


def walk_smem_bytes(rows: int, gates: int, hidden: int, stages: int) -> int:
    """Dynamic shared memory of one walk block: the bf16 dgates tile
    [rows, Gp] and a ring of ``stages`` W_hh^T slots [32, Hp]."""
    gp, hp = walk_widths(gates, hidden)
    return 2 * (rows * gp + stages * _WALK_K * hp)


def pick_walk_tile(n: int, gates: int, hidden: int) -> tuple[int, int]:
    """(rows per block, ring stages) of the streaming walk. Every block
    streams all of W_hh^T from L2 at every step, whatever its rows, and
    a step's own work grows with them: the tile is the smallest that still
    runs every block at once on the 132 SMs (one block an SM), and the
    ring is as deep as shared memory allows, up to 4. Measured on an H100
    (PERF.md §6): at the sub-band shape 32 rows (128 blocks) beat 16 (two
    waves) and 64; at N = 32, 16 rows (two blocks) beat 32."""
    fits = [r for r in WALK_ROWS if walk_smem_bytes(r, gates, hidden, 2) <= _MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"no walk tile fits {gates} gate columns of H = {hidden} in shared memory")
    rows = min(fits, key=lambda r: ((-(-n // r) + _SMS - 1) // _SMS, r))
    return rows, walk_ring(rows, gates, hidden)


SPLIT_CTAS = 16  # CTAs of one cluster of the split walk
SPLIT_ROWS = 32  # rows one cluster walks
SPLIT_MAX_CLUSTERS = 4


def walk_splits(n: int, hidden: int) -> bool:
    """Whether the walk runs split over clusters (``fsn_rnn_bwd_walk_split``)
    rather than streaming W_hh^T (``fsn_rnn_bwd_walk``): for few rows, at
    most 4 clusters of 16 CTAs x 32 rows, where the streaming walk has only
    a block or two and each of them waits on L2 for the whole of W_hh^T at
    every step; its 16 CTAs keep W_hh^T resident, a 16th each, which fits
    at H = 256 and 512."""
    return hidden in (256, 512) and -(-n // SPLIT_ROWS) <= SPLIT_MAX_CLUSTERS


def split_smem_bytes(gates: int, hidden: int) -> int:
    """Dynamic shared memory of one CTA of the split walk: its rows of
    W_hh^T [G/16, H] and its dgates tile [32, G/16 rounded up to 64] in
    bf16, and the partial carries [32, H + 8] in fp32."""
    kc = gates // SPLIT_CTAS
    return 2 * (kc * hidden + SPLIT_ROWS * _round_up(kc, 64)) + 4 * SPLIT_ROWS * (hidden + 8)


def walk_ring(rows: int, gates: int, hidden: int) -> int:
    """The deepest ring (2 to 4 slots) that fits beside ``rows`` rows of
    dgates; 2 where none fits (the launch check then refuses it)."""
    return max([s for s in (3, 4)
                if walk_smem_bytes(rows, gates, hidden, s) <= _MAX_SMEM_BYTES], default=2)


def _padded_hh_t(w_hh_t: torch.Tensor) -> torch.Tensor:
    """W_hh^T [G, H] as the walk streams it: bf16, contiguous, zero-padded
    to [Gp, Hp]."""
    g, h = w_hh_t.shape
    out = w_hh_t.new_zeros(walk_widths(g, h), dtype=torch.bfloat16)
    out[:g, :h] = w_hh_t
    return out


def plain_lstm_walk(p, dh, cs, c0, w_hh_t, dh_in, dc_in):
    """Plain PyTorch version of :data:`lstm_walk`, with its roundings: the
    cell backward of ``_lstm_layer_bwd_kernel`` at every step from the
    fp32 pre-activations p [T, N, 4H] (bias included), dgates rounded to
    the storage type before the carry product dgates · W_hh (w_hh_t
    [4H, H]). Returns (dgates [T, N, 4H] in dh's dtype, dh0, dc0 fp32)."""
    cdt = dh.dtype
    i, f, g, o = p.float().chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_prev = torch.cat([c0[None], cs[:-1]]).float()
    tanh_c = torch.tanh(cs.float())
    w = w_hh_t.float()
    dh_c, dc_c = dh_in.float(), dc_in.float()
    dgs = [None] * p.shape[0]
    for step in reversed(range(p.shape[0])):
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
        dh_c = dgs[step] @ w
        dc_c = dc * f[step]
    return torch.stack(dgs).to(cdt), dh_c, dc_c


def plain_gru_walk(p, dh, hs, h0, w_hh_t, dh_in):
    """Plain PyTorch version of :data:`gru_walk`, with its roundings: the
    cell backward of ``_gru_layer_bwd_kernel`` from the packed fp32 sums
    p [T, N, 4H] = (r, z, n's x part, n's h part hn), h_{t-1} from the
    stash (h0 at t = 0) in dz, dxw and dhw rounded to the storage type,
    the carry dh_tot z + dhw · W_hh (w_hh_t [3H, H]). Returns (dxw, dhw
    [T, N, 3H] in dh's dtype, dh0 fp32)."""
    cdt = dh.dtype
    pr, pz, pn, hn = p.float().chunk(4, dim=-1)
    r, z = torch.sigmoid(pr), torch.sigmoid(pz)
    n = torch.tanh(pn + r * hn)
    h_prev = torch.cat([h0[None], hs[:-1]]).float()
    w = w_hh_t.float()
    dh_c = dh_in.float()
    dxws, dhws = [None] * p.shape[0], [None] * p.shape[0]
    for step in reversed(range(p.shape[0])):
        dh_tot = dh[step].float() + dh_c
        dz = dh_tot * (h_prev[step] - n[step])
        dn = (dh_tot * (1.0 - z[step])) * (1.0 - n[step] * n[step])
        dr = (dn * hn[step]) * r[step] * (1.0 - r[step])
        dz = dz * z[step] * (1.0 - z[step])
        dxws[step] = _round(torch.cat([dr, dz, dn], dim=-1), cdt)
        dhws[step] = _round(torch.cat([dr, dz, dn * r[step]], dim=-1), cdt)
        dh_c = dh_tot * z[step] + dhws[step] @ w
    return torch.stack(dxws).to(cdt), torch.stack(dhws).to(cdt), dh_c


class BwdWalkKernel(_Counts):
    """ctypes wrapper of the bf16 layer backward's walk over time for one
    cell (``lstm_walk``, ``gru_walk``), csrc/rnn_bwd_tc.cu: the streaming
    walk ``fsn_rnn_bwd_walk``, or for few rows the split walk
    ``fsn_rnn_bwd_walk_split`` (:func:`walk_splits`); counted by (N, H)."""

    def __init__(self, cell: str):
        super().__init__()
        self.cell = cell

    def __call__(self, p, dh, stash, init, w_hh_t, dh_in, dc_in=None,
                 rows_per_block: int | None = None, stages: int | None = None,
                 split: bool | None = None, clocks: torch.Tensor | None = None):
        """The walk as :func:`plain_lstm_walk` (stash = c stash, init = c0,
        with dc_in) or :func:`plain_gru_walk` (stash = h stash, init = h0)
        takes it: p [T, N, 4H] fp32; dh, stash [T, N, H], init [N, H] and
        w_hh_t [G, H] (any strides) bf16; dh_in, dc_in [N, H] fp32. H even
        and at most 512. ``split`` None follows :func:`walk_splits`;
        ``rows_per_block`` and ``stages`` set the streaming walk's tile.
        ``clocks``, an int64 [3] on the device, receives block 0's cycles
        over all steps in the cell backward, the product and (split walk)
        the cluster exchange."""
        if p.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {p.device}")
        lstm = self.cell == "lstm"
        if lstm == (dc_in is None):
            raise ValueError("the LSTM walk takes dc_in, the GRU walk does not")
        t, n, hidden = dh.shape
        gates = (4 if lstm else 3) * hidden
        if hidden % 2 or hidden > WALK_MAX_HIDDEN:
            raise ValueError(f"the walk takes an even H up to {WALK_MAX_HIDDEN}, got {hidden}")
        shapes = {"p": (t, n, 4 * hidden), "dh": (t, n, hidden), "stash": (t, n, hidden),
                  "init": (n, hidden), "w_hh_t": (gates, hidden), "dh_in": (n, hidden)}
        named = {"p": p, "dh": dh, "stash": stash, "init": init, "w_hh_t": w_hh_t,
                 "dh_in": dh_in}
        if lstm:
            shapes["dc_in"] = (n, hidden)
            named["dc_in"] = dc_in
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        if w_hh_t.device != p.device or w_hh_t.dtype != torch.bfloat16:
            raise TypeError(f"w_hh_t must be bfloat16 on {p.device}")
        del named["w_hh_t"]
        _check_operands(p.device, named, {
            k: torch.float32 if k in ("p", "dh_in", "dc_in") else torch.bfloat16 for k in named
        })
        if clocks is not None:
            if clocks.shape != (3,):
                raise ValueError("clocks must be [3]")
            _check_operands(p.device, {"clocks": clocks}, {"clocks": torch.int64})
        if split is None:
            split = walk_splits(n, hidden) and rows_per_block is None and stages is None
        if split and (hidden not in (256, 512) or rows_per_block or stages):
            raise ValueError("the split walk takes H = 256 or 512 and no tile")
        if split and split_smem_bytes(gates, hidden) > _MAX_SMEM_BYTES:
            raise ValueError(f"the split walk at H = {hidden} needs more shared memory than a "
                             "block may use")
        if not split:
            if rows_per_block is None:
                rows_per_block = pick_walk_tile(n, gates, hidden)[0]
            if stages is None:
                stages = walk_ring(rows_per_block, gates, hidden)
            if rows_per_block not in WALK_ROWS or stages not in (2, 3, 4):
                raise ValueError(f"rows_per_block must be one of {WALK_ROWS} and stages 2, 3 "
                                 "or 4")
            if walk_smem_bytes(rows_per_block, gates, hidden, stages) > _MAX_SMEM_BYTES:
                raise ValueError(f"the walk at {rows_per_block} rows and {stages} stages needs "
                                 "more shared memory than a block may use")

        lib = tc_library()
        out0 = torch.empty((t, n, gates), device=p.device, dtype=torch.bfloat16)
        out1 = None if lstm else torch.empty_like(out0)
        dh_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
        dc_out = torch.empty_like(dh_out) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            operands = (int(lstm), p.data_ptr(), dh.data_ptr(), stash.data_ptr(), init.data_ptr())
            outputs = (dh_in.data_ptr(), ptr(dc_in), out0.data_ptr(), ptr(out1),
                       dh_out.data_ptr(), ptr(dc_out), ptr(clocks), t, n, hidden)
            if split:
                w = w_hh_t.contiguous()
                name = "fsn_rnn_bwd_walk_split"
                err = lib.fsn_rnn_bwd_walk_split(*operands, w.data_ptr(), *outputs, stream)
            else:
                w = _padded_hh_t(w_hh_t)
                name = "fsn_rnn_bwd_walk"
                err = lib.fsn_rnn_bwd_walk(*operands, w.data_ptr(), *outputs, w.shape[0],
                                           w.shape[1] // 128, rows_per_block, stages, stream)
        _raise_on(err, name, lib.fsn_tc_error_string)
        self._count(p.device, (n, hidden))
        if lstm:
            return out0, dh_out, dc_out
        return out0, out1, dh_out


lstm_walk = BwdWalkKernel("lstm")
gru_walk = BwdWalkKernel("gru")


# ---------------------------------------------------------------------------
# the bf16 training forward's walk (K2, K2-GRU): csrc/rnn_train_fwd_tc.cu
# ---------------------------------------------------------------------------

TRAIN_WALK_ROWS = (16, 32)  # rows of one block of the streaming walk: the instances built
TRAIN_CHUNK = 128  # units of one chunk of the streaming walk: 8 for each of its 16 warps
TRAIN_MAX_STAGES = 6
TRAIN_WALK_MAX_HIDDEN = 4 * TRAIN_CHUNK


class TrainFwdKernelLibrary:
    """The library of the bf16 training forward's walks, streaming and split
    (csrc/rnn_train_fwd_tc.cu), built at first use and loaded with ctypes;
    the GEMM of its other stages is :data:`tc_gemm`'s."""

    SOURCES = (CSRC / "rnn_train_fwd_tc.cu", CSRC / "lstm_train_common.cuh",
               CSRC / "mma_common.cuh")
    NAME = "fsn_rnn_train_fwd"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_rnn_train_walk.argtypes = [i] + [ptr] * 8 + [i] * 5 + [ptr]
            lib.fsn_rnn_train_walk.restype = i
            lib.fsn_rnn_train_walk_split.argtypes = [i] + [ptr] * 8 + [i] * 3 + [ptr]
            lib.fsn_rnn_train_walk_split.restype = i
            lib.fsn_rnn_fwd_stream_walk_bf16.argtypes = [i] + [ptr] * 9 + [i] * 5 + [ptr]
            lib.fsn_rnn_fwd_stream_walk_bf16.restype = i
            lib.fsn_train_fwd_error_string.argtypes = [i]
            lib.fsn_train_fwd_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


train_fwd_library = TrainFwdKernelLibrary()


def train_walk_smem_bytes(rows: int, cell: str, hidden: int, stages: int) -> int:
    """Dynamic shared memory of one block of the streaming training walk:
    the bf16 h tile by step parity [2, rows, H rounded up to 128], a ring of
    ``stages`` bf16 W_hh^T slices [32, G x 128], and the fp32 P tile of one
    chunk [rows, G x 128 + 8]."""
    hp = _round_up(hidden, TRAIN_CHUNK)
    wc = _GATES[cell] * TRAIN_CHUNK
    return 2 * (2 * rows * hp + stages * _WALK_K * wc) + 4 * rows * (wc + 8)


def train_walk_ring(rows: int, cell: str, hidden: int) -> int:
    """The deepest ring (2 to 6 slots) that fits beside ``rows`` rows of h;
    2 where none fits (the launch check then refuses it)."""
    return max([s for s in range(3, TRAIN_MAX_STAGES + 1)
                if train_walk_smem_bytes(rows, cell, hidden, s) <= _MAX_SMEM_BYTES], default=2)


def pick_train_walk_tile(n: int, cell: str, hidden: int) -> tuple[int, int]:
    """(rows per block, ring slots) of the streaming training walk, by the
    rule of the backward's :func:`pick_walk_tile`: every block streams all
    of W_hh^T from L2 at every step, so the tile is the smallest that still
    runs every block at once on the 132 SMs, and the ring is as deep as
    shared memory allows. Measured on an H100 at the sub-band shape (N =
    4096, PERF.md §6): 32 rows (128 blocks, one wave) took 19.5 ms for both
    LSTM layers, 16 rows (two waves) 29.3, the split walk (128 clusters in
    waves of 7) 42.7; the GRU's ring at 5 slots beat 3 by 2%."""
    fits = [r for r in TRAIN_WALK_ROWS
            if train_walk_smem_bytes(r, cell, hidden, 2) <= _MAX_SMEM_BYTES]
    rows = min(fits, key=lambda r: ((-(-n // r) + _SMS - 1) // _SMS, r))
    return rows, train_walk_ring(rows, cell, hidden)


def train_walk_splits(n: int, hidden: int) -> bool:
    """Whether the training walk runs split over clusters
    (``fsn_rnn_train_walk_split``) rather than streaming W_hh^T: H a
    multiple of 128 up to 512 (each of the 16 CTAs owns H/16 units, whole
    mma tiles of 8) and at most :data:`SPLIT_MAX_CLUSTERS` clusters of 32
    rows, the backward's split rule. Measured on an H100 (PERF.md §6): at
    the full-band stage, N = 32 and H = 512, one cluster took 2.4 ms for
    both LSTM layers, the streaming walk 25.7 at its best tile; at N = 4096
    the split walk lost (above)."""
    return (hidden % TRAIN_CHUNK == 0 and hidden <= TRAIN_WALK_MAX_HIDDEN
            and -(-n // SPLIT_ROWS) <= SPLIT_MAX_CLUSTERS)


def train_split_smem_bytes(cell: str, hidden: int) -> int:
    """Dynamic shared memory of one CTA of the split training walk: its gate
    columns of W_hh^T [H, G·H/16 rounded up to 64], the gathered h_{t-1}
    [32, H] and its h slice by step parity [2, 32, H/16], all bf16."""
    hc = hidden // SPLIT_CTAS
    wp = _round_up(_GATES[cell] * hc, 64)
    return 2 * (hidden * wp + SPLIT_ROWS * hidden + 2 * SPLIT_ROWS * hc)


def _stream_hh_t(w_hh_t: torch.Tensor, gates: int) -> torch.Tensor:
    """W_hh^T [H, G·H] as the streaming walk reads it: bf16, regrouped by
    chunk of 128 units into [ceil(H/128), Kp, G, 128] (Kp = H rounded up to
    32), zero where a unit or a row is padding."""
    h = w_hh_t.shape[0]
    uc, kp = -(-h // TRAIN_CHUNK), _round_up(h, _WALK_K)
    out = w_hh_t.new_zeros((kp, gates, uc * TRAIN_CHUNK), dtype=torch.bfloat16)
    out[:h, :, :h] = w_hh_t.reshape(h, gates, h)
    return out.view(kp, gates, uc, TRAIN_CHUNK).permute(2, 0, 1, 3).contiguous()


def _split_hh_t(w_hh_t: torch.Tensor, gates: int) -> torch.Tensor:
    """W_hh^T [H, G·H] as the split walk reads it: bf16 [16, H, WP], CTA
    k's block holding the columns of its units [k H/16, (k + 1) H/16) of
    every gate, each row zero-padded to WP = G·H/16 rounded up to 64."""
    h = w_hh_t.shape[0]
    hc = h // SPLIT_CTAS
    out = w_hh_t.new_zeros((SPLIT_CTAS, h, _round_up(gates * hc, 64)), dtype=torch.bfloat16)
    out[:, :, : gates * hc] = (w_hh_t.reshape(h, gates, SPLIT_CTAS, hc).permute(2, 0, 1, 3)
                               .reshape(SPLIT_CTAS, h, gates * hc))
    return out


class TrainWalkKernel(_Counts):
    """ctypes wrapper of the bf16 training forward's walk over time for one
    cell (``lstm_train_walk``, ``gru_train_walk``), csrc/rnn_train_fwd_tc.cu:
    the streaming walk ``fsn_rnn_train_walk``, or for few rows the split
    walk ``fsn_rnn_train_walk_split`` (:func:`train_walk_splits`); counted by
    (N, H)."""

    def __init__(self, cell: str):
        super().__init__()
        self.cell = cell

    def __call__(self, p, w_hh_t, *state, rows_per_block: int | None = None,
                 stages: int | None = None, split: bool | None = None,
                 clocks: torch.Tensor | None = None):
        """The walk as :func:`plain_lstm_train_walk` (state = h0, c0) or
        :func:`plain_gru_train_walk` (state = b_hh, h0) takes it: p
        [T, N, G·H] fp32; w_hh_t [H, G·H] bf16 (any strides); b_hh [G·H]
        fp32; h0 and c0 [N, H] bf16; H a multiple of 4, at most 512. ``split`` None
        follows :func:`train_walk_splits`; ``rows_per_block`` and ``stages``
        set the streaming walk's tile. ``clocks``, an int64 [3] on the
        device, receives block 0's cycles over all steps in the product, the
        cell and stash stores, and (split walk) the cluster exchange.
        Returns (h stash, c stash) [T, N, H] bf16, or the GRU's h stash."""
        if p.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {p.device}")
        lstm = self.cell == "lstm"
        if len(state) != 2:
            raise ValueError("the LSTM walk takes (h0, c0), the GRU walk (b_hh, h0)")
        h0, c0, b_hh = (*state, None) if lstm else (state[1], None, state[0])
        if p.ndim != 3 or w_hh_t.ndim != 2:
            raise ValueError("p must be [T, N, G·H] and w_hh_t [H, G·H]")
        t, n, _ = p.shape
        hidden = w_hh_t.shape[0]
        gates = _GATES[self.cell]
        if hidden % 4 or hidden > TRAIN_WALK_MAX_HIDDEN:
            raise ValueError(f"the walk takes H a multiple of 4 up to {TRAIN_WALK_MAX_HIDDEN}, "
                             f"got {hidden}")
        shapes = {"p": (t, n, gates * hidden), "w_hh_t": (hidden, gates * hidden),
                  "h0": (n, hidden)}
        named = {"p": p, "w_hh_t": w_hh_t, "h0": h0}
        if lstm:
            shapes["c0"], named["c0"] = (n, hidden), c0
        else:
            shapes["b_hh"], named["b_hh"] = (gates * hidden,), b_hh
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        if w_hh_t.device != p.device or w_hh_t.dtype != torch.bfloat16:
            raise TypeError(f"w_hh_t must be bfloat16 on {p.device}")
        del named["w_hh_t"]
        _check_operands(p.device, named, {
            k: torch.float32 if k in ("p", "b_hh") else torch.bfloat16 for k in named
        })
        if clocks is not None:
            if clocks.shape != (3,):
                raise ValueError("clocks must be [3]")
            _check_operands(p.device, {"clocks": clocks}, {"clocks": torch.int64})
        if split is None:
            split = train_walk_splits(n, hidden) and rows_per_block is None and stages is None
        if split and (hidden % TRAIN_CHUNK or rows_per_block or stages):
            raise ValueError("the split walk takes H a multiple of 128 and no tile")
        if not split:
            if rows_per_block is None:
                rows_per_block = pick_train_walk_tile(n, self.cell, hidden)[0]
            if stages is None:
                stages = train_walk_ring(rows_per_block, self.cell, hidden)
            if rows_per_block not in TRAIN_WALK_ROWS or not 2 <= stages <= TRAIN_MAX_STAGES:
                raise ValueError(f"rows_per_block must be one of {TRAIN_WALK_ROWS} and stages 2 "
                                 f"to {TRAIN_MAX_STAGES}")
            if train_walk_smem_bytes(rows_per_block, self.cell, hidden, stages) > _MAX_SMEM_BYTES:
                raise ValueError(f"the walk at {rows_per_block} rows and {stages} stages needs "
                                 "more shared memory than a block may use")

        lib = train_fwd_library()
        hs = torch.empty((t, n, hidden), device=p.device, dtype=torch.bfloat16)
        cs = torch.empty_like(hs) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            if split:
                w = _split_hh_t(w_hh_t, gates)
                name = "fsn_rnn_train_walk_split"
                err = lib.fsn_rnn_train_walk_split(
                    int(lstm), p.data_ptr(), w.data_ptr(), ptr(b_hh), h0.data_ptr(), ptr(c0),
                    hs.data_ptr(), ptr(cs), ptr(clocks), t, n, hidden, stream)
            else:
                w = _stream_hh_t(w_hh_t, gates)
                name = "fsn_rnn_train_walk"
                err = lib.fsn_rnn_train_walk(
                    int(lstm), p.data_ptr(), w.data_ptr(), ptr(b_hh), h0.data_ptr(), ptr(c0),
                    hs.data_ptr(), ptr(cs), ptr(clocks), t, n, hidden, rows_per_block, stages,
                    stream)
        _raise_on(err, name, lib.fsn_train_fwd_error_string)
        self._count(p.device, (n, hidden))
        return (hs, cs) if lstm else hs


lstm_train_walk = TrainWalkKernel("lstm")
gru_train_walk = TrainWalkKernel("gru")


def pack_gru_weights(w: torch.Tensor, b: torch.Tensor, f_in: int):
    """A GRU layer's prepped weights w [F + H, 3H] (rows W_ih^T, then
    W_hh^T) and biases b [2, 3H] (b_ih, b_hh), packed so that one product
    ``[x | h] · w' + b'`` gives the four sums of ``_gru_layer_bwd_kernel``
    (:670-684) side by side: r and z (x and h parts and both biases
    together), n's x part with b_in, and n's h part hn = W_hn h + b_hn,
    which the reset gate scales. Returns (w' [F + H, 4H] in w's dtype,
    b' [4H] fp32)."""
    hidden = w.shape[1] // 3
    wp = w.new_zeros(w.shape[0], 4 * hidden)
    wp[:, : 2 * hidden] = w[:, : 2 * hidden]
    wp[:f_in, 2 * hidden : 3 * hidden] = w[:f_in, 2 * hidden :]
    wp[f_in:, 3 * hidden :] = w[f_in:, 2 * hidden :]
    return wp, _pack_gru_bias(b, hidden)


def pack_gru_weights_t(wt: torch.Tensor, b: torch.Tensor, f_in: int):
    """:func:`pack_gru_weights` in PyTorch's [out, in] layout, as
    :data:`fwd_gemm` reads B: from wt [3H, F + H] (the same weights
    transposed: W_ih beside W_hh) to wt' [4H, F + H] = w'ᵀ, written
    directly, without a transpose of w'. Returns (wt', b' [4H] fp32)."""
    hidden = wt.shape[0] // 3
    wp = wt.new_zeros(4 * hidden, wt.shape[1])
    wp[: 2 * hidden] = wt[: 2 * hidden]
    wp[2 * hidden : 3 * hidden, :f_in] = wt[2 * hidden :, :f_in]
    wp[3 * hidden :, f_in:] = wt[2 * hidden :, f_in:]
    return wp, _pack_gru_bias(b, hidden)


def _pack_gru_bias(b: torch.Tensor, hidden: int) -> torch.Tensor:
    """b [2, 3H] (b_ih, b_hh) -> [b_ir + b_hr, b_iz + b_hz, b_in, b_hn] fp32."""
    b = b.float()
    return torch.cat([b[0, : 2 * hidden] + b[1, : 2 * hidden], b[0, 2 * hidden :],
                      b[1, 2 * hidden :]])


def _round(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """v (fp32) rounded to ``dtype`` and back: the cast the kernels make
    before a product or a store."""
    return v.to(dtype).float()


def plain_lstm_train_walk(p, w_hh_t, h0, c0):
    """Plain PyTorch version of :data:`lstm_train_walk`, with its roundings:
    from the input projections p [T, N, 4H] (fp32, both biases included)
    and (h0, c0) [N, H] in the storage type, the LSTM cell over T steps,
    h · W_hh^T (w_hh_t [H, 4H]) from h rounded where it is produced, c an
    fp32 carry stashed rounded. Returns (h stash, c stash) [T, N, H] in
    h0's dtype."""
    cdt = h0.dtype
    w = w_hh_t.float()
    h, c = h0.float(), c0.float()
    h_steps, c_steps = [], []
    for step in range(p.shape[0]):
        i, f, g, o = (p[step] + h @ w).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = _round(torch.sigmoid(o) * torch.tanh(c), cdt)
        h_steps.append(h)
        c_steps.append(c)
    return torch.stack(h_steps).to(cdt), torch.stack(c_steps).to(cdt)


def plain_gru_train_walk(p, w_hh_t, b_hh, h0):
    """Plain PyTorch version of :data:`gru_train_walk`, with its roundings:
    from the input projections p [T, N, 3H] (fp32, with b_ih only) and h0
    [N, H] in the storage type, the GRU cell over T steps on an fp32 h
    carry, h · W_hh^T (w_hh_t [H, 3H]) from h rounded, b_hh [3H] added to it
    because the reset gate scales W_hn h + b_hn. Returns the h stash
    [T, N, H] (h rounded) in h0's dtype."""
    cdt = h0.dtype
    hidden = h0.shape[-1]
    w = w_hh_t.float()
    h = h0.float()  # the fp32 carry; h0 is stored, so already rounded
    h_steps = []
    for step in range(p.shape[0]):
        hw = _round(h, cdt) @ w + b_hh
        r, z = torch.sigmoid(p[step, :, : 2 * hidden] + hw[:, : 2 * hidden]).chunk(2, -1)
        n = torch.tanh(p[step, :, 2 * hidden :] + r * hw[:, 2 * hidden :])
        h = (1.0 - z) * n + z * h
        h_steps.append(_round(h, cdt))
    return torch.stack(h_steps).to(cdt)


def _head(gemm, seq, wfc, bfc):
    """The head seq · W_fc^T + b_fc, fp32 [rows, OUT]: W_fc^T and the bias
    zero-padded to a multiple of 8 columns, so that the GEMM's 16-byte loads
    serve OUT = 2 and 257 too, and the first OUT columns kept."""
    out_dim = wfc.shape[1]
    pad = _round_up(out_dim, 8) - out_dim
    if pad:
        wfc = torch.cat([wfc, wfc.new_zeros(wfc.shape[0], pad)], dim=1)
        bfc = torch.cat([bfc, bfc.new_zeros(pad)])
    return gemm(seq, wfc, bias=bfc)[:, :out_dim].contiguous()


def _train_forward_stages(gemm, walk, x, ws, bs, wfc, bfc, h0s, c0s=None, out_in: bool = False):
    """K2 (with ``c0s``) or K2-GRU as stages, in x's storage type: per
    layer the input projection of all T·N rows at once (``gemm``; LSTM with
    b_ih + b_hh, GRU with b_ih alone), then the walk over time (``walk``,
    the cell's; it returns the stashes, LSTM (h, c), GRU h), whose h stash is
    the next layer's input; then the head over the last h stash. ``gemm``
    and ``walk`` are the kernels or their plain versions. The weights are
    :func:`prep_weights`'s as :data:`tc_gemm` reads B ([K, Ncols]: ws
    [W_ih^T ; W_hh^T], wfc W_fc^T) or, with ``out_in``, in PyTorch's
    [out, in] layout as :data:`fwd_gemm` reads B: ws each layer's pair
    (W_ih [G·H, in], W_hh as the walk takes it), wfc W_fc [OUT, H]. Returns
    (out [T, N, OUT] fp32, h stashes, c stashes) or, for a GRU, (out, h
    stashes). ``wfc`` None: a head-less stack, out the top layer's h stash
    [T, N, H] in fp32, no head GEMM."""
    t, n, _ = x.shape
    lstm = c0s is not None
    seq = x.reshape(t * n, -1)
    hs, cs = [], []
    for li, (w, b) in enumerate(zip(ws, bs)):
        in_dim = seq.shape[1]
        w_ih, w_hh = w if out_in else (w[:in_dim], w[in_dim:])
        p = gemm(seq, w_ih, bias=b if lstm else b[0]).view(t, n, -1)
        if lstm:
            h, c = walk(p, w_hh, h0s[li], c0s[li])
            cs.append(c)
        else:
            h = walk(p, w_hh, b[1], h0s[li])
        del p  # one layer's fp32 P alive at a time
        hs.append(h)
        seq = h.view(t * n, -1)
    if wfc is None:  # a head-less stack: the top layer's h stash, in fp32
        out = seq.float()
    elif out_in:
        out = gemm(seq, wfc, bias=bfc)
    else:
        out = _head(gemm, seq, wfc, bfc)
    return (out.view(t, n, -1), hs, cs) if lstm else (out.view(t, n, -1), hs)


def plain_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """Plain PyTorch version of K2 (with ``c0s``) and of K2-GRU (without),
    with their signatures and roundings: the composition of
    :func:`plain_tc_gemm` and :func:`plain_lstm_train_walk` (or
    :func:`plain_gru_train_walk`), the products and the cell in fp32 from
    the stored values. LSTM: returns (out [T, N, OUT] fp32, h stashes, c
    stashes); GRU: (out, h stashes)."""
    walk = plain_lstm_train_walk if c0s is not None else plain_gru_train_walk
    return _train_forward_stages(plain_tc_gemm, walk, x, ws, bs, wfc, bfc, h0s, c0s)


def plain_f32_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """Plain PyTorch version of the fp32 K2 / K2-GRU stages as the card runs
    them, with :func:`plain_stash_forward`'s signature (the weights as
    :func:`prep_weights` gives them): :func:`plain_fwd_gemm` (B in
    PyTorch's layout, views of the transposes of ``ws`` and ``wfc``) around
    :func:`plain_lstm_fwd_walk` / :func:`plain_gru_fwd_walk` with
    ``stash=True`` (the plain versions of :data:`lstm_train_walk_f32` and
    :data:`gru_train_walk_f32` in either form). Equal to
    :func:`plain_stash_forward` at fp32 up to the order of the sums."""
    lstm = c0s is not None
    plain_walk = plain_lstm_fwd_walk if lstm else plain_gru_fwd_walk

    def walk(*args):
        return plain_walk(*args, stash=True)

    hidden = h0s[0].shape[1]
    layers = [(w[:-hidden].t(), w[-hidden:].t()) for w in ws]
    return _train_forward_stages(plain_fwd_gemm, walk, x, layers, bs,
                                 None if wfc is None else wfc.t(), bfc, h0s, c0s, out_in=True)


def _lstm_backward_stages(gemm, walk, dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in,
                          out_in: bool = False):
    """K3 as three stages: the gate pre-activations of all steps at once
    (they read x and the stashes, not the carries), the walk back in time,
    and dx from the dgates stream; ``gemm`` and ``walk`` are the kernels
    or their plain versions. ``gemm`` takes B as :data:`tc_gemm` does
    ([K, Ncols]: w, then wt's W_ih columns) or, with ``out_in``, as
    :data:`fwd_gemm` does (PyTorch's [out, in]: wt, then w's W_ih^T rows),
    both layouts the caller holds. Returns (dx, dgates, dh0, dc0)."""
    t, n, f_in = x.shape
    hidden = hs.shape[-1]
    p = gemm(x.reshape(t * n, f_in), wt if out_in else w, bias=b,
             prev=hs.reshape(t * n, hidden), head=h0)
    dg, dh0, dc0 = walk(p.view(t, n, -1), dh, cs, c0, wt[:, f_in:], dh_in, dc_in)
    del p  # one layer's fp32 pre-activations alive at a time
    dx = _dx_gemm(gemm, dg.view(t * n, -1), w, wt, f_in, x.dtype, out_in)
    return dx.view(t, n, f_in), dg, dh0, dc0


def _gru_backward_stages(gemm, walk, dh, x, hs, w, wt, b, h0, dh_in, out_in: bool = False):
    """K4 as K3's three stages, the weights packed by
    :func:`pack_gru_weights` (with ``out_in``, :func:`pack_gru_weights_t`).
    Returns (dx, dxw, dhw, dh0)."""
    t, n, f_in = x.shape
    hidden = hs.shape[-1]
    wp, bp = pack_gru_weights_t(wt, b, f_in) if out_in else pack_gru_weights(w, b, f_in)
    p = gemm(x.reshape(t * n, f_in), wp, bias=bp, prev=hs.reshape(t * n, hidden), head=h0)
    del wp
    dxw, dhw, dh0 = walk(p.view(t, n, -1), dh, hs, h0, wt[:, f_in:], dh_in)
    del p
    dx = _dx_gemm(gemm, dxw.view(t * n, -1), w, wt, f_in, x.dtype, out_in)
    return dx.view(t, n, f_in), dxw, dhw, dh0


def _dx_gemm(gemm, d, w, wt, f_in: int, dtype: torch.dtype, out_in: bool):
    """dx = d · W_ih from the cotangent stream d [T·N, G·H] (dgates or dxw):
    B as wt[:, :F] for :data:`tc_gemm`'s layout, out in the storage type;
    as w[:F] for :data:`fwd_gemm`'s (fp32)."""
    if out_in:
        return gemm(d, w[:f_in])
    return gemm(d, wt[:, :f_in], out_dtype=dtype)


def plain_layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """Plain PyTorch version of K3, with K3's signature and roundings: the
    composition of :func:`plain_tc_gemm` and :func:`plain_lstm_walk`.
    Returns (dx, dgates, dh0, dc0)."""
    return _lstm_backward_stages(plain_tc_gemm, plain_lstm_walk, dh, x, hs, cs, w, wt, b, h0,
                                 c0, dh_in, dc_in)


def plain_gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in):
    """Plain PyTorch version of K4, with K4's signature and roundings (h_{t-1}
    from the stash in the recompute and in dz, dxw and dhw rounded to the
    storage type before the products): the composition of
    :func:`plain_tc_gemm` and :func:`plain_gru_walk`. Returns (dx, dxw,
    dhw, dh0)."""
    return _gru_backward_stages(plain_tc_gemm, plain_gru_walk, dh, x, hs, w, wt, b, h0, dh_in)


def plain_f32_layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """Plain PyTorch version of the fp32 K3 stages as the card runs them:
    :func:`plain_fwd_gemm` (B in PyTorch's layout) around
    :func:`plain_lstm_walk`, whose roundings are no-ops at fp32 (the plain
    version of :data:`lstm_walk_f32`). Equal to :func:`plain_layer_backward`
    at fp32 up to the order of the sums."""
    return _lstm_backward_stages(plain_fwd_gemm, plain_lstm_walk, dh, x, hs, cs, w, wt, b, h0,
                                 c0, dh_in, dc_in, out_in=True)


def plain_f32_gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in):
    """Plain PyTorch version of the fp32 K4 stages: :func:`plain_fwd_gemm`
    around :func:`plain_gru_walk` (the plain version of
    :data:`gru_walk_f32`), the weights packed by :func:`pack_gru_weights_t`."""
    return _gru_backward_stages(plain_fwd_gemm, plain_gru_walk, dh, x, hs, w, wt, b, h0, dh_in,
                                out_in=True)


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no training path for device {x.device}")
    return x.device.type


def stash_forward(x, ws, bs, wfc, bfc, h0s, c0s=None):
    """K2 (with ``c0s``) or K2-GRU (without): their plain version on a CPU
    tensor; on a CUDA tensor the tensor-core stages at bf16 storage,
    otherwise the fp32 stages, :data:`fwd_gemm` around
    :data:`lstm_train_walk_f32` / :data:`gru_train_walk_f32` (which raise on
    a type other than fp32). Their weights are made here once a call, from
    the transposes of ``ws`` and ``wfc``: each layer's W_ih and W_fc in
    PyTorch's layout, and W_hh in the form the walk reads for N rows
    (:meth:`TrainF32WalkKernel.weights`). The earlier fp32 kernels
    :data:`stash_fwd` and :data:`gru_stash_fwd` run on no path."""
    if _device_of(x) == "cpu":
        return plain_stash_forward(x, ws, bs, wfc, bfc, h0s, c0s)
    if x.dtype == torch.bfloat16:
        walk = gru_train_walk if c0s is None else lstm_train_walk
        return _train_forward_stages(tc_gemm, walk, x, ws, bs, wfc, bfc, h0s, c0s)
    walk = gru_train_walk_f32 if c0s is None else lstm_train_walk_f32
    return _train_forward_stages(fwd_gemm, walk, x, walk.layer_weights(ws, x.shape[1]), bs,
                                 None if wfc is None else wfc.t().contiguous(), bfc, h0s, c0s,
                                 out_in=True)


def layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """K3: its plain version on a CPU tensor. On a CUDA tensor three stages:
    at bf16 storage :data:`tc_gemm` around :data:`lstm_walk` on the tensor
    cores; otherwise the fp32 stages, :data:`fwd_gemm` around
    :data:`lstm_walk_f32` (which raise on a type other than fp32). The
    earlier fp32 kernel :data:`layer_bwd` runs on no path."""
    if _device_of(x) == "cpu":
        return plain_layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in)
    if x.dtype == torch.bfloat16:
        return _lstm_backward_stages(tc_gemm, lstm_walk, dh, x, hs, cs, w, wt, b, h0, c0,
                                     dh_in, dc_in)
    return _lstm_backward_stages(fwd_gemm, lstm_walk_f32, dh, x, hs, cs, w, wt, b, h0, c0,
                                 dh_in, dc_in, out_in=True)


def gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in):
    """K4: its plain version on a CPU tensor. On a CUDA tensor the stages of
    K3 with the GRU's walk: :data:`tc_gemm` and :data:`gru_walk` at bf16
    storage, otherwise :data:`fwd_gemm` and :data:`gru_walk_f32` (fp32).
    The earlier fp32 kernel :data:`gru_layer_bwd` runs on no path."""
    if _device_of(x) == "cpu":
        return plain_gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in)
    if x.dtype == torch.bfloat16:
        return _gru_backward_stages(tc_gemm, gru_walk, dh, x, hs, w, wt, b, h0, dh_in)
    return _gru_backward_stages(fwd_gemm, gru_walk_f32, dh, x, hs, w, wt, b, h0, dh_in,
                                out_in=True)


# ---------------------------------------------------------------------------
# the layer backward's weight gradients (K3, K4's dW stage): csrc/rnn_dw.cu
# (the split-K kernel of the earlier design) and csrc/rnn_dw_tma.cu (the
# persistent kernel on the path)
# ---------------------------------------------------------------------------

DW_TILE = 128  # rows and columns of C one CTA of the dW GEMM sums
DW_SLICE_GRAIN = 32  # a slice of K is whole tiles of this many rows
# the split of K: about DW_WAVES waves of CTAs (two an SM), each slice at
# least DW_MIN_SLICE_TILES tiles of DW_SLICE_GRAIN rows
DW_WAVES = 8
DW_MIN_SLICE_TILES = 64


class DwKernelLibrary:
    """The library of the dW stage's split-K GEMM and its ordered sum
    (csrc/rnn_dw.cu), built at first use and loaded with ctypes."""

    SOURCES = (CSRC / "rnn_dw.cu", CSRC / "mma_common.cuh")
    NAME = "fsn_rnn_dw"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            segment = [ptr, ptr, i, i, i]
            lib.fsn_dw_gemm.argtypes = [i, *segment, *segment, ptr, i, i, i, i, ptr, ptr, ptr]
            lib.fsn_dw_gemm.restype = i
            lib.fsn_dw_error_string.argtypes = [i]
            lib.fsn_dw_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


dw_library = DwKernelLibrary()


def dw_slice_rows(k: int, splits: int) -> int:
    """Rows of each slice when the dW GEMM cuts K rows into ``splits``:
    whole tiles of :data:`DW_SLICE_GRAIN` rows, the last slice shorter
    (and fewer slices where ``splits`` would leave one empty)."""
    tiles = -(-k // DW_SLICE_GRAIN)
    return -(-tiles // max(1, splits)) * DW_SLICE_GRAIN


def pick_dw_splits(m: int, ncols: int, k: int, sms: int) -> int:
    """Slices of K for the dW GEMM of C [m, ncols] over k rows on a card of
    ``sms`` SMs: about :data:`DW_WAVES` waves of CTAs, two an SM, over the
    128 x 128 tiles of C's first m - 1 rows (the CTAs of the first tile row
    sum the last, the bias row), each slice at least
    :data:`DW_MIN_SLICE_TILES` tiles of K; no slice empty."""
    tiles = -(-(m - 1) // DW_TILE) * -(-ncols // DW_TILE)
    cap = max(1, -(-k // DW_SLICE_GRAIN) // DW_MIN_SLICE_TILES)
    splits = min(cap, max(1, round(DW_WAVES * 2 * sms / tiles)))
    return -(-k // dw_slice_rows(k, splits))


def plain_dw_gemm(a, b, prev=None, head=None, splits: int = 1):
    """Plain PyTorch version of :data:`dw_gemm`: ``[a | a_prev | 1]^T · b``
    over the K rows of b, fp32 sums of the stored values. a [K, F] or
    None; prev [>= K - S, H] and head [S, H] give a_prev (row k is head[k]
    for k < S, else prev[k - S]), or None; b [K, Ncols]. K is cut into
    slices as the kernel cuts it for ``splits`` (:func:`dw_slice_rows`),
    and the slices' products are summed in slice order. Returns
    [F + H + 1, Ncols] fp32, whose last row is b's column sums."""
    k = b.shape[0]
    cols = [] if a is None else [a]
    if prev is not None:
        cols.append(_shifted(prev, head, k))
    cols.append(b.new_ones((k, 1)))
    a_aug = torch.cat([c.float() for c in cols], dim=1)
    rows = dw_slice_rows(k, splits)
    out = None
    for r0 in range(0, k, rows):
        part = a_aug[r0 : r0 + rows].t() @ b[r0 : r0 + rows].float()
        out = part if out is None else out + part
    return out


class DwGemmKernel(_Counts):
    """ctypes wrapper of ``fsn_dw_gemm`` (csrc/rnn_dw.cu), the dW stage of
    K3 and K4 of the earlier design (no path runs it; :data:`dw_tma` took
    its place) at either storage type: bf16 on the tensor cores, fp32 on
    the fp32 cores. Counted by (F, H, Ncols), 0 for a segment left out: per
    LSTM layer (F, H, 4H), per GRU layer (F, 0, 3H) and (0, H, 3H)."""

    def __init__(self):
        super().__init__()
        self._sms = {}

    def sms(self, device: torch.device) -> int:
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        return self._sms[device]

    def __call__(self, a, b, prev=None, head=None, splits: int | None = None):
        """``[a | a_prev | 1]^T · b`` as :func:`plain_dw_gemm` takes it: b
        [K, Ncols] bf16 or fp32 with unit column stride; a, prev and head
        contiguous, of b's dtype. ``splits`` None picks the slices of K
        (:func:`pick_dw_splits`). Returns [F + H + 1, Ncols] fp32."""
        if b.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {b.device}")
        if b.dtype not in TRAIN_DTYPES:
            raise TypeError(f"b must be float32 or bfloat16, got {b.dtype}")
        if b.ndim != 2 or b.stride(1) != 1:
            raise ValueError(f"b must be [K, Ncols] with unit column stride, got "
                             f"{list(b.shape)} strides {b.stride()}")
        k, ncols = b.shape
        named, segments = {}, []
        if a is not None:
            if a.ndim != 2 or a.shape[0] != k:
                raise ValueError(f"a must be [{k}, F], got {list(a.shape)}")
            named["a"] = a
            segments.append((a.data_ptr(), None, a.shape[1], a.shape[1], 0))
        if prev is not None:
            if (head is None or prev.ndim != 2 or head.ndim != 2
                    or head.shape[1] != prev.shape[1] or prev.shape[0] < k - head.shape[0]):
                raise ValueError("prev [rows, H] needs head [S, H] and must give K rows")
            named.update(prev=prev, head=head)
            segments.append((prev.data_ptr(), head.data_ptr(), prev.shape[1], prev.shape[1],
                             head.shape[0]))
        if not segments:
            raise ValueError("the dW GEMM needs a or prev")
        _check_operands(b.device, named, dict.fromkeys(named, b.dtype))
        segments.append((None, None, 0, 0, 0))
        m = segments[0][3] + segments[1][3] + 1
        if splits is None:
            splits = pick_dw_splits(m, ncols, k, self.sms(b.device))
        rows = dw_slice_rows(k, splits)
        slices = -(-k // rows)

        lib = dw_library()
        out = torch.empty((m, ncols), device=b.device, dtype=torch.float32)
        work = (torch.empty((slices, m, ncols), device=b.device, dtype=torch.float32)
                if slices > 1 else None)
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            err = lib.fsn_dw_gemm(
                int(b.dtype == torch.bfloat16), *segments[0], *segments[1], b.data_ptr(),
                b.stride(0), ncols, k, rows, work.data_ptr() if work is not None else None,
                out.data_ptr(), stream,
            )
        _raise_on(err, "fsn_dw_gemm", lib.fsn_dw_error_string)
        self._count(b.device, (a.shape[1] if a is not None else 0,
                     prev.shape[1] if prev is not None else 0, ncols))
        return out


dw_gemm = DwGemmKernel()


# the redesigned dW stage: csrc/rnn_dw_tma.cu, a persistent TMA-fed GEMM
# (wgmma at bf16, FFMA at fp32) walking the units of plan_dw
DW_SLOT = 64  # rows of C one slot (a consumer warpgroup at bf16) sums
DW_TILE_N = 256  # columns of C one CTA sums; a CTA's tile is two slots by this
DW_TILE_ELEMS = 2 * DW_SLOT * DW_TILE_N  # floats of one unit's partial
# rows of the streams a k-tile: the ring's stage at each storage type
DW_K_TILE = {torch.bfloat16: 64, torch.float32: 16}
# the most waves of units the schedule considers
DW_MAX_WAVES = 8
# the schedule takes the fewest slabs whose largest load is within this
# share of the least: more units cost more partials to write and sum. In the
# slab sweep of chip_smoke.py --dw (an H100; seven counts around the plan's
# at six shapes) the plan's count was the fastest at three and within 5% of
# the fastest at the others
DW_LOAD_SLACK = 0.01
# the most rows of K one unit sums in its accumulators. The tensor cores'
# fp32 sums round toward zero, so on products of one sign their error grows
# with the run: on operands uniform in [0, 1) the bf16 instance erred 1.6e-5
# / 1.5e-5 of the largest value at 8,192 rows a unit, 3.0e-5 / 3.6e-5 at
# 16,384 and 6.7e-5 / 8.0e-5 at 32,768 (chip_smoke.py --dw on an H100, K =
# 24,576 / 798,720), against the smoke's 1e-4 and the card tests' one-sign
# 4e-5; its slab sweep found 49 slabs (16,384 rows) no faster than 98 at the
# sub-band stage. The fp32 cores' sums round to nearest.
DW_MAX_UNIT_ROWS = {torch.bfloat16: 8_192, torch.float32: 32_768}
# the fewest k-tiles at which clusters of two CTAs share B's loads: on a
# short K (the full-band stage's 98 k-tiles) the pairs run faster alone
DW_CLUSTER_K_TILES = 1024
# the load paths of an operand in the kernel, by the code it hands over
DW_PATHS = ("tma", "cp.async", "gather")


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The work units of the dW stage's persistent GEMM (csrc/rnn_dw_tma.cu)
    for C = [a | a_prev | 1]^T . b: a cols0 columns, a_prev cols1 columns
    shifted by ``shift`` rows, b ncols columns, k rows, at a k-tile of ``bk``
    rows.

    C's rows but the last are cut into slots of :data:`DW_SLOT`: ``n0``
    over a's columns, then ``n1`` over a_prev's, each slot inside one
    segment (its tail past the segment's end is zeros). A CTA's tile is a
    pair of slots by :data:`DW_TILE_N` columns. The last row of C, b's
    column sums, takes no slot: the slab units of the first pair sum b's
    columns beside their products. The CTAs run in clusters of ``cs``; a
    cluster's CTAs take ``cs`` pairs (a group; past the last pair, none) of
    one column tile, and share the loads of its B (multicast). K's
    ``k_tiles`` are cut into ``slabs`` of near-equal length. A cluster's
    units, in order: each slab's over every group and column tile, slab by
    slab; then, where a_prev is shifted, a head unit over each group that
    holds a_prev's slots and each column tile (head^T . b[0:shift], over
    ``head_tiles`` k-tiles). Unit u is cluster unit u // cs taken by the
    CTA of rank u % cs. ``ctas`` persistent CTAs (``ctas // cs`` clusters)
    take cluster units round robin; each CTA's unit writes its partial, and
    each element of C is the sum of its tile's partials in this order (the
    head unit's only on a_prev's rows)."""

    cols0: int
    cols1: int
    shift: int
    ncols: int
    k: int
    bk: int
    n0: int
    n1: int
    n_slots: int
    pairs: int
    n_tiles: int
    k_tiles: int
    slabs: int
    cs: int
    head_group0: int
    head_groups: int
    head_tiles: int
    units: int
    ctas: int

    @property
    def groups(self) -> int:
        return -(-self.pairs // self.cs)

    @property
    def tiles(self) -> int:
        """A slab's cluster units: groups by column tiles."""
        return self.groups * self.n_tiles

    @property
    def head_units(self) -> int:
        return self.head_groups * self.n_tiles * self.cs

    def params(self) -> list[int]:
        """The plan as the C entry takes it (``fsn_dw_tma``'s plan[])."""
        return [self.n0, self.n1, self.n_slots, self.pairs, self.n_tiles, self.k_tiles,
                self.slabs, self.cs, self.head_group0, self.head_groups, self.head_tiles,
                self.units]

    @property
    def work_floats(self) -> int:
        """The workspace: every unit's partial, then each slab's bias sums."""
        return self.units * DW_TILE_ELEMS + self.slabs * self.n_tiles * DW_TILE_N

    def slot(self, index: int, head: bool) -> tuple[str | None, int]:
        """(segment "a", "prev", "head" or None, first column) of slot
        ``index`` in a head unit or a slab's unit."""
        if index < self.n0 and not head:
            return "a", index * DW_SLOT
        if self.n0 <= index < self.n0 + self.n1:
            return ("head" if head else "prev"), (index - self.n0) * DW_SLOT
        return None, 0

    @staticmethod
    def bias_unit(pair: int, head: bool) -> bool:
        """Whether a unit sums b's columns, the bias row: the slab units of
        the first pair."""
        return pair == 0 and not head

    def unit(self, u: int) -> tuple[int, int, int, int, bool]:
        """(pair, column tile, first k-tile, end k-tile, head) of unit u;
        a pair past the last is a cluster's CTA without slots."""
        cu, rank = divmod(u, self.cs)
        mains = self.slabs * self.tiles
        if cu >= mains:
            group, nt = divmod(cu - mains, self.n_tiles)
            return ((self.head_group0 + group) * self.cs + rank, nt, 0, self.head_tiles, True)
        s, t = divmod(cu, self.tiles)
        group, nt = divmod(t, self.n_tiles)
        return (group * self.cs + rank, nt, s * self.k_tiles // self.slabs,
                (s + 1) * self.k_tiles // self.slabs, False)

    def cta_units(self, cta: int) -> range:
        """The units CTA ``cta`` runs, in its order."""
        clusters = self.ctas // self.cs
        return range((cta // self.cs) * self.cs + cta % self.cs, self.units, clusters * self.cs)

    def row_of(self, r: int) -> tuple[int, int]:
        """(slot, row in the slot) of row r < cols0 + cols1 of C."""
        if r < self.cols0:
            return divmod(r, DW_SLOT)
        slot, lr = divmod(r - self.cols0, DW_SLOT)
        return self.n0 + slot, lr


def _dw_plan(cols0: int, cols1: int, shift: int, ncols: int, k: int, sms: int,
             dtype: torch.dtype, slabs: int | None = None, cs: int = 1) -> DwPlan:
    """The plan at ``slabs`` slabs of K (None: one slab) in clusters of
    ``cs`` CTAs."""
    if k < 1 or ncols < 1 or cols0 < 0 or cols1 < 0 or cols0 + cols1 < 1 or shift < 0:
        raise ValueError(f"no dW plan for cols {cols0} + {cols1}, ncols {ncols}, K {k}, "
                         f"shift {shift}")
    if cs not in (1, 2):
        raise ValueError(f"clusters of 1 or 2 CTAs, not {cs}")
    bk = DW_K_TILE[dtype]
    n0, n1 = -(-cols0 // DW_SLOT), -(-cols1 // DW_SLOT)
    n_slots = n0 + n1
    pairs, n_tiles = -(-n_slots // 2), -(-ncols // DW_TILE_N)
    k_tiles = -(-k // bk)
    slabs = min(max(1, slabs or 1), k_tiles)
    shift = shift if cols1 else 0
    head_tiles = -(-min(shift, k) // bk)
    # the groups whose pairs hold a_prev's slots n0 .. n0 + n1 - 1
    head_group0 = n0 // 2 // cs
    head_groups = (n0 + n1 - 1) // 2 // cs - head_group0 + 1 if head_tiles else 0
    groups = -(-pairs // cs)
    units = (slabs * groups + head_groups) * n_tiles * cs
    return DwPlan(cols0, cols1, shift, ncols, k, bk, n0, n1, n_slots, pairs, n_tiles,
                  k_tiles, slabs, cs, head_group0, head_groups, head_tiles if head_groups else 0,
                  units, cs * min(sms // cs, units // cs))


@functools.lru_cache(maxsize=256)
def plan_dw(cols0: int, cols1: int, shift: int, ncols: int, k: int, sms: int,
            dtype: torch.dtype, cluster: bool = False) -> DwPlan:
    """The plan of the dW stage's persistent GEMM (:class:`DwPlan`) on a
    card of ``sms`` SMs, one CTA an SM: the slots and tiles of C; clusters
    of two CTAs that share B's loads where ``cluster`` allows them (bf16,
    B loaded by TMA), C has an even number of pairs of slots (an odd one
    would leave a CTA of a cluster without slots) and K at least
    :data:`DW_CLUSTER_K_TILES` k-tiles, else of one; and
    the number of slabs of K: the fewest, with no unit over
    :data:`DW_MAX_UNIT_ROWS` rows and within :data:`DW_MAX_WAVES` waves of
    units (or twice the fewest slabs), whose largest load of a cluster (its
    units' k-tiles round robin, the head units after the slabs', each at
    its :func:`dw_unit_share`) is within :data:`DW_LOAD_SLACK` of the
    least."""
    plan = _dw_plan(cols0, cols1, shift, ncols, k, sms, dtype)
    cs = 2 if cluster and plan.pairs % 2 == 0 and plan.k_tiles >= DW_CLUSTER_K_TILES else 1
    plan = _dw_plan(cols0, cols1, shift, ncols, k, sms, dtype, cs=cs)
    tiles, k_tiles, clusters = plan.tiles, plan.k_tiles, sms // cs
    fewest = -(-k_tiles // (DW_MAX_UNIT_ROWS[dtype] // plan.bk))
    most = min(k_tiles, max(2 * fewest, -(-DW_MAX_WAVES * clusters // tiles)))
    # a cluster unit's share: its slowest CTA's (rank r takes pair g * cs + r)
    share = torch.tensor([[max(dw_unit_share(plan, g * cs + r, nt, head, dtype) for r in range(cs))
                           for g in range(plan.groups) for nt in range(plan.n_tiles)]
                          for head in (False, True)], dtype=torch.float64)
    heads = share[1, plan.head_group0 * plan.n_tiles:][: plan.head_groups * plan.n_tiles]

    def load(slabs: int) -> float:
        lengths = torch.diff(torch.arange(slabs + 1, dtype=torch.float64) * k_tiles // slabs)
        cost = torch.cat([(lengths[:, None] * share[0]).flatten(), heads * plan.head_tiles])
        taker = torch.arange(len(cost)) % clusters
        return float(torch.zeros(clusters, dtype=torch.float64).index_add_(0, taker, cost).max())

    loads = {slabs: load(slabs) for slabs in range(fewest, most + 1)}
    least = min(loads.values())
    slabs = min(s for s, v in loads.items() if v <= least * (1 + DW_LOAD_SLACK))
    return _dw_plan(cols0, cols1, shift, ncols, k, sms, dtype, slabs, cs)


def dw_unit_share(plan: DwPlan, pair: int, nt: int, head: bool, dtype: torch.dtype) -> float:
    """The share of a whole tile's sums that a unit of ``pair`` (past the
    last pair: none) and column tile ``nt`` takes its CTA: at bf16 1 where
    it has a slot; at fp32 its slowest FFMA warp's, since a warp (rows
    (w // 2) * 16 .. + 15 of each slot, columns (w % 2) * 32 .. + 31 of each
    64-column box) leaves out the slots none of its rows reaches, and has
    nothing to do where all its columns lie past ``ncols``."""
    slots = [plan.slot(2 * pair + h, head) for h in range(2)] if pair < plan.pairs else []
    widths = [plan.cols0 if seg == "a" else plan.cols1 for seg, _ in slots]
    if dtype != torch.float32:
        return float(any(seg is not None for seg, _ in slots))
    most = 0.0
    for warp in range(8):
        live = sum(seg is not None and col0 + (warp // 2) * 16 < width
                   for (seg, col0), width in zip(slots, widths))
        if plan.ncols - nt * DW_TILE_N - (warp % 2) * 32 > 0:
            most = max(most, live / 2)
    return most


def plain_dw_plan(plan: DwPlan, a, b, prev=None, head=None):
    """The plan's composition in plain PyTorch: each unit's product over its
    k-tiles (the head units' over head and b[0:shift]), summed into C tile
    by tile in the units' order, as the kernel's ordered sum takes them; the
    bias row each slab's column sums of b, taken by the first pair's units;
    fp32 sums of the stored values. Returns [cols0 + cols1 + 1, ncols]
    fp32, as :func:`plain_dw_gemm`."""
    k, bk = plan.k, plan.bk
    cols = {"a": None if a is None else a.float(),
            "prev": None if prev is None else torch.cat(
                [prev.new_zeros((plan.shift, prev.shape[1])), prev])[:k].float(),
            "head": None if head is None else head.float()}
    bf = b.float()
    tile_rows = 2 * DW_SLOT
    parts, bias = {}, bf.new_zeros(plan.ncols)
    for u in range(plan.units):
        pair, nt, kt0, kt1, is_head = plan.unit(u)
        if pair >= plan.pairs:
            continue
        r0, r1 = kt0 * bk, min(kt1 * bk, k)
        if is_head:
            r1 = min(r1, plan.shift)
        n0, n1 = nt * DW_TILE_N, min((nt + 1) * DW_TILE_N, plan.ncols)
        a_t = bf.new_zeros((r1 - r0, tile_rows))
        for h in range(2):
            seg, col0 = plan.slot(2 * pair + h, is_head)
            if seg is not None:
                src = cols[seg][r0:r1, col0 : col0 + DW_SLOT]
                a_t[:, h * DW_SLOT : h * DW_SLOT + src.shape[1]] = src
        part = a_t.t() @ bf[r0:r1, n0:n1]
        key = (pair, nt)
        if is_head:
            parts[key, "head"] = part
        else:
            parts[key] = part if key not in parts else parts[key] + part
        if plan.bias_unit(pair, is_head):
            bias[n0:n1] += bf[r0:r1, n0:n1].sum(0)
    mw = plan.cols0 + plan.cols1
    out = bf.new_empty((mw + 1, plan.ncols))
    out[mw] = bias
    for r in range(mw):
        slot, lr = plan.row_of(r)
        row = (slot % 2) * DW_SLOT + lr
        for nt in range(plan.n_tiles):
            n0, n1 = nt * DW_TILE_N, min((nt + 1) * DW_TILE_N, plan.ncols)
            val = parts[slot // 2, nt][row]
            head_part = parts.get(((slot // 2, nt), "head"))
            if r >= plan.cols0 and head_part is not None:
                val = val + head_part[row]
            out[r, n0:n1] = val
    return out


class DwTmaKernelLibrary:
    """The library of the redesigned dW stage (csrc/rnn_dw_tma.cu), built
    at first use and loaded with ctypes."""

    SOURCES = (CSRC / "rnn_dw_tma.cu", CSRC / "mma_common.cuh", CSRC / "tma_common.cuh")
    NAME = "fsn_rnn_dw_tma"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_dw_tma.argtypes = [i, ptr, i, i, ptr, ptr, i, i, i, i, ptr, i, i, i, ptr, i,
                                       ptr, ptr, ptr, ptr]
            lib.fsn_dw_tma.restype = i
            lib.fsn_dw_tma_error_string.argtypes = [i]
            lib.fsn_dw_tma_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


dw_tma_library = DwTmaKernelLibrary()


def dw_load_path(t: torch.Tensor) -> str:
    """The path the dW kernel's loads of an operand take (:data:`DW_PATHS`):
    TMA where its base and row stride are 16-byte multiples, else 4-byte
    cp.async where they are 4-byte multiples, else 2-byte gathers (a bf16
    operand with an odd row stride)."""
    row = t.stride(0) * t.element_size()
    if t.data_ptr() % 16 == 0 and row % 16 == 0:
        return "tma"
    if t.data_ptr() % 4 == 0 and row % 4 == 0:
        return "cp.async"
    return "gather"


class DwTmaKernel(_Counts):
    """ctypes wrapper of ``fsn_dw_tma`` (csrc/rnn_dw_tma.cu), the dW stage
    of K3 and K4 on the main path, at either storage type: bf16 on wgmma,
    fp32 on the fp32 cores, from TMA loads where the operands allow them.
    Counted by (F, H, Ncols), 0 for a segment left out (per LSTM layer (F,
    H, 4H), per GRU layer (F, 0, 3H) and (0, H, 3H)), and by form: "tma"
    where every operand's loads take TMA, else "cp.async" (the slowest path
    any operand takes, :func:`dw_load_path`)."""

    def __init__(self):
        super().__init__()
        self._sms = {}

    def sms(self, device: torch.device) -> int:
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        return self._sms[device]

    def plan(self, a, b, prev=None, head=None) -> DwPlan:
        """The plan a call on these operands runs (:func:`plan_dw`): in
        clusters that share B's loads at bf16 where B takes TMA."""
        return plan_dw(0 if a is None else a.shape[1], 0 if prev is None else prev.shape[1],
                       0 if head is None else head.shape[0], b.shape[1], b.shape[0],
                       self.sms(b.device), b.dtype,
                       b.dtype == torch.bfloat16 and dw_load_path(b) == "tma")

    def __call__(self, a, b, prev=None, head=None, plan: DwPlan | None = None):
        """``[a | a_prev | 1]^T · b`` as :func:`plain_dw_gemm` takes it: b
        [K, Ncols] bf16 or fp32 with unit column stride; a, prev and head
        contiguous, of b's dtype; ``plan`` one of these operands' plans
        (:func:`_dw_plan`; None: :meth:`plan`'s). Returns [F + H + 1, Ncols]
        fp32."""
        if b.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {b.device}")
        if b.dtype not in TRAIN_DTYPES:
            raise TypeError(f"b must be float32 or bfloat16, got {b.dtype}")
        if b.ndim != 2 or b.stride(1) != 1:
            raise ValueError(f"b must be [K, Ncols] with unit column stride, got "
                             f"{list(b.shape)} strides {b.stride()}")
        k, ncols = b.shape
        named = {}
        if a is not None:
            if a.ndim != 2 or a.shape[0] != k:
                raise ValueError(f"a must be [{k}, F], got {list(a.shape)}")
            named["a"] = a
        if prev is not None:
            if (head is None or prev.ndim != 2 or head.ndim != 2
                    or head.shape[1] != prev.shape[1] or prev.shape[0] < k - head.shape[0]):
                raise ValueError("prev [rows, H] needs head [S, H] and must give K rows")
            named.update(prev=prev, head=head)
        if not named:
            raise ValueError("the dW GEMM needs a or prev")
        _check_operands(b.device, named, dict.fromkeys(named, b.dtype))
        plan = plan or self.plan(a, b, prev, head)
        shift = plan.shift
        paths = [dw_load_path(t) if t is not None and t.numel() else "tma"
                 for t in (a, prev, head if shift else None, b)]
        lib = dw_tma_library()
        out = torch.empty((plan.cols0 + plan.cols1 + 1, ncols), device=b.device,
                          dtype=torch.float32)
        work = torch.empty(plan.work_floats, device=b.device, dtype=torch.float32)
        params = (ctypes.c_int * 12)(*plan.params())
        codes = (ctypes.c_int * 4)(*map(DW_PATHS.index, paths))
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            err = lib.fsn_dw_tma(
                int(b.dtype == torch.bfloat16),
                None if a is None else a.data_ptr(), 0 if a is None else a.stride(0),
                plan.cols0, None if prev is None else prev.data_ptr(),
                head.data_ptr() if shift else None, 0 if prev is None else prev.stride(0),
                0 if prev is None else prev.shape[0], plan.cols1, shift, b.data_ptr(),
                b.stride(0), ncols, k, params, plan.ctas, codes, work.data_ptr(),
                out.data_ptr(), stream,
            )
        _raise_on(err, "fsn_dw_tma", lib.fsn_dw_tma_error_string)
        self._count(b.device, (plan.cols0, plan.cols1, ncols),
                    "tma" if all(p == "tma" for p in paths) else "cp.async")
        return out


dw_tma = DwTmaKernel()


def _weight_grads(gemm, x, hs, h0, dxw, dhw=None):
    """One layer's weight gradients from its cotangent streams through
    ``gemm`` (:data:`dw_tma` or :func:`plain_dw_gemm`), as the fused-dW
    form of ``_pallas_layer_bwd`` sums them (:609-626, :710-727,
    :896-901): the LSTM's one problem [x | h_prev | 1]^T · dgates, the
    GRU's two, [x | 1]^T · dxw and [h_prev | 1]^T · dhw; h_prev is the h
    stash one block of N rows back, h0 first. ``dhw`` None means the LSTM
    (``dxw`` is dgates), whose two bias gradients are one tensor. Returns
    (dW_ih^T [F, G·H], dW_hh^T [H, G·H], db_ih, db_hh), fp32."""
    t, n, f_in = x.shape
    rows = t * n
    xs, prev = x.reshape(rows, f_in), hs.reshape(rows, hs.shape[-1])
    if dhw is None:
        c = gemm(xs, dxw.reshape(rows, -1), prev=prev, head=h0)
        db = c[-1]
        return c[:f_in], c[f_in:-1], db, db
    ci = gemm(xs, dxw.reshape(rows, -1))
    ch = gemm(None, dhw.reshape(rows, -1), prev=prev, head=h0)
    return ci[:-1], ch[:-1], ci[-1], ch[-1]


def layer_weight_grads(x, hs, h0, dxw, dhw=None):
    """Plain PyTorch version of the dW stage (:func:`weight_grads`): the
    composition of :func:`plain_dw_gemm`. Returns (dW_ih^T, dW_hh^T, db_ih,
    db_hh)."""
    return _weight_grads(plain_dw_gemm, x, hs, h0, dxw, dhw)


def weight_grads(x, hs, h0, dxw, dhw=None):
    """The dW stage of K3 (``dhw`` None: ``dxw`` is dgates) or K4: its
    plain version on a CPU tensor, :data:`dw_tma` on a CUDA tensor (one
    launch a LSTM layer, two a GRU layer), at the streams' storage type,
    reading them as stored. The earlier split-K kernel :data:`dw_gemm` runs
    on no path."""
    if _device_of(x) == "cpu":
        return layer_weight_grads(x, hs, h0, dxw, dhw)
    return _weight_grads(dw_tma, x, hs, h0, dxw, dhw)


def _stack_from_flat(params, num_layers):
    """(layer dicts, head dict or None) from the flat (w_ih, w_hh, b_ih,
    b_hh) per layer, then the head's (weight, bias) where the stack has one."""
    layers = [
        dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), params[4 * li : 4 * li + 4]))
        for li in range(num_layers)
    ]
    if len(params) == 4 * num_layers:
        return layers, None
    return layers, {"weight": params[-2], "bias": params[-1]}


def _head_backward(g, h_top, fc, cdt: torch.dtype):
    """The head's backward over the top layer's h stash [T, N, H]: two
    products on the cotangent cast to the compute dtype first, as the JAX
    package does. Returns (dh [T, N, H] in ``cdt``, dW_fc fp32 or None). A
    head-less stack (``fc`` None) takes the cotangent as the top layer's dh."""
    if fc is None:
        return g.to(cdt).contiguous(), None
    out_dim, hidden = fc["weight"].shape
    gc = g.to(cdt).float()
    dfc_w = gc.reshape(-1, out_dim).t() @ h_top.float().reshape(-1, hidden)
    return (gc @ fc["weight"].to(cdt).float()).to(cdt), dfc_w


def _head_param_grads(g, dfc_w, fc):
    """The head's (weight, bias) gradients in their dtypes: dW_fc (fp32) and
    db_fc from the whole fp32 cotangent, as ``_bwd_direct`` and
    ``_bwd_chunked`` take it; none for a head-less stack."""
    if fc is None:
        return ()
    return dfc_w.to(fc["weight"].dtype), g.float().sum(dim=(0, 1)).to(fc["bias"].dtype)


def _layer_backward_and_grads(lstm: bool, dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in):
    """One layer's backward (K3, or K4 for a GRU) and its dW stage from
    incoming carries: (dx, dh0, dc0 or None, (dW_ih^T, dW_hh^T, db_ih, db_hh)
    fp32). The cotangent streams die here, before the next layer's walk."""
    if lstm:
        dx, dg, dh0, dc0 = layer_backward(dh, x, hs, cs, w, wt, b, h0, c0, dh_in, dc_in)
        return dx, dh0, dc0, weight_grads(x, hs, h0, dg)
    dx, dxw, dhw, dh0 = gru_layer_backward(dh, x, hs, w, wt, b, h0, dh_in)
    return dx, dh0, None, weight_grads(x, hs, h0, dxw, dhw)


def _layer_param_grads(layer, grads_w):
    """One layer's (w_ih, w_hh, b_ih, b_hh) gradients in each parameter's
    dtype from the dW stage's (dW_ih^T, dW_hh^T, db_ih, db_hh) fp32."""
    return [(v.t() if k.startswith("w_") else v).to(layer[k].dtype)
            for k, v in zip(("w_ih", "w_hh", "b_ih", "b_hh"), grads_w)]


class RnnScanFunction(torch.autograd.Function):
    """The differentiable fused scan of an LSTM or GRU stack (counterpart
    of ``_train_vjp_fn`` with ``_bwd_direct``). ``apply(x, num_layers,
    *params)`` with x [T, N, F] (its dtype is the compute dtype: the
    weights are cast to it) and params = (w_ih, w_hh, b_ih, b_hh) per
    layer, then the head's weight and bias; returns [T, N, OUT] fp32. The
    cell follows from the weights' gate count. A head-less stack passes no
    head's parameters and returns the top layer's h [T, N, H] fp32.

    forward: the training forward (K2 or K2-GRU) from zero initial
    states, keeping the stashes (h and c, or h).
    backward: the head backward as two products (a head-less stack takes
    the incoming gradient, cast to the compute dtype, as the top layer's
    dh, and runs no product); then the layers last to first through the layer backward (K3 or K4), each layer's input being
    the previous layer's h stash (x for layer 0), and its dW stage
    (:func:`weight_grads`) over the cotangent streams the layer backward
    wrote; grads in each parameter's dtype.
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
        ctx.num_params = len(params)
        ctx.cell = cell
        ctx.save_for_backward(x, zeros, *params, *ws, *bs, *hs, *cs)
        return out

    @staticmethod
    def backward(ctx, g):
        num_layers, num_params = ctx.num_layers, ctx.num_params
        x, zeros, *rest = ctx.saved_tensors
        params = rest[:num_params]
        ws, bs, hs, cs = (
            rest[num_params + k * num_layers : num_params + (k + 1) * num_layers]
            for k in range(4)
        )  # cs is empty for a GRU
        layers, fc = _stack_from_flat(params, num_layers)
        cdt = x.dtype
        n = x.shape[1]
        hidden = layers[0]["w_hh"].shape[1]

        dh, dfc_w = _head_backward(g, hs[-1], fc, cdt)
        zero_f = torch.zeros((n, hidden), device=x.device, dtype=torch.float32)
        lstm = ctx.cell == "lstm"
        grads = [None] * (4 * num_layers)
        for li in reversed(range(num_layers)):
            dh, _, _, grads_w = _layer_backward_and_grads(
                lstm, dh, x if li == 0 else hs[li - 1], hs[li], cs[li] if lstm else None, ws[li],
                ws[li].t().contiguous(), bs[li], zeros, zeros, zero_f, zero_f)
            grads[4 * li : 4 * li + 4] = _layer_param_grads(layers[li], grads_w)
        return (dh.to(x.dtype), None, *grads, *_head_param_grads(g, dfc_w, fc))


# ---------------------------------------------------------------------------
# the time-chunked training stash: K2's ``boundary_chunk`` mode and
# ``_bwd_chunked``, on the stages above and K1's
# ---------------------------------------------------------------------------

# the share of the card's memory one training call of the op may hold by
# default: the JAX package's 6 GiB of a 16 GiB v5e (``_DEFAULT_STASH_BUDGET``).
# The callers pass their own (``SequenceModel``: 3 of 16; FullSubNet's
# sub-band stage: 10.5 of 16)
STASH_BUDGET_SHARE = 6 / 16
# the memory a CPU tensor's call is sized for: an H100 80GB's, as
# ``torch.cuda.get_device_properties`` reports it, so that a call picks the
# same chunk on either device
CPU_CARD_BYTES = 85_017_493_504


def stash_budget_bytes(share: float = STASH_BUDGET_SHARE, device=None) -> int:
    """``share`` of the memory of the card ``device`` is on (a CUDA device),
    else of :data:`CPU_CARD_BYTES`: the bytes one training call may hold."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = CPU_CARD_BYTES
    return int(share * total)


def train_step_bytes(n: int, hidden: int, cell: str = "lstm", itemsize: int = 2,
                     num_layers: int = 2) -> tuple[int, int]:
    """What a training call holds for each step of a chunk, in bytes: (the
    state stash alone, and all of it). The stash: every layer's h (and the
    LSTM's c) in the storage type. All of it, at the backward's peak (the
    top layer's walk): the stash, the incoming dh in the storage type, the
    gate pre-activations in fp32 (4H wide for either cell: the GRU's are
    packed with W_hn h apart) and the dgates stream the walk writes (LSTM
    4H, GRU dxw and dhw 6H) in the storage type. The forward holds less (one
    layer's fp32 P of G·H beside the stash). Unlike the TPU kernel, whose P
    stays in VMEM, the port writes these to HBM; it pads no rows."""
    lstm = cell == "lstm"
    stash = (2 if lstm else 1) * num_layers * n * hidden * itemsize
    transients = n * hidden * (itemsize + 4 * 4 + (4 if lstm else 6) * itemsize)
    return stash, stash + transients


def pick_chunk(t: int, per_step: int, stash_budget: int) -> int:
    """The time chunk of a training call of ``t`` steps holding ``per_step``
    bytes a step (the rule of the JAX package's ``_pick_chunk``, which
    passes its stash alone): 0 (the full stash, no re-run) while ``t``
    rounded up to 8 steps fits ``stash_budget``; otherwise from round(√T/8)·8
    (at least 8) up in steps of 8 while the boundary states and one chunk's
    steps, (⌈T/K⌉ + K)·per_step, stay under 0.6 x the budget, since the
    backward holds more on top; at most T rounded up to 8. Best-effort: past
    the √T minimum the budget is not met, and that minimum is returned."""
    t8 = -(-t // 8) * 8
    if t8 * per_step <= stash_budget:
        return 0
    k = max(8, int(round((t8**0.5) / 8.0)) * 8)
    best = k
    grow_cap = int(stash_budget * 0.6)
    while k + 8 <= t8:
        k += 8
        if (-(-t8 // k) + k) * per_step > grow_cap:
            break
        best = k
    return min(best, t8)


def train_chunk(t: int, n: int, hidden: int, cell: str = "lstm", itemsize: int = 2,
                num_layers: int = 2, stash_budget: int | None = None) -> int:
    """The chunk a training call of T steps, N rows and H units picks under
    ``stash_budget`` bytes (default: the op's share of an H100 80GB):
    :func:`pick_chunk` over :func:`train_step_bytes`."""
    if stash_budget is None:
        stash_budget = stash_budget_bytes()
    per_step = train_step_bytes(n, hidden, cell, itemsize, num_layers)[1]
    return pick_chunk(t, per_step, stash_budget)


def train_stash_bytes(t: int, n: int, hidden: int, cell: str = "lstm", itemsize: int = 2,
                      stash_budget: int | None = None, num_layers: int = 2,
                      time_chunk: int | None = None) -> int:
    """The state stash a training call holds, in bytes, at the chunk it
    picks (or ``time_chunk``): all T steps unchunked; else the states
    entering every chunk but the first and one chunk's stash."""
    k = (train_chunk(t, n, hidden, cell, itemsize, num_layers, stash_budget)
         if time_chunk is None else time_chunk)
    stash = train_step_bytes(n, hidden, cell, itemsize, num_layers)[0]
    if k == 0:
        return t * stash
    return (-(-t // k) - 1 + min(k, t)) * stash


def train_bwd_peak_bytes(t: int, n: int, hidden: int, unit: int, out: int = 0,
                         cell: str = "lstm", itemsize: int = 2,
                         stash_budget: int | None = None, num_layers: int = 2,
                         time_chunk: int | None = None) -> int:
    """The peak a training call holds on the card, in bytes, at the chunk it
    picks (or ``time_chunk``; 0: the full stash): its input x [T, N, unit]
    and dx in the storage type, the output and its cotangent [T, N, out]
    fp32 (``out`` the head's width, H for a head-less stack), and the
    backward: unchunked every step's :func:`train_step_bytes`; chunked the
    boundary states and one chunk's steps."""
    k = (train_chunk(t, n, hidden, cell, itemsize, num_layers, stash_budget)
         if time_chunk is None else time_chunk)
    stash, per_step = train_step_bytes(n, hidden, cell, itemsize, num_layers)
    io = 2 * t * n * unit * itemsize + 2 * t * n * out * 4
    if k == 0:
        return io + t * per_step
    return io + (-(-t // k) - 1) * stash + min(k, t) * per_step


# the chunk each training call took, by chunk (0: the full stash); the
# smoke reads it beside the kernels' launch counts
train_chunks: collections.Counter = collections.Counter()


def _k1_stack(ws, bs, wfc, bfc, f_in: int, lstm: bool):
    """K2's operands (:func:`prep_weights` in the compute dtype) as the
    layer dicts and head K1's stages read (:func:`forward_stages`): W_ih and
    W_hh in PyTorch's layout; the LSTM's bias pair already summed (b_hh
    zero: adding it again is exact), the GRU's kept apart. So the chunked
    forward computes on K2's weights, rounded as K2 rounds them."""
    layers, in_dim = [], f_in
    for w, b in zip(ws, bs):
        b_ih, b_hh = (b, torch.zeros_like(b)) if lstm else (b[0], b[1])
        layers.append({"w_ih": w[:in_dim].t().contiguous(), "w_hh": w[in_dim:].t().contiguous(),
                       "b_ih": b_ih, "b_hh": b_hh})
        in_dim = w.shape[0] - in_dim
    return layers, None if wfc is None else {"weight": wfc.t().contiguous(), "bias": bfc}


def boundary_forward(x, layers, fc, chunk: int):
    """The chunked training forward (K2's ``boundary_chunk`` mode): K1's
    stages (:func:`forward_stages`) chunk by chunk of ``chunk`` steps,
    each layer's fp32 (h, c) carried over every boundary, so that the output
    is one uninterrupted pass's; the kernels on a CUDA tensor (K1 at fp32,
    K1-bf16 at bf16), their plain versions on a CPU tensor. Returns (out
    [T, N, OUT] fp32, per layer the states entering chunks 1 .. C-1 as
    (h [C-1, N, H], c or None) rounded to x's dtype, as ``_kernel_train_fwd``
    writes its boundary stash)."""
    t, n, _ = x.shape
    hidden, cell = _cell_of(layers[0])
    lstm = cell == "lstm"
    bf16 = x.dtype == torch.bfloat16
    if _device_of(x) == "cpu":
        gemm, walk = (plain_tc_gemm if bf16 else plain_fwd_gemm), _plain_walk(layers, x.dtype)
    else:
        gemm, walk = (tc_gemm if bf16 else fwd_gemm), _kernel_walk(layers, x.dtype)
    chunks = -(-t // chunk)
    bounds = [(x.new_empty(chunks - 1, n, hidden), x.new_empty(chunks - 1, n, hidden) if lstm
               else None) for _ in layers]
    states, outs = None, []
    for j in range(chunks):
        out, states = forward_stages(gemm, walk, x[j * chunk : (j + 1) * chunk], layers, fc,
                                     chunk, states)
        outs.append(out)
        if j + 1 < chunks:
            for (bh, bc), (h, c) in zip(bounds, states):
                bh[j] = h
                if lstm:
                    bc[j] = c
    return (outs[0] if chunks == 1 else torch.cat(outs)), bounds


class ChunkedRnnScanFunction(torch.autograd.Function):
    """:class:`RnnScanFunction` with the time-chunked stash (the counterpart
    of ``_train_vjp_fn`` with a chunk and ``_bwd_chunked``). ``apply(x,
    num_layers, chunk, *params)``; the same output.

    forward: :func:`boundary_forward` on K2's weights; it saves x and the
    states entering each chunk, and no stash.
    backward: the chunks last to first. Each re-runs the training forward
    (K2 or K2-GRU, :func:`stash_forward`) over its steps from the states
    entering it (zeros for the first chunk), takes the head backward on its
    top h stash, and runs each layer's backward (K3 or K4) from the carries
    (dh, dc) that the chunk after it handed back, and its dW stage with the
    chunk's h0. dW and db are summed in fp32 over the chunks and cast once;
    dW_fc likewise, db_fc from the whole fp32 cotangent. A last chunk
    shorter than the others stands for the JAX package's zero-padded tail,
    whose cotangent is 0."""

    @staticmethod
    def forward(ctx, x, num_layers, chunk, *params):
        layers, fc = _stack_from_flat(params, num_layers)
        lstm = _cell_of(layers[0])[1] == "lstm"
        ws, bs, wfc, bfc = prep_weights(layers, fc, x.dtype)
        out, bounds = boundary_forward(x, *_k1_stack(ws, bs, wfc, bfc, x.shape[2], lstm), chunk)
        ctx.num_layers, ctx.num_params, ctx.chunk, ctx.lstm = num_layers, len(params), chunk, lstm
        head = () if wfc is None else (wfc, bfc)
        ctx.save_for_backward(x, *params, *ws, *bs, *head,
                              *(v for pair in bounds for v in pair if v is not None))
        return out

    @staticmethod
    def backward(ctx, g):
        num_layers, num_params, chunk, lstm = ctx.num_layers, ctx.num_params, ctx.chunk, ctx.lstm
        x, *rest = ctx.saved_tensors
        params = rest[:num_params]
        ws = rest[num_params : num_params + num_layers]
        bs = rest[num_params + num_layers : num_params + 2 * num_layers]
        layers, fc = _stack_from_flat(params, num_layers)
        saved = rest[num_params + 2 * num_layers :]
        wfc, bfc = (None, None) if fc is None else saved[:2]
        saved = saved[0 if fc is None else 2 :]
        bh, bc = (saved[0::2], saved[1::2]) if lstm else (saved, [None] * num_layers)
        wts = [w.t().contiguous() for w in ws]
        t, n, _ = x.shape
        hidden = layers[0]["w_hh"].shape[1]
        zeros = x.new_zeros(n, hidden)
        dh_in = [torch.zeros((n, hidden), device=x.device, dtype=torch.float32)] * num_layers
        dc_in = list(dh_in)
        acc, dfc_w = [None] * num_layers, None
        dx = torch.empty_like(x)
        for j in reversed(range(-(-t // chunk))):
            steps = slice(j * chunk, (j + 1) * chunk)
            x_c = x[steps]
            h0s = [zeros if j == 0 else bh[li][j - 1] for li in range(num_layers)]
            c0s = [zeros if j == 0 or not lstm else bc[li][j - 1] for li in range(num_layers)]
            if lstm:
                _, hs, cs = stash_forward(x_c, ws, bs, wfc, bfc, h0s, c0s)
            else:
                (_, hs), cs = stash_forward(x_c, ws, bs, wfc, bfc, h0s), [None] * num_layers
            dh, dfc_c = _head_backward(g[steps], hs[-1], fc, x.dtype)
            if dfc_c is not None:
                dfc_w = dfc_c if dfc_w is None else dfc_w + dfc_c
            for li in reversed(range(num_layers)):
                dh, dh_in[li], dc_in[li], grads_w = _layer_backward_and_grads(
                    lstm, dh, x_c if li == 0 else hs[li - 1], hs[li], cs[li], ws[li], wts[li],
                    bs[li], h0s[li], c0s[li], dh_in[li], dc_in[li])
                acc[li] = list(grads_w) if acc[li] is None else [
                    a + v for a, v in zip(acc[li], grads_w)]
                hs[li] = cs[li] = None  # the layer above is done: one chunk's stash at a time
            dx[steps] = dh
        grads = [v for li in range(num_layers) for v in _layer_param_grads(layers[li], acc[li])]
        return (dx, None, None, *grads, *_head_param_grads(g, dfc_w, fc))


# ---------------------------------------------------------------------------
# the inference forward as stages (K1, K1-GRU): csrc/rnn_fwd.cu
# ---------------------------------------------------------------------------

FWD_CTAS = 16  # CTAs of one cluster of the walk; CTA k owns units [k H/16, (k + 1) H/16)
FWD_SLICES = 4  # K slices of the walk's product: G·H/4 threads a CTA
FWD_MAX_THREADS = 512
FWD_ROWS = (1, 2, 4, 8, 16, 32, 40)  # rows one cluster walks: the instances built
FWD_WIDE_ROWS = 16  # from this many rows (KR = 0) a thread takes 4 columns: 4 | G·H/16
FWD_REG_ROWS = 48  # rows of each K slice of W_hh^T that a thread holds in registers
# The fp32 input projections of one chunk, P [Tc, N, G·H], stay under this
# many bytes of the card's 80 GB, beside the model's own tensors (at
# B = 128 x 30 s the unfolded sub-band input is 7.9 GB fp32, and the model
# holds several such). The sub-band stage there (N = 32,896, T = 1,878)
# costs 202 MB of P a step (a whole-T P: 379 GB), so Tc = 21 steps.
FWD_P_BUDGET = 4 << 30


class FwdKernelLibrary:
    """The library of the inference forward's two kernels, the GEMM and the
    walk (csrc/rnn_fwd.cu), built at first use and loaded with ctypes."""

    SOURCES = (CSRC / "rnn_fwd.cu",)
    NAME = "fsn_rnn_fwd"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_fwd_gemm.argtypes = [ptr] * 6 + [i] * 8 + [ptr]
            lib.fsn_fwd_gemm.restype = i
            lib.fsn_rnn_fwd_walk.argtypes = [i] + [ptr] * 10 + [i] * 5 + [ptr]
            lib.fsn_rnn_fwd_walk.restype = i
            lib.fsn_rnn_fwd_max_clusters.argtypes = [i] * 5 + [ctypes.POINTER(i)]
            lib.fsn_rnn_fwd_max_clusters.restype = i
            lib.fsn_rnn_fwd_walk_bf16.argtypes = [i] + [ptr] * 9 + [i] * 4 + [ptr]
            lib.fsn_rnn_fwd_walk_bf16.restype = i
            lib.fsn_rnn_fwd_max_clusters_bf16.argtypes = [i] * 3 + [ctypes.POINTER(i)]
            lib.fsn_rnn_fwd_max_clusters_bf16.restype = i
            lib.fsn_rnn_fwd_error_string.argtypes = [i]
            lib.fsn_rnn_fwd_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


fwd_library = FwdKernelLibrary()


def fwd_walk_threads(hidden: int, cell: str) -> int:
    """Threads of one walk CTA: a column of its G·H/16 and a K slice each."""
    return FWD_SLICES * _GATES[cell] * (hidden // FWD_CTAS)


def fwd_walk_smem_bytes(rows: int, hidden: int, cell: str, kr: int,
                        dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one walk CTA (rnn_fwd.cu, walk_smem): its
    columns of W_hh^T beyond the ``kr`` rows of each K slice held in
    registers, the gathered h_{t-1} [rows, H] (afterwards the fp32 partial
    sums, [4, rows, G·H/16]), its h slice by step parity, P_t of its
    columns and, for a GRU, their b_hh. W_hh^T, the gathered h and the slice
    in ``dtype`` (K1-bf16: bf16), the rest fp32."""
    gates = _GATES[cell]
    hc = hidden // FWD_CTAS
    cols = gates * hc
    kl = hidden // FWD_SLICES
    size = torch.finfo(dtype).bits // 8
    h_bytes = max(size * rows * hidden, 4 * FWD_SLICES * rows * cols)
    return (size * (FWD_SLICES * (kl - kr) * cols + 2 * rows * hc) + h_bytes
            + 4 * (rows * cols + (cols if cell == "gru" else 0)))


def fwd_walk_kr(rows: int, hidden: int, cell: str,
                dtype: torch.dtype = torch.float32) -> int | None:
    """Rows of each K slice of W_hh^T held in registers: 0 where the CTA's
    columns fit in shared memory beside ``rows`` rows, else
    :data:`FWD_REG_ROWS` (the fp32 LSTM at H = 512: 256 KB of W_hh^T a
    CTA); None where neither fits. The bf16 instances hold none in
    registers (the bf16 LSTM's W_hh^T at H = 512 takes 128 KB a CTA). A wide
    tile without registers gives each thread 4 of the CTA's G·H/16 columns,
    which 4 must divide."""
    wide_ok = rows < FWD_WIDE_ROWS or _GATES[cell] * (hidden // FWD_CTAS) % 4 == 0
    for kr in (0,) if dtype == torch.bfloat16 else (0, FWD_REG_ROWS):
        if ((kr or wide_ok) and kr <= hidden // FWD_SLICES
                and fwd_walk_smem_bytes(rows, hidden, cell, kr, dtype) <= _MAX_SMEM_BYTES):
            return kr
    return None


# ---------------------------------------------------------------------------
# K1-bf16's tensor-core walk (csrc/rnn_fwd_tc.cu) and the picker of the bf16
# walk's three forms
# ---------------------------------------------------------------------------

FWD_TC_HIDDEN = (128, 256, 384, 512)  # the instances built: 8 units of a CTA per 128
FWD_TC_ROWS = tuple(range(16, 129, 16))  # rows of a tile: 1 to 8 m-tiles of 16
# the cost of a tile at a step, in rows of its product and gather
# (fwd_tc_plan): a fixed part (its syncs, latencies and its share of the
# cluster barrier) and its rows, each row dearer by FWD_TC_ONE_SLICE_COST
# where the product runs in one K slice (80 rows and more at H = 384);
# fitted to the tile sweep of smoke phase 25 (PERF.md §6)
FWD_TC_TILE_COST_ROWS = 25
FWD_TC_ONE_SLICE_COST = 1.2
# the bf16 walk's forms by rows (pick_fwd_bf16_form) where the tensor-core
# walk takes H: by (H, cell), (most rows, form) in order of rows, the last
# for any N (None). Each bound is the last N of smoke phase 25's form sweep
# (a grid 2^(1/4) apart, T = 200) at which that form was the fastest, with
# single points where the forms ran within a few per cent of each other
# merged into their neighbours. The tensor-core walk loses to the cluster
# walk below 14-16 rows (8 for the GRU at H = 512); the streaming walk's
# cost rises by a wave at each 132 blocks of 32 rows (4,224), the
# tensor-core walk's by a wave of 7 clusters, so at H = 384 they trade
# places twice. At H = 128 the tensor-core walk's time varied by up to 2x
# between runs; the GRU's there is never picked. For an H the tensor-core
# walk does not take, the streaming walk past FWD_BF16_STREAM_WAVES waves of
# the cluster walk
FWD_BF16_FORM_BOUNDS = {
    (128, "lstm"): ((256, "cluster"), (512, "tc"), (None, "streaming")),
    (128, "gru"): ((215, "cluster"), (None, "streaming")),
    (256, "lstm"): ((54, "cluster"), (861, "tc"), (None, "streaming")),
    (256, "gru"): ((54, "cluster"), (1218, "tc"), (None, "streaming")),
    (384, "lstm"): ((13, "cluster"), (2896, "tc"), (4096, "streaming"), (5793, "tc"),
                    (None, "streaming")),
    (384, "gru"): ((13, "cluster"), (2896, "tc"), (4096, "streaming"), (6889, "tc"),
                   (None, "streaming")),
    (512, "lstm"): ((13, "cluster"), (1722, "tc"), (4096, "streaming"), (4871, "tc"),
                    (None, "streaming")),
    (512, "gru"): ((7, "cluster"), (None, "tc")),
}
FWD_BF16_STREAM_WAVES = 2


class FwdTcKernelLibrary:
    """The library of K1-bf16's tensor-core walk (csrc/rnn_fwd_tc.cu), built
    at first use and loaded with ctypes."""

    SOURCES = (CSRC / "rnn_fwd_tc.cu", CSRC / "mma_common.cuh",
               CSRC / "lstm_train_common.cuh")
    NAME = "fsn_rnn_fwd_tc"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_rnn_fwd_walk_tc_bf16.argtypes = [i] + [ptr] * 9 + [i] * 5 + [ptr]
            lib.fsn_rnn_fwd_walk_tc_bf16.restype = i
            lib.fsn_rnn_fwd_max_clusters_tc_bf16.argtypes = [i] * 4 + [ctypes.POINTER(i)]
            lib.fsn_rnn_fwd_max_clusters_tc_bf16.restype = i
            lib.fsn_rnn_fwd_tc_error_string.argtypes = [i]
            lib.fsn_rnn_fwd_tc_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


fwd_tc_library = FwdTcKernelLibrary()


def fwd_tc_slice_pitch(hidden: int) -> int:
    """The row pitch (bf16 elements) of a CTA's h slice in the tensor-core
    walk: its H/16 units rounded up to an odd number of 16-byte chunks."""
    chunks = hidden // FWD_CTAS // 8
    return 8 * (chunks if chunks % 2 else chunks + 1)


def fwd_tc_ksplit(rows: int, hidden: int) -> int:
    """K slices of the tensor-core walk's product (rnn_fwd_tc.cu,
    tc_ksplit): 4, 2 or 1, the most that keep a CTA at 16 warps, a warp for
    each pair of m-tiles, 8 of the CTA's H/16 units and K slice."""
    warps = -(-(rows // 16) // 2) * (hidden // 128)
    return 4 if warps * 4 <= 16 else 2 if warps * 2 <= 16 else 1


def fwd_tc_smem_bytes(rows: int, tiles: int, hidden: int, cell: str) -> int:
    """Dynamic shared memory of a CTA of the tensor-core walk
    (rnn_fwd_tc.cu, tc_smem) at ``rows`` rows a tile and ``tiles`` tiles a
    cluster: its W_hh rows [G·H/16, H] bf16; a tile buffer (two when the
    cluster has more than one tile) that holds the gathered h_{t-1}
    [rows, H] bf16 and then the product's fp32 partial sums [K slices,
    rows, G·H/16 + 8]; two P tiles [2, rows, G·H/16] fp32; the fp32 carry
    of its units [tiles, rows, H/16]; its h slices [2, tiles, rows, pitch]
    bf16 (:func:`fwd_tc_slice_pitch`); for a GRU its b_hh [G·H/16] fp32."""
    gates = _GATES[cell]
    hc = hidden // FWD_CTAS
    buf = rows * max(2 * hidden, 4 * fwd_tc_ksplit(rows, hidden) * (gates * hc + 8))
    return (2 * (gates * hc * hidden + 2 * tiles * rows * fwd_tc_slice_pitch(hidden))
            + (2 if tiles > 1 else 1) * buf
            + 4 * (2 * rows * gates * hc + tiles * rows * hc + (0 if cell == "lstm" else gates * hc)))


def fwd_tc_takes(hidden: int, cell: str) -> bool:
    """Whether the tensor-core walk takes H: one of :data:`FWD_TC_HIDDEN`
    (its 16-row tile then fits in shared memory)."""
    return hidden in FWD_TC_HIDDEN and fwd_tc_smem_bytes(16, 1, hidden, cell) <= _MAX_SMEM_BYTES


def fwd_tc_max_tiles(rows: int, hidden: int, cell: str) -> int:
    """The most tiles of ``rows`` rows a cluster of the tensor-core walk
    holds (its h slices of every tile beside two gather buffers; one tile
    with one buffer), 0 where not even that fits."""
    if fwd_tc_smem_bytes(rows, 1, hidden, cell) > _MAX_SMEM_BYTES:
        return 0
    tiles = 1
    while fwd_tc_smem_bytes(rows, tiles + 1, hidden, cell) <= _MAX_SMEM_BYTES:
        tiles += 1
    return tiles


def fwd_tc_plan(n: int, hidden: int, cell: str, max_clusters) -> tuple[int, int]:
    """(rows a tile, tiles a cluster) of the tensor-core walk for N rows.
    ``max_clusters``: the clusters the card runs at once, or a function of
    the rows a tile that gives it. For each tile of :data:`FWD_TC_ROWS` that
    fits, each cluster takes ceil(tiles / clusters) tiles, as many as fit
    (a later wave of clusters takes the rest); the plan of least cost wins:
    waves x tiles a cluster x (:data:`FWD_TC_TILE_COST_ROWS` + rows, times
    :data:`FWD_TC_ONE_SLICE_COST` where the product has one K slice), the
    fewer tiles a cluster on a tie. A tile costs about as much in a band as
    alone, so the plan runs a wave of single tiles as small as covers N,
    and past one wave of the tiles that fit best more waves or a band,
    whichever is cheaper."""
    best = None
    for rows in FWD_TC_ROWS:
        most = fwd_tc_max_tiles(rows, hidden, cell)
        if not most:
            continue
        clusters = max(1, max_clusters(rows) if callable(max_clusters) else max_clusters)
        tiles = -(-n // rows)
        per = min(-(-tiles // clusters), most)
        waves = -(-(-(-tiles // per)) // clusters)
        row_cost = FWD_TC_ONE_SLICE_COST if fwd_tc_ksplit(rows, hidden) == 1 else 1.0
        cost = waves * per * (FWD_TC_TILE_COST_ROWS + rows * row_cost)
        if best is None or (cost, per) < best[0]:
            best = ((cost, per), rows, per)
    if best is None:
        raise ValueError(f"no tile of the tensor-core walk fits {cell} H = {hidden}")
    return best[1], best[2]


def pick_fwd_bf16_form(n: int, hidden: int, cell: str, max_clusters) -> tuple[str, int]:
    """(form, rows) of K1-bf16's walk for N rows, a pure function of the
    shape and the clusters the card runs at once. ``max_clusters``: that
    count, or a function of (form, rows a tile or cluster) that gives it for
    the form's instance ("tc": ``cudaOccupancyMaxActiveClusters`` of the
    tensor-core walk at one tile a cluster, "cluster": of the cluster
    walk). Where the tensor-core walk takes H: "cluster", ``csrc/rnn_fwd.cu``'s
    walk at bf16 (rows a cluster, :func:`pick_fwd_tile`); "tc", the
    tensor-core walk (``csrc/rnn_fwd_tc.cu``; rows of a tile,
    :func:`fwd_tc_plan`); "streaming", the inference form of
    ``csrc/rnn_train_fwd_tc.cu``'s walk (rows a block,
    :func:`pick_train_walk_tile`); each over the rows
    :data:`FWD_BF16_FORM_BOUNDS` gives it for (H, cell). For another H: the cluster walk,
    or the streaming walk past :data:`FWD_BF16_STREAM_WAVES` waves of it
    where H is a multiple of 4 up to 512. Measured by smoke phase 25's
    form sweep on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6), µs a
    step of one layer at T = 200, cluster / tc / streaming: H = 384 LSTM,
    N = 13 4.11 / 4.32 / 40.1, N = 16 5.42 / 4.04 / 40.4, N = 2,896 tc
    49.1 against streaming 54.0, N = 3,444 54.8 / 54.7, N = 4,096 67.8 /
    55.0, N = 4,871 76.7 / 107.5, N = 6,889 109.1 / 108.9; H = 384 GRU,
    N = 13 3.45 / 3.84 / 32.1, N = 16 4.54 / 4.00 / 32.1, N = 2,896 38.4 /
    43.9, N = 4,096 57.8 / 46.1, N = 4,871 72.6 / 86.1, N = 8,192 104.9 /
    90.5; H = 512 LSTM, N = 16 6.92 / 4.57 / 67.1, N = 1,722 68.1 / 67.5,
    N = 2,048 76.4 / 69.6, N = 4,871 171.2 / 182.4, N = 5,793 205.6 /
    180.6 (16-row tiles, 3 a cluster, fit there); H = 512 GRU, N = 7 3.47 /
    4.53, N = 8 4.98 / 4.60, N = 8,224 tc 139.9 against streaming 153.9."""
    def clusters(form: str, rows: int) -> int:
        return max_clusters(form, rows) if callable(max_clusters) else max_clusters

    if fwd_tc_takes(hidden, cell):
        form = next(f for most, f in FWD_BF16_FORM_BOUNDS[hidden, cell]
                    if most is None or n <= most)
    else:
        streams = hidden % 4 == 0 and hidden <= TRAIN_WALK_MAX_HIDDEN
        fits = [(r, kr) for r in FWD_ROWS
                if (kr := fwd_walk_kr(r, hidden, cell, torch.bfloat16)) is not None]
        form = ("streaming" if streams and (not fits or -(-n // fits[-1][0])
                > FWD_BF16_STREAM_WAVES * clusters("cluster", fits[-1][0])) else "cluster")
    if form == "tc":
        return "tc", fwd_tc_plan(n, hidden, cell, lambda rows: clusters("tc", rows))[0]
    if form == "streaming":
        return "streaming", pick_train_walk_tile(n, cell, hidden)[0]
    return "cluster", pick_fwd_tile(n, hidden, cell, lambda r, kr: clusters("cluster", r),
                                    torch.bfloat16)[0]


def _fwd_walk_takes(hidden: int, cell: str) -> bool:
    """Whether the cluster walk takes H: a multiple of 16 with at most 512
    threads a CTA (its 1-row tile then fits in shared memory)."""
    return (hidden >= FWD_CTAS and hidden % FWD_CTAS == 0
            and fwd_walk_threads(hidden, cell) <= FWD_MAX_THREADS)


def _check_fwd_hidden(hidden: int, cell: str) -> None:
    if not _fwd_walk_takes(hidden, cell):
        raise ValueError(
            f"the forward walk takes H a multiple of {FWD_CTAS} with "
            f"{FWD_SLICES}·G·H/{FWD_CTAS} <= {FWD_MAX_THREADS} threads a CTA; got H = {hidden} "
            f"({cell})"
        )


def pick_fwd_tile(n: int, hidden: int, cell: str, max_clusters,
                  dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(rows a cluster walks, KR) of the forward walk for N rows.
    ``max_clusters`` is the count of clusters the card runs at once, or a
    function of (rows, KR) that gives it (``cudaOccupancyMaxActiveClusters``
    of that instance). The smallest tile of :data:`FWD_ROWS` that fits and
    walks every row in one wave; where none does, the largest that fits
    (fewest waves). A step's product grows with the rows while the exchange
    does not, so one wave of small tiles beats one cluster of many rows.
    ``dtype``: the walk's storage type (its instances' shared memory)."""
    _check_fwd_hidden(hidden, cell)
    fits = [(r, kr) for r in FWD_ROWS
            if (kr := fwd_walk_kr(r, hidden, cell, dtype)) is not None]
    if not fits:
        raise ValueError(f"no walk tile fits {cell} H = {hidden} in shared memory")
    for rows, kr in fits:
        clusters = max_clusters(rows, kr) if callable(max_clusters) else max_clusters
        if -(-n // rows) <= clusters:
            return rows, kr
    return fits[-1]


def fwd_chunk_steps(t: int, n: int, hidden: int, cell: str) -> int:
    """Steps of one chunk of the forward: as many as keep P [Tc, N, G·H]
    fp32 under :data:`FWD_P_BUDGET` bytes, at least one."""
    return max(1, min(t, FWD_P_BUDGET // (4 * n * _GATES[cell] * hidden)))


def plain_fwd_gemm(a, b, bias=None, out=None, prev=None, head=None):
    """Plain PyTorch version of :data:`fwd_gemm`: ``a · bᵀ + bias`` with b
    a weight in PyTorch's [out, in] layout, fp32; written into ``out``
    where given. With ``prev`` and ``head`` A is ``[a | a_prev]`` as in
    :func:`plain_tc_gemm`: a_prev's row m is head[m] for m < S, else
    prev[m - S]."""
    if prev is not None:
        a = torch.cat([a, _shifted(prev, head, a.shape[0])], dim=1)
    res = a @ b.t()
    if bias is not None:
        res = res + bias
    if out is None:
        return res
    return out.copy_(res)


def plain_lstm_fwd_walk(p, w_hh, h0, c0, stash: bool = False):
    """Plain PyTorch version of :data:`lstm_fwd_walk` and of
    :data:`lstm_train_walk_f32`: from the input projections p [T, N, 4H]
    (both biases included) and (h0, c0) [N, H], the LSTM cell over T steps
    with h · W_hh^T (w_hh [4H, H]). Returns (h stream [T, N, H], h_T, c_T)
    or, with ``stash`` (the training forward), the h and c streams, whose
    last steps are the state after the walk."""
    h, c = h0, c0
    hs, cs = [], []
    for step in range(p.shape[0]):
        h, c = lstm_step(w_hh.t(), h, c, p[step])
        hs.append(h)
        cs.append(c)
    if stash:
        return torch.stack(hs), torch.stack(cs)
    return torch.stack(hs), h, c


def plain_gru_fwd_walk(p, w_hh, b_hh, h0, stash: bool = False):
    """Plain PyTorch version of :data:`gru_fwd_walk` and of
    :data:`gru_train_walk_f32`: from the input projections p [T, N, 3H]
    (with b_ih only) and h0 [N, H], the GRU cell over T steps, b_hh added
    to h · W_hh^T (w_hh [3H, H]) because the reset gate scales
    W_hn h + b_hn. Returns (h stream [T, N, H], h_T) or, with ``stash`` (the
    training forward), the h stream alone: the GRU's stash."""
    h = h0
    hs = []
    for step in range(p.shape[0]):
        h = gru_step(w_hh.t(), b_hh, h, p[step])
        hs.append(h)
    if stash:
        return torch.stack(hs)
    return torch.stack(hs), h


def plain_lstm_fwd_walk_bf16(p, w_hh, h0, c0):
    """Plain PyTorch version of :data:`lstm_fwd_walk_bf16`, with its
    roundings (the JAX kernel's ``_lstm_step`` at bf16): from the input
    projections p [T, N, 4H] (fp32, both biases included), w_hh [4H, H] bf16
    and the fp32 state (h0, c0) [N, H], the LSTM cell over T steps with h
    rounded to bf16 in h · W_hh^T, the sums and c in fp32. Returns (h stream
    [T, N, H] bf16, h_T, c_T fp32)."""
    w = w_hh.float().t()
    h, c = h0.float(), c0.float()
    hs = []
    for step in range(p.shape[0]):
        i, f, g, o = (p[step] + _round(h, torch.bfloat16) @ w).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs).to(torch.bfloat16), h, c


def plain_gru_fwd_walk_bf16(p, w_hh, b_hh, h0):
    """Plain PyTorch version of :data:`gru_fwd_walk_bf16`, with its
    roundings (``_gru_step`` at bf16): from p [T, N, 3H] (fp32, b_ih only),
    w_hh [3H, H] bf16, b_hh [3H] and h0 [N, H] fp32, the GRU cell over T
    steps on an fp32 h carry, h · W_hh^T from h rounded to bf16, b_hh added
    to it. Returns (h stream [T, N, H] bf16, h_T fp32)."""
    hidden = h0.shape[-1]
    w = w_hh.float().t()
    h = h0.float()
    hs = []
    for step in range(p.shape[0]):
        hw = _round(h, torch.bfloat16) @ w + b_hh
        r, z = torch.sigmoid(p[step, :, : 2 * hidden] + hw[:, : 2 * hidden]).chunk(2, -1)
        n = torch.tanh(p[step, :, 2 * hidden :] + r * hw[:, 2 * hidden :])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs).to(torch.bfloat16), h


def _fwd_weights(layers, fc, dtype: torch.dtype):
    """The stack's weights as K1's stages read them: per layer (the GEMM's
    B, W_hh, the GEMM's bias, b_hh), and the head's (B, bias, OUT) or None.
    At fp32 as they are, B in PyTorch's [out, in] layout (:data:`fwd_gemm`);
    the LSTM's GEMM adds b_ih + b_hh, the GRU's b_ih alone (the reset gate
    scales W_hn h + b_hn). At bf16 (K1-bf16, the JAX kernel's
    ``_prep_weights`` at a bf16 ``compute_dtype``): W_ih^T [in, G·H] and W_fc^T
    [H, OUT] for :data:`tc_gemm` and W_hh, rounded to bf16, the head's
    columns zero-padded to a multiple of 8 (its 16-byte loads); the biases
    fp32, the LSTM's pair summed in the parameters' dtype first."""
    lstm = _cell_of(layers[0])[1] == "lstm"
    biases = [l["b_ih"] + l["b_hh"] if lstm else l["b_ih"] for l in layers]
    if dtype != torch.bfloat16:
        weights = [(l["w_ih"], l["w_hh"], b, l["b_hh"]) for l, b in zip(layers, biases)]
        return weights, None if fc is None else (fc["weight"], fc["bias"], fc["weight"].shape[0])
    bf16 = torch.bfloat16
    weights = [(l["w_ih"].t().to(bf16).contiguous(), l["w_hh"].to(bf16).contiguous(),
                b.float(), l["b_hh"].float()) for l, b in zip(layers, biases)]
    if fc is None:
        return weights, None
    out_dim = fc["weight"].shape[0]
    pad = _round_up(out_dim, 8) - out_dim
    head = (F.pad(fc["weight"].t().to(bf16), (0, pad)).contiguous(),
            F.pad(fc["bias"].float(), (0, pad)), out_dim)
    return weights, head


def forward_stages(gemm, walk, x, layers, fc, chunk: int | None = None, states=None):
    """K1 / K1-GRU as stages, chunk by chunk of ``chunk`` steps (default
    :func:`fwd_chunk_steps`): within a chunk GEMM(x) -> walk 0 -> GEMM(h^0)
    -> walk 1 ... -> the head GEMM; the chunks' outputs are joined at the
    end, and each layer's (h, c) carries into the next chunk, in fp32.
    ``gemm`` and ``walk`` (the stack's cell) are the kernels, their plain
    versions or the registered operators, of x's type: x [T, N, F] fp32
    (K1: :data:`fwd_gemm`, which reads the weights in PyTorch's layout) or
    bf16 (K1-bf16: :data:`tc_gemm` and the bf16 walk, on the weights as
    :func:`_fwd_weights` rounds them) -> ([T, N, OUT] fp32, the final
    states); ``fc`` None (a head-less stack): no head GEMM, the top layer's
    h [T, N, H] in fp32. ``states``: per layer (h0, c0) [N, H] fp32 to start
    from (a GRU's c0 None), zeros by default; the final states come back in
    that form."""
    t, n, _ = x.shape
    hidden, cell = _cell_of(layers[0])
    lstm = cell == "lstm"
    steps = chunk or fwd_chunk_steps(t, n, hidden, cell)
    weights, head = _fwd_weights(layers, fc, x.dtype)
    if states is None:
        zeros = x.new_zeros(n, hidden, dtype=torch.float32)
        states = [(zeros, zeros if lstm else None)] * len(layers)
    states = list(states)
    outs = []
    for t0 in range(0, t, steps):
        tc = min(steps, t - t0)
        seq = x[t0 : t0 + tc].reshape(tc * n, -1)
        for li, (w_in, w_hh, bias, b_hh) in enumerate(weights):
            p = gemm(seq, w_in, bias).view(tc, n, -1)
            if lstm:
                hseq, h, c = walk(p, w_hh, *states[li])
                states[li] = (h, c)
            else:
                hseq, h = walk(p, w_hh, b_hh, states[li][0])
                states[li] = (h, None)
            del p  # one layer's P alive at a time
            seq = hseq.view(tc * n, hidden)
        if head is None:
            outs.append(hseq.float())
        else:
            outs.append(gemm(seq, head[0], head[1])[:, : head[2]].reshape(tc, n, -1))
    # functional (no write into a slice of the output), so that torch.export
    # traces the registered operators; one chunk needs no copy
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), states


def plain_fused_forward(x, layers, fc, chunk: int | None = None):
    """The plain stages composed as :func:`fused_forward` composes the
    kernels: at fp32 equal to :func:`plain_fused_subband_lstm` (or ``_gru``)
    up to the order of fp32 sums; at bf16 the plain version of K1-bf16
    (:func:`plain_tc_gemm` and :func:`plain_lstm_fwd_walk_bf16` /
    :func:`plain_gru_fwd_walk_bf16`)."""
    gemm = plain_tc_gemm if x.dtype == torch.bfloat16 else plain_fwd_gemm
    return forward_stages(gemm, _plain_walk(layers, x.dtype), x, layers, fc, chunk)[0]


def fused_forward(x, layers, fc, chunk: int | None = None):
    """K1 / K1-GRU on the card: :data:`fwd_gemm` and the cell's walk, chunk
    by chunk; at bf16 K1-bf16 (:data:`tc_gemm` and the bf16 walk, an input
    width that is a multiple of :data:`TC_INPUT_MULTIPLE` for the GEMM's
    16-byte loads). x [T, N, F] fp32 or bf16 on a CUDA device, contiguous."""
    gemm = tc_gemm if x.dtype == torch.bfloat16 else fwd_gemm
    return forward_stages(gemm, _kernel_walk(layers, x.dtype), x, layers, fc, chunk)[0]


def _plain_walk(layers, dtype: torch.dtype = torch.float32):
    lstm = _cell_of(layers[0])[1] == "lstm"
    if dtype == torch.bfloat16:
        return plain_lstm_fwd_walk_bf16 if lstm else plain_gru_fwd_walk_bf16
    return plain_lstm_fwd_walk if lstm else plain_gru_fwd_walk


def _kernel_walk(layers, dtype: torch.dtype = torch.float32):
    lstm = _cell_of(layers[0])[1] == "lstm"
    if dtype == torch.bfloat16:
        return lstm_fwd_walk_bf16 if lstm else gru_fwd_walk_bf16
    return lstm_fwd_walk if lstm else gru_fwd_walk


def step_stages(gemm, walk, x, layers, fc, states, width: int):
    """The stack from a carried state, as :func:`forward_stages` composes
    ``gemm`` and ``walk`` (the kernels or their plain versions), run at
    ``width`` units: where that is above the stack's H (the walks' grid,
    :func:`padded_hidden`) the stack is zero-padded (:func:`_cached_pad`)
    and so are the states into the walks, and both are cut back after. A
    padded unit stays 0 from a zero state, so this is exact, and the carried
    state keeps the stack's true H on either device. x [T, N, F] fp32 (K1)
    or bf16 (K1-bf16, the states fp32 all the same);
    ``states`` per layer (h, c) for an LSTM, h for a GRU, each [N, H]
    (:func:`fullsubnet_tpu_torch.nn.rnn.rnn_init_state`), or None for zero
    states. Returns ([T, N, OUT] fp32 (a head-less stack: the top h [T, N,
    H]), the final states in the same form)."""
    hidden, cell = _cell_of(layers[0])
    lstm = cell == "lstm"
    pad = width - hidden
    if pad:
        layers, fc = _cached_pad(layers, fc, width)
    widen = (lambda v: F.pad(v, (0, pad))) if pad else torch.Tensor.contiguous  # noqa: E731
    into = None if states is None else [
        (widen(st[0]), widen(st[1])) if lstm else (widen(st), None) for st in states]
    out, final = forward_stages(gemm, walk, x, layers, fc, states=into)
    final = [(h[:, :hidden], c[:, :hidden]) if lstm else h[:, :hidden] for h, c in final]
    if pad and fc is None:
        out = out[..., :hidden]
    return out, final


def fused_subband_lstm_step(x: torch.Tensor, *layers_and_fc: dict, states):
    """The stateful form of :func:`fused_subband_lstm` for the streaming
    engines: x [T, N, F] and the stack's carried ``states`` (per layer
    (h, c) for an LSTM, h for a GRU, [N, H]) -> (out [T, N, OUT] float32 or
    the top h [T, N, H] head-less, the final states). Through the registered
    operators (:func:`_op_stages`): a CPU tensor runs the plain stages; a
    CUDA tensor :data:`fwd_gemm` and the cell's walk (K1 / K1-GRU) from the
    carried state, at :func:`padded_hidden` units (:func:`step_stages`). No
    autograd path: call it under ``torch.inference_mode()`` or
    ``torch.no_grad()``."""
    layers, fc = tuple(layers_and_fc[:-1]), layers_and_fc[-1]
    _check_stack(x, layers, fc)
    return _op_stages(x, layers, fc, states)


def _op_stages(x: torch.Tensor, layers, fc, states):
    """:func:`step_stages` over the registered operators (:data:`fwd_gemm_op`,
    or :data:`tc_gemm_op` for a bf16 x, and the cell's walk op), which run
    the plain stages on a CPU tensor and K1 / K1-GRU (K1-bf16 for a bf16 x)
    at :func:`padded_hidden` units on a CUDA tensor, a bf16 x's width
    zero-padded to a multiple of :data:`TC_INPUT_MULTIPLE` there
    (:func:`pad_input`, exact). The no-grad forward of both devices, eager or
    traced by ``torch.export``."""
    hidden = layers[0]["w_hh"].shape[1]
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        width = hidden
    elif x.device.type == "cuda":
        width = padded_hidden(hidden)
        if bf16:
            x, layers = pad_input(x, layers, TC_INPUT_MULTIPLE)
    else:
        raise ValueError(f"no fused scan path for device {x.device}")
    walk = lstm_fwd_walk_op if _cell_of(layers[0])[1] == "lstm" else gru_fwd_walk_op
    return step_stages(tc_gemm_op if bf16 else fwd_gemm_op, walk, x.contiguous(), layers, fc,
                       states, width)


def _row_stride(v: torch.Tensor) -> int:
    return v.stride(0) if v.shape[0] > 1 else v.shape[1]


class FwdGemmKernel(_Counts):
    """ctypes wrapper of ``fsn_fwd_gemm`` (csrc/rnn_fwd.cu), the fp32 GEMM
    of the inference forward (each layer's input projection and the head)
    and of the fp32 layer backward (the gate pre-activations and dx);
    counted by (K, Ncols), K the whole depth of A."""

    def __call__(self, a, b, bias=None, out=None, prev=None, head=None):
        """``[a | a_prev] · bᵀ + bias`` as :func:`plain_fwd_gemm` takes it:
        a [M, K0] with unit column stride; prev [>= M - S, K1] and head
        [S, K1] contiguous, or both None (K1 = 0: K1's GEMM, unchanged); b
        [Ncols, K0 + K1] contiguous (a weight in PyTorch's layout), bias
        [Ncols] or None, all fp32 on one CUDA device; ``out`` [M, Ncols]
        with unit column stride, or None for a new tensor."""
        if a.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError(f"a must be [M, K0] and b [Ncols, K]: got {list(a.shape)} and "
                             f"{list(b.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"a must be torch.float32, got {a.dtype}")
        if a.stride(1) != 1:
            raise ValueError("a must have unit column stride")
        m, k0 = a.shape
        ncols = b.shape[0]
        named = {"b": b}
        k1 = 0
        if prev is not None:
            if head is None or prev.ndim != 2 or head.ndim != 2:
                raise ValueError("prev [rows, K1] needs head [S, K1]")
            k1 = prev.shape[1]
            if head.shape[1] != k1 or prev.shape[0] < m - head.shape[0]:
                raise ValueError(f"prev {list(prev.shape)} and head {list(head.shape)} do not "
                                 f"give {m} rows of one width")
            named.update(prev=prev, head=head)
        k = k0 + k1
        if b.shape[1] != k:
            raise ValueError(f"b must be [Ncols, K0 + K1] = [{ncols}, {k}], got {list(b.shape)}")
        if bias is not None:
            if bias.shape != (ncols,):
                raise ValueError(f"bias must be [{ncols}]")
            named["bias"] = bias
        _check_operands(a.device, named, dict.fromkeys(named, torch.float32))
        if out is None:
            out = torch.empty((m, ncols), device=a.device, dtype=torch.float32)
        elif (out.shape != (m, ncols) or out.dtype != torch.float32 or out.device != a.device
              or out.stride(1) != 1):
            raise ValueError(f"out must be [{m}, {ncols}] fp32 on {a.device} with unit column "
                             "stride")

        lib = fwd_library()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.fsn_fwd_gemm(a.data_ptr(), prev.data_ptr() if k1 else None,
                                   head.data_ptr() if k1 else None, b.data_ptr(),
                                   None if bias is None else bias.data_ptr(), out.data_ptr(),
                                   m, ncols, k, k0, head.shape[0] if k1 else 0, _row_stride(a),
                                   k1, _row_stride(out), stream)
        _raise_on(err, "fsn_fwd_gemm", lib.fsn_rnn_fwd_error_string)
        self._count(a.device, (k, ncols))
        return out


fwd_gemm = FwdGemmKernel()


class FwdWalkKernel(_Counts):
    """ctypes wrapper of the inference forward's walk for one cell and
    storage type (``lstm_fwd_walk``, ``gru_fwd_walk``: ``fsn_rnn_fwd_walk``,
    csrc/rnn_fwd.cu, clusters of 16 CTAs with W_hh resident; K1-bf16's
    ``lstm_fwd_walk_bf16``, ``gru_fwd_walk_bf16``: the forms of
    :func:`pick_fwd_bf16_form`, ``fsn_rnn_fwd_walk_tc_bf16`` (csrc/rnn_fwd_tc.cu),
    ``fsn_rnn_fwd_walk_bf16`` (csrc/rnn_fwd.cu) or
    ``fsn_rnn_fwd_stream_walk_bf16`` (csrc/rnn_train_fwd_tc.cu)); counted by
    (N, H). ``stash``: whether its instances write
    the LSTM's c stream (the training walk's do; the inference walk's do
    not). ``dtype``: the type of W_hh and of the h stream (fp32 or bf16);
    p, b_hh and the states are fp32 at either."""

    stash = False

    def __init__(self, cell: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cell = cell
        self.dtype = dtype
        self._clusters: dict = {}

    def max_clusters(self, hidden: int, rows: int, kr: int, device: torch.device) -> int:
        """Clusters of the instance (cell, :attr:`stash`, H, rows, KR) that
        the card of ``device`` runs at once
        (``cudaOccupancyMaxActiveClusters``)."""
        key = (device.index, hidden, rows, kr)
        if key not in self._clusters:
            lib = fwd_library()
            count = ctypes.c_int(0)
            lstm = int(self.cell == "lstm")
            with torch.cuda.device(device):
                if self.dtype == torch.bfloat16:
                    name = "fsn_rnn_fwd_max_clusters_bf16"
                    err = lib.fsn_rnn_fwd_max_clusters_bf16(lstm, hidden, rows,
                                                            ctypes.byref(count))
                else:
                    name = "fsn_rnn_fwd_max_clusters"
                    err = lib.fsn_rnn_fwd_max_clusters(lstm, int(self.stash), hidden, rows, kr,
                                                       ctypes.byref(count))
            _raise_on(err, name, lib.fsn_rnn_fwd_error_string)
            self._clusters[key] = count.value
        return self._clusters[key]

    def max_clusters_tc(self, hidden: int, rows: int, tiles: int, device: torch.device) -> int:
        """Clusters of the bf16 tensor-core walk (cell, H) at ``rows`` rows
        a tile and ``tiles`` tiles a cluster that the card of ``device`` runs
        at once (``cudaOccupancyMaxActiveClusters``)."""
        key = ("tc", device.index, hidden, rows, tiles)
        if key not in self._clusters:
            lib = fwd_tc_library()
            count = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.fsn_rnn_fwd_max_clusters_tc_bf16(int(self.cell == "lstm"), hidden, rows,
                                                           tiles, ctypes.byref(count))
            _raise_on(err, "fsn_rnn_fwd_max_clusters_tc_bf16", lib.fsn_rnn_fwd_tc_error_string)
            self._clusters[key] = count.value
        return self._clusters[key]

    def form(self, n: int, hidden: int, device: torch.device) -> tuple[str, int]:
        """(form, rows) that the bf16 walk takes for N rows on ``device``
        (:func:`pick_fwd_bf16_form`, asking the card how many clusters of
        each form it runs at once); the fp32 walk's is always the cluster
        form (:func:`pick_fwd_tile`)."""
        if self.dtype != torch.bfloat16:
            return "cluster", self.tile(n, hidden, device)[0]

        def clusters(form: str, rows: int) -> int:
            if form == "tc":
                return self.max_clusters_tc(hidden, rows, 1, device)
            return self.max_clusters(hidden, rows, 0, device)

        return pick_fwd_bf16_form(n, hidden, self.cell, clusters)

    def tc_plan(self, n: int, hidden: int, device: torch.device) -> tuple[int, int, int]:
        """(rows a tile, tiles a cluster, clusters the card runs at once) of
        the tensor-core walk for N rows on ``device`` (:func:`fwd_tc_plan`)."""
        rows, tiles = fwd_tc_plan(n, hidden, self.cell,
                                  lambda r: self.max_clusters_tc(hidden, r, 1, device))
        return rows, tiles, self.max_clusters_tc(hidden, rows, tiles, device)

    def tile(self, n: int, hidden: int, device: torch.device) -> tuple[int, int, int]:
        """(rows a cluster walks, KR, clusters the card runs at once) that
        the walk picks for N rows on ``device`` (:func:`pick_fwd_tile`)."""
        rows, kr = pick_fwd_tile(n, hidden, self.cell,
                                 lambda r, k: self.max_clusters(hidden, r, k, device), self.dtype)
        return rows, kr, self.max_clusters(hidden, rows, kr, device)

    def _operands(self, p, w_hh, state, clocks, grouped: bool = False):
        """Check the walk's operands as :meth:`__call__` takes them, w_hh
        [G·H, H] or, ``grouped``, as :func:`_group_hh` gives it; returns
        (h0, c0, b_hh), the absent one None."""
        if p.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {p.device}")
        lstm = self.cell == "lstm"
        if len(state) != 2:
            raise ValueError("the LSTM walk takes (h0, c0), the GRU walk (b_hh, h0)")
        h0, c0, b_hh = (*state, None) if lstm else (state[1], None, state[0])
        if p.ndim != 3 or h0.ndim != 2:
            raise ValueError("p must be [T, N, G·H] and h0 [N, H]")
        t, n, _ = p.shape
        hidden = h0.shape[1]
        gh = _GATES[self.cell] * hidden
        w_shape = _grouped_hh_shape(hidden, _GATES[self.cell]) if grouped else (gh, hidden)
        shapes = {"p": (t, n, gh), "w_hh": w_shape, "h0": (n, hidden)}
        named = {"p": p, "w_hh": w_hh, "h0": h0}
        if lstm:
            shapes["c0"], named["c0"] = (n, hidden), c0
        else:
            shapes["b_hh"], named["b_hh"] = (gh,), b_hh
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        _check_operands(p.device, named, {k: self.dtype if k == "w_hh" else torch.float32
                                          for k in named})
        if clocks is not None:
            if clocks.shape != (3,):
                raise ValueError("clocks must be [3]")
            _check_operands(p.device, {"clocks": clocks}, {"clocks": torch.int64})
        return h0, c0, b_hh

    def _cluster_tile(self, n: int, hidden: int, rows, device) -> tuple[int, int]:
        """The cluster walk's (rows, KR): ``rows`` checked, or picked."""
        _check_fwd_hidden(hidden, self.cell)
        if rows is None:
            rows, kr, _ = self.tile(n, hidden, device)
        else:
            kr = fwd_walk_kr(rows, hidden, self.cell, self.dtype) if rows in FWD_ROWS else None
            if kr is None:
                raise ValueError(f"rows must be one of {FWD_ROWS} and fit in shared memory")
        if self.max_clusters(hidden, rows, kr, device) < 1:
            raise ValueError(f"no cluster of {FWD_CTAS} CTAs of the {self.cell} walk at H = "
                             f"{hidden}, {rows} rows fits on {torch.cuda.get_device_name(device)}")
        return rows, kr

    def _launch(self, p, w_hh, h0, c0, b_hh, clocks, rows: int, kr: int):
        """``fsn_rnn_fwd_walk`` on checked operands; returns (h stream,
        c stream or None, h_T, c_T or None)."""
        lstm = self.cell == "lstm"
        t, n, _ = p.shape
        hidden = w_hh.shape[1]
        lib = fwd_library()
        hseq = torch.empty((t, n, hidden), device=p.device, dtype=self.dtype)
        cseq = torch.empty_like(hseq) if self.stash else None
        h_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
        c_out = torch.empty_like(h_out) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            if self.dtype == torch.bfloat16:
                name = "fsn_rnn_fwd_walk_bf16"
                err = lib.fsn_rnn_fwd_walk_bf16(int(lstm), p.data_ptr(), w_hh.data_ptr(),
                                                ptr(b_hh), h0.data_ptr(), ptr(c0),
                                                hseq.data_ptr(), h_out.data_ptr(), ptr(c_out),
                                                ptr(clocks), t, n, hidden, rows, stream)
            else:
                name = "fsn_rnn_fwd_walk"
                err = lib.fsn_rnn_fwd_walk(int(lstm), p.data_ptr(), w_hh.data_ptr(), ptr(b_hh),
                                           h0.data_ptr(), ptr(c0), hseq.data_ptr(), ptr(cseq),
                                           h_out.data_ptr(), ptr(c_out), ptr(clocks), t, n,
                                           hidden, rows, kr, stream)
        _raise_on(err, name, lib.fsn_rnn_fwd_error_string)
        return hseq, cseq, h_out, c_out

    def _launch_streaming(self, p, w_hh, h0, c0, b_hh, clocks, rows: int | None,
                          stages: int | None):
        """K1-bf16's streaming form, ``fsn_rnn_fwd_stream_walk_bf16`` (the
        bf16 training walk's inference form) on checked operands, W_hh^T
        regrouped as that walk reads it; returns (h stream, h_T, c_T or
        None)."""
        lstm = self.cell == "lstm"
        t, n, _ = p.shape
        hidden = w_hh.shape[1]
        if hidden % 4 or hidden > TRAIN_WALK_MAX_HIDDEN:
            raise ValueError(f"the streaming walk takes H a multiple of 4 up to "
                             f"{TRAIN_WALK_MAX_HIDDEN}, got {hidden}")
        if rows is None:
            rows = pick_train_walk_tile(n, self.cell, hidden)[0]
        if stages is None:
            stages = train_walk_ring(rows, self.cell, hidden)
        if rows not in TRAIN_WALK_ROWS or not 2 <= stages <= TRAIN_MAX_STAGES:
            raise ValueError(f"rows must be one of {TRAIN_WALK_ROWS} and stages 2 to "
                             f"{TRAIN_MAX_STAGES}")
        if train_walk_smem_bytes(rows, self.cell, hidden, stages) > _MAX_SMEM_BYTES:
            raise ValueError(f"the streaming walk at {rows} rows and {stages} stages needs more "
                             "shared memory than a block may use")
        lib = train_fwd_library()
        w = _stream_hh_t(w_hh.t(), _GATES[self.cell])
        hseq = torch.empty((t, n, hidden), device=p.device, dtype=torch.bfloat16)
        h_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
        c_out = torch.empty_like(h_out) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            err = lib.fsn_rnn_fwd_stream_walk_bf16(
                int(lstm), p.data_ptr(), w.data_ptr(), ptr(b_hh), h0.data_ptr(), ptr(c0),
                hseq.data_ptr(), h_out.data_ptr(), ptr(c_out), ptr(clocks), t, n, hidden, rows,
                stages, stream)
        _raise_on(err, "fsn_rnn_fwd_stream_walk_bf16", lib.fsn_train_fwd_error_string)
        return hseq, h_out, c_out

    def _launch_tc(self, p, w_hh, h0, c0, b_hh, clocks, rows: int | None,
                   tiles: int | None):
        """K1-bf16's tensor-core form, ``fsn_rnn_fwd_walk_tc_bf16``
        (csrc/rnn_fwd_tc.cu) on checked operands: ``rows`` a tile (one of
        :data:`FWD_TC_ROWS`) and ``tiles`` a cluster, each picked where None
        (:func:`fwd_tc_plan`; given rows, as many tiles a cluster as one
        wave of clusters needs, as fit); returns (h stream, h_T, c_T or
        None)."""
        lstm = self.cell == "lstm"
        t, n, _ = p.shape
        hidden = w_hh.shape[1]
        if not fwd_tc_takes(hidden, self.cell):
            raise ValueError(f"the tensor-core walk takes H one of {FWD_TC_HIDDEN}, got {hidden}")
        if rows is None:
            rows, planned, _ = self.tc_plan(n, hidden, p.device)
            tiles = planned if tiles is None else tiles
        if rows not in FWD_TC_ROWS:
            raise ValueError(f"rows must be one of {FWD_TC_ROWS}, got {rows}")
        most = fwd_tc_max_tiles(rows, hidden, self.cell)
        if tiles is None:
            clusters = max(1, self.max_clusters_tc(hidden, rows, 1, p.device))
            tiles = min(-(-(-(-n // rows)) // clusters), most)
        if not 1 <= tiles <= most:
            raise ValueError(f"the tensor-core walk at {rows} rows a tile holds 1 to {most} tiles "
                             f"a cluster in shared memory; got {tiles}")
        lib = fwd_tc_library()
        hseq = torch.empty((t, n, hidden), device=p.device, dtype=torch.bfloat16)
        h_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
        c_out = torch.empty_like(h_out) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            err = lib.fsn_rnn_fwd_walk_tc_bf16(
                int(lstm), p.data_ptr(), w_hh.data_ptr(), ptr(b_hh), h0.data_ptr(), ptr(c0),
                hseq.data_ptr(), h_out.data_ptr(), ptr(c_out), ptr(clocks), t, n, hidden, rows,
                tiles, stream)
        _raise_on(err, "fsn_rnn_fwd_walk_tc_bf16", lib.fsn_rnn_fwd_tc_error_string)
        return hseq, h_out, c_out

    def __call__(self, p, w_hh, *state, rows: int | None = None,
                 clocks: torch.Tensor | None = None, form: str | None = None,
                 stages: int | None = None, tiles: int | None = None):
        """The walk as :func:`plain_lstm_fwd_walk` (state = h0, c0) or
        :func:`plain_gru_fwd_walk` (state = b_hh, h0) takes it (at bf16,
        :func:`plain_lstm_fwd_walk_bf16` / :func:`plain_gru_fwd_walk_bf16`):
        p [T, N, G·H], w_hh [G·H, H] in :attr:`dtype`, b_hh [G·H], h0 and c0
        [N, H] fp32, all contiguous on one CUDA device; the h stream comes
        back in :attr:`dtype`, (h_T, c_T) in fp32. ``rows`` sets the tile
        (one of :data:`FWD_ROWS`); ``clocks``, an
        int64 [3] on the device, receives block 0's cycles over all steps in
        the exchange (gather and cluster barrier), the product and the cell
        update (streaming form: the product, the cell and its stores, 0).
        ``form`` (bf16 only): "tc" (``csrc/rnn_fwd_tc.cu``; ``rows`` a tile
        of :data:`FWD_TC_ROWS` and ``tiles`` a cluster then), "cluster" (``csrc/rnn_fwd.cu``) or "streaming"
        (``csrc/rnn_train_fwd_tc.cu``, ``rows`` 16 or 32 and ring ``stages``
        then); None follows
        :func:`pick_fwd_bf16_form` (with ``rows`` given, the cluster form).
        The registered operators call it with None, so eager calls, the
        chunked training forward and exported programs take the same form.
        The bf16 walk also counts its launches by form."""
        h0, c0, b_hh = self._operands(p, w_hh, state, clocks)
        n, hidden = p.shape[1], w_hh.shape[1]
        bf16 = self.dtype == torch.bfloat16
        if form is None:
            form = "cluster"
            if bf16 and rows is None:
                form, rows = self.form(n, hidden, p.device)
        if form not in ("cluster", "streaming", "tc") or (form != "cluster" and not bf16):
            raise ValueError(f"form must be 'cluster', or 'tc' or 'streaming' for the bf16 walk; "
                             f"got {form!r}")
        if form == "tc":
            hseq, h_out, c_out = self._launch_tc(p, w_hh, h0, c0, b_hh, clocks, rows, tiles)
        elif form == "streaming":
            hseq, h_out, c_out = self._launch_streaming(p, w_hh, h0, c0, b_hh, clocks, rows,
                                                        stages)
        else:
            rows, kr = self._cluster_tile(n, hidden, rows, p.device)
            hseq, _, h_out, c_out = self._launch(p, w_hh, h0, c0, b_hh, clocks, rows, kr)
        self._count(p.device, (n, hidden), form if bf16 else None)
        if self.cell == "lstm":
            return hseq, h_out, c_out
        return hseq, h_out


lstm_fwd_walk = FwdWalkKernel("lstm")
gru_fwd_walk = FwdWalkKernel("gru")
lstm_fwd_walk_bf16 = FwdWalkKernel("lstm", torch.bfloat16)
gru_fwd_walk_bf16 = FwdWalkKernel("gru", torch.bfloat16)


# ---------------------------------------------------------------------------
# K1's stages as registered operators, for the no-grad forward of both
# devices: torch.export traces each call as one node of the program
# (``torch.ops.fsn.*``), and a loaded program launches K1 / K1-GRU through
# them. The CPU kernel of each is its plain version, the CUDA kernel the
# ctypes wrapper above (which counts its launches); no other device has one.
# K1-bf16 runs through ``tc_gemm`` and the walks' ops, which take the bf16
# instance where W_hh is bf16: their outputs' types follow W_hh's.
# ---------------------------------------------------------------------------

OPS_NAMESPACE = "fsn"


def _op(name: str, schema: str, plain, kernel, fake):
    op = torch.library.custom_op(f"{OPS_NAMESPACE}::{name}", mutates_args=(),
                                 device_types="cpu", schema=schema)(plain)
    op.register_kernel("cuda")(kernel)
    op.register_fake(fake)
    return op


def _h_stream_fake(p, w_hh):
    """The h stream [T, N, H], in W_hh's type (bf16 for K1-bf16)."""
    return p.new_empty((*p.shape[:2], w_hh.shape[1]), dtype=w_hh.dtype)


def _by_type(fp32, bf16):
    """A walk's function that takes the bf16 one where W_hh (the second
    argument) is bf16, the fp32 one otherwise."""
    return lambda p, w_hh, *rest: (bf16 if w_hh.dtype == torch.bfloat16 else fp32)(p, w_hh, *rest)


fwd_gemm_op = _op(
    "fwd_gemm", "(Tensor a, Tensor b, Tensor? bias) -> Tensor",
    lambda a, b, bias: plain_fwd_gemm(a, b, bias),
    lambda a, b, bias: fwd_gemm(a, b, bias),
    lambda a, b, bias: a.new_empty((a.shape[0], b.shape[0])))
tc_gemm_op = _op(
    "tc_gemm", "(Tensor a, Tensor b, Tensor? bias) -> Tensor",
    lambda a, b, bias: plain_tc_gemm(a, b, bias),
    lambda a, b, bias: tc_gemm(a, b, bias),
    lambda a, b, bias: a.new_empty((a.shape[0], b.shape[1]), dtype=torch.float32))
lstm_fwd_walk_op = _op(
    "lstm_fwd_walk", "(Tensor p, Tensor w_hh, Tensor h0, Tensor c0) -> (Tensor, Tensor, Tensor)",
    _by_type(plain_lstm_fwd_walk, plain_lstm_fwd_walk_bf16),
    _by_type(lstm_fwd_walk, lstm_fwd_walk_bf16),
    lambda p, w_hh, h0, c0: (_h_stream_fake(p, w_hh), h0.new_empty(h0.shape),
                             c0.new_empty(c0.shape)))
gru_fwd_walk_op = _op(
    "gru_fwd_walk", "(Tensor p, Tensor w_hh, Tensor b_hh, Tensor h0) -> (Tensor, Tensor)",
    _by_type(plain_gru_fwd_walk, plain_gru_fwd_walk_bf16),
    _by_type(gru_fwd_walk, gru_fwd_walk_bf16),
    lambda p, w_hh, b_hh, h0: (_h_stream_fake(p, w_hh), h0.new_empty(h0.shape)))


# ---------------------------------------------------------------------------
# the fp32 training forward's walk (K2, K2-GRU at fp32): the cluster walk of
# csrc/rnn_fwd.cu with its c stream for few rows, csrc/rnn_train_fwd_f32.cu
# streaming W_hh^T for many
# ---------------------------------------------------------------------------

TRAIN_F32_ROWS = 32  # rows of one block of the streaming form
TRAIN_F32_UNITS = 96  # units of one group of its product: 4 row groups x 96 = 384 threads
TRAIN_F32_MAX_HIDDEN = 512  # the h tiles and the ring fill a block's shared memory there
_TRAIN_F32_CHUNK = 32  # K rows of W_hh^T in one slot of the ring
_TRAIN_F32_RING = 2  # slots of the ring


class TrainF32KernelLibrary:
    """The library of the fp32 training forward's streaming walk
    (csrc/rnn_train_fwd_f32.cu), built at first use and loaded with ctypes;
    its cluster form and its GEMM are :data:`fwd_library`'s."""

    SOURCES = (CSRC / "rnn_train_fwd_f32.cu",)
    NAME = "fsn_rnn_train_fwd_f32"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_rnn_train_f32_walk.argtypes = [i] + [ptr] * 10 + [i] * 3 + [ptr]
            lib.fsn_rnn_train_f32_walk.restype = i
            lib.fsn_rnn_train_f32_error_string.argtypes = [i]
            lib.fsn_rnn_train_f32_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


train_f32_library = TrainF32KernelLibrary()


def train_f32_stream_smem_bytes(hidden: int, cell: str) -> int:
    """Dynamic shared memory of one block of the streaming walk
    (rnn_train_fwd_f32.cu, walk_smem): h_{t-1} and h_t [32, H rounded up to
    32] and a ring of 2 slots of W_hh^T [32 K rows, 96 units, G gates]."""
    return 4 * (2 * TRAIN_F32_ROWS * _round_up(hidden, _TRAIN_F32_CHUNK)
                + _TRAIN_F32_RING * _TRAIN_F32_CHUNK * TRAIN_F32_UNITS * _GATES[cell])


def train_f32_stream_fits(hidden: int, cell: str) -> bool:
    """Whether the streaming walk takes H: up to 512, within a block's
    shared memory."""
    return (1 <= hidden <= TRAIN_F32_MAX_HIDDEN
            and train_f32_stream_smem_bytes(hidden, cell) <= _MAX_SMEM_BYTES)


def train_f32_streams(n: int, hidden: int, cell: str, max_clusters) -> bool:
    """Whether the fp32 training walk streams W_hh^T (blocks of 32 rows with
    every unit, no cluster) rather than keeping it resident over a cluster
    (rnn_fwd.cu's walk): where the cluster form cannot walk every row in one
    wave of the clusters the card runs at once (``max_clusters`` as
    :func:`pick_fwd_tile` takes it) or does not take H. At the flagship's
    training shapes: the sub-band stage (N = 4096, H = 384) streams, the
    full-band stage (N = 32, H = 512) takes the cluster form. Raises
    ValueError where neither form takes H."""
    cluster = _fwd_walk_takes(hidden, cell) and any(
        fwd_walk_kr(rows, hidden, cell) is not None for rows in FWD_ROWS)
    stream = train_f32_stream_fits(hidden, cell)
    if not (cluster or stream):
        raise ValueError(
            f"no fp32 training walk takes {cell} H = {hidden}: the cluster form takes H a "
            f"multiple of {FWD_CTAS} with {FWD_SLICES}·G·H/{FWD_CTAS} <= {FWD_MAX_THREADS} "
            f"threads a CTA and a tile in shared memory, the streaming form H up to "
            f"{TRAIN_F32_MAX_HIDDEN}"
        )
    if not (cluster and stream):
        return stream
    rows, kr = pick_fwd_tile(n, hidden, cell, max_clusters)
    clusters = max_clusters(rows, kr) if callable(max_clusters) else max_clusters
    return -(-n // rows) > clusters


def _grouped_hh_shape(hidden: int, gates: int) -> tuple[int, int, int, int]:
    """[NG, HP, 96, G] of :func:`_group_hh`'s result: NG = ceil(H / 96),
    HP = H rounded up to 32."""
    return (-(-hidden // TRAIN_F32_UNITS), _round_up(hidden, _TRAIN_F32_CHUNK),
            TRAIN_F32_UNITS, gates)


def _group_hh(w_hh: torch.Tensor, gates: int) -> torch.Tensor:
    """W_hh [G·H, H] (any strides) as the streaming walk reads it: W_hh^T
    regrouped [NG, HP, 96, G] (:func:`_grouped_hh_shape`), element
    [g, k, u, j] = W_hh[j·H + 96 g + u, k], zero for units past H and for K
    rows past H."""
    hidden = w_hh.shape[1]
    groups, hp, _, _ = _grouped_hh_shape(hidden, gates)
    out = w_hh.new_zeros(hp, groups * TRAIN_F32_UNITS, gates)  # [k, unit, gate]
    out[:hidden, :hidden] = w_hh.unflatten(0, (gates, hidden)).permute(2, 1, 0)
    return out.view(hp, groups, TRAIN_F32_UNITS, gates).transpose(0, 1).contiguous()


class TrainF32WalkKernel(FwdWalkKernel):
    """ctypes wrapper of the fp32 training forward's walk for one cell
    (``lstm_train_walk_f32``, ``gru_train_walk_f32``): for few rows the
    cluster walk of the inference forward, ``fsn_rnn_fwd_walk``
    (csrc/rnn_fwd.cu; the LSTM's instances with a c stream), for many rows
    the streaming walk ``fsn_rnn_train_f32_walk`` (csrc/rnn_train_fwd_f32.cu),
    as :func:`train_f32_streams` picks; counted by (N, H) and by form. Its
    plain versions are :func:`plain_lstm_fwd_walk` and
    :func:`plain_gru_fwd_walk` with ``stash=True``."""

    def __init__(self, cell: str):
        super().__init__(cell)
        self.stash = cell == "lstm"  # the GRU's stash is its h stream

    def streams(self, n: int, hidden: int, device: torch.device) -> bool:
        """Whether the walk takes the streaming form for N rows on ``device``
        (:func:`train_f32_streams`)."""
        return train_f32_streams(n, hidden, self.cell,
                                 lambda r, k: self.max_clusters(hidden, r, k, device))

    def weights(self, w_hh: torch.Tensor, n: int) -> torch.Tensor:
        """W_hh [G·H, H] (any strides) in the form the walk reads for N rows:
        regrouped (:func:`_group_hh`) where it streams, else contiguous."""
        if self.streams(n, w_hh.shape[1], w_hh.device):
            return _group_hh(w_hh, _GATES[self.cell])
        return w_hh.contiguous()

    def layer_weights(self, ws, n: int) -> list:
        """Each layer's (W_ih [G·H, in] contiguous, W_hh as :meth:`weights`
        gives it for N rows) from :func:`prep_weights`' [W_ih^T ; W_hh^T]."""
        hidden = ws[0].shape[1] // _GATES[self.cell]
        return [(w[:-hidden].t().contiguous(), self.weights(w[-hidden:].t(), n)) for w in ws]

    def __call__(self, p, w_hh, *state, stream: bool | None = None, rows: int | None = None,
                 clocks: torch.Tensor | None = None):
        """The walk as :func:`plain_lstm_fwd_walk` (state = h0, c0) or
        :func:`plain_gru_fwd_walk` (state = b_hh, h0) takes it with
        ``stash=True``: p [T, N, G·H], b_hh [G·H], h0 and c0 [N, H], and
        w_hh [G·H, H] or, for the streaming form, as :meth:`weights` makes
        it once for many calls (4-D: the form is then the streaming one);
        all fp32 and contiguous on one CUDA device. Returns the stashes: LSTM
        (h stream, c stream), GRU the h stream. ``stream`` None follows
        :func:`train_f32_streams`; ``rows`` sets the cluster form's tile (one
        of :data:`FWD_ROWS`); ``clocks``, an int64 [3] on the device,
        receives block 0's cycles over all steps: the cluster form's
        exchange, product and cell update, or the streaming form's ring wait,
        product and cell update."""
        grouped = w_hh.ndim == 4
        h0, c0, b_hh = self._operands(p, w_hh, state, clocks, grouped)
        lstm = self.cell == "lstm"
        t, n, _ = p.shape
        hidden = h0.shape[1]
        if stream is None:
            stream = grouped or (rows is None and self.streams(n, hidden, p.device))
        if not stream:
            if grouped:
                raise ValueError("the cluster form takes w_hh [G·H, H]")
            rows, kr = self._cluster_tile(n, hidden, rows, p.device)
            hseq, cseq, _, _ = self._launch(p, w_hh, h0, c0, b_hh, clocks, rows, kr)
        else:
            if rows is not None or not train_f32_stream_fits(hidden, self.cell):
                raise ValueError(f"the streaming form takes blocks of {TRAIN_F32_ROWS} rows and H "
                                 f"up to {TRAIN_F32_MAX_HIDDEN}")
            lib = train_f32_library()
            hseq = torch.empty((t, n, hidden), device=p.device, dtype=torch.float32)
            cseq = torch.empty_like(hseq) if lstm else None
            h_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
            c_out = torch.empty_like(h_out) if lstm else None
            w = w_hh if grouped else _group_hh(w_hh, _GATES[self.cell])
            ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
            with torch.cuda.device(p.device):
                err = lib.fsn_rnn_train_f32_walk(
                    int(lstm), p.data_ptr(), w.data_ptr(), ptr(b_hh), h0.data_ptr(), ptr(c0),
                    hseq.data_ptr(), ptr(cseq), h_out.data_ptr(), ptr(c_out), ptr(clocks), t, n,
                    hidden, torch.cuda.current_stream(p.device).cuda_stream)
            _raise_on(err, "fsn_rnn_train_f32_walk", lib.fsn_rnn_train_f32_error_string)
        self._count(p.device, (n, hidden), "streaming" if stream else "cluster")
        return (hseq, cseq) if lstm else hseq


lstm_train_walk_f32 = TrainF32WalkKernel("lstm")
gru_train_walk_f32 = TrainF32WalkKernel("gru")


# ---------------------------------------------------------------------------
# the fp32 layer backward's walk (K3, K4 at fp32): csrc/rnn_bwd_f32.cu
# ---------------------------------------------------------------------------

BWD_F32_ROWS = (1, 2, 4, 8, 16)  # rows one cluster walks: the instances built
BWD_F32_REG_ROWS = 8  # rows of each K slice of W_hh a thread holds in registers (KR)
BWD_F32_MAX_REG_TILE = 8  # the register-holding instances are built up to this tile
BWD_F32_SLICES = 4
BWD_F32_STREAM_ROWS = 16  # rows of one block of the streaming form
BWD_F32_STREAM_MAX_HIDDEN = 384  # H threads a block of the streaming form, at most
_BWD_F32_CHUNK = 8  # W_hh rows of each K slice in one slot of the streaming form's ring
_BWD_F32_RING = 2  # slots of that ring (3 time the same, PERF.md §6)


class BwdF32KernelLibrary:
    """The library of the fp32 layer backward's walk (csrc/rnn_bwd_f32.cu),
    built at first use and loaded with ctypes; the GEMM of its other stages
    is :data:`fwd_gemm`'s."""

    SOURCES = (CSRC / "rnn_bwd_f32.cu",)
    NAME = "fsn_rnn_bwd_f32"

    def __init__(self):
        self._lib = None

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build_library(self.NAME, list(self.SOURCES))))
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.fsn_rnn_bwd_f32_walk.argtypes = [i] + [ptr] * 12 + [i] * 6 + [ptr]
            lib.fsn_rnn_bwd_f32_walk.restype = i
            lib.fsn_rnn_bwd_f32_stream.argtypes = [i] + [ptr] * 12 + [i] * 3 + [ptr]
            lib.fsn_rnn_bwd_f32_stream.restype = i
            lib.fsn_rnn_bwd_f32_max_clusters.argtypes = [i] * 4 + [ctypes.POINTER(i)]
            lib.fsn_rnn_bwd_f32_max_clusters.restype = i
            lib.fsn_rnn_bwd_f32_error_string.argtypes = [i]
            lib.fsn_rnn_bwd_f32_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


bwd_f32_library = BwdF32KernelLibrary()


def bwd_f32_smem_bytes(rows: int, hidden: int, cell: str, kr: int) -> int:
    """Dynamic shared memory of one CTA of the fp32 walk (rnn_bwd_f32.cu,
    walk_smem): its G·H/16 rows of W_hh, zero-padded to CP (a multiple of
    16) and cut in 4 K slices, beyond the ``kr`` rows of each slice held in
    registers; its cotangent tile [rows, CP]; the partial carries
    [rows, H]."""
    cp = _round_up(_GATES[cell] * (hidden // FWD_CTAS), 16)
    ks = cp // BWD_F32_SLICES - kr
    return 4 * (BWD_F32_SLICES * ks * hidden + rows * cp + rows * hidden)


def bwd_f32_kr(rows: int, hidden: int, cell: str) -> int | None:
    """Rows of each K slice of W_hh held in registers: 0 where the CTA's rows
    fit in shared memory beside ``rows`` rows, else for the LSTM
    :data:`BWD_F32_REG_ROWS` (at H = 512: 256 KB of W_hh a CTA), built for
    tiles up to :data:`BWD_F32_MAX_REG_TILE` rows; None where neither fits
    (the GRU's rows fit in shared memory wherever a tile does, so its
    register-holding instances are not built)."""
    cs = _round_up(_GATES[cell] * (hidden // FWD_CTAS), 16) // BWD_F32_SLICES
    for kr in (0, BWD_F32_REG_ROWS) if cell == "lstm" else (0,):
        if ((kr == 0 or rows <= BWD_F32_MAX_REG_TILE) and kr <= cs
                and bwd_f32_smem_bytes(rows, hidden, cell, kr) <= _MAX_SMEM_BYTES):
            return kr
    return None


def _check_bwd_f32_hidden(hidden: int) -> None:
    if hidden < FWD_CTAS or hidden % FWD_CTAS or hidden > FWD_MAX_THREADS:
        raise ValueError(f"the fp32 walk takes H a multiple of {FWD_CTAS} up to "
                         f"{FWD_MAX_THREADS} (a warp of threads for each 32 units), got {hidden}")


def pick_bwd_f32_tile(n: int, hidden: int, cell: str, max_clusters) -> tuple[int, int]:
    """(rows a cluster walks, KR) of the fp32 walk for N rows, by the rule of
    the forward's :func:`pick_fwd_tile`: the smallest tile of
    :data:`BWD_F32_ROWS` that fits and walks every row in one wave of the
    clusters the card runs at once (``max_clusters``: a count, or a function
    of (rows, KR)); where none does, the largest that fits. A step's product
    grows with the rows while its exchange does not."""
    _check_bwd_f32_hidden(hidden)
    fits = [(r, kr) for r in BWD_F32_ROWS if (kr := bwd_f32_kr(r, hidden, cell)) is not None]
    if not fits:
        raise ValueError(f"no fp32 walk tile fits {cell} H = {hidden} in shared memory")
    for rows, kr in fits:
        clusters = max_clusters(rows, kr) if callable(max_clusters) else max_clusters
        if -(-n // rows) <= clusters:
            return rows, kr
    return fits[-1]


def bwd_f32_stream_smem_bytes(hidden: int, cell: str) -> int:
    """Dynamic shared memory of one block of the fp32 walk's streaming form
    (rnn_bwd_f32.cu, stream_smem): the cotangent tile [16, G·H rounded up to
    32] and a ring of 2 W_hh chunks [4 slices, 8 rows, H]."""
    kp = _round_up(_GATES[cell] * hidden, BWD_F32_SLICES * _BWD_F32_CHUNK)
    return 4 * (BWD_F32_STREAM_ROWS * kp + _BWD_F32_RING * BWD_F32_SLICES * _BWD_F32_CHUNK * hidden)


def bwd_f32_stream_fits(hidden: int, cell: str) -> bool:
    """Whether the streaming form is built for H: a thread a unit, so H up
    to 384, and a block's shared memory."""
    return (hidden <= BWD_F32_STREAM_MAX_HIDDEN
            and bwd_f32_stream_smem_bytes(hidden, cell) <= _MAX_SMEM_BYTES)


def bwd_f32_streams(n: int, hidden: int, cell: str, max_clusters) -> bool:
    """Whether the fp32 walk streams W_hh (one block of 16 rows with every
    unit, no cluster) rather than keeping it resident over a cluster: where
    the streaming form fits and the cluster form cannot walk every row in
    one wave (``max_clusters`` as :func:`pick_bwd_f32_tile` takes it).
    Measured on an H100 (PERF.md §6): at the sub-band stage (N = 4096,
    H = 384) the cluster form takes 37 waves of 7 clusters, while each
    streaming block reads W_hh from L2."""
    if not bwd_f32_stream_fits(hidden, cell):
        return False
    rows, kr = pick_bwd_f32_tile(n, hidden, cell, max_clusters)
    clusters = max_clusters(rows, kr) if callable(max_clusters) else max_clusters
    return -(-n // rows) > clusters


class BwdF32WalkKernel(_Counts):
    """ctypes wrapper of the fp32 layer backward's walk over time for one
    cell (``lstm_walk_f32``, ``gru_walk_f32``): ``fsn_rnn_bwd_f32_walk``
    (csrc/rnn_bwd_f32.cu), clusters of 16 CTAs with W_hh resident; or, for
    many rows, its streaming form ``fsn_rnn_bwd_f32_stream``
    (:func:`bwd_f32_streams`); counted by (N, H) and by form. Its plain versions
    are :func:`plain_lstm_walk` and :func:`plain_gru_walk`, whose roundings
    are no-ops at fp32."""

    def __init__(self, cell: str):
        super().__init__()
        self.cell = cell
        self._clusters: dict = {}

    def max_clusters(self, hidden: int, rows: int, kr: int, device: torch.device) -> int:
        """Clusters of the instance (cell, H, rows, KR) that the card of
        ``device`` runs at once (``cudaOccupancyMaxActiveClusters``)."""
        key = (device.index, hidden, rows, kr)
        if key not in self._clusters:
            lib = bwd_f32_library()
            count = ctypes.c_int(0)
            with torch.cuda.device(device):
                err = lib.fsn_rnn_bwd_f32_max_clusters(int(self.cell == "lstm"), hidden, rows,
                                                       kr, ctypes.byref(count))
            _raise_on(err, "fsn_rnn_bwd_f32_max_clusters", lib.fsn_rnn_bwd_f32_error_string)
            self._clusters[key] = count.value
        return self._clusters[key]

    def tile(self, n: int, hidden: int, device: torch.device) -> tuple[int, int, int]:
        """(rows a cluster walks, KR, clusters the card runs at once) that
        the walk picks for N rows on ``device`` (:func:`pick_bwd_f32_tile`)."""
        rows, kr = pick_bwd_f32_tile(n, hidden, self.cell,
                                     lambda r, k: self.max_clusters(hidden, r, k, device))
        return rows, kr, self.max_clusters(hidden, rows, kr, device)

    def __call__(self, p, dh, stash, init, w_hh, dh_in, dc_in=None, rows: int | None = None,
                 stream: bool | None = None, clocks: torch.Tensor | None = None):
        """The walk as :func:`plain_lstm_walk` (stash = c stash, init = c0,
        with dc_in) or :func:`plain_gru_walk` (stash = h stash, init = h0)
        takes it, at fp32: p [T, N, 4H]; dh, stash [T, N, H], init, dh_in,
        dc_in [N, H], contiguous; w_hh [G·H, H] with unit column stride (a
        column slice of the layer's wt is read in place). H a multiple of 16
        up to 512. ``stream`` None follows :func:`bwd_f32_streams`; the
        streaming form reads its operands 16 bytes at a time and raises
        where one is not 16-byte aligned. ``rows`` sets the cluster form's
        tile (one of :data:`BWD_F32_ROWS`); ``clocks``, an int64 [3] on the
        device, receives block 0's cycles over all steps in the cell
        backward, the product and (cluster form) the cluster exchange.
        Returns (dgates [T, N, 4H], dh0, dc0), or the GRU's (dxw, dhw
        [T, N, 3H], dh0), all fp32."""
        if p.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {p.device}")
        lstm = self.cell == "lstm"
        if lstm == (dc_in is None):
            raise ValueError("the LSTM walk takes dc_in, the GRU walk does not")
        if dh.ndim != 3:
            raise ValueError(f"dh must be [T, N, H], got {list(dh.shape)}")
        t, n, hidden = dh.shape
        _check_bwd_f32_hidden(hidden)
        gates = _GATES[self.cell] * hidden
        shapes = {"p": (t, n, 4 * hidden), "dh": (t, n, hidden), "stash": (t, n, hidden),
                  "init": (n, hidden), "w_hh": (gates, hidden), "dh_in": (n, hidden)}
        named = {"p": p, "dh": dh, "stash": stash, "init": init, "w_hh": w_hh, "dh_in": dh_in}
        if lstm:
            shapes["dc_in"], named["dc_in"] = (n, hidden), dc_in
        for name, shape in shapes.items():
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {list(named[name].shape)}")
        if w_hh.device != p.device or w_hh.dtype != torch.float32 or w_hh.stride(1) != 1:
            raise TypeError(f"w_hh must be float32 on {p.device} with unit column stride")
        del named["w_hh"]
        _check_operands(p.device, named, dict.fromkeys(named, torch.float32))
        if clocks is not None:
            if clocks.shape != (3,):
                raise ValueError("clocks must be [3]")
            _check_operands(p.device, {"clocks": clocks}, {"clocks": torch.int64})
        if stream is None:
            stream = rows is None and bwd_f32_streams(
                n, hidden, self.cell, lambda r, k: self.max_clusters(hidden, r, k, p.device))
        if stream:
            if rows is not None or not bwd_f32_stream_fits(hidden, self.cell):
                raise ValueError(f"the streaming form takes blocks of {BWD_F32_STREAM_ROWS} rows "
                                 f"and H up to {BWD_F32_STREAM_MAX_HIDDEN} that fits in shared "
                                 "memory")
            # W_hh made contiguous (a 2.4 MB copy at the sub-band stage): its
            # rows stream as 16-byte chunks
            w_hh = w_hh.contiguous()
            if any(v.data_ptr() % 16 for v in (w_hh, *named.values())):
                raise ValueError("the streaming form reads its operands 16 bytes at a time: "
                                 "each must start on a 16-byte boundary")
        else:
            rows, kr = self._cluster_tile(n, hidden, rows, p.device)

        lib = bwd_f32_library()
        out0 = torch.empty((t, n, gates), device=p.device, dtype=torch.float32)
        out1 = None if lstm else torch.empty_like(out0)
        dh_out = torch.empty((n, hidden), device=p.device, dtype=torch.float32)
        dc_out = torch.empty_like(dh_out) if lstm else None
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        operands = (int(lstm), p.data_ptr(), dh.data_ptr(), stash.data_ptr(), init.data_ptr(),
                    w_hh.data_ptr(), dh_in.data_ptr(), ptr(dc_in), out0.data_ptr(), ptr(out1),
                    dh_out.data_ptr(), ptr(dc_out), ptr(clocks), t, n, hidden)
        with torch.cuda.device(p.device):
            cuda_stream = torch.cuda.current_stream(p.device).cuda_stream
            if stream:
                name = "fsn_rnn_bwd_f32_stream"
                err = lib.fsn_rnn_bwd_f32_stream(*operands, cuda_stream)
            else:
                name = "fsn_rnn_bwd_f32_walk"
                err = lib.fsn_rnn_bwd_f32_walk(*operands, _row_stride(w_hh), rows, kr, cuda_stream)
        _raise_on(err, name, lib.fsn_rnn_bwd_f32_error_string)
        self._count(p.device, (n, hidden), "streaming" if stream else "cluster")
        if lstm:
            return out0, dh_out, dc_out
        return out0, out1, dh_out

    def _cluster_tile(self, n: int, hidden: int, rows, device) -> tuple[int, int]:
        """The cluster form's (rows, KR): ``rows`` checked, or picked."""
        if rows is None:
            rows, kr, _ = self.tile(n, hidden, device)
        else:
            kr = bwd_f32_kr(rows, hidden, self.cell) if rows in BWD_F32_ROWS else None
            if kr is None:
                raise ValueError(f"rows must be one of {BWD_F32_ROWS} and fit in shared memory")
        if self.max_clusters(hidden, rows, kr, device) < 1:
            raise ValueError(f"no cluster of {FWD_CTAS} CTAs of the fp32 {self.cell} walk at "
                             f"H = {hidden}, {rows} rows fits on "
                             f"{torch.cuda.get_device_name(device)}")
        return rows, kr


lstm_walk_f32 = BwdF32WalkKernel("lstm")
gru_walk_f32 = BwdF32WalkKernel("gru")


# padded copies of a stack's weights for the inference forward, built once
# per weight version: by the id of the stack's first W_hh, checked against
# every weight's identity and version
_PADDED: dict = {}


def _cached_pad(layers, fc, width: int):
    """:func:`pad_stack` outside autograd, built once per weight version.
    While ``torch.export`` traces, the padding is part of the graph: a
    cached copy would hold the tracer's tensors, or enter the program as a
    constant instead of following the weights it is given."""
    tensors = [*(l[k] for l in layers for k in ("w_ih", "w_hh", "b_ih", "b_hh")),
               *(() if fc is None else (fc["weight"], fc["bias"]))]
    # inference tensors have no version counter to key on
    if torch.compiler.is_compiling() or any(v.is_inference() for v in tensors):
        return pad_stack(layers, fc, width)
    anchor = layers[0]["w_hh"]
    key = (width, tuple((id(v), v._version) for v in tensors))
    entry = _PADDED.get(id(anchor))
    if entry is None or entry[0]() is not anchor or entry[1] != key:
        if entry is None:
            weakref.finalize(anchor, _PADDED.pop, id(anchor), None)
        with torch.no_grad():
            entry = (weakref.ref(anchor), key, pad_stack(layers, fc, width))
        _PADDED[id(anchor)] = entry
    return entry[2]


def fused_subband_lstm(
    x: torch.Tensor,
    *layers_and_fc: dict,
    time_major_features: bool = False,
    stash_budget: int | None = None,
    time_chunk: int | None = None,
) -> torch.Tensor:
    """Run the fused N-layer LSTM or GRU + Linear over x.

    Args:
        x: [T, N, F_in] (or [T, F_in, N] if ``time_major_features``);
            N = B·F frequency-batched rows.
        *layers_and_fc: one to three layer dicts of one cell (4H gate
            rows: LSTM; 3H: GRU), then the head dict, or None for a
            head-less stack.
        stash_budget: bytes a training call may hold (default: the card's
            :data:`STASH_BUDGET_SHARE`, :func:`stash_budget_bytes`); above it
            the call takes the time-chunked stash (:func:`train_chunk`).
        time_chunk: force the chunk of a training call, a multiple of 8
            steps; 0 means the full stash.

    Returns:
        [T, N, OUT] float32, or the top layer's h [T, N, H] for a head-less
        stack. Differentiable: when autograd records the call (grad enabled
        and x or a weight requires grad) it runs :class:`RnnScanFunction`,
        which launches K2 and K3 (LSTM) or K2-GRU and K4 (GRU) on a CUDA
        tensor (as the tensor-core stages at bf16, the fp32 stages at fp32;
        the dW stage at either) and their plain versions on a CPU tensor;
        with a chunk above 0, :class:`ChunkedRnnScanFunction`: K1's stages
        chunk by chunk forward (K1-bf16 at bf16), and the same training
        stages chunk by chunk backward, each chunk's K2 re-run from the
        states entering it. The chunk each call took is counted in
        :data:`train_chunks`.
        Otherwise the registered operators run from zero states
        (:func:`_op_stages`): the plain stages on a CPU tensor, those of K1
        or K1-GRU on a CUDA tensor (:func:`step_stages`): K1 at fp32, K1-bf16
        on a bf16 x (the weights rounded to bf16).
        On a CUDA tensor a stack whose H the walks do not take (not a
        multiple of 16, as Fast FullSubNet's 257) runs zero-padded to
        :func:`padded_hidden` units (exact: :func:`pad_stack` under autograd,
        :func:`_cached_pad` in :func:`step_stages` otherwise), its outputs
        and gradients cut back;
        at bf16 an input width that is not a multiple of
        :data:`TC_INPUT_MULTIPLE` runs zero-padded to one (:func:`pad_input`,
        exact), so that the tensor-core GEMMs take their 16-byte loads.
    """
    layers, fc = tuple(layers_and_fc[:-1]), layers_and_fc[-1]
    if time_major_features:
        x = x.transpose(1, 2)  # -> [T, N, F_in]
    cell = _check_stack(x, layers, fc)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused scan path for device {x.device}")
    if time_chunk is not None and (time_chunk < 0 or time_chunk % 8):
        raise ValueError(f"time_chunk must be a multiple of 8 steps (0: the full stash); "
                         f"got {time_chunk}")
    params = [*(l[k] for l in layers for k in ("w_ih", "w_hh", "b_ih", "b_hh")),
              *(() if fc is None else (fc["weight"], fc["bias"]))]
    grad = torch.is_grad_enabled() and any(v.requires_grad for v in (x, *params))
    if not grad:
        return _op_stages(x, layers, fc, None)[0]
    hidden = layers[0]["w_hh"].shape[1]
    width = padded_hidden(hidden) if x.device.type == "cuda" else hidden
    chunking = {"stash_budget": stash_budget, "time_chunk": time_chunk}
    if width != hidden:
        layers, fc = pad_stack(layers, fc, width)
        out = fused_subband_lstm(x, *layers, fc, **chunking)
        return out if fc is not None else out[..., :hidden]
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and x.shape[2] % TC_INPUT_MULTIPLE:
        x, layers = pad_input(x, layers, TC_INPUT_MULTIPLE)
        return fused_subband_lstm(x, *layers, fc, **chunking)
    if time_chunk is None:
        if stash_budget is None:
            stash_budget = stash_budget_bytes(STASH_BUDGET_SHARE, x.device)
        time_chunk = train_chunk(x.shape[0], x.shape[1], hidden, cell, x.element_size(),
                                 len(layers), stash_budget)
    train_chunks[time_chunk] += 1
    if time_chunk == 0:
        return RnnScanFunction.apply(x.contiguous(), len(layers), *params)
    return ChunkedRnnScanFunction.apply(x.contiguous(), len(layers), time_chunk, *params)
