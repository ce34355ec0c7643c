"""Streaming (frame-by-frame) inference (counterpart of
``fullsubnet_tpu/infer/streaming.py``).

The cumulative-norm models stream: unidirectional stacks, running-mean
norms and a look-ahead of a few frames. Each engine carries, per lane
(one lane per stream), every stack's (h, c), the norms' running sums and
the frame count, all as tensors on the model's device; a frame in gives
the cRM of the frame ``look_ahead`` frames back (Improved FullSubNet: the
enhanced spectrum of the same frame). The offline pad-then-slice is a
delay line, so the streamed output equals the offline forward.

* ``step`` takes one frame; ``step_block`` takes K frames and runs each
  stack once over them (T = K) with its state carried: frame t of a
  stack's input depends only on the stacks below at t, and the running
  sums over the K frames are a cumulative sum. Fast FullSubNet's
  bottleneck runs on the down clock and steps frame by frame.
* On a CUDA model every stack runs K1 or K1-GRU (``fwd_gemm`` and the
  cell's walk) from the carried state
  (``ops.subband_lstm.fused_subband_lstm_step``); on a CPU model their
  plain versions.
* The engines run natively over S lanes (``init_state(lanes)``,
  ``_block_lanes``): the full-band stage at N = S rows, the sub-band
  stage at N = S·257. :class:`MultiStreamEnhancer` advances S live
  streams in one batched hop a tick, an ``active`` mask selecting per
  lane with ``torch.where``.

:class:`StreamingEnhancer` wires framing, the window and ``rfft``, an
engine, the look-ahead spectrum delay line, the cIRM and the streaming
overlap-add iSTFT (:class:`StreamingISTFT`) into push-based wave in, wave
out, over the numpy host of ``infer/host.py``. The hop is eager PyTorch:
one host→device copy of the hop's samples and one device→host copy of the
enhanced hop, and no Python branch on a device value.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fullsubnet_tpu_torch.acoustics.mask import decompress_cIRM
from fullsubnet_tpu_torch.acoustics.norm import cumulative_laplace_norm
from fullsubnet_tpu_torch.acoustics.stft import hann_window, istft, stft_complex
from fullsubnet_tpu_torch.constant import EPSILON
from fullsubnet_tpu_torch.infer.host import MultiStreamHost, StreamingWaveHost
from fullsubnet_tpu_torch.models import FastFullSubNet, FullBandModel, FullSubNet
from fullsubnet_tpu_torch.models.improved_fullsubnet import ImprovedFullSubNet
from fullsubnet_tpu_torch.utils import resolve_device

# -- helpers over the engines' state -----------------------------------------


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-shaped dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _select(mask: torch.Tensor, new, old):
    """Per lane, ``new`` where ``mask`` [S] holds, else ``old``: every leaf
    has the lane axis first."""
    return _tree_map(
        lambda n, o: torch.where(mask.view(-1, *(1,) * (n.ndim - 1)), n, o), new, old)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _reflect(idx: np.ndarray, n: int) -> np.ndarray:
    """Positions in a vector of ``n`` entries reflect-padded on both sides
    (``mode="reflect"``, the edge not repeated; by fewer than ``n``) -> the
    positions they read in the vector."""
    idx = np.abs(idx)
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def _windows(n: int, starts: np.ndarray, width: int, pad: int, device) -> torch.Tensor:
    """[len(starts), width] indices into a vector of ``n`` entries: the
    windows of ``width`` at ``starts`` of the vector reflect-padded by
    ``pad``, as a gather into the unpadded one."""
    idx = starts[:, None] + np.arange(width)[None, :] - pad
    return torch.from_numpy(_reflect(idx, n)).to(device)


def _running(total: torch.Tensor, per_frame: torch.Tensor) -> torch.Tensor:
    """The running sums after each of K frames: ``total`` [S, ...] plus
    ``per_frame`` [K, S, ...], added frame after frame as K single steps
    add them -> [K, S, ...]."""
    return torch.cat([total[None], per_frame]).cumsum(0)[1:]


def _frame_counts(frame_idx: torch.Tensor, k: int) -> torch.Tensor:
    """[K, S] float32: each lane's 1-based frame count at each of K frames."""
    steps = torch.arange(1, k + 1, device=frame_idx.device, dtype=frame_idx.dtype)
    return (frame_idx[None] + steps[:, None]).float()


def _lane_state(stack, lanes: int, rows: int, device) -> list:
    """A stack's zero state for ``lanes`` lanes of ``rows`` rows each:
    leaves [lanes, rows, H]."""
    return _tree_map(lambda v: v.view(lanes, rows, -1), stack.init_state(lanes * rows, device))


def _stack_block(stack, state, x: torch.Tensor):
    """A stack over K frames from its lane state: x [K, S, rows, F] ->
    (state, y [K, S, rows, F_out]); the stack runs once at N = S·rows."""
    k, lanes, rows, _ = x.shape
    flat = _tree_map(lambda v: v.reshape(lanes * rows, v.shape[-1]), state)
    flat, y = stack.step_block(flat, x.reshape(k, lanes * rows, -1))
    return _tree_map(lambda v: v.view(lanes, rows, -1), flat), y.reshape(k, lanes, rows, -1)


def _check_cumulative(model) -> None:
    assert model.norm is cumulative_laplace_norm, "streaming requires a cumulative normalization"


class _FrameEngine:
    """The single-stream calls of an engine over its lane form
    (``init_state(lanes)``, ``_block_lanes(state, frames [K, S, F])``)."""

    device: torch.device

    def _frames(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return x if x.is_complex() else x.float()

    @torch.inference_mode()
    def step(self, state, frame):
        """One frame [F] in, one output [2, F] (Improved: [F] complex) out."""
        state, out = self._block_lanes(state, self._frames(frame)[None, None])
        return state, out[0, 0]

    @torch.inference_mode()
    def step_block(self, state, frames):
        """K frames [K, F] in, [K, 2, F] (Improved: [K, F] complex) out;
        equal to K calls of :meth:`step`."""
        state, out = self._block_lanes(state, self._frames(frames)[:, None])
        return state, out[:, 0]


class _MagnitudeEngine(_FrameEngine):
    """An engine of a magnitude-masking family: cRM out, ``look_ahead``
    frames late."""

    F: int
    look_ahead: int

    @torch.inference_mode()
    def enhance_spectrogram(self, noisy_mag) -> torch.Tensor:
        """[F, T] magnitudes -> [2, F, T] cRM with streaming semantics:
        ``look_ahead`` trailing zero frames fed (the offline pad) and the
        first ``look_ahead`` outputs dropped, which is the offline forward's
        pad-then-slice."""
        mag = self._frames(noisy_mag)
        frames = torch.cat([mag.T, mag.new_zeros(self.look_ahead, self.F)])
        _, crms = self.step_block(self.init_state(), frames)
        return crms[self.look_ahead :].permute(1, 2, 0)


# -- the engines ----------------------------------------------------------------


class StreamingFullSubNet(_MagnitudeEngine):
    """Frame-in / cRM-out engine of a FullSubNet with
    ``cumulative_laplace_norm`` (JAX ``StreamingFullSubNet``): the full-band
    stack at N = S rows of F, the sub-band stack at N = S·F units of
    2·sb_num_neighbors + 2, each with its (h, c) carried."""

    def __init__(self, model: FullSubNet):
        _check_cumulative(model)
        assert model.fb_num_neighbors == 0, "streaming supports fb neighbors=0"
        self.model = model
        self.device = _model_device(model)
        self.F = model.num_freqs
        self.N = model.sb_num_neighbors
        self.look_ahead = model.look_ahead
        self._unfold = _windows(self.F, np.arange(self.F), 2 * self.N + 1, self.N, self.device)

    def init_state(self, lanes: int = 1) -> dict:
        """Zero state of ``lanes`` streams: the stacks' states, the
        cumulative norms' running sums (a scalar a lane for the full band,
        one per bin for the sub band) and the frame count."""
        dev = self.device
        return {
            "fb_rnn": _lane_state(self.model.fb_model, lanes, 1, dev),
            "sb_rnn": _lane_state(self.model.sb_model, lanes, self.F, dev),
            "fb_norm_sum": torch.zeros(lanes, device=dev),
            "sb_norm_sum": torch.zeros(lanes, self.F, device=dev),
            "frame_idx": torch.zeros(lanes, dtype=torch.int32, device=dev),
        }

    def _block_lanes(self, state: dict, frames: torch.Tensor):
        """frames [K, S, F] noisy magnitudes -> (state, cRM [K, S, 2, F])."""
        k = _frame_counts(state["frame_idx"], frames.shape[0])  # [K, S]
        fb_sum = _running(state["fb_norm_sum"], frames.sum(-1))
        fb_in = frames / (fb_sum / (k * self.F) + EPSILON)[..., None]
        fb_rnn, fb_out = _stack_block(self.model.fb_model, state["fb_rnn"], fb_in[:, :, None])

        # [K, S, F, 2N+1] reflect-padded neighbourhoods and the full-band output
        sb_in = torch.cat([frames[..., self._unfold], fb_out[:, :, 0, :, None]], dim=-1)
        sb_sum = _running(state["sb_norm_sum"], sb_in.sum(-1))  # [K, S, F]
        sb_in = sb_in / (sb_sum / (k[..., None] * sb_in.shape[-1]) + EPSILON)[..., None]
        sb_rnn, crm = _stack_block(self.model.sb_model, state["sb_rnn"], sb_in)  # [K, S, F, 2]
        new_state = {
            "fb_rnn": fb_rnn,
            "sb_rnn": sb_rnn,
            "fb_norm_sum": fb_sum[-1],
            "sb_norm_sum": sb_sum[-1],
            "frame_idx": state["frame_idx"] + frames.shape[0],
        }
        return new_state, crm.transpose(-1, -2)


class StreamingFullBand(_MagnitudeEngine):
    """Frame-in / cRM-out engine of the full-band baseline with
    ``cumulative_laplace_norm`` (JAX ``StreamingFullBand``): one stack at
    N = S rows, a running sum and a frame count a lane."""

    def __init__(self, model: FullBandModel):
        _check_cumulative(model)
        self.model = model
        self.device = _model_device(model)
        self.F = model.num_freqs
        self.look_ahead = model.look_ahead

    def init_state(self, lanes: int = 1) -> dict:
        dev = self.device
        return {
            "rnn": _lane_state(self.model.fullband_model, lanes, 1, dev),
            "norm_sum": torch.zeros(lanes, device=dev),
            "frame_idx": torch.zeros(lanes, dtype=torch.int32, device=dev),
        }

    def _block_lanes(self, state: dict, frames: torch.Tensor):
        """frames [K, S, F] -> (state, cRM [K, S, 2, F])."""
        k = _frame_counts(state["frame_idx"], frames.shape[0])
        norm_sum = _running(state["norm_sum"], frames.sum(-1))
        x = frames / (norm_sum / (k * self.F) + EPSILON)[..., None]
        rnn, out = _stack_block(self.model.fullband_model, state["rnn"], x[:, :, None])
        new_state = {"rnn": rnn, "norm_sum": norm_sum[-1],
                     "frame_idx": state["frame_idx"] + frames.shape[0]}
        return new_state, out.reshape(*frames.shape[:2], 2, self.F)


class StreamingFastFullSubNet(_MagnitudeEngine):
    """Frame-in / cRM-out engine of Fast FullSubNet with
    ``cumulative_laplace_norm`` (JAX ``StreamingFastFullSubNet``; the
    reference's ``real_time_down/upsampling`` exists for this mode).

    The encoder and the decoder run at the frame clock over all K frames
    of a block at once (N = S rows). The bottleneck (N = S·M rows) runs at
    the down clock: frame 0 alone, then the mean of each completed block of
    ``shrink_size`` frames; its step is computed every frame and kept, per
    lane, only where the lane's clock emits (``torch.where``), and its
    latest output is held for the decoder until the next block completes.
    The offline trim ``up[t] = down[t // s]`` never reads the partial tail
    block, so this is exact."""

    def __init__(self, model: FastFullSubNet):
        _check_cumulative(model)
        self.model = model
        self.device = _model_device(model)
        self.F = model.num_freqs
        self.M = model.num_mels
        n_noisy, n_enc = model.noisy_input_num_neighbors, model.enc_output_num_neighbors
        self.unit = (2 * n_noisy + 1) + (2 * n_enc + 1)
        self.look_ahead = model.look_ahead
        mels = np.arange(self.M)
        self._unfold_noisy = _windows(self.M, mels, 2 * n_noisy + 1, n_noisy, self.device)
        self._unfold_enc = _windows(self.M, mels, 2 * n_enc + 1, n_enc, self.device)

    def init_state(self, lanes: int = 1) -> dict:
        m, dev = self.model, self.device
        zeros = lambda *shape: torch.zeros(lanes, *shape, device=dev)  # noqa: E731
        return {
            "enc0_rnn": _lane_state(m.encoder[0], lanes, 1, dev),
            "enc1_rnn": _lane_state(m.encoder[1], lanes, 1, dev),
            "bn_rnn": _lane_state(m.bottleneck, lanes, self.M, dev),
            "dec0_rnn": _lane_state(m.decoder_lstm[0], lanes, 1, dev),
            "dec1_rnn": _lane_state(m.decoder_lstm[1], lanes, 1, dev),
            "mel_norm_sum": zeros(),
            "bn_norm_sum": zeros(self.M),
            "bn_block_acc": zeros(self.M, self.unit),  # the open shrink block's sum
            "bn_out": zeros(self.M),  # the held (repeat-upsampled) bottleneck output
            "down_idx": torch.zeros(lanes, dtype=torch.int32, device=dev),
            "frame_idx": torch.zeros(lanes, dtype=torch.int32, device=dev),
        }

    def _bottleneck_step(self, st: dict, unit: torch.Tensor, t: torch.Tensor) -> dict:
        """One frame of the down clock: ``unit`` [S, M, unit] this frame's
        sub-band units, ``t`` [S] its 0-based index. A lane emits at frame 0
        and when frame t closes a block (t % shrink == 0); otherwise only its
        block sum grows."""
        s = self.model.shrink_size
        emit = t % s == 0
        down = torch.where((t == 0)[:, None, None], unit, (st["bn_block_acc"] + unit) / s)
        count = (st["down_idx"] + 1).float()
        sums = st["bn_norm_sum"] + down.sum(-1)  # [S, M]
        normed = down / (sums / (count[:, None] * self.unit) + EPSILON)[..., None]
        rnn, out = _stack_block(self.model.bottleneck, st["bn_rnn"], normed[None])
        fresh = {"bn_rnn": rnn, "bn_norm_sum": sums, "bn_out": out[0, :, :, 0],
                 # a new block opens after an emission
                 "bn_block_acc": torch.zeros_like(unit)}
        kept = {**st, "bn_block_acc": st["bn_block_acc"] + unit}
        new = _select(emit, fresh, {k: kept[k] for k in fresh})
        new["down_idx"] = st["down_idx"] + emit.int()
        return new

    def _block_lanes(self, state: dict, frames: torch.Tensor):
        """frames [K, S, F] -> (state, cRM [K, S, 2, F])."""
        m = self.model
        k_frames, lanes = frames.shape[:2]
        k = _frame_counts(state["frame_idx"], k_frames)

        # the mel projection and the encoder (frame clock)
        mel = frames @ m.mel_scale.fb  # [K, S, M]
        mel_sum = _running(state["mel_norm_sum"], mel.sum(-1))
        enc_in = (mel / (mel_sum / (k * self.M) + EPSILON)[..., None])[:, :, None]
        enc0_rnn, h = _stack_block(m.encoder[0], state["enc0_rnn"], enc_in)
        enc1_rnn, enc_out = _stack_block(m.encoder[1], state["enc1_rnn"], h)
        enc_out = enc_out[:, :, 0]  # [K, S, M]
        bn_in = torch.cat([mel[..., self._unfold_noisy], enc_out[..., self._unfold_enc]], dim=-1)

        # the bottleneck (down clock), frame by frame
        keys = ("bn_rnn", "bn_norm_sum", "bn_block_acc", "bn_out", "down_idx")
        st = {key: state[key] for key in keys}
        held = []
        for j in range(k_frames):
            st = self._bottleneck_step(st, bn_in[j], state["frame_idx"] + j)
            held.append(st["bn_out"])

        # the decoder (frame clock) on the held bottleneck output
        dec_in = torch.cat([enc_out, torch.stack(held)], dim=-1)[:, :, None]  # [K, S, 1, 2M]
        dec0_rnn, h = _stack_block(m.decoder_lstm[0], state["dec0_rnn"], dec_in)
        dec1_rnn, out = _stack_block(m.decoder_lstm[1], state["dec1_rnn"], h)
        new_state = {
            **st,
            "enc0_rnn": enc0_rnn,
            "enc1_rnn": enc1_rnn,
            "dec0_rnn": dec0_rnn,
            "dec1_rnn": dec1_rnn,
            "mel_norm_sum": mel_sum[-1],
            "frame_idx": state["frame_idx"] + k_frames,
        }
        return new_state, out.reshape(k_frames, lanes, 2, self.F)


class StreamingImprovedFullSubNet(_FrameEngine):
    """Spectrum-frame engine of Improved FullSubNet with
    ``cumulative_laplace_norm`` (JAX ``StreamingImprovedFullSubNet``; no
    look-ahead). Per frame: |X|**fdrc without the last bin -> the
    full-band stack (N = S rows) on its running-mean norm -> per section,
    the strided units (fixed index grids into the reflect-padded
    frequency axis), their per-unit running sums and the section's stack
    (N = S·n_units rows) -> the cRM, its last bin 0 -> the reference's
    element-wise mask (real by real, imag by imag). Complex STFT frames
    in, enhanced complex frames out."""

    def __init__(self, model: ImprovedFullSubNet):
        _check_cumulative(model)
        assert model.sb_model.norm is cumulative_laplace_norm
        self.model = model
        self.device = _model_device(model)
        self.F = model.num_freqs
        f = self.F - 1  # the last bin is dropped for the stacks
        sbm = model.sb_model
        self.sections = []
        for i in range(len(sbm.sb_models)):
            lower, upper = sbm._section_bounds(i, f)
            c = sbm.sb_num_center_freqs[i]
            assert c == sbm.fb_num_center_freqs[i], "aligned sb/fb center counts required"
            nb_s, nb_f = sbm.sb_num_neighbor_freqs[i], sbm.fb_num_neighbor_freqs[i]
            n_units = (upper - lower) // c
            starts = np.arange(n_units) * c + lower
            self.sections.append({
                "idx_noisy": _windows(f, starts, c + 2 * nb_s, nb_s, self.device),
                "idx_fb": _windows(f, starts, c + 2 * nb_f, nb_f, self.device),
                "n_units": n_units,
                "centers": c,
            })

    def init_state(self, lanes: int = 1) -> dict:
        dev = self.device
        state = {
            "fb_rnn": _lane_state(self.model.fb_model, lanes, 1, dev),
            "fb_norm_sum": torch.zeros(lanes, device=dev),
            "frame_idx": torch.zeros(lanes, dtype=torch.int32, device=dev),
        }
        for i, (sec, stack) in enumerate(zip(self.sections, self.model.sb_model.sb_models)):
            state[f"sec{i}_rnn"] = _lane_state(stack, lanes, sec["n_units"], dev)
            state[f"sec{i}_norm_sum"] = torch.zeros(lanes, sec["n_units"], device=dev)
        return state

    def _block_lanes(self, state: dict, spec: torch.Tensor):
        """spec [K, S, F] complex -> (state, enhanced [K, S, F] complex)."""
        model = self.model
        k_frames, lanes = spec.shape[:2]
        k = _frame_counts(state["frame_idx"], k_frames)
        x = (spec.abs() ** model.fdrc)[..., : self.F - 1]  # [K, S, F-1]

        fb_sum = _running(state["fb_norm_sum"], x.sum(-1))
        fb_in = x / (fb_sum / (k * (self.F - 1)) + EPSILON)[..., None]
        fb_rnn, fb_out = _stack_block(model.fb_model, state["fb_rnn"], fb_in[:, :, None])
        fb_out = fb_out[:, :, 0]  # [K, S, F-1]

        new_state = {"fb_rnn": fb_rnn, "fb_norm_sum": fb_sum[-1],
                     "frame_idx": state["frame_idx"] + k_frames}
        outs = []
        for i, (sec, stack) in enumerate(zip(self.sections, model.sb_model.sb_models)):
            sb_in = torch.cat([x[..., sec["idx_noisy"]], fb_out[..., sec["idx_fb"]]], dim=-1)
            sums = _running(state[f"sec{i}_norm_sum"], sb_in.sum(-1))  # [K, S, units]
            sb_in = sb_in / (sums / (k[..., None] * sb_in.shape[-1]) + EPSILON)[..., None]
            rnn, out = _stack_block(stack, state[f"sec{i}_rnn"], sb_in)  # [K, S, units, 2c]
            new_state[f"sec{i}_rnn"] = rnn
            new_state[f"sec{i}_norm_sum"] = sums[-1]
            out = out.view(k_frames, lanes, sec["n_units"], 2, sec["centers"]).transpose(2, 3)
            outs.append(out.reshape(k_frames, lanes, 2, -1))
        crm = F.pad(torch.cat(outs, dim=-1), (0, 1))  # [K, S, 2, F], the last bin 0
        # the reference's element-wise (non-complex) masking, kept for parity
        enhanced = torch.complex(crm[:, :, 0] * spec.real, crm[:, :, 1] * spec.imag)
        return new_state, enhanced

    @torch.inference_mode()
    def enhance_wave(self, wave) -> torch.Tensor:
        """[T] -> [T] enhanced with streaming semantics; equal to the
        offline forward."""
        m = self.model
        wave = self._frames(wave)
        spec = stft_complex(wave[None], m.n_fft, m.hop_length, m.win_length)[0]  # [F, T']
        _, enhanced = self.step_block(self.init_state(), spec.T)  # [T', F]
        return istft(enhanced.T[None], m.n_fft, m.hop_length, m.win_length,
                     length=wave.shape[-1])[0]


def make_streaming_engine(model):
    """The frame-in / cRM-out engine of a magnitude-masking model of the
    family, by its class. Improved FullSubNet masks inside its own engine
    (:class:`StreamingImprovedFullSubNet`), which :class:`StreamingEnhancer`
    wraps in its spectrum-domain mode."""
    if isinstance(model, FullSubNet):
        return StreamingFullSubNet(model)
    if isinstance(model, FullBandModel):
        return StreamingFullBand(model)
    if isinstance(model, FastFullSubNet):
        return StreamingFastFullSubNet(model)
    raise TypeError(f"no magnitude streaming engine for {type(model).__name__}")


# -- the overlap-add iSTFT and the wave-in / wave-out enhancers ----------------


class StreamingISTFT:
    """Streaming inverse STFT by overlap-add, one hop of samples a frame.

    Output hop k sums the windowed frames k - r, r = 0..min(k, ratio - 1),
    so the first ratio - 1 hops see a partial squared-window envelope (at
    50% overlap the first hop only; more at 75%). A table of the envelope
    after each warm-up hop normalises each hop by the frames accumulated so
    far; its last row is the steady state. ``push`` takes frames of any
    leading shape that matches the state's (``init_state(lanes)``). The
    state lives on ``device`` (the card unless the caller names the CPU);
    a frame on another device raises rather than being copied across."""

    def __init__(self, n_fft: int, hop_length: int, device: str | torch.device = "cuda"):
        assert n_fft % hop_length == 0
        self.n_fft = n_fft
        self.hop = hop_length
        self.ratio = n_fft // hop_length
        self.device = resolve_device(device)
        self.window = hann_window(n_fft, device=self.device)
        wsq = self.window.cpu().numpy() ** 2
        envs = np.cumsum(wsq.reshape(self.ratio, hop_length).astype(np.float64), axis=0)
        self.envelopes = torch.from_numpy(np.maximum(envs, 1e-11)).float().to(self.device)

    def init_state(self, lanes: int | None = None) -> dict:
        """The accumulator [n_fft] and the warm-up index, or [lanes, n_fft]
        and [lanes] for ``lanes`` streams."""
        shape = () if lanes is None else (lanes,)
        return {"acc": torch.zeros(*shape, self.n_fft, device=self.device),
                "k": torch.zeros(shape, dtype=torch.int32, device=self.device)}

    def push(self, state: dict, spec_frame, advance=True):
        """spec_frame [..., F] complex -> (state, samples [..., hop]).

        ``advance`` (a bool, or a bool tensor of the lanes): whether this
        frame counts toward the warm-up envelope index. The enhancer's
        look-ahead warm-up pushes zero spectra (their output is dropped on
        the host); they must not advance it, or the first real frame would
        be normalised by a too-full envelope. Zero frames leave the
        accumulator as it is. A host array is copied to the state's device;
        a tensor must already be there."""
        if isinstance(spec_frame, torch.Tensor) and spec_frame.device != state["acc"].device:
            raise ValueError(f"a frame on {spec_frame.device} pushed into an overlap-add "
                             f"state on {state['acc'].device}")
        spec_frame = torch.as_tensor(spec_frame, device=self.device)
        frame = torch.fft.irfft(spec_frame, n=self.n_fft) * self.window
        acc = state["acc"] + frame
        env = self.envelopes[torch.clamp(state["k"], max=self.ratio - 1).long()]
        out = acc[..., : self.hop] / env
        new_state = {"acc": F.pad(acc[..., self.hop :], (0, self.hop)), "k": state["k"] + advance}
        return new_state, out


class StreamingEnhancer(StreamingWaveHost):
    """Push-based wave-in / wave-out real-time enhancer (JAX
    ``StreamingEnhancer``) on the model's device.

    Streaming STFT framing (the offline reflect center pad reproduced at
    stream start by the host), a frame engine (any magnitude-masking family
    through :func:`make_streaming_engine`, or Improved FullSubNet's
    spectrum-domain engine), the look-ahead spectrum delay line, cIRM
    decompression and the complex mask, and the streaming OLA iSTFT. Feed
    blocks of samples of any size with ``push``, end with ``flush``; the
    concatenated output is ``enhanced[0:]``, sample-aligned with the input
    and equal to the offline ``full_band_crm_mask`` (``time_domain`` for
    Improved FullSubNet) except the last ~``n_fft // 2`` samples (the stream
    drains with zeros where the offline pipeline reflect-pads the tail).
    Enhanced sample j comes out once j + n_fft // 2 + (1 + look_ahead)·hop
    samples are in: the algorithmic latency.

    A hop is one eager pass on the device (framing buffer, window, rfft,
    the engine at T = 1, the delay line, the mask, the OLA) with one
    host→device copy of the hop's samples and one device→host copy of the
    enhanced hop."""

    def __init__(self, model, n_fft: int = 512, hop_length: int = 256, win_length=None):
        # the streaming analysis window is a full-length hann(n_fft); a
        # shorter (center-padded) offline window would silently diverge
        if win_length is not None and win_length != n_fft:
            raise ValueError(
                "streaming uses a full-length analysis window; "
                f"win_length must equal n_fft (got {win_length} != {n_fft})"
            )
        # Improved FullSubNet masks inside its engine (spectrum frame in,
        # enhanced spectrum out, no look-ahead); the magnitude families emit
        # a cRM that this wrapper decompresses and applies
        self._spec_domain = isinstance(model, ImprovedFullSubNet)
        if self._spec_domain:
            assert n_fft == model.n_fft and hop_length == model.hop_length, (
                "streaming STFT shape must match the model's "
                f"({model.n_fft}/{model.hop_length})"
            )
            assert model.win_length == model.n_fft, "streaming requires win_length == n_fft"
            self.engine = StreamingImprovedFullSubNet(model)
            self.look_ahead = 0
        else:
            self.engine = make_streaming_engine(model)
            self.look_ahead = model.look_ahead
        self.n_fft = n_fft
        self.hop = hop_length
        self.F = n_fft // 2 + 1
        self.device = self.engine.device
        self.window = hann_window(n_fft, device=self.device)
        self.ola = StreamingISTFT(n_fft, hop_length, self.device)

    def _to_device(self, samples: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(samples, np.float32)).to(self.device)

    @torch.inference_mode()
    def _dev_init(self, buf: np.ndarray):
        return self._init_device_state(self._to_device(buf)[None])

    @torch.inference_mode()
    def _dev_hop(self, dstate, hop_samples: np.ndarray):
        dstate, out = self._hop_lanes(dstate, self._to_device(hop_samples)[None])
        return dstate, out[0].cpu().numpy()

    def _init_device_state(self, buf: torch.Tensor) -> dict:
        """The device state of S lanes from their first n_fft - hop staged
        samples ``buf`` [S, n_fft - hop]."""
        lanes = buf.shape[0]
        state = {
            "buf": buf.float(),  # the trailing n_fft - hop samples of the last frame
            "engine": self.engine.init_state(lanes),
            "ola": self.ola.init_state(lanes),
        }
        if not self._spec_domain:
            # the delay line starts with zero spectra: for the first
            # look_ahead hops the masked target is zero, so is its OLA
            # output, and the host drops those hops
            state["spec_delay"] = torch.zeros(lanes, self.look_ahead, self.F,
                                              dtype=torch.complex64, device=self.device)
            # the first look_ahead hops feed the OLA a zero target and must
            # not advance its warm-up envelope index
            state["hops"] = torch.zeros(lanes, dtype=torch.int32, device=self.device)
        return state

    def _hop_lanes(self, dstate: dict, hop_samples: torch.Tensor):
        """One hop of S lanes on the device: [S, hop] samples -> (state,
        [S, hop] enhanced)."""
        samples = torch.cat([dstate["buf"], hop_samples], dim=-1)  # [S, n_fft]
        spec = torch.fft.rfft(samples * self.window)  # [S, F]
        if self._spec_domain:  # the engine masks (Improved FullSubNet)
            eng, enhanced = self.engine._block_lanes(dstate["engine"], spec[None])
            ola, out = self.ola.push(dstate["ola"], enhanced[0])
            return {"buf": samples[:, self.hop :], "engine": eng, "ola": ola}, out
        eng, crm = self.engine._block_lanes(dstate["engine"], spec.abs()[None])
        crm = decompress_cIRM(crm[0])  # [S, 2, F]
        if self.look_ahead > 0:
            target = dstate["spec_delay"][:, 0]
            spec_delay = torch.cat([dstate["spec_delay"][:, 1:], spec[:, None]], dim=1)
        else:
            target, spec_delay = spec, dstate["spec_delay"]
        er = crm[:, 0] * target.real - crm[:, 1] * target.imag
        ei = crm[:, 1] * target.real + crm[:, 0] * target.imag
        ola, out = self.ola.push(dstate["ola"], torch.complex(er, ei),
                                 advance=dstate["hops"] >= self.look_ahead)
        new_state = {"buf": samples[:, self.hop :], "engine": eng, "ola": ola,
                     "spec_delay": spec_delay, "hops": dstate["hops"] + 1}
        return new_state, out


class MultiStreamEnhancer(MultiStreamHost):
    """Up to ``max_streams`` concurrent real-time streams, one batched hop
    on the device a tick (JAX ``MultiStreamEnhancer``).

    The hop of :class:`StreamingEnhancer` runs natively over the S =
    ``max_streams`` lanes: the stacks at N = S rows (the full band) and
    N = S·257 (FullSubNet's sub band). An ``active`` mask [S] keeps an idle
    lane's state (``torch.where``) and zeroes its output, so a stream that
    lags sits masked while the others tick; each lane keeps its own frame
    count and OLA envelope index. Opening a slot writes that lane of every
    state tensor in place. Each stream's output is that of its own
    :class:`StreamingEnhancer`."""

    def __init__(self, model, n_fft: int = 512, hop_length: int = 256, max_streams: int = 8,
                 win_length=None):
        self._enh = StreamingEnhancer(model, n_fft, hop_length, win_length=win_length)
        self.n_fft = n_fft
        self.hop = hop_length
        self.look_ahead = self._enh.look_ahead
        self.max_streams = int(max_streams)
        self.device = self._enh.device

    # -- the device programs, tensors in and out (JAX ``_init_batched_impl``,
    # ``_reset_impl``, the vmapped ``_hop_lane``): what ``serving.py`` exports

    def _init_batched_impl(self) -> dict:
        """The zero state of every lane."""
        return self._enh._init_device_state(
            torch.zeros(self.max_streams, self.n_fft - self.hop, device=self.device))

    def _reset_impl(self, bstate: dict, slot: torch.Tensor, buf: torch.Tensor) -> dict:
        """A new state where lane ``slot`` (a 0-d integer tensor) starts from
        its first n_fft - hop samples ``buf`` and every other lane is kept:
        a lane mask selects with ``torch.where``, no write in place."""
        fresh = self._enh._init_device_state(buf[None])  # one lane, broadcast
        lane = torch.arange(self.max_streams, device=buf.device) == slot
        return _select(lane, fresh, bstate)

    def _hop_batch_impl(self, bstate: dict, hops: torch.Tensor, active: torch.Tensor):
        """One hop of every lane, hops [S, hop]: an idle lane (``active``
        [S] False) keeps its state and gives zeros. Returns (state, [S, hop])."""
        new_state, out = self._enh._hop_lanes(bstate, hops)
        return _select(active, new_state, bstate), torch.where(active[:, None], out, 0.0)

    # -- the host's device hooks

    @torch.inference_mode()
    def _dev_init_batched(self):
        return self._init_batched_impl()

    @torch.inference_mode()
    def _dev_reset(self, bstate, slot: int, buf: np.ndarray):
        # the live host keeps its state tensors and writes them in place
        slot = torch.tensor(slot, device=self.device)
        new = self._reset_impl(bstate, slot, self._enh._to_device(buf))
        _tree_map(lambda full, value: full.copy_(value), bstate, new)
        return bstate

    @torch.inference_mode()
    def _dev_hop_batch(self, bstate, hops: np.ndarray, active: np.ndarray):
        active = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        bstate, out = self._hop_batch_impl(bstate, self._enh._to_device(hops), active)
        return bstate, out.cpu().numpy()
