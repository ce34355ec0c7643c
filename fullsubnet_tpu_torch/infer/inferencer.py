"""Inference runtime (counterpart of ``fullsubnet_tpu/infer/inferencer.py``).

The six strategies of the JAX package (``[inferencer] type``), each
followed by an unconditional peak normalisation to 0.8 full scale on
write:

* ``full_band_crm_mask``, which every shipped inference config uses, for
  the mask models: STFT -> magnitude -> model -> cIRM decompression
  (clamp ±9.9) -> complex mask -> iSTFT at the input length;
* ``mag``: the model's channel 0 is the enhanced magnitude, joined with
  the noisy phase;
* ``scaled_mask``: the model's two channels are a complex mask on the
  noisy spectrum, applied as they are;
* ``sub_band_crm_mask``, for the sub-band baseline: the utterance's
  magnitude unfolded into [F, 2N+1, T] units (``[inferencer.args]
  n_neighbor``, default 15, and ``pad_mode``, default "reflect"), the
  model's 3-D form, cIRM decompression clamped at ±9.99, the complex mask
  and the iSTFT;
* ``time_domain``, for the wave-to-wave model (Improved FullSubNet): the
  model maps the waveform to the enhanced one;
* ``overlapped_chunk``, for the wave-to-wave model too: ``time_domain``
  over chunks of ``[inferencer.args] chunk_length`` seconds (default 4)
  at a hop of half a chunk, each with the 256 samples before it as
  history, joined by a Hann window's overlap-add.

With ``[inferencer] batch_size = 1`` each utterance runs at its exact
length. With ``batch_size > 1`` (and ``bucket_seconds > 0``, default 1.0),
for the models that take ``valid_frames`` under ``full_band_crm_mask``
(``bucketed_capable``: FullSubNet, the full-band baseline and Fast
FullSubNet) and those that take ``valid_samples`` under ``time_domain``
(``time_domain_bucketed_capable``: Improved FullSubNet; any other model
or strategy runs every utterance at its exact length, as in the JAX
package), utterances are grouped by length bucket (their length plus one
FFT frame, rounded up to a multiple of ``bucket_seconds``) and each flush
of up to ``batch_size`` utterances of a bucket is enhanced as one
zero-padded [rows, bucket] batch with a vector of true lengths
(``bucketed_enhance``, ``bucketed_time_domain``): the model takes
``valid_frames`` or ``valid_samples``, and each row's output equals its
unpadded run's. A partial flush runs only its own rows: eager PyTorch
needs no fixed batch shape, so it pads no filler rows. Utterances of at
most ``n_fft // 2`` samples take the exact path. ``mag``, ``scaled_mask``
and ``sub_band_crm_mask`` never bucket, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fullsubnet_tpu_torch import config as config_lib
from fullsubnet_tpu_torch.acoustics.feature import freq_unfold
from fullsubnet_tpu_torch.acoustics.mask import complex_mul, decompress_cIRM
from fullsubnet_tpu_torch.acoustics.stft import (
    insert_tail_reflection,
    istft,
    stft_complex,
    traced_num_frames,
)
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict
from fullsubnet_tpu_torch.data.wavio import write_wav
from fullsubnet_tpu_torch.infer.host import pad_bucket_batch
from fullsubnet_tpu_torch.models import (
    FastFullSubNet,
    FullBandModel,
    FullSubNet,
    SubBandBaseline,
    is_wave_to_wave,
)
from fullsubnet_tpu_torch.utils import prepare_empty_dir, resolve_device


def predict_crm(model, acoustics: dict, noisy: torch.Tensor,
                compute_dtype: torch.dtype | None = None):
    """noisy [B, T] on the model's device -> (decompressed cIRM [B, F, T',
    2] fp32, complex STFT [B, F, T']): the magnitude cast to
    ``compute_dtype`` (None: as it is) before the model (a bf16 one runs the
    stacks on K1-bf16 on a card), the cRM back to fp32 after it."""
    spec = stft_complex(noisy, acoustics["n_fft"], acoustics["hop_length"],
                        acoustics["win_length"])
    mag = spec.abs()[:, None]
    crm = model(mag if compute_dtype is None else mag.to(compute_dtype), dropping_band=False)
    return decompress_cIRM(crm.permute(0, 2, 3, 1).float()), spec


def full_band_crm_mask(model, acoustics: dict, noisy: torch.Tensor,
                       compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The ``full_band_crm_mask`` strategy's device function: noisy [B, T]
    on the model's device -> enhanced [B, T] (:func:`predict_crm`, the
    complex mask, the iSTFT at the input length). Tensors in and out, no
    host value read."""
    crm, spec = predict_crm(model, acoustics, noisy, compute_dtype)
    real, imag = complex_mul(spec.real, spec.imag, crm[..., 0], crm[..., 1])
    return istft((real, imag), acoustics["n_fft"], acoustics["hop_length"],
                 acoustics["win_length"], length=noisy.shape[-1], input_type="real_imag")


def bucketed_enhance(model, acoustics: dict, noisy: torch.Tensor,
                     true_len: torch.Tensor) -> torch.Tensor:
    """Enhance a zero-padded batch (JAX ``build_bucketed_enhance_fn``):
    noisy [B, bucket] on the model's device, ``true_len`` the true sample
    counts, a tensor on that device: [B], or one count for every row (each
    above ``n_fft // 2`` and at most ``bucket - n_fft // 2``). Returns [B,
    bucket], zero past each row's length, where row b's first ``true_len[b]``
    samples equal its unpadded run's: the tail reflection is re-created at
    each true length, the padded frames are zeroed and the model takes the
    true frame counts (``valid_frames``), and one masked iSTFT
    (``frame_mask``) reads each row's real frames only. Tensors in and out,
    no host value read: ``torch.export`` traces it for a length bucket."""
    n_fft, hop, win = acoustics["n_fft"], acoustics["hop_length"], acoustics["win_length"]
    true_len = true_len.long().reshape(-1).expand(noisy.shape[0])
    frames = traced_num_frames(true_len, hop, n_fft)
    reflected = insert_tail_reflection(noisy, true_len, n_fft)
    spec = stft_complex(reflected, n_fft, hop, win)
    real = torch.arange(spec.shape[-1], device=noisy.device) < frames[:, None]
    crm = model((spec.abs() * real[:, None, :])[:, None], dropping_band=False,
                valid_frames=frames)
    crm = decompress_cIRM(crm.permute(0, 2, 3, 1))
    er, ei = complex_mul(spec.real, spec.imag, crm[..., 0], crm[..., 1])
    out = istft((er, ei), n_fft, hop, win, length=noisy.shape[-1], input_type="real_imag",
                frame_mask=real)
    return out * (torch.arange(out.shape[-1], device=noisy.device) < true_len[:, None])


def bucketed_time_domain(model, noisy: torch.Tensor, true_len: torch.Tensor) -> torch.Tensor:
    """Enhance a zero-padded batch with a wave-to-wave model: noisy [B,
    bucket] on the model's device, ``true_len`` the true sample counts as
    :func:`bucketed_enhance` takes them (each above ``n_fft // 2`` and at
    most ``bucket - n_fft // 2``). Returns [B, bucket], zero past each row's
    length, where row b's first ``true_len[b]`` samples equal its unpadded
    run's (the model takes ``valid_samples``)."""
    true_len = true_len.long().reshape(-1).expand(noisy.shape[0])
    out = model(noisy, valid_samples=true_len)[:, 0]
    return out * (torch.arange(out.shape[-1], device=noisy.device) < true_len[:, None])


def time_domain_bucketed_capable(model) -> bool:
    """Whether the ``time_domain`` strategy can bucket ``model`` (JAX
    ``infer/inferencer.py:time_domain_bucketed_capable``): the wave-to-wave
    models, which all take ``valid_samples`` (Improved FullSubNet)."""
    return is_wave_to_wave(model)


def bucketed_capable(model, strategy: str) -> bool:
    """Whether length-bucketed enhancement is exact for ``model`` under
    ``strategy`` (JAX ``infer/inferencer.py:bucketed_capable``): the models
    that take ``valid_frames`` (FullSubNet, the full-band baseline, Fast
    FullSubNet) under ``full_band_crm_mask``. The port's stacks are all
    unidirectional."""
    return strategy == "full_band_crm_mask" and isinstance(
        model, (FullSubNet, FullBandModel, FastFullSubNet))


_TIME_DOMAIN = ("time_domain", "overlapped_chunk")
_STRATEGIES = ("mag", "scaled_mask", "sub_band_crm_mask", "full_band_crm_mask", *_TIME_DOMAIN)


class Inferencer:
    def __init__(
        self,
        config: dict,
        checkpoint_path: str,
        output_dir: str | None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.acoustics = config_lib.acoustics_args(config)
        self.inference_config = config.get("inferencer", {})
        self.strategy = self.inference_config.get("type", "full_band_crm_mask")
        if self.strategy not in _STRATEGIES:
            raise NotImplementedError(
                f"Unknown inference type {self.strategy!r}; choose from {', '.join(_STRATEGIES)}."
            )
        self.inference_args = self.inference_config.get("args", {}) or {}
        self.batch_size = int(self.inference_config.get("batch_size", 1))
        # utterances are padded up to a multiple of this many seconds (+ one
        # FFT frame of reflection headroom); 0 runs every utterance alone
        self.bucket_seconds = float(self.inference_config.get("bucket_seconds", 1.0))
        self.sr = self.acoustics["sr"]

        ds_section = config.get("dataset", config.get("inference_dataset"))
        self.dataset = (
            config_lib.build_dataset(ds_section, "inference")
            if ds_section is not None
            else None
        )

        self.model, _ = config_lib.build_model(config)
        self.model.load_state_dict(load_torch_state_dict(Path(checkpoint_path).expanduser()))
        self.model.to(self.device).eval()
        # the waveform models run only the time-domain strategies, and only
        # the sub-band baseline takes the [F, 2N+1, T] units
        if (is_wave_to_wave(self.model) != (self.strategy in _TIME_DOMAIN)
                or (self.strategy == "sub_band_crm_mask"
                    and not isinstance(self.model, SubBandBaseline))):
            raise ValueError(f"{type(self.model).__name__} does not run under the "
                             f"{self.strategy!r} strategy")

        if output_dir is not None:
            self.output_dir = Path(output_dir).expanduser().absolute()
            self.enhanced_dir = self.output_dir / "enhanced"
            self.noisy_dir = self.output_dir / "noisy"
            prepare_empty_dir([self.enhanced_dir, self.noisy_dir])
        else:
            self.output_dir = self.enhanced_dir = self.noisy_dir = None

    # -- the strategies' device functions: noisy [1, T] -> enhanced [1, T] on
    # the model's device, tensors in and out (JAX ``_<strategy>_fn``; what
    # ``serving.py`` exports); the host methods below run them under
    # ``torch.inference_mode`` and return numpy

    def _stft(self, noisy: torch.Tensor) -> torch.Tensor:
        a = self.acoustics
        return stft_complex(noisy, a["n_fft"], a["hop_length"], a["win_length"])

    def _istft(self, features, length: int, input_type: str = "complex") -> torch.Tensor:
        a = self.acoustics
        return istft(features, a["n_fft"], a["hop_length"], a["win_length"], length=length,
                     input_type=input_type)

    def predict_crm(self, noisy: torch.Tensor):
        """noisy [B, T] on the model's device -> (decompressed cIRM
        [B, F, T', 2], complex STFT [B, F, T'])."""
        with torch.inference_mode():
            return self._predict_crm(noisy)

    def _predict_crm(self, noisy: torch.Tensor):
        return predict_crm(self.model, self.acoustics, noisy)

    def _full_band_crm_mask_fn(self, noisy: torch.Tensor) -> torch.Tensor:
        return full_band_crm_mask(self.model, self.acoustics, noisy)

    def _mag_fn(self, noisy: torch.Tensor) -> torch.Tensor:
        """The model's channel 0 as the magnitude, with the noisy phase."""
        spec = self._stft(noisy)
        enhanced_mag = self.model(spec.abs()[:, None], dropping_band=False)[:, 0]
        return self._istft((enhanced_mag, torch.angle(spec)), noisy.shape[-1], "mag_phase")

    def _scaled_mask_fn(self, noisy: torch.Tensor) -> torch.Tensor:
        """The model's two channels as a complex mask on the noisy spectrum."""
        spec = self._stft(noisy)
        mask = self.model(spec.abs()[:, None], dropping_band=False).permute(0, 2, 3, 1)
        return self._istft(spec * torch.complex(mask[..., 0], mask[..., 1]), noisy.shape[-1])

    def _sub_band_crm_mask_fn(self, noisy: torch.Tensor) -> torch.Tensor:
        """The magnitude's [F, 2N+1, T] units through the sub-band model's
        3-D form, the cIRM decompressed with the clamp at 9.99."""
        n_neighbors = self.inference_args.get("n_neighbor", 15)
        pad_mode = self.inference_args.get("pad_mode", "reflect")
        spec = self._stft(noisy)
        real, imag = spec.real[0], spec.imag[0]
        noisy_mag = torch.sqrt(torch.square(real) + torch.square(imag))
        units = freq_unfold(noisy_mag[None, None], n_neighbors, mode=pad_mode)[0, :, 0]
        crm = decompress_cIRM(self.model(units).permute(0, 2, 1), limit=9.99)  # [F, T, 2]
        er, ei = complex_mul(real, imag, crm[..., 0], crm[..., 1])
        return self._istft((er[None], ei[None]), noisy.shape[-1], "real_imag")

    def _time_domain_fn(self, noisy: torch.Tensor) -> torch.Tensor:
        return self.model(noisy)[:, 0]

    def _run(self, strategy: str, noisy: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            return getattr(self, f"_{strategy}_fn")(noisy)[0].cpu().numpy()

    def full_band_crm_mask(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T] (float32, before peak scaling)."""
        return self._run("full_band_crm_mask", noisy)

    def mag(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T]: the model's channel 0 as the
        magnitude, with the noisy phase."""
        return self._run("mag", noisy)

    def scaled_mask(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T]: the model's two channels as a
        complex mask on the noisy spectrum."""
        return self._run("scaled_mask", noisy)

    def sub_band_crm_mask(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T] (JAX ``_sub_band_crm_mask_fn``)."""
        return self._run("sub_band_crm_mask", noisy)

    def time_domain(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T] (float32, before peak scaling)."""
        return self._run("time_domain", noisy)

    def overlapped_chunk(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T] (JAX ``Inferencer.overlapped_chunk``):
        chunks of ``chunk_length`` seconds every half chunk, each after the
        256 samples before it (zeros for the first), through
        :meth:`time_domain`; the history cut off, the chunks after the first
        weighted by a periodic Hann window, and each half chunk the sum of
        two. An utterance shorter than a chunk keeps its short tail (the
        reference fails there)."""
        chunk_length = int(self.sr * self.inference_args.get("chunk_length", 4))
        hop = chunk_length // 2
        noisy = noisy.cpu().numpy()
        num_chunks = int(noisy.shape[-1] / hop) + 1
        win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(chunk_length) / chunk_length))
        pieces, prev = [], None
        for chunk_idx in range(num_chunks):
            start = chunk_idx * hop
            history = (np.zeros((noisy.shape[0], 256), noisy.dtype) if chunk_idx == 0
                       else noisy[:, start - 256 : start])
            chunk = np.concatenate([history, noisy[:, start : start + chunk_length]], axis=1)
            enhanced = self.time_domain(torch.from_numpy(chunk).to(self.device))[256:]
            if chunk_idx == 0:
                pieces.append(enhanced[:hop])
                tail = enhanced[hop:]
                prev = tail * win[hop : hop + len(tail)]
            else:
                enhanced = enhanced * win[: len(enhanced)]
                cur = enhanced[:hop]
                n = min(len(cur), len(prev))
                pieces.append(cur[:n] + prev[:n])
                prev = enhanced[hop:]
        return np.concatenate(pieces)[: noisy.shape[-1]]

    def _bucketed_capable(self) -> bool:
        if self.strategy == "time_domain":
            return time_domain_bucketed_capable(self.model)
        return bucketed_capable(self.model, self.strategy)

    def _write_outputs(self, enhanced: np.ndarray, noisy, name: str):
        enhanced = np.asarray(enhanced, dtype=np.float32)
        # unconditional peak normalisation to 0.8 full scale, exactly the
        # reference's `0.8 * enhanced / max(|enhanced|)`
        peak = np.max(np.abs(enhanced))
        if peak > 0:
            enhanced = enhanced / peak * 0.8
        write_wav(self.enhanced_dir / f"{name}.wav", enhanced, self.sr)
        # the noisy copy: first channel, trimmed to the enhanced length
        noisy_out = np.asarray(noisy, np.float32)
        if noisy_out.ndim > 1:
            noisy_out = noisy_out[0]
        noisy_out = noisy_out[: enhanced.shape[-1]]
        write_wav(self.noisy_dir / f"{name}.wav", noisy_out, self.sr)

    def enhance_bucket(self, waves, bucket: int) -> list[np.ndarray]:
        """Enhance 1-D float32 waves of one bucket (each longer than
        ``n_fft // 2`` samples, at most ``bucket - n_fft``) as one padded
        [len(waves), bucket] batch; returns each wave's enhanced signal at
        its length, before peak scaling."""
        if not self._bucketed_capable():
            raise ValueError(f"{type(self.model).__name__} under {self.strategy!r} takes no "
                             "true lengths: it runs each utterance at its exact length")
        padded, lengths = pad_bucket_batch(waves, len(waves), bucket)
        padded = torch.from_numpy(padded).to(self.device)
        true_len = torch.from_numpy(lengths).to(self.device)
        with torch.inference_mode():
            if self.strategy == "time_domain":
                out = bucketed_time_domain(self.model, padded, true_len)
            else:
                out = bucketed_enhance(self.model, self.acoustics, padded, true_len)
            out = out.cpu().numpy()
        return [row[: len(w)] for row, w in zip(out, waves)]

    def _call_batched(self):
        """Group the utterances by length bucket and enhance each bucket in
        batches of ``batch_size`` (the last one of a bucket partial)."""
        step = int(self.bucket_seconds * self.sr)
        n_fft = self.acoustics["n_fft"]

        def flush(bucket, items):
            waves = [y for y, _ in items]
            for (y, name), enhanced in zip(items, self.enhance_bucket(waves, bucket)):
                self._write_outputs(enhanced, y, name)

        groups: dict[int, list] = {}
        for i in range(len(self.dataset)):
            noisy, name = self.dataset[i]
            noisy = np.asarray(noisy, np.float32)
            if noisy.ndim > 1:
                noisy = noisy[0]
            if len(noisy) <= n_fft // 2:  # no room for the tail reflection
                wave = torch.from_numpy(noisy[None]).to(self.device)
                self._write_outputs(getattr(self, self.strategy)(wave), noisy, name)
                continue
            bucket = -(-(len(noisy) + n_fft) // step) * step
            groups.setdefault(bucket, []).append((noisy, name))
            if len(groups[bucket]) == self.batch_size:
                flush(bucket, groups.pop(bucket))
        for bucket in sorted(groups):
            flush(bucket, groups[bucket])
        return self.enhanced_dir

    def __call__(self):
        if self.dataset is None or self.enhanced_dir is None:
            raise RuntimeError(
                "Inferencer was built without a dataset/output_dir; "
                "batch enhancement needs both"
            )
        if self.batch_size > 1 and self.bucket_seconds > 0 and self._bucketed_capable():
            return self._call_batched()
        strategy = getattr(self, self.strategy)
        for i in range(len(self.dataset)):
            noisy, name = self.dataset[i]
            wave = torch.from_numpy(np.asarray(noisy, np.float32)[None]).to(self.device)
            self._write_outputs(strategy(wave), noisy, name)
        return self.enhanced_dir
