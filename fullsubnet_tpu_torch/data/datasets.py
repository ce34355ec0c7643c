"""Datasets (counterpart of ``fullsubnet_tpu/data/datasets.py``): the
training set, which synthesises noisy mixtures on the fly, the
validation pairs and the inference listing.

``TrainDataset`` follows the JAX package draw for draw, so the same
lists, seed and epoch give the same items: the per-item RNG is
``SeedSequence([seed, epoch, item])``; the clean crop is planned from the
wav header and only the cropped frames are read; the noise is assembled
from whole files with silence gaps, planned from headers and read only
where it survives the final crop; then an SNR draw, a reverb draw with
``reverb_proportion``, and ``snr_mix``: a scipy convolution with the RIR,
then the pointwise mix in the host mixer (``native.snr_mix``, the JAX
package's C++ mixer, built with g++ when the dataset is constructed). With
``device_synthesis`` an item is instead the raw
mixture components and the mixer's draws, taken from the same RNG stream,
which ``data/device_mixer.py`` mixes on the device.
``ValidationDataset`` reads the DNS synthetic test-set layouts as the JAX
one does.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy import signal

from fullsubnet_tpu_torch import native
from fullsubnet_tpu_torch.acoustics.feature import (
    is_clipped,
    norm_amplitude,
    subsample,
    tailor_dB_FS,
)
from fullsubnet_tpu_torch.data.wavio import (
    load_wav,
    read_wav_slice,
    resampled_length,
    wav_frames,
)
from fullsubnet_tpu_torch.utils import basename, expand_path

_AUDIO_EXTS = (".wav", ".flac", ".aif", ".aiff", ".ogg")


def _quantize_int16(x: np.ndarray) -> np.ndarray:
    """Float waveform -> wav-native int16 PCM (round half to even,
    clipped): the exact inverse of wavio's int16 read (x / 32768) for
    values on that grid."""
    return np.clip(np.round(np.asarray(x, np.float32) * 32768.0), -32768, 32767).astype(np.int16)


def find_audio_files(directory: str | os.PathLike) -> list[str]:
    """Recursively list audio files, sorted."""
    out = []
    for root, _dirs, files in os.walk(os.fspath(directory)):
        for f in files:
            if f.lower().endswith(_AUDIO_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


def _read_slice(path, start: int, count: int, sr: int) -> np.ndarray:
    """Frames [start, start + count) of a mono wav at ``sr``; a format
    scipy cannot memory-map (24-bit PCM) is decoded whole instead."""
    try:
        return read_wav_slice(expand_path(os.fspath(path)), start, count)
    except ValueError:
        return np.ravel(load_wav(path, sr=sr))[start : start + count]


def _offset_and_limit(dataset_list, offset, limit):
    dataset_list = dataset_list[offset:]
    if limit:
        dataset_list = dataset_list[:limit]
    return dataset_list


class TrainDataset:
    """On-the-fly noisy synthesis from clean/noise/RIR list files; an item
    is (noisy, clean), float32 [sub_sample_length * sr].

    With ``device_synthesis`` an item is (clean, noise, rir_buf,
    use_reverb, snr, noisy_target_dB_FS): the crop and the noise track
    (float32, or int16 PCM with ``device_synthesis_transfer = "int16"``,
    half the bytes), the drawn RIR channel zero-padded to ``rir_samples``
    (sized from the wav headers at construction), and three float32
    scalars, for ``device_mixer.device_snr_mix``."""

    def __init__(
        self,
        clean_dataset,
        noise_dataset,
        rir_dataset,
        snr_range=(-5, 20),
        reverb_proportion=0.75,
        silence_length=0.2,
        target_dB_FS=-25,
        target_dB_FS_floating_value=10,
        sub_sample_length=3.072,
        sr=16000,
        clean_dataset_limit=None,
        clean_dataset_offset=0,
        noise_dataset_limit=None,
        noise_dataset_offset=0,
        rir_dataset_limit=None,
        rir_dataset_offset=0,
        pre_load_clean_dataset=False,
        pre_load_noise=False,
        pre_load_rir=False,
        num_workers=0,
        seed=0,
        device_synthesis=False,
        device_synthesis_transfer="f32",
    ):
        del num_workers  # only the JAX package's preloading uses it
        self.sr = sr

        def read_list(p):
            with open(expand_path(p)) as f:
                return [ln.rstrip("\n") for ln in f]

        lists = []
        for path, offset, limit, preload in (
            (clean_dataset, clean_dataset_offset, clean_dataset_limit, pre_load_clean_dataset),
            (noise_dataset, noise_dataset_offset, noise_dataset_limit, pre_load_noise),
            (rir_dataset, rir_dataset_offset, rir_dataset_limit, pre_load_rir),
        ):
            entries = _offset_and_limit(read_list(path), offset, limit)
            if preload:
                entries = [(p, load_wav(p, self.sr)) for p in entries]
            lists.append(entries)
        self.clean_dataset_list, self.noise_dataset_list, self.rir_dataset_list = lists
        self._header_cache: dict = {}  # path -> wav_frames() or None

        snr_range = list(snr_range)
        if len(snr_range) != 2 or snr_range[0] > snr_range[-1]:
            raise ValueError(f"The range of SNR should be [low, high], not {snr_range}.")
        self.snr_list = list(range(snr_range[0], snr_range[-1] + 1))
        if not 0 <= reverb_proportion <= 1:
            raise ValueError("The 'reverb_proportion' should be in [0, 1].")
        self.reverb_proportion = reverb_proportion
        self.silence_length = silence_length
        self.target_dB_FS = target_dB_FS
        self.target_dB_FS_floating_value = target_dB_FS_floating_value
        self.sub_sample_length = sub_sample_length
        self.seed = seed
        self.epoch = 0
        self.length = len(self.clean_dataset_list)

        self.device_synthesis = bool(device_synthesis)
        if device_synthesis_transfer not in ("f32", "int16"):
            raise ValueError(
                "device_synthesis_transfer must be 'f32' or 'int16', got "
                f"{device_synthesis_transfer!r}"
            )
        self.device_synthesis_transfer = device_synthesis_transfer
        # the RIR buffer holds the longest RIR after resampling, sized from
        # the wav headers alone
        self.rir_samples = 1
        if self.device_synthesis and self.rir_dataset_list:
            self.rir_samples = max(self._rir_length(e) for e in self.rir_dataset_list)
        if not self.device_synthesis:
            # built here, in the parent, before the loader's workers start
            native.load()

    def _rir_length(self, entry) -> int:
        if not isinstance(entry, (str, os.PathLike)) and len(entry) == 2:
            return int(np.shape(entry[-1])[-1])  # preloaded (path, array)
        frames, file_sr, _ = wav_frames(expand_path(os.fspath(entry)))
        return resampled_length(frames, file_sr, self.sr)

    def set_epoch(self, epoch: int):
        """Changes the per-item RNG stream so every epoch mixes differently."""
        self.epoch = epoch

    def __len__(self):
        return self.length

    def _sliceable(self, entry):
        """Frame count when ``entry`` is a mono wav at the dataset rate (so
        it can be read as a partial slice), else None."""
        if not isinstance(entry, (str, os.PathLike)):
            return None
        if entry not in self._header_cache:
            try:
                self._header_cache[entry] = wav_frames(expand_path(os.fspath(entry)))
            except (OSError, ValueError):
                self._header_cache[entry] = None
        info = self._header_cache[entry]
        if info is not None and info[1] == self.sr and info[2] == 1:
            return info[0]
        return None

    def _select_noise_y(self, target_length: int, rng: np.random.Generator):
        """Assemble ``target_length`` samples of noise: whole files with
        silence gaps, random-cropped. The assembly is planned from the
        headers first and only the ranges that survive the crop are read;
        the draws are those of the read-everything loop."""
        silence_len_full = int(self.sr * self.silence_length)
        remaining_length = target_length

        # (kind, payload, appended samples); a [C, T] preloaded array
        # lowers the remaining length by C but appends C*T samples, as
        # np.append does in the read-everything loop
        segments = []
        total = 0
        while remaining_length > 0:
            entry = self.noise_dataset_list[int(rng.integers(0, len(self.noise_dataset_list)))]
            frames = self._sliceable(entry)
            if frames is not None:
                segments.append(("slice", entry, frames))
                total += frames
                remaining_length -= frames
            else:
                arr = load_wav(entry, sr=self.sr)
                segments.append(("array", np.ravel(arr), arr.size))
                total += arr.size
                remaining_length -= len(arr)
            if remaining_length > 0:
                silence_len = min(remaining_length, silence_len_full)
                segments.append(("silence", None, silence_len))
                total += silence_len
                remaining_length -= silence_len

        idx_start = 0
        if total > target_length:
            idx_start = int(rng.integers(0, total - target_length))

        out = np.zeros(min(total, target_length), dtype=np.float32)
        pos = 0
        end = idx_start + len(out)
        for kind, payload, n in segments:
            lo, hi = max(pos, idx_start), min(pos + n, end)
            if hi > lo and kind != "silence":
                if kind == "slice":
                    seg = _read_slice(payload, lo - pos, hi - lo, self.sr)
                else:
                    seg = payload[lo - pos : hi - pos]
                out[lo - idx_start : hi - idx_start] = seg
            pos += n
            if pos >= end:
                break
        return out

    @staticmethod
    def mix_draws(rng, rir, target_dB_FS, target_dB_FS_floating_value):
        """The two draws ``snr_mix`` makes, in its order: the RIR channel
        (multichannel RIRs only), then the mixture loudness target.
        Returns (mono_rir_or_None, noisy_target_dB_FS)."""
        if rir is not None and rir.ndim > 1:
            rir = rir[int(rng.integers(0, rir.shape[0])), :]
        noisy_target_dB_FS = int(
            rng.integers(
                target_dB_FS - target_dB_FS_floating_value,
                target_dB_FS + target_dB_FS_floating_value,
            )
        )
        return rir, noisy_target_dB_FS

    @staticmethod
    def _draws_and_reverb(clean_y, rir, target_dB_FS, target_dB_FS_floating_value, rng):
        """``mix_draws`` from ``rng``, then the clean signal reverbed with the
        drawn RIR channel by scipy's FFT convolution, as the JAX package
        reverbs it (the C++ engine's own convolution stays off the path).
        Returns (clean_y, noisy_target_dB_FS)."""
        rng = rng or np.random.default_rng()
        rir, noisy_target_dB_FS = TrainDataset.mix_draws(
            rng, rir, target_dB_FS, target_dB_FS_floating_value
        )
        if rir is not None:
            clean_y = signal.fftconvolve(clean_y, rir)[: len(clean_y)]
        return clean_y, noisy_target_dB_FS

    @staticmethod
    def snr_mix(
        clean_y,
        noise_y,
        snr,
        target_dB_FS,
        target_dB_FS_floating_value,
        rir=None,
        eps=1e-6,
        rng: np.random.Generator | None = None,
    ):
        """Mix clean and noise at an SNR, with optional RIR reverb: reverb
        the clean signal, normalise the amplitude and loudness of both,
        scale the noise to the SNR, re-target the mixture loudness to
        target ± floating dB FS, and rescale both if the mixture clips. The
        pointwise mix runs in the host mixer (``native.snr_mix``)."""
        clean_y, noisy_target_dB_FS = TrainDataset._draws_and_reverb(
            clean_y, rir, target_dB_FS, target_dB_FS_floating_value, rng
        )
        return native.snr_mix(clean_y, noise_y, snr, target_dB_FS, noisy_target_dB_FS, eps=eps)

    @staticmethod
    def plain_snr_mix(
        clean_y,
        noise_y,
        snr,
        target_dB_FS,
        target_dB_FS_floating_value,
        rir=None,
        eps=1e-6,
        rng: np.random.Generator | None = None,
    ):
        """``snr_mix`` with its pointwise mix in numpy: the plain version
        the tests and the smoke hold the host mixer to (the mixer sums and
        scales in double: the two agree to float32 rounding)."""
        clean_y, noisy_target_dB_FS = TrainDataset._draws_and_reverb(
            clean_y, rir, target_dB_FS, target_dB_FS_floating_value, rng
        )
        clean_y, _ = norm_amplitude(clean_y)
        clean_y, _, _ = tailor_dB_FS(clean_y, target_dB_FS)
        clean_rms = (clean_y**2).mean() ** 0.5

        noise_y, _ = norm_amplitude(noise_y)
        noise_y, _, _ = tailor_dB_FS(noise_y, target_dB_FS)
        noise_rms = (noise_y**2).mean() ** 0.5

        snr_scalar = clean_rms / (10 ** (snr / 20)) / (noise_rms + eps)
        noise_y = noise_y * snr_scalar
        noisy_y = clean_y + noise_y

        noisy_y, _, noisy_scalar = tailor_dB_FS(noisy_y, noisy_target_dB_FS)
        clean_y = clean_y * noisy_scalar

        if is_clipped(noisy_y):
            noisy_y_scalar = np.max(np.abs(noisy_y)) / (0.99 - eps)
            noisy_y = noisy_y / noisy_y_scalar
            clean_y = clean_y / noisy_y_scalar

        return noisy_y, clean_y

    def __getitem__(self, item: int):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, item]))
        clean_fpath = self.clean_dataset_list[item]
        crop = int(self.sub_sample_length * self.sr)
        frames = self._sliceable(clean_fpath)
        if frames is not None and frames > crop:
            # the crop-start draw of subsample(), but only the crop is read
            start = int(rng.integers(0, frames - crop))
            clean_y = _read_slice(clean_fpath, start, crop, self.sr)
        else:
            clean_y = subsample(load_wav(clean_fpath, sr=self.sr), sub_sample_length=crop, rng=rng)

        noise_y = self._select_noise_y(target_length=len(clean_y), rng=rng)
        snr = self.snr_list[int(rng.integers(0, len(self.snr_list)))]
        use_reverb = bool(rng.random() < self.reverb_proportion)
        rir = (
            load_wav(
                self.rir_dataset_list[int(rng.integers(0, len(self.rir_dataset_list)))],
                sr=self.sr,
            )
            if use_reverb
            else None
        )
        if self.device_synthesis:
            return self._components(clean_y, noise_y, rir, snr, rng)
        noisy_y, clean_y = self.snr_mix(
            clean_y=clean_y,
            noise_y=noise_y,
            snr=snr,
            target_dB_FS=self.target_dB_FS,
            target_dB_FS_floating_value=self.target_dB_FS_floating_value,
            rir=rir,
            rng=rng,
        )
        return noisy_y.astype(np.float32), clean_y.astype(np.float32)

    def _components(self, clean_y, noise_y, rir, snr, rng):
        """The device-synthesis item: ``snr_mix``'s draws from the same RNG
        stream (``mix_draws``), and the components it would mix."""
        rir, noisy_target_dB_FS = self.mix_draws(
            rng, rir, self.target_dB_FS, self.target_dB_FS_floating_value
        )
        rir_buf = np.zeros(self.rir_samples, dtype=np.float32)
        if rir is not None:
            if len(rir) > self.rir_samples:
                raise ValueError(
                    f"RIR of {len(rir)} samples exceeds the header-sized buffer "
                    f"({self.rir_samples}); is the RIR list stable since dataset "
                    "construction?"
                )
            rir_buf[: len(rir)] = rir
        if self.device_synthesis_transfer == "int16":
            clean_y, noise_y, rir_buf = (_quantize_int16(v) for v in (clean_y, noise_y, rir_buf))
        else:
            clean_y, noise_y = clean_y.astype(np.float32), noise_y.astype(np.float32)
        return (clean_y, noise_y, rir_buf, np.float32(rir is not None), np.float32(snr),
                np.float32(noisy_target_dB_FS))


class ValidationDataset:
    """DNS test_set/synthetic pairs; an item is (noisy, clean, name,
    speech_type).

    Clean paths are derived from the noisy fileid like the reference
    (``dataset_validation.py:42-93``), including the dns_2 layouts.
    """

    _SPEECH_TYPES = {
        "with_reverb": "With_reverb",
        "no_reverb": "No_reverb",
        "dns_2_non_english": "Non_english",
        "dns_2_emotion": "Emotion",
        "dns_2_singing": "Singing",
    }

    def __init__(self, dataset_dir_list, sr=16000):
        self.noisy_files_list = []
        for dataset_dir in dataset_dir_list:
            d = Path(dataset_dir).expanduser().absolute()
            self.noisy_files_list += find_audio_files(d / "noisy")
        self.length = len(self.noisy_files_list)
        self.sr = sr

    def __len__(self):
        return self.length

    def speech_type_of(self, item: int) -> str:
        """Speech type of item ``item`` from its path alone (no audio read)."""
        parent_dir = Path(self.noisy_files_list[item]).parents[1].name
        try:
            return self._SPEECH_TYPES[parent_dir]
        except KeyError:
            raise NotImplementedError(f"Not supported dir: {parent_dir}") from None

    def clean_path_of(self, item: int) -> tuple[str, str]:
        """(the clean file's path, the name the item reports) of item
        ``item``, from the noisy path's layout and fileid."""
        noisy_file_path = self.noisy_files_list[item]
        parent_dir = Path(noisy_file_path).parents[1].name
        noisy_filename, _ = basename(noisy_file_path)
        speech_type = self.speech_type_of(item)
        file_id = noisy_filename.split("_")[-1]
        reverb_remark = ""
        if parent_dir in ("dns_2_emotion", "dns_2_singing"):
            clean_filename = f"synthetic_{speech_type.lower()}_clean_fileid_{file_id}"
        elif parent_dir == "dns_2_non_english":
            clean_filename = f"synthetic_clean_fileid_{file_id}"
        else:
            if parent_dir == "with_reverb":
                reverb_remark = "with_reverb"
            clean_filename = f"clean_fileid_{file_id}"
        clean_file_path = noisy_file_path.replace(
            f"noisy/{noisy_filename}", f"clean/{clean_filename}"
        )
        return clean_file_path, reverb_remark + noisy_filename

    def __getitem__(self, item: int):
        clean_file_path, name = self.clean_path_of(item)
        noisy = load_wav(expand_path(self.noisy_files_list[item]), sr=self.sr)
        clean = load_wav(expand_path(clean_file_path), sr=self.sr)
        return noisy, clean, name, self.speech_type_of(item)


class InferenceDataset:
    """Noisy-only recursive listing; returns (waveform, basename)."""

    def __init__(self, dataset_dir_list, sr=16000):
        if not isinstance(dataset_dir_list, list):
            raise TypeError("dataset_dir_list must be a list of directories")
        self.sr = sr
        self.noisy_file_path_list = []
        for dataset_dir in dataset_dir_list:
            d = Path(dataset_dir).expanduser().absolute()
            self.noisy_file_path_list += find_audio_files(d)
        self.length = len(self.noisy_file_path_list)

    def __len__(self):
        return self.length

    def __getitem__(self, item: int):
        noisy_file_path = self.noisy_file_path_list[item]
        noisy_y = load_wav(noisy_file_path, sr=self.sr).astype(np.float32)
        return noisy_y, basename(noisy_file_path)[0]
