"""WAV I/O on scipy (counterpart of ``fullsubnet_tpu/data/wavio.py``).

Carried over unchanged: float32 in [-1, 1], polyphase resampling, and
libsndfile-style rounding to int16 on write.
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from fullsubnet_tpu_torch.utils import expand_path


def read_wav(path: str | os.PathLike, sr: int | None = None, mono: bool = False):
    """Read a wav file to float32 in [-1, 1]; optionally resample to ``sr``.

    Returns (audio, sample_rate). Multi-channel audio is returned as
    [C, T] (librosa ``mono=False`` convention); mono as [T].
    """
    file_sr, data = wavfile.read(os.fspath(path))
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        audio = data.astype(np.float32)

    if audio.ndim == 2:  # scipy gives [T, C]
        audio = audio.T  # -> [C, T]
        if mono:
            audio = audio.mean(axis=0)

    if sr is not None and sr != file_sr:
        frac = Fraction(sr, file_sr)
        audio = resample_poly(audio, frac.numerator, frac.denominator, axis=-1)
        audio = audio.astype(np.float32)
        file_sr = sr
    return audio, file_sr


def load_wav(file, sr: int = 16000):
    """Reference-compatible loader: accepts a path or a (name, array)
    pair; returns the waveform."""
    if not isinstance(file, (str, os.PathLike)) and len(file) == 2:
        return file[-1]
    return read_wav(expand_path(os.fspath(file)), sr=sr)[0]


def write_wav(path: str | os.PathLike, audio: np.ndarray, sr: int):
    """Write float32 [-1, 1] (or int16) audio; [T] or [C, T]."""
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio.T  # -> [T, C] for scipy
    if audio.dtype in (np.float32, np.float64):
        # scale by 32768 and round to nearest, as libsndfile does
        audio = np.clip(
            np.rint(audio * 32768.0), -32768, 32767
        ).astype(np.int16)
    wavfile.write(os.fspath(path), sr, audio)
