"""WAV I/O on scipy (counterpart of ``fullsubnet_tpu/data/wavio.py``).

Carried over unchanged: float32 in [-1, 1], polyphase resampling,
libsndfile-style rounding to int16 on write, and the header-only frame
count and partial mono reads the training dataset plans its crops with.
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


def wav_frames(path: str | os.PathLike) -> tuple[int, int, int]:
    """(frames, sample_rate, channels) from the RIFF header alone; no
    sample data is read."""
    import struct

    with open(os.fspath(path), "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise ValueError(f"truncated WAV header: {path}")
        riff, _size, wave = struct.unpack("<4sI4s", head)
        if riff == b"RF64":
            # the 32-bit size fields are sentinels there
            raise ValueError(f"RF64 WAV files are not supported: {path}")
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        sr = channels = block_align = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk found: {path}")
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize + (csize & 1))  # incl. the pad byte
                if len(fmt) < 16:
                    raise ValueError(f"malformed fmt chunk ({len(fmt)} bytes < 16): {path}")
                channels, sr = struct.unpack("<HI", fmt[2:8])
                (block_align,) = struct.unpack("<H", fmt[12:14])
                if block_align <= 0 or channels <= 0 or sr <= 0:
                    raise ValueError(
                        f"invalid fmt chunk (channels={channels}, sr={sr}, "
                        f"block_align={block_align}): {path}"
                    )
            elif cid == b"data":
                if not (sr and channels and block_align):
                    raise ValueError(f"data chunk before fmt: {path}")
                if csize == 0xFFFFFFFF:
                    raise ValueError(f"streaming WAV with unsized data chunk: {path}")
                return csize // block_align, sr, channels
            else:
                f.seek(csize + (csize & 1), 1)  # chunks are word-aligned


def resampled_length(frames: int, file_sr: int, sr: int) -> int:
    """Output length of ``resample_poly`` for a file_sr -> sr resample."""
    if sr == file_sr:
        return frames
    frac = Fraction(sr, file_sr)
    return -(-frames * frac.numerator // frac.denominator)


def read_wav_slice(path: str | os.PathLike, start: int, count: int) -> np.ndarray:
    """Frames ``[start, start + count)`` of a mono wav at its native rate,
    as float32; the file is memory-mapped and only the slice is converted.
    The caller checks (:func:`wav_frames`) that the file is mono and needs
    no resampling; formats scipy cannot map (24-bit PCM) raise."""
    _sr, data = wavfile.read(os.fspath(path), mmap=True)
    seg = np.asarray(data[start : start + count])
    if seg.dtype == np.int16:
        return seg.astype(np.float32) / 32768.0
    if seg.dtype == np.int32:
        return seg.astype(np.float32) / 2147483648.0
    if seg.dtype == np.uint8:
        return (seg.astype(np.float32) - 128.0) / 128.0
    return seg.astype(np.float32)


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
