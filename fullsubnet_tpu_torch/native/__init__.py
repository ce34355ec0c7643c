"""The host mixer (counterpart of ``fullsubnet_tpu/native``): ``mixer.cpp``'s
C ABI through ctypes, the same source and arithmetic as the JAX package's.

``TrainDataset`` mixes every item through ``snr_mix`` (after a scipy
convolution with the RIR) and ``acoustics.feature.frame_energies_db`` (so
``activity_detector``) sums its windows through ``frame_energies_db``;
``fft_convolve_trunc`` is the C++ engine's own convolution, on no path.

The library is built with the system ``g++`` at the first ``load()`` of a
process into ``_build/`` beside this file (listed in ``.gitignore``). Its
name carries a digest of the source, the flags, the CPU's feature flags and
the compiler's version, so a checkout shared by hosts of other CPUs or
toolchains builds one library for each, and an edited source is rebuilt.
Each build writes a file of its own and renames it into place, so
processes that build at once each load a whole library. ``TrainDataset``
loads it when constructed, before its loader's workers start, so they find
it built. There is no fallback: a failed build or load raises, with the
compiler's output. The numpy versions (``TrainDataset.plain_snr_mix``,
``feature.plain_frame_energies_db``) are the plain versions the tests hold
these functions to; no path runs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "mixer.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ABI_VERSION = 1
# the library is built on the host that loads it (its name carries the
# CPU's flags), so -march=native is safe; -O3 alone where the compiler
# refuses it. No -ffast-math: gcc then links crtfastmath.o into the shared
# library, which sets the process-wide flush-to-zero and denormals-are-zero
# modes when it is loaded and changes subnormal arithmetic everywhere.
FLAG_SETS = (("-O3", "-march=native"), ("-O3",))
SHARED_FLAGS = ("-std=c++17", "-shared", "-fPIC")

_FP = ctypes.POINTER(ctypes.c_float)
_LOCK = threading.Lock()
_LIB = None


def _cpu_flags() -> str:
    """The machine and the CPU's feature flags (the first ``flags`` or
    ``Features`` line of /proc/cpuinfo, where there is one)."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return ident + line
    except OSError:
        pass
    return ident


def _compiler_version(compiler: str) -> str:
    try:
        proc = subprocess.run([compiler, "-dumpfullversion", "-dumpversion"],
                              capture_output=True, text=True, timeout=60)
    except OSError as e:
        raise RuntimeError(
            f"the host mixer is built with a C++ compiler at first use, and {compiler!r} "
            f"did not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} -dumpversion failed ({proc.returncode}):\n{proc.stderr}")
    return proc.stdout.strip()


def library_path(compiler: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Where ``compiler`` builds the library on this host."""
    digest = hashlib.sha256(SRC.read_bytes())
    for part in (repr(FLAG_SETS), repr(SHARED_FLAGS), _cpu_flags(), compiler,
                 _compiler_version(compiler)):
        digest.update(part.encode())
    return Path(build_dir) / f"libfsn_mixer-{digest.hexdigest()[:12]}.so"


def build_library(compiler: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``mixer.cpp`` unless this host's library exists; returns its
    path. Raises with the compiler's output when no flag set builds."""
    out = library_path(compiler, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.so.tmp")
    errors = []
    try:
        for flags in FLAG_SETS:
            cmd = [compiler, *flags, *SHARED_FLAGS, str(SRC), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: no process loads a half-written file
                return out
            errors.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stderr}")
    finally:
        tmp.unlink(missing_ok=True)
    raise RuntimeError("the host mixer did not build:\n" + "\n".join(errors))


def _open(path: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
        version = lib.fsn_abi_version()
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"the host mixer {path} did not load: {e}") from e
    if version != ABI_VERSION:
        raise RuntimeError(f"the host mixer {path} has ABI {version}, not {ABI_VERSION}")
    i64, f32 = ctypes.c_int64, ctypes.c_float
    lib.fsn_abi_version.restype = ctypes.c_int
    lib.fsn_fft_convolve_trunc.argtypes = [_FP, i64, _FP, i64, _FP]
    lib.fsn_fft_convolve_trunc.restype = None
    lib.fsn_snr_mix.argtypes = [_FP, _FP, i64, _FP, i64, f32, f32, f32, f32]
    lib.fsn_snr_mix.restype = None
    lib.fsn_frame_energies_db.argtypes = [_FP, i64, i64, f32, _FP, ctypes.POINTER(i64)]
    lib.fsn_frame_energies_db.restype = None
    return lib


def load(compiler: str = "g++") -> ctypes.CDLL:
    """The library, built with ``compiler`` at the first call in this
    process and kept for the process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _open(build_library(compiler))
        return _LIB


def _f32(x, name: str, copy: bool = False) -> np.ndarray:
    a = np.array(x, dtype=np.float32, order="C") if copy else np.ascontiguousarray(x, np.float32)
    if a.ndim != 1:
        raise ValueError(f"{name} must be one-dimensional, got shape {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def fft_convolve_trunc(x, h) -> np.ndarray:
    """The linear convolution of x with h, truncated to len(x)
    (``fftconvolve(x, h)[:len(x)]``), in float32."""
    lib = load()
    x, h = _f32(x, "x"), _f32(h, "h")
    if not (len(x) and len(h)):
        raise ValueError("x and h must not be empty")
    out = np.empty_like(x)
    lib.fsn_fft_convolve_trunc(_ptr(x), len(x), _ptr(h), len(h), _ptr(out))
    return out


def snr_mix(clean, noise, snr: float, target_dbfs: float, noisy_target_dbfs: float,
            rir=None, eps: float = 1e-6) -> tuple[np.ndarray, np.ndarray]:
    """The whole SNR mix of one item; returns (noisy, clean), float32. It
    draws nothing: the caller draws ``noisy_target_dbfs`` (and the RIR's
    channel) beforehand. ``rir``: reverb the clean signal with the C++
    engine's convolution first."""
    lib = load()
    clean, noise = _f32(clean, "clean", copy=True), _f32(noise, "noise", copy=True)
    if len(clean) != len(noise):
        raise ValueError(f"clean ({len(clean)}) and noise ({len(noise)}) differ in length")
    if rir is None:
        rir_ptr, rir_len = ctypes.cast(None, _FP), 0
    else:
        rir = _f32(rir, "rir")
        rir_ptr, rir_len = _ptr(rir), len(rir)
    lib.fsn_snr_mix(_ptr(clean), _ptr(noise), len(clean), rir_ptr, rir_len, float(snr),
                    float(target_dbfs), float(noisy_target_dbfs), float(eps))
    return noise, clean  # the noise buffer holds the mixture


def frame_energies_db(x, window: int, eps: float = 1e-6) -> np.ndarray:
    """The energy in dB of each ``window``-sample window of x (the last
    window partial), summed in float64."""
    lib = load()
    x = _f32(x, "x")
    if window < 1:
        raise ValueError(f"window must be positive, got {window}")
    out = np.empty(-(-len(x) // window), dtype=np.float32)
    count = ctypes.c_int64(0)
    lib.fsn_frame_energies_db(_ptr(x), len(x), int(window), float(eps), _ptr(out),
                              ctypes.byref(count))
    return out[: count.value]
