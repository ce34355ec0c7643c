"""Speech quality/intelligibility metrics (counterpart of
``fullsubnet_tpu/metrics.py``; the port's own numpy copy, so the same
waveforms give the same bits).

Mirrors the reference registry (``audio_zen/metrics.py:6-52``): SI_SDR,
STOI, WB_PESQ, NB_PESQ. The reference delegates STOI to pystoi and PESQ to
the ITU ``pesq`` C extension; neither need be installed, so:

* ``SI_SDR`` — NumPy, same formula as the reference.
* ``STOI``  — a NumPy implementation of the published STOI algorithm
  (Taal et al. 2010: silent-frame removal, 1/3-octave band decomposition
  over 15 bands from 150 Hz, 384 ms segment correlation with clipped
  normalization), numerically compatible with pystoi defaults.
* ``WB_PESQ``/``NB_PESQ`` — the NumPy P.862 model with the P.862.1/P.862.2
  MOS-LQO mappings (``fullsubnet_tpu_torch.pesq``); the ITU C extension
  is used instead when installed. They feed the reference's
  (STOI + norm-PESQ)/2 model-selection score (``base_trainer.py:364-370``).

``validation_metrics`` is the Trainer's unit of work for its metric pool:
it lives here so that a worker process imports numpy and this module,
not torch.
"""

from __future__ import annotations

import numpy as np

EPS = np.finfo(np.float64).eps


# --------------------------------------------------------------------------
# SI-SDR
# --------------------------------------------------------------------------


def SI_SDR(reference, estimation, sr=16000):
    """Scale-Invariant Signal-to-Distortion Ratio (dB).

    Same math as the reference (``audio_zen/metrics.py:6-31``), vectorized
    over leading axes.
    """
    estimation, reference = np.broadcast_arrays(
        np.asarray(estimation, dtype=np.float64),
        np.asarray(reference, dtype=np.float64),
    )
    reference_energy = np.sum(reference**2, axis=-1, keepdims=True)
    optimal_scaling = (
        np.sum(reference * estimation, axis=-1, keepdims=True) / (reference_energy + EPS)
    )
    projection = optimal_scaling * reference
    noise = estimation - projection
    ratio = np.sum(projection**2, axis=-1) / (np.sum(noise**2, axis=-1) + EPS)
    return 10 * np.log10(ratio + EPS)


# --------------------------------------------------------------------------
# STOI (Taal et al., 2010) — pystoi-compatible defaults
# --------------------------------------------------------------------------

_STOI_FS = 10000  # internal rate
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150
_STOI_N = 30  # frames per analysis segment (384 ms)
_STOI_BETA = -15.0
_STOI_DYN_RANGE = 40


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = cf * 2.0 ** (-1.0 / 6)
    freq_high = cf * 2.0 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1
    return obm


def _frames(x, framelen, hop, window):
    # pystoi frames with range(0, len - framelen, hop) — EXCLUSIVE stop,
    # so a hop-aligned final exact-fit frame is NOT taken
    n = max(0, -(-(len(x) - framelen) // hop))
    if n <= 0:
        return np.zeros((0, framelen))
    idx = np.arange(n)[:, None] * hop + np.arange(framelen)[None, :]
    return x[idx] * window


def _overlap_add(frames, hop):
    n, flen = frames.shape
    out = np.zeros(n * hop + flen - hop)
    for i in range(n):
        out[i * hop : i * hop + flen] += frames[i]
    return out


def _remove_silent_frames(x, y, dyn_range, framelen, hop):
    w = np.hanning(framelen + 2)[1:-1]
    xf = _frames(x, framelen, hop, w)
    yf = _frames(y, framelen, hop, w)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > np.max(energies) - dyn_range
    return _overlap_add(xf[mask], hop), _overlap_add(yf[mask], hop)


def _resample(x, fs_in, fs_out):
    from fractions import Fraction

    from scipy.signal import resample_poly

    if fs_in == fs_out:
        return x
    frac = Fraction(fs_out, fs_in)
    return resample_poly(x, frac.numerator, frac.denominator)


def STOI(ref, est, sr=16000):
    """Short-Time Objective Intelligibility in [0, 1]."""
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    est = np.asarray(est, dtype=np.float64).reshape(-1)
    assert ref.shape == est.shape, "ref and est must have the same length"

    x = _resample(ref, sr, _STOI_FS)
    y = _resample(est, sr, _STOI_FS)
    x, y = _remove_silent_frames(x, y, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_HOP)

    w = np.hanning(_STOI_FRAME + 2)[1:-1]
    xf = _frames(x, _STOI_FRAME, _STOI_HOP, w)
    yf = _frames(y, _STOI_FRAME, _STOI_HOP, w)
    if xf.shape[0] < _STOI_N:
        return 1e-5  # too short to evaluate (pystoi raises; we degrade softly)

    X = np.abs(np.fft.rfft(xf, n=_STOI_NFFT, axis=1)) ** 2  # [M, F]
    Y = np.abs(np.fft.rfft(yf, n=_STOI_NFFT, axis=1)) ** 2

    obm = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    x_tob = np.sqrt(X @ obm.T).T  # [J, M]
    y_tob = np.sqrt(Y @ obm.T).T

    M = x_tob.shape[1]
    c = 10 ** (-_STOI_BETA / 20.0)
    d_sum = 0.0
    count = 0
    for m in range(_STOI_N, M + 1):
        x_seg = x_tob[:, m - _STOI_N : m]  # [J, N]
        y_seg = y_tob[:, m - _STOI_N : m]
        alpha = np.sqrt(
            np.sum(x_seg**2, axis=1, keepdims=True)
            / (np.sum(y_seg**2, axis=1, keepdims=True) + EPS)
        )
        ay = y_seg * alpha
        y_prime = np.minimum(ay, x_seg * (1 + c))

        xn = x_seg - np.mean(x_seg, axis=1, keepdims=True)
        xn = xn / (np.linalg.norm(xn, axis=1, keepdims=True) + EPS)
        yn = y_prime - np.mean(y_prime, axis=1, keepdims=True)
        yn = yn / (np.linalg.norm(yn, axis=1, keepdims=True) + EPS)
        d_sum += np.sum(xn * yn) / _STOI_NBANDS
        count += 1
    return d_sum / count


# --------------------------------------------------------------------------
# PESQ — native P.862/P.862.1/P.862.2 (see fullsubnet_tpu_torch.pesq); the ITU C
# extension is preferred when installed (bit-exact with published scores)
# --------------------------------------------------------------------------


def _pesq(ref, est, sr, mode):
    if sr not in (8000, 16000):
        # P.862 is defined for 8/16 kHz only (the ITU C extension rejects
        # anything else); resample like practitioners do for 48 kHz evals
        ref = _resample(np.asarray(ref, np.float64).reshape(-1), sr, 16000)
        est = _resample(np.asarray(est, np.float64).reshape(-1), sr, 16000)
        sr = 16000
    try:  # pragma: no cover - the C extension is optional
        from pesq import pesq as pesq_fn
    except ImportError:
        from fullsubnet_tpu_torch.pesq import pesq as pesq_native

        return pesq_native(ref, est, sr=sr, mode=mode)
    return pesq_fn(sr, np.asarray(ref), np.asarray(est), mode)


def WB_PESQ(ref, est, sr=16000):
    """Wideband PESQ MOS-LQO (P.862.2), reference audio_zen/metrics.py:38."""
    return _pesq(ref, est, sr, "wb")


def NB_PESQ(ref, est, sr=16000):
    """Narrowband PESQ MOS-LQO (P.862.1), reference audio_zen/metrics.py:44."""
    return _pesq(ref, est, sr, "nb")


def pesq_available() -> bool:
    """PESQ is always available (native fallback implementation)."""
    return True


def transform_pesq_range(pesq_score):
    """PESQ [-0.5, 4.5] -> [0, 1] (reference ``acoustics/utils.py:1-3``)."""
    return (pesq_score + 0.5) / 5


REGISTERED_METRICS = {
    "SI_SDR": SI_SDR,
    "STOI": STOI,
    "WB_PESQ": WB_PESQ,
    "NB_PESQ": NB_PESQ,
}


def validation_metrics(noisy, clean, enhanced, sr: int, with_pesq: bool) -> dict:
    """The metrics of one validation utterance, noisy and enhanced against
    clean (the JAX Trainer's ``metrics_visualization.one``): STOI and
    SI-SDR, and WB-PESQ when ``with_pesq``."""
    out = {
        "stoi_n": STOI(clean, noisy, sr=sr),
        "stoi_e": STOI(clean, enhanced, sr=sr),
        "sisdr_n": SI_SDR(clean, noisy, sr=sr),
        "sisdr_e": SI_SDR(clean, enhanced, sr=sr),
    }
    if with_pesq:
        out["pesq_n"] = WB_PESQ(clean, noisy, sr=sr)
        out["pesq_e"] = WB_PESQ(clean, enhanced, sr=sr)
    return out
