"""PESQ — Perceptual Evaluation of Speech Quality (ITU-T P.862 family).

The port's own copy of ``fullsubnet_tpu/pesq.py``, numpy only, with the
same calibrated constants: the same inputs give the same bits. The
tests and tools named below hold the JAX package's copy, and
``tests/test_torch_metrics.py`` holds this one equal to it.

A from-scratch NumPy implementation of the P.862 perceptual model with the
P.862.1 (narrowband) and P.862.2 (wideband) MOS-LQO mappings, replacing the
reference's dependency on the ITU C extension (``audio_zen/metrics.py:38-45``
via the ``pesq`` package), which need not be installed.

The implementation follows the published P.862 algorithm end to end:

1.  **Buffers**: both signals carry a 75-frame (300 ms) zero search buffer
    on each side plus 320 ms of data padding, exactly like the ITU
    processing buffers (pads count in the level-normalization divisor).
2.  **Level alignment** (``fix_power_level``): mean power of the
    350-3250 Hz band-passed signal over the active region is scaled to
    1e7 (16-bit sample domain).
3.  **Input filtering**: the IRS-receive response for NB (FFT magnitude
    filter on the spec's dB table, 0 dB re 1 kHz), the P.862.2 input IIR
    biquad for WB.
4.  **Time alignment**: envelope (VAD) based crude alignment of the whole
    file, VAD utterance location, per-utterance crude + fine alignment
    (64 ms Hann frames, 75% overlap, FFT cross-correlation histogram with
    v^0.125 weighting and triangular smoothing), and utterance splitting
    when the per-frame delay track jumps inside an utterance (the split is
    kept when both halves align more confidently than the whole).
5.  **Perceptual model**: 32 ms Hann frames (50% overlap) -> Bark spectra
    on the 49 (16 kHz) / 42 (8 kHz) band tables -> partial frequency
    compensation of the reference -> short-term gain compensation ->
    Zwicker loudness -> center-clipped loudness difference -> asymmetry
    factor ((deg+50)/(ref+50))^1.2 gated at 3, capped at 12.
6.  **Bad intervals**: frames whose symmetric disturbance exceeds 30 form
    bad intervals (>= 5 consecutive, smeared by 2); each interval is
    re-aligned by interval cross-correlation and the per-frame disturbance
    takes the minimum of the two alignments.
7.  **Aggregation** (``Lpq_weight``): L6 over 20-frame splits (10-frame
    hop, tail splits divided by the FULL split length, per the spec code),
    L2 over splits, frames weighted by ((audible ref power + 1e5)/1e7)^0.04
    and capped at 45. Raw score = 4.5 - 0.1*D_sym - 0.0309*D_asym, mapped
    to MOS-LQO with the published logistics (P.862.1 / P.862.2).

Fidelity note (see docs/parity.md): the Bark band tables (centres, widths,
bin counts, power-density corrections, hearing thresholds) and the model
constants are the ITU table values; their transcription is validated by
internal-consistency tests (``tests/test_pesq.py``) — centre/width
recurrence exact, bin counts summing to the FFT size, threshold curve
matching the published dB anchors. Two quantities are NOT spec-derived:
the band-aggregation scales ``_SYM_SCALE`` / ``_ASYM_SCALE``, which are
fitted (``tools/pesq_calibrate.py``) so a DNS-like synthetic noisy
testbed reproduces the reference repo's published DNS no_reverb noisy
baselines for BOTH modes simultaneously (WB 1.582 / NB 2.454 — two
anchors, two constants, and the fitted asym scale lands at
1/totalBandWidth, consistent with a width-normalized ITU power mean).
The NB input filter uses the spec's IRS-receive magnitude table as a
zero-phase FFT filter instead of the ITU IIR cascade (magnitude response
table-exact; measured score sensitivity to the phase choice is max
0.17 / median 0.004 MOS on the noisy testbed); the crude aligner uses
NORMALIZED cross-correlation with an energy-coverage gate (raw
correlation is energy-biased on quasi-periodic envelopes; the end-to-end
constant-delay invariance this must preserve is pinned at max 0.18 MOS
over a delay sweep). Each documented deviation carries a pinned measured
bound in ``tests/test_pesq_fidelity.py``; deviation vs the ITU C
implementation on individual scores is bounded by those measurements
plus the 0.006-RMSE anchor calibration, not ITU-certified.
``tools/pesq_goldens.py`` cross-checks against the ITU ``pesq`` package
(auto-run by ``tests/test_pesq_goldens.py`` whenever the wheel is
importable) and records golden triples for regression.

Reference parity: replaces ``pesq.pesq(sr, ref, deg, 'wb'|'nb')`` in
the reference's ``audio_zen/metrics.py:38-45``.
"""

from __future__ import annotations

import numpy as np

_EPS = np.finfo(np.float64).eps

# ---------------------------------------------------------------------------
# ITU-T P.862 constants
# ---------------------------------------------------------------------------

_TARGET_AVG_POWER = 1e7
_SEARCHBUFFER = 75          # 4 ms frames of zero padding each side
_DATAPADDING_MS = 320
_MINUTTLENGTH = 50          # 4 ms frames (200 ms) minimum utterance
_MAXNUTTERANCES = 50
_THRESHOLD_BAD_FRAMES = 30.0
_SMEAR_RANGE = 2
_MIN_BAD_INTERVAL = 5       # bad frames needed to form a bad interval

_ZWICKER_POWER = 0.23
_D_POW_F, _D_POW_S, _D_POW_T = 2.0, 6.0, 2.0
_A_POW_F, _A_POW_S, _A_POW_T = 1.0, 6.0, 2.0
_D_WEIGHT, _A_WEIGHT = 0.1, 0.0309

# Calibration of the two disturbance aggregation scales (see docs/parity.md):
# the perceptual chain (level/filter/align/Bark/loudness/asym gates/caps/Lpq)
# is the ITU structure with ITU table values; these two constants absorb the
# residual uncertainty in the band-aggregation normalization and are fitted
# so a DNS-like synthetic noisy testbed reproduces the reference-published
# DNS no_reverb noisy baselines (WB-PESQ 1.582 / NB-PESQ 2.454,
# BASELINE.md). Identity/delay/gain anchors are exact regardless (zero
# disturbance). Fitted by tools/pesq_calibrate.py (24-clip testbed:
# WB 1.587 / NB 2.447, rmse 0.006). The fitted asym scale lands at
# 1/totalBandWidth (1/20.98) — consistent with ITU pseudo_Lp being a
# width-normalized power mean with no re-scaling.
_SYM_SCALE = 0.139115
_ASYM_SCALE = 0.0482088

_SP = {16000: 6.910853e-6, 8000: 2.764344e-5}
_SL = {16000: 1.866055e-1, 8000: 1.866055e-1}

# MOS-LQO logistic: y = 0.999 + 4 / (1 + exp(-a*x + b))
_MAPPING = {"wb": (1.3669, 3.8224), "nb": (1.4945, 4.6607)}

# Level-alignment bandpass (350-3250 Hz), P.862 align_filter_dB.
_ALIGN_FILTER_DB = [
    (0, -500), (50, -500), (100, -500), (125, -500), (160, -500),
    (200, -500), (250, -500), (300, -500), (350, 0), (400, 0),
    (500, 0), (600, 0), (630, 0), (800, 0), (1000, 0), (1250, 0),
    (1600, 0), (2000, 0), (2500, 0), (3000, 0), (3250, 0),
    (3500, -500), (4000, -500), (5000, -500), (6300, -500), (8000, -500),
]

# IRS receive characteristic (NB input filter), P.862 standard_IRS_filter_dB.
_IRS_FILTER_DB = [
    (0, -200), (50, -40), (100, -20), (125, -12), (160, -6), (200, 0),
    (250, 4), (300, 6), (350, 8), (400, 10), (500, 11), (600, 12),
    (700, 12), (800, 12), (1000, 12), (1300, 12), (1600, 12), (2000, 12),
    (2500, 12), (3000, 12), (3250, 12), (3500, 4), (4000, -200),
    (5000, -200), (6300, -200), (8000, -200),
]

# P.862.2 wideband input filter (one second-order section, 16 kHz).
_WB_IIR_SOS = (2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434)

# ---------------------------------------------------------------------------
# Bark band tables (ITU P.862, 16 kHz: 49 bands over 256 bins; the 8 kHz
# 42-band tables are the prefix of the same Bark grid, the last band
# truncated to the 128-bin Nyquist).
# ---------------------------------------------------------------------------

_NR_OF_HZ_BANDS_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1, 2, 2, 2, 2, 2, 2,
    2, 2, 3, 3, 3, 3, 4, 3, 4, 5, 4, 5, 6, 6, 7, 8, 9, 9, 12, 12, 15, 16,
    18, 21, 25, 20,
])

_CENTRE_OF_BAND_BARK_16K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450, 1.624217, 1.962597,
    2.305636, 2.653383, 3.005889, 3.363201, 3.725371, 4.092449, 4.464486,
    4.841533, 5.223642, 5.610866, 6.003256, 6.400869, 6.803755, 7.211971,
    7.625571, 8.044611, 8.469146, 8.899232, 9.334927, 9.776288, 10.223374,
    10.676242, 11.134952, 11.599563, 12.070135, 12.546731, 13.029408,
    13.518232, 14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478, 19.319147,
    19.886751, 20.461355, 21.043034,
])

_WIDTH_OF_BAND_BARK_16K = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934,
    0.543629, 0.550390, 0.557220, 0.564119, 0.571085, 0.578125, 0.585232,
])

_POW_DENS_CORRECTION_16K = np.array([
    100.000000, 99.999992, 100.000000, 100.000008, 100.000008, 100.000015,
    99.999992, 99.999969, 50.000027, 100.000000, 99.999969, 100.000015,
    99.999947, 100.000061, 53.047077, 110.000046, 117.991989, 65.000000,
    68.760147, 69.999931, 71.428574, 75.000038, 76.843384, 80.968781,
    88.646126, 63.864388, 68.155350, 72.547775, 75.584831, 58.379192,
    80.950836, 64.135651, 54.384785, 73.821884, 64.437073, 59.176456,
    65.521278, 61.399822, 58.144047, 57.231384, 59.605368, 51.571451,
    59.104108, 52.478142, 55.146812, 56.871075, 53.410809, 56.871075,
    55.000000,
])

_ABS_THRESH_POWER_16K = np.array([
    51286152.00, 2454709.500, 70794.593750, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372, 4.897789,
    3.090296, 1.905461, 1.258925, 0.977237, 0.724436, 0.562341, 0.457088,
    0.389045, 0.331131, 0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030, 0.338844, 0.371535,
    0.398107, 0.436516, 0.467735, 0.489779, 0.501187, 0.501187, 0.512861,
    0.524807, 0.524807, 0.524807, 0.512861, 0.478630, 0.426580, 0.371535,
    0.363078, 0.416869, 0.537032,
])


class _Model:
    """Per-sample-rate tables and sizes."""

    def __init__(self, sr: int):
        self.sr = sr
        self.frame = 512 if sr == 16000 else 256      # Nf (32 ms)
        self.shift = self.frame // 2
        self.downsample = sr // 250                   # 4 ms VAD/align frames
        self.align_nfft = 1024 if sr == 16000 else 512
        self.sp = _SP[sr]
        self.sl = _SL[sr]
        if sr == 16000:
            self.nb = 49
            self.nr_of_hz_bands = _NR_OF_HZ_BANDS_16K
        else:
            # 42-band prefix of the same Bark grid; the last band loses
            # one bin to the 128-bin Nyquist (sum 129 -> 128)
            self.nb = 42
            nr = _NR_OF_HZ_BANDS_16K[:42].copy()
            nr[-1] -= 1
            self.nr_of_hz_bands = nr
        self.centre_bark = _CENTRE_OF_BAND_BARK_16K[: self.nb]
        self.width_bark = _WIDTH_OF_BAND_BARK_16K[: self.nb]
        self.pow_dens_correction = _POW_DENS_CORRECTION_16K[: self.nb]
        self.abs_thresh = _ABS_THRESH_POWER_16K[: self.nb]
        assert self.nr_of_hz_bands.sum() == self.frame // 2
        self.band_edges = np.concatenate(
            [[0], np.cumsum(self.nr_of_hz_bands)]
        )
        self.window = 0.5 * (
            1.0 - np.cos(2.0 * np.pi * np.arange(self.frame) / self.frame)
        )
        # Zwicker exponent, raised below 4 Bark (the low-band modification
        # h = min(6/(z+2), 2) ** 0.15)
        h = np.minimum(6.0 / (self.centre_bark + 2.0), 2.0)
        h = np.where(self.centre_bark < 4.0, h, 1.0)
        self.zwicker = _ZWICKER_POWER * h**0.15
        # pseudo_Lp / total_audible skip band 0 (per the spec code)
        self.band_w = self.width_bark.copy()
        self.total_w = float(self.width_bark[1:].sum())

    @property
    def buf(self) -> int:
        return _SEARCHBUFFER * self.downsample

    @property
    def datapad(self) -> int:
        return _DATAPADDING_MS * self.sr // 1000


_MODELS: dict[int, _Model] = {}


def _model(sr: int) -> _Model:
    if sr not in _MODELS:
        _MODELS[sr] = _Model(sr)
    return _MODELS[sr]


# ---------------------------------------------------------------------------
# Pre-processing
# ---------------------------------------------------------------------------


def _interp_db(f, curve):
    hz, db = np.asarray(curve, np.float64).T
    return np.interp(f, hz, db)


def _apply_fft_filter(
    x, m: _Model, curve, active, re_1khz: bool, phase: str = "zero"
):
    """Magnitude filter over the active region: gains from a piecewise-
    linear dB table, optionally normalized to 0 dB at 1 kHz
    (``apply_filter``'s overallGainFilter).

    ``phase='zero'`` applies the table as a zero-phase FFT filter (the
    calibrated default). ``phase='minimum'`` converts the same magnitude
    response to its minimum-phase counterpart (real-cepstrum folding) —
    the ITU C implementation realizes the IRS-receive response as an IIR
    cascade, which is minimum-phase-like, so this option narrows the
    documented phase deviation without changing the table-exact
    magnitude (tests/test_pesq_fidelity.py pins the score delta between
    the two)."""
    start, n = active
    seg = x[start : start + n]
    nfft = int(2 ** np.ceil(np.log2(max(n, 2))))
    spec = np.fft.rfft(seg, nfft)
    f = np.arange(len(spec)) * (m.sr / nfft)
    db = _interp_db(f, curve)
    if re_1khz:
        db = db - _interp_db(1000.0, curve)
    gain = 10.0 ** (db / 20.0)
    if phase == "minimum":
        # homomorphic construction: fold the real cepstrum of log|H| so
        # exp(FFT(fold)) has the same magnitude and minimum phase
        cep = np.fft.irfft(np.log(np.maximum(gain, 1e-8)), nfft)
        fold = np.zeros_like(cep)
        fold[0] = cep[0]
        fold[1 : nfft // 2] = 2 * cep[1 : nfft // 2]
        fold[nfft // 2] = cep[nfft // 2]
        h = np.exp(np.fft.rfft(fold, nfft))
    else:
        assert phase == "zero", phase
        h = gain
    out = x.copy()
    out[start : start + n] = np.fft.irfft(spec * h, nfft)[:n]
    return out


def _apply_wb_iir(x):
    """P.862.2 wideband input filter (single SOS, forward)."""
    b0, b1, b2, a1, a2 = _WB_IIR_SOS
    y = np.empty_like(x)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(len(x)):
        xi = x[i]
        yi = b0 * xi + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        y[i] = yi
        x2, x1 = x1, xi
        y2, y1 = y1, yi
    return y


def _apply_wb_iir_fast(x):
    """Vectorized biquad via scipy when available (exact same filter)."""
    try:
        from scipy.signal import lfilter

        b0, b1, b2, a1, a2 = _WB_IIR_SOS
        return lfilter([b0, b1, b2], [1.0, a1, a2], x)
    except Exception:
        return _apply_wb_iir(x)


def _fix_power_level(x, m: _Model, n_active: int):
    """Scale so the 350-3250 Hz mean power over the active region is 1e7.
    The divisor includes the 320 ms data padding (zeros), per the spec."""
    filtered = _apply_fft_filter(
        x, m, _ALIGN_FILTER_DB, (m.buf, n_active), re_1khz=False
    )
    power = float(
        np.sum(filtered[m.buf : m.buf + n_active] ** 2)
    ) / n_active
    return x * np.sqrt(_TARGET_AVG_POWER / (power + _EPS))


# ---------------------------------------------------------------------------
# VAD + alignment
# ---------------------------------------------------------------------------


def _vad(x, m: _Model, n_samples: int):
    """P.862 ``apply_VAD``: per-4ms-frame powers, iterative noise-floor
    threshold, returns (vad, logvad) where logvad > 0 marks speech."""
    nwin = n_samples // m.downsample
    vad = np.mean(
        x[: nwin * m.downsample].reshape(nwin, m.downsample) ** 2, axis=1
    )
    level_thresh = float(vad.mean())
    level_min = float(vad.max())
    level_min = level_min * 1.0e-4 if level_min > 0 else 1.0
    vad = np.maximum(vad, level_min)

    for _ in range(12):
        noise = vad[vad <= level_thresh]
        if len(noise) > 0:
            level_noise = float(noise.mean())
            std_noise = float(np.sqrt(np.mean((noise - level_noise) ** 2)))
        else:
            level_noise, std_noise = 0.0, 0.0
        level_thresh = 1.001 * (level_noise + 2.0 * std_noise)

    logvad = np.where(vad > level_thresh, np.log(vad / level_thresh), 0.0)
    return vad, logvad


def _xcorr_argmax(a, b, prefer: int | None = None):
    """argmax lag of full linear cross-correlation c[lag] = sum_i
    a[i] * b[i + lag] (lag of b relative to a), via FFT.

    ``prefer``: among near-tied maxima (within 0.1% — (quasi-)periodic
    content ties at period multiples; e.g. pesq(x, x) on a pure tone
    must still find lag 0), pick the candidate closest to this lag.
    Distinct peaks are unaffected.
    """
    n = len(a) + len(b) - 1
    nfft = int(2 ** np.ceil(np.log2(max(n, 2))))
    c = np.fft.irfft(
        np.conj(np.fft.rfft(a, nfft)) * np.fft.rfft(b, nfft), nfft
    )
    lags = np.concatenate(
        [np.arange(nfft - len(a) + 1, nfft), np.arange(0, len(b))]
    )
    # order lags from -(len(a)-1) .. len(b)-1
    vals = c[lags]
    i = int(np.argmax(vals))
    if prefer is not None and vals[i] > 0:
        near = np.flatnonzero(vals >= (1.0 - 1e-3) * vals[i])
        i = int(near[np.argmin(np.abs(near - (len(a) - 1) - prefer))])
    return i - (len(a) - 1), float(vals[i])


def _ncc_argmax(a, b, prefer: int, min_overlap: int):
    """argmax lag of NORMALIZED cross-correlation c[lag] /
    sqrt(E_a(lag) * E_b(lag)) over the overlapped samples. Excluded lags:
    overlap < ``min_overlap``, and lags whose overlap covers less than
    half of ``a``'s total envelope energy (NCC's classic pathology is a
    high score on a small-overlap sliver at an extreme lag — a candidate
    alignment must explain the reference envelope, not a tail of it;
    pinned by tests/test_pesq_fidelity.py's delay-invariance sweep).

    Used for the envelope-domain crude aligns: raw correlation (ITU's
    choice) is biased toward high-energy regions — on quasi-periodic
    envelopes the peak one syllable over can beat the true lag because
    the neighboring syllable is merely louder. Normalizing makes an
    exact match (NCC = 1) dominate any energy imbalance; on real speech
    the argmax is unchanged. Near-ties (0.1%) resolve toward ``prefer``.
    """
    n = len(a) + len(b) - 1
    nfft = int(2 ** np.ceil(np.log2(max(n, 2))))
    c = np.fft.irfft(
        np.conj(np.fft.rfft(a, nfft)) * np.fft.rfft(b, nfft), nfft
    )
    lags_idx = np.concatenate(
        [np.arange(nfft - len(a) + 1, nfft), np.arange(0, len(b))]
    )
    vals = c[lags_idx]
    lags = np.arange(-(len(a) - 1), len(b))
    ca = np.concatenate([[0.0], np.cumsum(a * a)])
    cb = np.concatenate([[0.0], np.cumsum(b * b)])
    i0 = np.maximum(0, -lags)                       # overlap start in a
    i1 = np.minimum(len(a), len(b) - lags)          # overlap end in a
    overlap = np.maximum(i1 - i0, 0)
    ea = ca[np.maximum(i1, i0)] - ca[i0]
    j0 = i0 + lags
    eb = cb[np.maximum(j0 + overlap, j0)] - cb[j0]
    admissible = (overlap >= min_overlap) & (ea >= 0.5 * ca[-1])
    if not admissible.any():
        # the 50% energy-coverage gate can be unsatisfiable (degraded
        # signal much shorter than the reference, or delays past ~half
        # the file). Relax the coverage threshold stepwise rather than
        # dropping it outright — overlap-only admission re-admits the
        # +1.5 MOS misalignment pathology the gate was built to stop
        # (unrelated audio can win on a sliver of reference energy).
        for frac in (0.25, 0.1):
            admissible = (overlap >= min_overlap) & (ea >= frac * ca[-1])
            if admissible.any():
                break
        else:
            # coverage unsatisfiable at any threshold (degraded signal
            # covers <10% of the reference energy at every lag). Allow an
            # overlap-only candidate — but only with a strong CENTERED
            # (Pearson) score: uncentered NCC of two nonnegative
            # envelopes is high (~0.7+) even for unrelated audio, while
            # centering sends unrelated to ~0 and a genuine match stays
            # near 1. Below the floor, return the ``prefer`` sentinel
            # rather than a confident wrong lag.
            admissible = overlap >= min_overlap
            if admissible.any():
                la = np.concatenate([[0.0], np.cumsum(a)])
                lb = np.concatenate([[0.0], np.cumsum(b)])
                sa = la[np.maximum(i1, i0)] - la[i0]
                sb = lb[np.maximum(j0 + overlap, j0)] - lb[j0]
                ov = np.maximum(overlap, 1)
                cov = vals - sa * sb / ov
                va = ea - sa * sa / ov
                vb = eb - sb * sb / ov
                r = np.where(
                    admissible & (va > 0) & (vb > 0),
                    cov / np.sqrt(np.maximum(va * vb, _EPS)),
                    -np.inf,
                )
                i = int(np.argmax(r))
                if np.isfinite(r[i]) and r[i] >= 0.5:
                    return int(lags[i]), float(r[i])
            return prefer, 0.0
    ncc = np.where(admissible, vals / np.sqrt(ea * eb + _EPS), -np.inf)
    if not np.isfinite(ncc).any():
        return prefer, 0.0
    i = int(np.argmax(ncc))
    if ncc[i] > 0:
        near = np.flatnonzero(ncc >= (1.0 - 1e-3) * ncc[i])
        i = int(near[np.argmin(np.abs(lags[near] - prefer))])
    return int(lags[i]), float(ncc[i])


def _crude_subalign(logvad_r, logvad_d, span, base_frames, m: _Model):
    """Crude (4 ms resolution) alignment of one search span: correlate the
    ref VAD envelope in ``span`` against the deg envelope around
    ``base_frames``, +/- SEARCHBUFFER."""
    s, e = span
    a = logvad_r[s:e]
    lo = max(0, s + base_frames - _SEARCHBUFFER)
    hi = min(len(logvad_d), e + base_frames + _SEARCHBUFFER)
    b = logvad_d[lo:hi]
    if len(a) < 2 or len(b) < 2 or not a.any() or not b.any():
        return base_frames
    lag, _ = _ncc_argmax(
        a, b, prefer=base_frames - lo + s, min_overlap=max(2, len(a) // 2)
    )
    return lag + lo - s


def _fine_align(ref, deg, m: _Model, start_f, end_f, delay_est):
    """P.862 ``time_align``: 64 ms Hann frames at 75% overlap inside the
    span [start_f, end_f) (4 ms units), FFT cross-correlation per frame,
    |c|^0.125-weighted delay histogram with triangular smoothing.

    Returns (delay_samples, confidence, frame_lags, frame_weights) where
    frame_lags[i] is frame i's best lag relative to ``delay_est``.
    """
    nfft = m.align_nfft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))
    s0 = start_f * m.downsample
    s1 = end_f * m.downsample
    starts = np.arange(s0, max(s1 - nfft, s0) + 1, nfft // 4)
    if len(starts) == 0:
        return delay_est, 0.0, np.zeros(0), np.zeros(0)

    def frames_at(x, offs):
        idx = offs[:, None] + np.arange(nfft)[None, :]
        idx = np.clip(idx, 0, len(x) - 1)
        valid = (offs >= 0) & (offs + nfft <= len(x))
        out = x[idx] * window[None, :]
        out[~valid] = 0.0
        return out

    fr = frames_at(ref, starts)
    fd = frames_at(deg, starts + delay_est)
    nfft2 = 2 * nfft
    c = np.fft.irfft(
        np.conj(np.fft.rfft(fr, nfft2, axis=1))
        * np.fft.rfft(fd, nfft2, axis=1),
        nfft2,
        axis=1,
    )
    # reorder to lags -(nfft-1) .. nfft-1
    c = np.concatenate([c[:, nfft2 - nfft + 1 :], c[:, :nfft]], axis=1)
    c = np.abs(c)
    v = c.max(axis=1)
    lags = c.argmax(axis=1) - (nfft - 1)
    w = np.where(v > 0, v**0.125, 0.0)

    hist = np.zeros(2 * nfft - 1)
    np.add.at(hist, lags + (nfft - 1), w)
    # triangular smoothing, half-width = one 4 ms frame
    k = m.downsample
    kernel = 1.0 - np.abs(np.arange(-k, k + 1)) / (k + 1.0)
    hist = np.convolve(hist, kernel, mode="same")
    i = int(np.argmax(hist))
    if hist[i] > 0:
        # near-tie break toward relative lag 0 (keep the crude
        # estimate) — periodic content votes at period multiples
        near = np.flatnonzero(hist >= (1.0 - 1e-3) * hist[i])
        i = int(near[np.argmin(np.abs(near - (nfft - 1)))])
    # NORMALIZED confidence (peak vote mass / total vote mass) so
    # confidences are comparable across spans of different lengths —
    # the split acceptance test below depends on this (P.862's
    # Utt_DelayConf is likewise a normalized quantity)
    conf = float(hist[i] / (hist.sum() + _EPS))
    return delay_est + (i - (nfft - 1)), conf, lags, w


def _speech_runs(logvad, min_len):
    """Contiguous logvad > 0 runs of at least ``min_len`` 4 ms frames."""
    speech = logvad > 0
    if not speech.any():
        return []
    d = np.diff(speech.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if speech[0]:
        starts.insert(0, 0)
    if speech[-1]:
        ends.append(len(speech))
    return [(s, e) for s, e in zip(starts, ends) if e - s >= min_len]


def _split_utterance(ref, deg, m, span, base, whole, depth=0):
    """P.862 ``split_align`` structure: if the per-frame delay track jumps
    inside the utterance, try splitting at the jump; keep the split when
    both halves align more confidently than the whole. Recursive (bounded).
    Returns a list of (start_f, end_f, delay_samples)."""
    s, e = span
    delay, conf, lags, w = whole
    min_span_f = 2 * _MINUTTLENGTH
    if depth >= 3 or e - s < 2 * min_span_f or len(lags) < 8:
        return [(s, e, delay)]
    # weighted smoothing of the per-frame lag track; largest jump that
    # exceeds one 4 ms frame is the split candidate
    kernel = np.ones(5)
    ww = np.convolve(w, kernel, mode="same") + _EPS
    track = np.convolve(lags * w, kernel, mode="same") / ww
    jumps = np.abs(np.diff(track))
    # frame i starts at s*D + i*nfft/4; convert to 4 ms units
    hop_f = m.align_nfft // 4 // m.downsample
    order = np.argsort(jumps)[::-1]
    for j in order[:3]:
        if jumps[j] <= m.downsample:
            break
        split_f = s + (j + 1) * hop_f
        if split_f - s < min_span_f // 2 or e - split_f < min_span_f // 2:
            continue
        # P.862 split_align searches AROUND the utterance's existing
        # delay estimate (no fresh crude align of the halves — energy-
        # envelope re-alignment of a short half-span locks onto bogus
        # syllable-period lags); the fine aligner's +/-nfft window
        # around the whole-utterance delay is the search range
        dl, cl, ll, wl = _fine_align(ref, deg, m, s, split_f, delay)
        dr, cr, lr, wr = _fine_align(ref, deg, m, split_f, e, delay)
        if min(cl, cr) > conf and dl != dr:
            left = _split_utterance(
                ref, deg, m, (s, split_f), base, (dl, cl, ll, wl), depth + 1
            )
            right = _split_utterance(
                ref, deg, m, (split_f, e), base, (dr, cr, lr, wr), depth + 1
            )
            return left + right
        break
    return [(s, e, delay)]


def _locate_utterances(ref, deg, m: _Model, n_samples: int):
    """Crude whole-file alignment -> VAD utterance location -> per-
    utterance crude + fine alignment -> splitting. Returns a list of
    (start_frame4ms, end_frame4ms, delay_samples) tiling the active file
    (``id_utterances`` midpoint semantics)."""
    _, logvad_r = _vad(ref, m, n_samples)
    _, logvad_d = _vad(deg, m, n_samples)
    nwin = n_samples // m.downsample

    if logvad_r.any() and logvad_d.any():
        lag, _ = _ncc_argmax(
            logvad_r, logvad_d, prefer=0,
            min_overlap=max(2, len(logvad_r) // 4),
        )
    else:
        lag = 0
    crude = lag * m.downsample

    runs = _speech_runs(logvad_r, _MINUTTLENGTH)[:_MAXNUTTERANCES]
    whole = (_SEARCHBUFFER, nwin - _SEARCHBUFFER)
    if not runs:
        d, c, _, _ = _fine_align(ref, deg, m, whole[0], whole[1], crude)
        return [(whole[0], whole[1], d if c > 0 else crude)]

    pieces = []
    for s, e in runs:
        win = (max(0, s - _SEARCHBUFFER), min(nwin, e + _SEARCHBUFFER))
        base_f = _crude_subalign(
            logvad_r, logvad_d, win, lag, m
        )
        est = base_f * m.downsample
        d, c, lg, w = _fine_align(ref, deg, m, win[0], win[1], est)
        if c <= 0:
            d = crude
        pieces += _split_utterance(
            ref, deg, m, win, est, (d, c, lg, w)
        )

    # midpoint tiling over the active region
    utts = []
    for i, (s, e, d) in enumerate(pieces):
        start = whole[0] if i == 0 else (pieces[i - 1][1] + s) // 2
        end = whole[1] if i == len(pieces) - 1 else (e + pieces[i + 1][0]) // 2
        if end > start:
            utts.append((start, end, int(d)))
    return utts or [(whole[0], whole[1], crude)]


# ---------------------------------------------------------------------------
# Perceptual model
# ---------------------------------------------------------------------------


def _frame_powers(x, starts, m: _Model):
    """Hann-windowed unnormalized |FFT|^2, first Nf/2 bins. Windows that
    fall (partly) outside the array read zeros."""
    idx = starts[:, None] + np.arange(m.frame)[None, :]
    valid = (idx >= 0) & (idx < len(x))
    seg = np.where(valid, x[np.clip(idx, 0, len(x) - 1)], 0.0)
    spec = np.fft.rfft(seg * m.window[None, :], axis=1)
    p = np.abs(spec[:, : m.frame // 2]) ** 2
    p[:, 0] *= 0.5  # DC bin halved, per the spec's short_term_fft
    return p


def _bark_spectra(hz_power, m: _Model):
    """[T, Nf/2] bin powers -> [T, Nb] pitch power densities
    (``freq_warping``: contiguous bin groups, correction factor, Sp)."""
    sums = np.add.reduceat(hz_power, m.band_edges[:-1], axis=1)
    return sums * m.pow_dens_correction[None, :] * m.sp


def _total_audible(pp, m: _Model, factor: float):
    """Total power of bands above factor * threshold (band 0 excluded)."""
    p = pp[:, 1:]
    return np.where(p > factor * m.abs_thresh[None, 1:], p, 0.0).sum(axis=1)


def _loudness(pp, m: _Model):
    """Zwicker loudness (Sone) per band (``intensity_warping_of``)."""
    z = m.zwicker[None, :]
    loud = (
        m.sl
        * (m.abs_thresh[None, :] / 0.5) ** z
        * ((0.5 + 0.5 * pp / m.abs_thresh[None, :]) ** z - 1.0)
    )
    return np.where(pp > m.abs_thresh[None, :], loud, 0.0)


def _pseudo_lp(d, m: _Model, p: float):
    """P.862 ``pseudo_Lp``: ((sum_b>=1 (|d_b| w_b)^p) / totalW)^(1/p)
    * totalW — a width-weighted power mean over bands (band 0
    excluded), rescaled by the total width per the spec code."""
    prod = np.abs(d[:, 1:]) * m.band_w[None, 1:]
    lp = (np.sum(prod**p, axis=1) / m.total_w) ** (1.0 / p)
    return lp * m.total_w


def _disturbances(pp_ref_mod, pp_deg, m: _Model):
    """Center-clipped loudness-difference disturbance (symmetric) and its
    asymmetry-weighted variant, per frame. ``pp_ref_mod`` already carries
    the frequency + gain compensations."""
    loud_ref = _loudness(pp_ref_mod, m)
    loud_deg = _loudness(pp_deg, m)
    d = loud_deg - loud_ref
    dead = 0.25 * np.minimum(loud_deg, loud_ref)
    d = np.sign(d) * np.maximum(np.abs(d) - dead, 0.0)

    asym = ((pp_deg + 50.0) / (pp_ref_mod + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    d_sym = _pseudo_lp(d, m, _D_POW_F)
    d_asym = _pseudo_lp(d * asym, m, _A_POW_F)
    return d_sym, d_asym


def _lpq_weight(frame_d, p_syl, p_time, split=20, hop=10):
    """P.862 ``Lpq_weight``: L_p over 20-frame splits starting every 10
    frames; every split divides by the FULL split length (tail splits are
    effectively zero-padded, per the spec code), then L_q over splits."""
    t = len(frame_d)
    if t == 0:
        return 0.0
    num = 0.0
    cnt = 0
    for s in range(0, t, hop):
        seg = frame_d[s : s + split]
        syl = (np.sum(seg**p_syl) / split) ** (1.0 / p_syl)
        num += syl**p_time
        cnt += 1
    return float((num / cnt) ** (1.0 / p_time))


def _bad_intervals(bad):
    """Consecutive-bad-frame intervals of >= _MIN_BAD_INTERVAL frames,
    smeared by _SMEAR_RANGE on each side."""
    runs = _speech_runs(bad.astype(np.float64), _MIN_BAD_INTERVAL)
    t = len(bad)
    return [
        (max(0, s - _SMEAR_RANGE), min(t, e + _SMEAR_RANGE)) for s, e in runs
    ]


def pesq_raw(
    ref, deg, sr: int = 16000, mode: str = "wb", irs_phase: str = "zero"
) -> float:
    """Raw P.862 score in ~[-0.5, 4.5] (before the MOS-LQO mapping)."""
    a = _analyze(ref, deg, sr=sr, mode=mode, irs_phase=irs_phase)
    if a is None:
        return -0.5
    return _score(a)


def _analyze(ref, deg, sr: int, mode: str, irs_phase: str = "zero"):
    """Level/filter/align/perceptual stages, up to the PRE-SCALE per-frame
    disturbances. Returns everything ``_score`` needs (kept separate so the
    calibration fit in ``tools/pesq_calibrate.py`` can reuse one analysis
    across many (sym, asym) scale candidates), or None for too-short
    input."""
    assert mode in ("wb", "nb")
    assert sr in (8000, 16000), "PESQ is defined for 8 kHz / 16 kHz input"
    if mode == "wb":
        assert sr == 16000, "wideband PESQ requires 16 kHz input"
        if irs_phase != "zero":
            # wb uses the IIR pre-filter, not the IRS-receive FFT filter —
            # a non-default irs_phase would be silently ignored
            raise ValueError(
                "irs_phase applies to nb mode only (wb uses the P.862.2 "
                "IIR pre-filter); got irs_phase="
                f"{irs_phase!r} with mode='wb'"
            )
    m = _model(sr)

    ref = np.asarray(ref, np.float64).reshape(-1) * 32768.0
    deg = np.asarray(deg, np.float64).reshape(-1) * 32768.0
    length = min(len(ref), len(deg))
    ref, deg = ref[:length], deg[:length]
    if length < 4 * m.frame:
        return None

    # processing buffers: [300 ms zeros][signal][300 ms zeros + 320 ms pad]
    pad_front = np.zeros(m.buf)
    pad_back = np.zeros(m.buf + m.datapad)
    ref = np.concatenate([pad_front, ref, pad_back])
    deg = np.concatenate([pad_front, deg, pad_back])
    n_active = length + m.datapad       # power divisor incl. data padding
    n_vad = length + 2 * m.buf          # VAD region excl. data padding

    ref = _fix_power_level(ref, m, n_active)
    deg = _fix_power_level(deg, m, n_active)
    if mode == "wb":
        ref = _apply_wb_iir_fast(ref)
        deg = _apply_wb_iir_fast(deg)
    else:
        ref = _apply_fft_filter(
            ref, m, _IRS_FILTER_DB, (m.buf, n_active), re_1khz=True,
            phase=irs_phase,
        )
        deg = _apply_fft_filter(
            deg, m, _IRS_FILTER_DB, (m.buf, n_active), re_1khz=True,
            phase=irs_phase,
        )

    utts = _locate_utterances(ref, deg, m, n_vad)

    # framing over the active region (incl. data padding), 50% overlap
    n_frames = (length + m.datapad) // m.shift - 1
    if n_frames < 4:
        return None
    starts_ref = m.buf + np.arange(n_frames) * m.shift
    # per-frame delay from the covering utterance (utterance u covers
    # frames starting at sample >= Utt_Start * Downsample)
    utt_starts = np.array([u[0] * m.downsample for u in utts])
    utt_of = np.clip(
        np.searchsorted(utt_starts, starts_ref, side="right") - 1,
        0,
        len(utts) - 1,
    )
    delays = np.array([utts[u][2] for u in utt_of], np.int64)

    hz_ref = _frame_powers(ref, starts_ref, m)
    hz_deg = _frame_powers(deg, starts_ref + delays, m)
    pp_ref = _bark_spectra(hz_ref, m)   # [T, Nb]
    pp_deg = _bark_spectra(hz_deg, m)

    # partial frequency compensation of the reference
    # (``freq_resp_compensation``: per-band avg over audible power in
    # non-silent frames, divided by the total frame count)
    silent = _total_audible(pp_ref, m, 100.0) < 1e7
    aud_ref = np.where(
        (~silent)[:, None] & (pp_ref > 100.0 * m.abs_thresh[None, :]),
        pp_ref, 0.0,
    )
    aud_deg = np.where(
        (~silent)[:, None] & (pp_deg > 100.0 * m.abs_thresh[None, :]),
        pp_deg, 0.0,
    )
    avg_ref = aud_ref.sum(axis=0) / n_frames
    avg_deg = aud_deg.sum(axis=0) / n_frames
    ratio = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0), 0.01, 100.0)
    pp_ref_c = pp_ref * ratio[None, :]

    # short-term gain compensation (first frame unsmoothed, then
    # scale = 0.2 old + 0.8 new, clamped to [3e-4, 5])
    p_ref_t = _total_audible(pp_ref_c, m, 1.0)
    p_deg_t = _total_audible(pp_deg, m, 1.0)
    gain = (p_deg_t + 5e3) / (p_ref_t + 5e3)
    smooth = np.empty_like(gain)
    acc = gain[0]
    smooth[0] = acc
    for t in range(1, n_frames):
        acc = 0.2 * acc + 0.8 * gain[t]
        smooth[t] = acc
    smooth = np.clip(smooth, 3e-4, 5.0)
    pp_ref_mod = pp_ref_c * smooth[:, None]

    d_sym, d_asym = _disturbances(pp_ref_mod, pp_deg, m)

    # frame weighting by audible reference power
    weight = ((_total_audible(pp_ref_mod, m, 1.0) + 1e5) / 1e7) ** 0.04

    return {
        "m": m, "ref": ref, "deg": deg, "starts": starts_ref,
        "delays": delays, "pp_ref_mod": pp_ref_mod,
        "d_sym": d_sym, "d_asym": d_asym, "weight": weight,
    }


def _score(a, sym_scale: float | None = None,
           asym_scale: float | None = None,
           realign: bool = True) -> float:
    """Scale, weight, cap, bad-interval realignment, Lpq aggregation."""
    m = a["m"]
    s_sym = _SYM_SCALE if sym_scale is None else sym_scale
    s_asym = _ASYM_SCALE if asym_scale is None else asym_scale
    weight = a["weight"]
    d_sym = np.minimum(s_sym * a["d_sym"] / weight, 45.0)
    d_asym = np.minimum(s_asym * a["d_asym"] / weight, 45.0)

    # bad-interval re-alignment: intervals of badly-disturbed frames are
    # re-aligned by interval cross-correlation; per-frame disturbance takes
    # the minimum of the two alignments
    if realign:
        ref, deg = a["ref"], a["deg"]
        starts_ref, delays = a["starts"], a["delays"]
        pp_ref_mod = a["pp_ref_mod"]
        for s, e in _bad_intervals(d_sym > _THRESHOLD_BAD_FRAMES):
            r0 = int(starts_ref[s])
            r1 = int(starts_ref[e - 1]) + m.frame
            base = int(delays[s])
            aa = ref[r0:r1]
            lo = max(0, r0 + base - m.frame)
            hi = min(len(deg), r1 + base + m.frame)
            b = deg[lo:hi]
            if len(aa) < m.frame or len(b) < m.frame:
                continue
            lag, v = _xcorr_argmax(aa, b, prefer=base - lo + r0)
            if v <= 0:
                continue
            new_delay = lag + lo - r0
            hz2 = _frame_powers(deg, starts_ref[s:e] + new_delay, m)
            pp2 = _bark_spectra(hz2, m)
            s2_sym, s2_asym = _disturbances(pp_ref_mod[s:e], pp2, m)
            w2 = weight[s:e]
            s2_sym = np.minimum(s_sym * s2_sym / w2, 45.0)
            s2_asym = np.minimum(s_asym * s2_asym / w2, 45.0)
            d_sym[s:e] = np.minimum(d_sym[s:e], s2_sym)
            d_asym[s:e] = np.minimum(d_asym[s:e], s2_asym)

    dist_sym = _lpq_weight(d_sym, _D_POW_S, _D_POW_T)
    dist_asym = _lpq_weight(d_asym, _A_POW_S, _A_POW_T)
    return float(4.5 - _D_WEIGHT * dist_sym - _A_WEIGHT * dist_asym)


def pesq(
    ref, deg, sr: int = 16000, mode: str = "wb", irs_phase: str = "zero"
) -> float:
    """PESQ MOS-LQO: P.862.2 mapping for ``mode='wb'``, P.862.1 for 'nb'.

    ref/deg: float waveforms in [-1, 1]. Returns ~[1.02, 4.64] (wb) /
    ~[1.02, 4.55] (nb). ``irs_phase='minimum'`` (NB only) swaps the
    zero-phase IRS-receive realization for its minimum-phase twin —
    closer in phase behavior to the ITU IIR cascade, same table-exact
    magnitude (docs/parity.md).
    """
    raw = pesq_raw(ref, deg, sr=sr, mode=mode, irs_phase=irs_phase)
    a, b = _MAPPING[mode]
    return float(0.999 + 4.0 / (1.0 + np.exp(-a * raw + b)))
