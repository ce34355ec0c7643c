"""The HTK mel filterbank of Fast FullSubNet (counterpart of
``fullsubnet_tpu/acoustics/filterbank.py:mel_filterbank``), in numpy.

The reference builds it with ``torchaudio.transforms.MelScale`` (HTK mel
scale, no norm); torchaudio is not a dependency, so the matrix is built
here, numerically equal to ``melscale_fbanks(norm=None, mel_scale="htk")``.
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    num_freqs: int,
    num_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """Triangular HTK mel filterbank [num_freqs, num_mels], float32."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate // 2, num_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), num_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)  # [num_mels + 2]

    f_diff = f_pts[1:] - f_pts[:-1]  # [num_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [F, num_mels + 2]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)
