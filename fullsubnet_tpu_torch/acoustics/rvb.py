"""Room-impulse-response utilities (counterpart of
``fullsubnet_tpu/acoustics/rvb.py``), numpy."""

import numpy as np


def reverberation_time_shortening(
    rir: np.ndarray,
    original_T60: float,
    target_T60: float,
    sr: int = 16000,
    time_after_max: float = 0.002,
):
    """Shorten the reverberation time of an RIR by an exponential window
    that starts ``time_after_max`` seconds after its peak (Speech
    Dereverberation With a Reverberation Time Shortening Target,
    arXiv:2204.08765). Returns (shortened RIR, window)."""
    if rir.ndim != 1:
        raise ValueError("rir must be a 1D array.")
    q = 3 / (target_T60 * sr) - 3 / (original_T60 * sr)
    idx_max = int(np.argmax(np.abs(rir)))
    n1 = int(idx_max + time_after_max * sr)
    win = np.empty(shape=rir.shape, dtype=np.float32)
    win[:n1] = 1
    win[n1:] = 10 ** (-q * np.arange(rir.shape[0] - n1))
    return rir * win, win
