"""Host-side batching helpers (counterpart of ``fullsubnet_tpu/infer/host.py``;
numpy only)."""

from __future__ import annotations

import numpy as np


def pad_bucket_batch(waves, batch_size: int, bucket: int):
    """Stack 1-D float32 waves into ([batch_size, bucket] zero-padded
    array, [batch_size] int32 true lengths). Filler rows (fewer waves than
    ``batch_size``) reuse the first wave's length, so their tail
    reflection stays in range; their outputs are discarded."""
    padded = np.zeros((batch_size, bucket), np.float32)
    lengths = np.full(batch_size, len(waves[0]), np.int32)
    for i, w in enumerate(waves):
        padded[i, : len(w)] = w
        lengths[i] = len(w)
    return padded, lengths
