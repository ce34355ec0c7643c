"""Feature normalisations (counterpart of ``fullsubnet_tpu/acoustics/norm.py``).

The two Laplace norms the flagship recipes use, and the offline Laplace
norm's masked form for zero-padded, length-bucketed inputs
(``masked_offline_norm``). The Gaussian, layer, forgetting and hybrid
norms, and the masked Gaussian branch, come with ROADMAP A.13.
"""

import math

import torch

from fullsubnet_tpu_torch.constant import EPSILON


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (mean over all non-batch dims + 1e-5). x: [B, ...]."""
    mu = torch.mean(x, dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + 1e-5)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal running-mean normalisation. x: [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    step_sum = torch.sum(xr, dim=1)  # [B*C, T]
    cumulative_sum = torch.cumsum(step_sum, dim=-1)
    entry_count = torch.arange(
        f, f * t + 1, f, dtype=x.dtype, device=x.device
    )  # [T]
    cumulative_mean = cumulative_sum / entry_count[None, :]
    normed = xr / (cumulative_mean[:, None, :] + EPSILON)
    return normed.reshape(b, c, f, t)


def laplace_norm_from_stats(v: torch.Tensor, total, count) -> torch.Tensor:
    """Offline Laplace normalisation of ``v`` from statistics computed
    elsewhere: ``total`` the sum over the real elements, ``count`` their
    number, both broadcastable to ``v``."""
    mu = total / count
    return v / (mu + 1e-5)


def masked_offline_norm(norm_fn, valid_total: torch.Tensor):
    """The masked (true-count) form of an offline norm for zero-padded,
    length-bucketed inputs: the statistics cover the real frames only, so
    the normalised real frames equal an unpadded run's. ``valid_total``:
    [b, 1, 1, 1] float true frame counts (b in {1, B}). Returns ``None``
    for a causal norm (cumulative Laplace): frame t sees only frames
    <= t, so zero-padded tails leave the real frames untouched."""
    if norm_fn is offline_laplace_norm:

        def masked(v: torch.Tensor) -> torch.Tensor:
            # the padded frames are zero, so plain sums are the masked
            # sums; only the divisor is the true count
            count = math.prod(int(s) for s in v.shape[1:-1]) * valid_total
            total = torch.sum(v, dim=tuple(range(1, v.ndim)), keepdim=True)
            return laplace_norm_from_stats(v, total, count)

        return masked
    return None


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
}


def norm_wrapper(norm_type: str):
    """String -> normalisation function."""
    if norm_type not in _NORMS:
        raise NotImplementedError(
            f"norm {norm_type!r} is not ported; choose from {sorted(_NORMS)} "
            "(the other norms of fullsubnet_tpu come with ROADMAP A.13)"
        )
    return _NORMS[norm_type]
