"""Feature normalisations (counterpart of ``fullsubnet_tpu/acoustics/norm.py``).

The six norms of ``norm_wrapper``, on [B, C, F, T] tensors (``hybrid_norm``
on [B, F, T], as in the reference):

* ``offline_laplace_norm``: divide by the utterance mean;
* ``cumulative_laplace_norm``: divide by the running (causal) mean;
* ``offline_gaussian_norm``: utterance mean and unbiased std;
* ``cumulative_layer_norm``: running mean and std;
* ``forgetting_norm``: divide by an EMA of the frame means;
* ``hybrid_norm``: that EMA for the first frames, the running mean after.

The EMA keeps the reference's warm-up coefficient
``alp_t = min((t-1)/(t+1), (L-1)/(L+1))``, so ``alp_0 = -1`` and frame 0's
mean enters twice. ``masked_offline_norm`` gives the two offline norms'
masked forms for zero-padded, length-bucketed inputs.
"""

import math

import torch

from fullsubnet_tpu_torch.constant import EPSILON


def offline_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """x / (mean over all non-batch dims + 1e-5). x: [B, ...]."""
    mu = torch.mean(x, dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + 1e-5)


def _entry_count(f: int, t: int, x: torch.Tensor) -> torch.Tensor:
    """[T]: the number of elements up to and including each frame."""
    return torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)


def cumulative_laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal running-mean normalisation. x: [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cumulative_sum = torch.cumsum(torch.sum(xr, dim=1), dim=-1)  # [B*C, T]
    cumulative_mean = cumulative_sum / _entry_count(f, t, x)[None, :]
    normed = xr / (cumulative_mean[:, None, :] + EPSILON)
    return normed.reshape(b, c, f, t)


def offline_gaussian_norm(x: torch.Tensor) -> torch.Tensor:
    """(x - mu) / (std + 1e-5) with the utterance's statistics and the
    unbiased (ddof 1) std. x: [B, C, F, T]."""
    mu = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    std = torch.std(x, dim=(1, 2, 3), keepdim=True)
    return (x - mu) / (std + 1e-5)


def cumulative_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Causal running zero-norm (mean and std). x: [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cumulative_sum = torch.cumsum(torch.sum(xr, dim=1), dim=-1)  # [B*C, T]
    cumulative_pow_sum = torch.cumsum(torch.sum(torch.square(xr), dim=1), dim=-1)
    entry_count = _entry_count(f, t, x)[None, :]
    cumulative_mean = cumulative_sum / entry_count
    cumulative_var = (
        cumulative_pow_sum - 2 * cumulative_mean * cumulative_sum
    ) / entry_count + torch.square(cumulative_mean)
    cumulative_std = torch.sqrt(cumulative_var + EPSILON)
    normed = (xr - cumulative_mean[:, None, :]) / cumulative_std[:, None, :]
    return normed.reshape(b, c, f, t)


def _ema_mu(frame_mean: torch.Tensor, sample_length: int) -> torch.Tensor:
    """[B, T] frame means -> [B, T] EMA with the warm-up coefficients:
    mu_t = alp_t * mu_{t-1} + (1 - alp_t) * m_t, mu_{-1} = 0,
    alp_t = min((t-1)/(t+1), (L-1)/(L+1))."""
    t = frame_mean.shape[-1]
    alpha = (sample_length - 1) / (sample_length + 1)
    tt = torch.arange(t, dtype=frame_mean.dtype, device=frame_mean.device)
    alp = torch.clamp((tt - 1.0) / (tt + 1.0), max=alpha)
    mu = torch.zeros_like(frame_mean[:, 0])
    mus = []
    for i in range(t):
        mu = alp[i] * mu + (1.0 - alp[i]) * frame_mean[:, i]
        mus.append(mu)
    return torch.stack(mus, dim=-1)


def forgetting_norm(x: torch.Tensor, sample_length: int = 192) -> torch.Tensor:
    """Divide by an EMA of the frame means. x: [B, C, F, T]."""
    b, c, f, t = x.shape
    xr = x.reshape(b, c * f, t)
    mu = _ema_mu(torch.mean(xr, dim=1), sample_length)  # [B, T]
    return (xr / (mu[:, None, :] + 1e-10)).reshape(b, c, f, t)


def hybrid_norm(x: torch.Tensor, sample_length_in_training: int = 192) -> torch.Tensor:
    """The EMA for the first ``sample_length_in_training`` frames, the
    running mean after. x: [B, F, T]."""
    b, f, t = x.shape
    mu_ema = _ema_mu(torch.mean(x, dim=1), sample_length_in_training)  # [B, T]
    cum_mean = torch.cumsum(torch.sum(x, dim=1), dim=-1) / _entry_count(f, t, x)[None, :]
    early = torch.arange(t, device=x.device)[None, :] < sample_length_in_training
    mu = torch.where(early, mu_ema, cum_mean)
    return x / (mu[:, None, :] + 1e-10)


def laplace_norm_from_stats(v: torch.Tensor, total, count) -> torch.Tensor:
    """Offline Laplace normalisation of ``v`` from statistics computed
    elsewhere: ``total`` the sum over the real elements, ``count`` their
    number, both broadcastable to ``v``."""
    mu = total / count
    return v / (mu + 1e-5)


def gaussian_norm_from_stats(v: torch.Tensor, total, sumsq, count) -> torch.Tensor:
    """Offline Gaussian normalisation of ``v`` from the real elements'
    sum, sum of squares and count: the unbiased variance in its
    count-based form, clamped at 0 against the fp32 cancellation of a
    near-constant input (which would give a NaN std)."""
    mu = total / count
    var = torch.clamp((sumsq - count * torch.square(mu)) / (count - 1.0), min=0.0)
    return (v - mu) / (torch.sqrt(var) + 1e-5)


def masked_offline_norm(norm_fn, valid_total: torch.Tensor):
    """The masked (true-count) form of an offline norm for zero-padded,
    length-bucketed inputs: the statistics cover the real frames only, so
    the normalised real frames equal an unpadded run's. ``valid_total``:
    [b, 1, 1, 1] float true frame counts (b in {1, B}). Returns ``None``
    for a causal norm (cumulative Laplace, cumulative layer, forgetting):
    frame t sees only frames <= t, so zero-padded tails leave the real
    frames untouched."""
    if norm_fn not in (offline_laplace_norm, offline_gaussian_norm):
        return None

    def masked(v: torch.Tensor) -> torch.Tensor:
        # the padded frames are zero, so plain sums are the masked sums;
        # only the count is the true one
        count = math.prod(int(s) for s in v.shape[1:-1]) * valid_total
        dims = tuple(range(1, v.ndim))
        total = torch.sum(v, dim=dims, keepdim=True)
        if norm_fn is offline_laplace_norm:
            return laplace_norm_from_stats(v, total, count)
        sumsq = torch.sum(torch.square(v), dim=dims, keepdim=True)
        return gaussian_norm_from_stats(v, total, sumsq, count)

    return masked


_NORMS = {
    "offline_laplace_norm": offline_laplace_norm,
    "cumulative_laplace_norm": cumulative_laplace_norm,
    "offline_gaussian_norm": offline_gaussian_norm,
    "cumulative_layer_norm": cumulative_layer_norm,
    "forgetting_norm": forgetting_norm,
    "hybrid_norm": hybrid_norm,
}


def norm_wrapper(norm_type: str):
    """String -> normalisation function."""
    try:
        return _NORMS[norm_type]
    except KeyError:
        raise NotImplementedError(
            f"Unknown norm {norm_type!r}. Choose from {sorted(_NORMS)}."
        ) from None
