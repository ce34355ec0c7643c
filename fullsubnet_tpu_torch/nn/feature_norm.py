"""Cumulative magnitude-spectral normalisation (counterpart of
``fullsubnet_tpu/nn/feature_norm.py``): ``cumulative_norm`` is the running
zero-norm of ``acoustics.norm.cumulative_layer_norm`` with eps 1e-10;
``cumulative_mag_spectral_norm`` divides by a running or global mean,
optionally of the middle frequency bin only."""

import torch


def cumulative_norm(x: torch.Tensor) -> torch.Tensor:
    """Running zero-norm over [B, C, F, T]."""
    eps = 1e-10
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    cumulative_sum = torch.cumsum(torch.sum(xr, dim=1), dim=-1)
    cumulative_pow_sum = torch.cumsum(torch.sum(torch.square(xr), dim=1), dim=-1)
    entry_count = torch.arange(f, f * t + 1, f, dtype=x.dtype, device=x.device)[None, :]
    cum_mean = cumulative_sum / entry_count
    cum_var = (cumulative_pow_sum - 2 * cum_mean * cumulative_sum) / entry_count + torch.square(cum_mean)
    cum_std = torch.sqrt(cum_var + eps)
    out = (xr - cum_mean[:, None, :]) / cum_std[:, None, :]
    return out.reshape(b, c, f, t)


def cumulative_mag_spectral_norm(
    x: torch.Tensor,
    cumulative: bool = False,
    use_mid_freq_mu: bool = False,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Divide [B, C, F, T] by a (running | global) mean of (the bin
    F // 2 - 1 | all bins)."""
    if x.ndim != 4:
        raise ValueError("cumulative_mag_spectral_norm only supports 4D input.")
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    step = xr[:, int(f // 2 - 1), :] if use_mid_freq_mu else torch.mean(xr, dim=1)
    if cumulative:
        counts = torch.arange(1, t + 1, dtype=x.dtype, device=x.device)[None, :]
        mu = (torch.cumsum(step, dim=-1) / counts)[:, None, :]  # [B*C, 1, T]
    else:
        mu = torch.mean(step, dim=-1)[:, None, None]  # [B*C, 1, 1]
    return (xr / (mu + eps)).reshape(b, c, f, t)
