"""Feature normalisations (counterpart of ``fullsubnet_tpu/acoustics/norm.py``).

The two Laplace norms the flagship recipes use. The Gaussian, layer,
forgetting and hybrid norms come with ROADMAP A.13.
"""

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
