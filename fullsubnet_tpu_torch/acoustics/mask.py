"""Complex Ideal Ratio Mask (cIRM) ops (counterpart of
``fullsubnet_tpu/acoustics/mask.py``): tanh compression with K=10,
C=0.1; decompression clamped at ``limit=9.9``."""

import torch

from fullsubnet_tpu_torch.constant import EPSILON


def build_complex_ideal_ratio_mask(
    noisy_real: torch.Tensor,
    noisy_imag: torch.Tensor,
    clean_real: torch.Tensor,
    clean_imag: torch.Tensor,
) -> torch.Tensor:
    """Compressed cIRM from noisy/clean STFTs; [..., F, T] -> [..., F, T, 2]."""
    denominator = torch.square(noisy_real) + torch.square(noisy_imag) + EPSILON
    mask_real = (noisy_real * clean_real + noisy_imag * clean_imag) / denominator
    mask_imag = (noisy_real * clean_imag - noisy_imag * clean_real) / denominator
    complex_ratio_mask = torch.stack((mask_real, mask_imag), dim=-1)
    return compress_cIRM(complex_ratio_mask, K=10.0, C=0.1)


def compress_cIRM(mask: torch.Tensor, K: float = 10.0, C: float = 0.1) -> torch.Tensor:
    """Compress cIRM values from (-inf, +inf) into (-K, K)."""
    mask = torch.clamp(mask, min=-100.0)
    return K * (1.0 - torch.exp(-C * mask)) / (1.0 + torch.exp(-C * mask))


def decompress_cIRM(
    mask: torch.Tensor, K: float = 10.0, limit: float = 9.9
) -> torch.Tensor:
    """Decompress cIRM from (-K, K) back to (-inf, +inf), clamped at ±limit."""
    mask = torch.clamp(mask, -limit, limit)
    return -K * torch.log((K - mask) / (K + mask))


def complex_mul(noisy_r, noisy_i, mask_r, mask_i):
    """(noisy_r + j noisy_i) * (mask_r + j mask_i) -> (real, imag)."""
    r = noisy_r * mask_r - noisy_i * mask_i
    i = noisy_r * mask_i + noisy_i * mask_r
    return r, i
