"""Loss functions (counterpart of ``fullsubnet_tpu/train/loss.py``)."""

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def si_snr_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative scale-invariant SNR of [..., T] waveforms."""
    if pred.shape != target.shape:
        raise ValueError(
            f"si_snr_loss shape mismatch: pred {tuple(pred.shape)} vs target "
            f"{tuple(target.shape)}"
        )
    pred = pred - torch.mean(pred, dim=-1, keepdim=True)
    target = target - torch.mean(target, dim=-1, keepdim=True)
    s_target = (
        torch.sum(pred * target, dim=-1, keepdim=True)
        * target
        / (torch.sum(torch.square(target), dim=-1, keepdim=True) + eps)
    )
    e_noise = pred - s_target
    ratio = torch.sum(torch.square(s_target), dim=-1) / (
        torch.sum(torch.square(e_noise), dim=-1) + eps
    )
    return -torch.mean(10 * torch.log10(ratio + eps))


LOSS_REGISTRY = {
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
    "si_snr_loss": si_snr_loss,
}
