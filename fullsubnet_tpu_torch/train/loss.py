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


def masked_waveform_loss(loss_fn, pred, target, valid_mask, true_count):
    """The unpadded run's waveform loss from zero-padded, length-bucketed
    signals: ``pred``/``target`` [..., T_bucket] with the pads zero,
    ``valid_mask`` a 0/1 mask broadcastable over the last axis,
    ``true_count`` the number of real samples. mse and l1 rescale their
    mean to the true count; si_snr centres with the masked means and masks
    again, after which every inner product is the unpadded run's. Returns
    None for a loss with no exact masked form."""
    t_pad = pred.shape[-1]
    count = torch.as_tensor(true_count, dtype=torch.float32, device=pred.device)
    if loss_fn is mse_loss or loss_fn is l1_loss:
        return loss_fn(pred * valid_mask, target * valid_mask) * (t_pad / count)
    if loss_fn is si_snr_loss:
        eps = 1e-8
        mu_p = torch.sum(pred * valid_mask, dim=-1, keepdim=True) / count
        mu_t = torch.sum(target * valid_mask, dim=-1, keepdim=True) / count
        p = (pred - mu_p) * valid_mask
        t = (target - mu_t) * valid_mask
        s_target = (
            torch.sum(p * t, dim=-1, keepdim=True)
            * t
            / (torch.sum(torch.square(t), dim=-1, keepdim=True) + eps)
        )
        e_noise = p - s_target
        ratio = torch.sum(torch.square(s_target), dim=-1) / (
            torch.sum(torch.square(e_noise), dim=-1) + eps
        )
        return -torch.mean(10 * torch.log10(ratio + eps))
    return None


# the losses with an exact masked (zero-padded bucket) form above
MASKED_WAVEFORM_LOSSES = (mse_loss, l1_loss, si_snr_loss)


LOSS_REGISTRY = {
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
    "si_snr_loss": si_snr_loss,
}
