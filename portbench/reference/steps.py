"""The recipes' training step and offline enhancement in plain PyTorch.

``train_steps`` is the published trainer's step (``audio_zen`` /
FullSubNet ``trainer.py``): STFT of both signals, the compressed cIRM
target, drop_band of the target and of the sub-band input when the batch
has more rows than groups, the model, the MSE loss; then global-norm
clipping and Adam, both written out here. ``enhance`` is the inferencer's
``full_band_crm_mask``: STFT, magnitude, model, cIRM decompression, the
complex mask and the iSTFT at the clip's length.
"""

from __future__ import annotations

import torch

from portbench.reference import dsp, models
from portbench.reference.precision import cast, strict_fp32


def _loss(family, w, args, acoustics, noisy, clean, precision):
    n_fft, hop, win = acoustics["n_fft"], acoustics["hop_length"], acoustics["win_length"]
    trained = models.weight_shapes(family, args)
    w = {k: cast(v, precision.get("cast")) if k in trained else v for k, v in w.items()}
    spec_n = dsp.stft(noisy, n_fft, hop, win)
    cirm = dsp.compressed_cirm(spec_n, dsp.stft(clean, n_fft, hop, win))  # [B, F, T, 2]
    groups = models.drop_groups(family, args, noisy.shape[0])
    if groups > 1:
        cirm = dsp.drop_band(cirm.permute(0, 3, 1, 2), groups).permute(0, 2, 3, 1)
    mag = cast(spec_n.abs()[:, None], precision.get("cast"))
    crm = models.forward(family, w, args, mag, groups > 1, precision["products"])
    return torch.mean(torch.square(crm.permute(0, 2, 3, 1) - cirm))


def train_steps(family: str, args: dict, acoustics: dict, weights: dict, batches, *,
                lr: float, betas: tuple[float, float], clip: float, precision: dict,
                eps: float = 1e-8, half_batch: bool = False) -> dict:
    """Adam steps from ``weights`` (float32 masters; buffers pass through),
    one for each (noisy, clean) pair of ``batches``, in ``precision``
    (``reference.precision``). Returns each step's
    ``losses``, ``grad1`` (each leaf's norm of the first step's gradient
    after clipping, as Adam gets it) and ``change`` (each leaf's norm of
    its change over all the steps). ``half_batch`` is a planted fault: each
    step's loss over the first half of its rows only."""
    trained = set(models.weight_shapes(family, args))
    params = {k: v.detach().clone().float().requires_grad_(k in trained) for k, v in weights.items()}
    leaves = [k for k in params if k in trained]
    start = {k: params[k].detach().clone() for k in leaves}
    m = {k: torch.zeros_like(start[k]) for k in leaves}
    v = {k: torch.zeros_like(start[k]) for k in leaves}
    losses, grad1 = [], None
    with strict_fp32():
        for step, (noisy, clean) in enumerate(batches, 1):
            if half_batch:
                noisy, clean = noisy[: len(noisy) // 2], clean[: len(clean) // 2]
            loss = _loss(family, params, args, acoustics, noisy, clean, precision)
            grads = torch.autograd.grad(loss, [params[k] for k in leaves])
            total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = (clip / (total + 1e-6)).clamp(max=1.0) if clip else 1.0
            grads = [g * scale for g in grads]
            if step == 1:
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(leaves, grads)}
            bc1, bc2 = 1 - betas[0] ** step, 1 - betas[1] ** step
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                    v[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                    denom = v[k].sqrt() / bc2**0.5 + eps
                    params[k].addcdiv_(m[k], denom, value=-lr / bc1)
            losses.append(float(loss.detach()))
            del loss, grads
    change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k])) for k in leaves}
    return {"losses": losses, "grad1": grad1, "change": change}


@torch.no_grad()
def enhance(family: str, args: dict, acoustics: dict, weights: dict, waves: torch.Tensor,
            precision: dict, block: int = 32) -> torch.Tensor:
    """waves [B, L] (one length) -> enhanced [B, L] in ``precision``,
    ``block`` rows at a time."""
    n_fft, hop, win = acoustics["n_fft"], acoustics["hop_length"], acoustics["win_length"]
    outs = []
    with strict_fp32():
        for rows in torch.split(waves, block):
            spec = dsp.stft(rows, n_fft, hop, win)
            mag = cast(spec.abs()[:, None], precision.get("cast"))
            crm = models.forward(family, weights, args, mag, False, precision["products"])
            crm = dsp.decompress_cirm(crm.permute(0, 2, 3, 1))
            real = spec.real * crm[..., 0] - spec.imag * crm[..., 1]
            imag = spec.real * crm[..., 1] + spec.imag * crm[..., 0]
            outs.append(dsp.istft(torch.complex(real, imag), n_fft, hop, win, rows.shape[-1]))
    return torch.cat(outs)
