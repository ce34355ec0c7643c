"""Models of the FullSubNet family: the flagship FullSubNet, the full-band
and sub-band baselines, Fast FullSubNet and Improved FullSubNet."""

from fullsubnet_tpu_torch.models.fast_fullsubnet import FastFullSubNet
from fullsubnet_tpu_torch.models.fullband import FullBandModel
from fullsubnet_tpu_torch.models.fullsubnet import FullSubNet
from fullsubnet_tpu_torch.models.improved_fullsubnet import ImprovedFullSubNet
from fullsubnet_tpu_torch.models.subband_baseline import SubBandBaseline

__all__ = ["FastFullSubNet", "FullBandModel", "FullSubNet", "ImprovedFullSubNet",
           "SubBandBaseline", "is_wave_to_wave"]


def is_wave_to_wave(model) -> bool:
    """Whether ``model`` maps the noisy waveform [B, S] to the enhanced one
    [B, 1, S] and takes ``valid_samples`` (Improved FullSubNet), rather
    than a magnitude [B, 1, F, T] to a cRM: the Trainer's step and
    validation, and the Inferencer's strategies, follow it."""
    return getattr(model, "wave_to_wave", False)
