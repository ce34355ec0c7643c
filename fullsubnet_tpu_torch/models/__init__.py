"""Models of the FullSubNet family ported so far: the flagship FullSubNet,
the full-band and sub-band baselines and Fast FullSubNet."""

from fullsubnet_tpu_torch.models.fast_fullsubnet import FastFullSubNet
from fullsubnet_tpu_torch.models.fullband import FullBandModel
from fullsubnet_tpu_torch.models.fullsubnet import FullSubNet
from fullsubnet_tpu_torch.models.subband_baseline import SubBandBaseline

__all__ = ["FastFullSubNet", "FullBandModel", "FullSubNet", "SubBandBaseline"]
