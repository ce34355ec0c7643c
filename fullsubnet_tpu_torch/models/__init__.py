"""Models of the FullSubNet family ported so far: the flagship FullSubNet."""

from fullsubnet_tpu_torch.models.fullsubnet import FullSubNet

__all__ = ["FullSubNet"]
