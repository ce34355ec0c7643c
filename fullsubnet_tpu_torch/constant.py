"""Numeric constants (counterpart of ``fullsubnet_tpu/constant.py``)."""

import numpy as np

EPSILON = float(np.finfo(np.float32).eps)
