"""Offline tools of the port: ``python -m fullsubnet_tpu_torch.tools.<name>``."""
