"""Small utilities (counterpart of ``fullsubnet_tpu/utils.py``)."""

from __future__ import annotations

import os
from pathlib import Path

import torch


def expand_path(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def basename(path: str):
    return os.path.splitext(os.path.basename(path))


def prepare_empty_dir(dirs: list[Path]):
    """Create a list of directories (existing ones are kept)."""
    for dir_path in dirs:
        dir_path.mkdir(parents=True, exist_ok=True)


def resolve_device(name: str | torch.device) -> torch.device:
    """``name`` -> a device that exists. A CUDA device without a card
    raises: the port never runs a CUDA request on the CPU instead."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch finds no CUDA "
            "card; pass --device cpu to run the plain CPU path"
        )
    return device
