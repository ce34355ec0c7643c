"""Small utilities (counterpart of ``fullsubnet_tpu/utils.py``)."""

from __future__ import annotations

import importlib
import os
import time
from pathlib import Path

import numpy as np
import torch


class ExecutionTime:
    """Wall-clock timer: ``t = ExecutionTime(); ...; t.duration()`` seconds."""

    def __init__(self):
        self.start = time.time()

    def duration(self) -> float:
        return time.time() - self.start


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


def _leaves(tree, path: str = ""):
    """(key path, leaf) of a nested dict, list or tuple, in the JAX
    package's pytree order (a dict's keys sorted) and written as its
    ``keystr`` writes them (``['a'][0]``)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def check_nan(tree, name: str = "tree") -> bool:
    """True (and print where) if any tensor or array of ``tree`` (a state
    dict, or a nested dict, list or tuple) holds a NaN."""
    bad = False
    for path, leaf in _leaves(tree):
        if np.any(np.isnan(_host(leaf))):
            print(f"NaN in {name}{path}")
            bad = True
    return bad


def initialize_module(path: str, args: dict | None = None, initialize: bool = True):
    """The class (or function) at a dotted path, called with ``args`` unless
    ``initialize`` is false: the reference's config mechanism
    (``audio_zen/utils.py:70-105``), so that a TOML can name a class outside
    :mod:`fullsubnet_tpu_torch.config`'s registry."""
    module_path, _, class_name = path.rpartition(".")
    cls = getattr(importlib.import_module(module_path), class_name)
    if initialize:
        return cls(**(args or {}))
    return cls


def print_tensor_info(tensor, flag: str = "Tensor") -> None:
    t = _host(tensor)
    print(f"{flag}\tmax: {t.max():.3e}, min: {t.min():.3e}, "
          f"mean: {t.mean():.3e}, std: {t.std():.3e}")
