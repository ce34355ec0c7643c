"""TOML config layer (counterpart of ``fullsubnet_tpu/config.py``).

Same schema and the same model, dataset, loss and optimizer names as
the JAX package; the registry holds every family of it: FullSubNet, the
full-band and sub-band baselines, Fast FullSubNet and Improved FullSubNet.
A model or dataset ``path`` outside the registry is a dotted path to a
class, built by ``utils.initialize_module`` as in the JAX package.
"""

from __future__ import annotations

import inspect
import os
import tomllib
from typing import Any

from fullsubnet_tpu_torch.utils import initialize_module


def load_config(path: str | os.PathLike) -> dict:
    with open(os.fspath(path), "rb") as f:
        return tomllib.load(f)


def _models():
    from fullsubnet_tpu_torch.models import (
        FastFullSubNet,
        FullBandModel,
        FullSubNet,
        ImprovedFullSubNet,
        SubBandBaseline,
    )

    return {
        "fullsubnet": FullSubNet,
        "fullsubnet.model.Model": FullSubNet,
        "model.Model": FullSubNet,
        "fullband_baseline": FullBandModel,
        "fullband_baseline.model.Model": FullBandModel,
        "fast_fullsubnet": FastFullSubNet,
        "fast_fullsubnet.model.Model": FastFullSubNet,
        "subband_baseline": SubBandBaseline,
        "subband_baseline.model.Model": SubBandBaseline,
        "improved_fullsubnet": ImprovedFullSubNet,
        "improved_fullsubnet.model.Model": ImprovedFullSubNet,
    }


def build_model(config: dict, generator=None):
    """config["model"] = {path|name, args}. Returns (model, init_kwargs).
    ``generator`` (a ``torch.Generator``) seeds the random initial
    weights of a class that takes one (every registered family); the
    model's default seed 0 without it."""
    section = config["model"]
    path = section.get("path", section.get("name"))
    args = dict(section.get("args", {}))
    weight_init = bool(args.pop("weight_init", True))
    # TOML has no null; the reference uses `false` for "no activation"
    for k, v in list(args.items()):
        if v is False and k.endswith("activate_function"):
            args[k] = None
    registry = _models()
    cls = registry[path] if path in registry else initialize_module(path, initialize=False)
    if "generator" in inspect.signature(cls).parameters:
        args["generator"] = generator
    return cls(**args), {"weight_init": weight_init}


_DATASETS = {
    "inference": "inference",
    "dataset_inference.Dataset": "inference",
    "train": "train",
    "dataset_train.Dataset": "train",
    "validation": "validation",
    "dataset_validation.Dataset": "validation",
}


def build_dataset(section: dict, kind: str):
    from fullsubnet_tpu_torch.data import datasets

    path = section.get("path", kind)
    if path not in _DATASETS:
        return initialize_module(path, dict(section.get("args", {})))
    cls = {
        "inference": datasets.InferenceDataset,
        "train": datasets.TrainDataset,
        "validation": datasets.ValidationDataset,
    }[_DATASETS[path]]
    return cls(**dict(section.get("args", {})))


def build_loss(config: dict):
    """The ``[loss_function]`` section -> a loss function of (pred, target)."""
    from fullsubnet_tpu_torch.train.loss import LOSS_REGISTRY

    name = config["loss_function"]["name"]
    args = config["loss_function"].get("args", {}) or {}
    fn = LOSS_REGISTRY[name]
    if args:
        import functools

        fn = functools.partial(fn, **args)
    return fn


def build_optimizer(config: dict, params):
    """The ``[optimizer]`` section -> Adam over ``params``. Clipping
    (``[trainer.train] clip_grad_norm_value``) is the trainer's, before
    each step, as optax chains it before Adam in the JAX package."""
    import torch

    section = config["optimizer"]
    lr = section.get("lr", 1e-3)
    betas = (section.get("beta1", 0.9), section.get("beta2", 0.999))
    return torch.optim.Adam(params, lr=lr, betas=betas)


def experiment_name_from_config_path(config_path: str) -> str:
    return os.path.splitext(os.path.basename(config_path))[0]


DEFAULT_ACOUSTICS = {"n_fft": 512, "hop_length": 256, "win_length": 512, "sr": 16000}


def acoustics_args(config: dict) -> dict[str, Any]:
    a = {**DEFAULT_ACOUSTICS, **config.get("acoustics", {})}
    return {
        "n_fft": a["n_fft"],
        "hop_length": a["hop_length"],
        "win_length": a["win_length"],
        "sr": a.get("sr", 16000),
    }
