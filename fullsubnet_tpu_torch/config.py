"""TOML config layer (counterpart of ``fullsubnet_tpu/config.py``).

Same schema and the same model and dataset names as the JAX package; the
registry holds what is ported so far. Other model families raise and
name the ROADMAP item that ports them.
"""

from __future__ import annotations

import os
import tomllib
from typing import Any


def load_config(path: str | os.PathLike) -> dict:
    with open(os.fspath(path), "rb") as f:
        return tomllib.load(f)


def _models():
    from fullsubnet_tpu_torch.models import FullSubNet

    return {
        "fullsubnet": FullSubNet,
        "fullsubnet.model.Model": FullSubNet,
        "model.Model": FullSubNet,
    }


_MODELS_NOT_PORTED = {
    "fullband_baseline": "A.9",
    "fullband_baseline.model.Model": "A.9",
    "fast_fullsubnet": "A.10",
    "fast_fullsubnet.model.Model": "A.10",
    "improved_fullsubnet": "A.11",
    "improved_fullsubnet.model.Model": "A.11",
    "subband_baseline": "A.12",
    "subband_baseline.model.Model": "A.12",
}


def build_model(config: dict):
    """config["model"] = {path|name, args}. Returns (model, init_kwargs)."""
    section = config["model"]
    path = section.get("path", section.get("name"))
    args = dict(section.get("args", {}))
    weight_init = bool(args.pop("weight_init", True))
    # TOML has no null; the reference uses `false` for "no activation"
    for k, v in list(args.items()):
        if v is False and k.endswith("activate_function"):
            args[k] = None
    registry = _models()
    if path in registry:
        return registry[path](**args), {"weight_init": weight_init}
    if path in _MODELS_NOT_PORTED:
        raise NotImplementedError(
            f"model {path!r} is not ported yet (ROADMAP {_MODELS_NOT_PORTED[path]})"
        )
    raise NotImplementedError(f"unknown model path {path!r}")


def build_dataset(section: dict, kind: str):
    from fullsubnet_tpu_torch.data.datasets import InferenceDataset

    path = section.get("path", kind)
    if path not in ("inference", "dataset_inference.Dataset"):
        raise NotImplementedError(
            f"dataset {path!r} is not ported yet (training data: ROADMAP A.7)"
        )
    return InferenceDataset(**dict(section.get("args", {})))


DEFAULT_ACOUSTICS = {"n_fft": 512, "hop_length": 256, "win_length": 512, "sr": 16000}


def acoustics_args(config: dict) -> dict[str, Any]:
    a = {**DEFAULT_ACOUSTICS, **config.get("acoustics", {})}
    return {
        "n_fft": a["n_fft"],
        "hop_length": a["hop_length"],
        "win_length": a["win_length"],
        "sr": a.get("sr", 16000),
    }
