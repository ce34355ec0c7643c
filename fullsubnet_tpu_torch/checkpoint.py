"""Checkpoint interop (counterpart of the interop half of
``fullsubnet_tpu/checkpoint.py``).

The port's modules carry the reference state-dict keys, so a reference
``.tar``/``.pth`` loads with ``load_state_dict`` after
:func:`load_torch_state_dict` unwraps it, and weights move from the JAX
package by key mapping alone (:func:`state_dict_from_jax_params`): both
keep the torch layout, with no transposes or gate re-ordering.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_torch_state_dict(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Load a reference checkpoint (.tar or .pth) into a flat dict of CPU
    tensors: unwraps ``model`` / ``model_state_dict`` and strips DDP
    ``module.`` prefixes. The file is unpickled, as the reference's
    loader does: load only checkpoints from a trusted source."""
    blob = torch.load(os.fspath(path), map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob:
        state = blob["model"]
    elif isinstance(blob, dict) and "model_state_dict" in blob:
        state = blob["model_state_dict"]
    else:
        state = blob
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module.") :]
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return out


def _sequence_model_state(params: dict, prefix: str) -> dict[str, torch.Tensor]:
    """A JAX ``SequenceModel`` param pytree -> state-dict keys under
    ``prefix`` (the mapping of ``fullsubnet_tpu.checkpoint._export_sequence_model``)."""
    out: dict[str, torch.Tensor] = {}
    for li, dirs in enumerate(params["rnn"]):
        for di, layer in enumerate(dirs):
            suffix = f"l{li}" + ("_reverse" if di == 1 else "")
            for name, v in layer.items():
                kind = "weight" if name.startswith("w_") else "bias"
                gate = name[2:]  # ih | hh
                out[f"{prefix}.sequence_model.{kind}_{gate}_{suffix}"] = _tensor(v)
    if "fc" in params:
        out[f"{prefix}.fc_output_layer.weight"] = _tensor(params["fc"]["weight"])
        out[f"{prefix}.fc_output_layer.bias"] = _tensor(params["fc"]["bias"])
    if "prelu" in params:
        out[f"{prefix}.activate_function.weight"] = _tensor(params["prelu"])
    return out


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def state_dict_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    """The weight bridge: the JAX package's FullSubNet params (leaves as
    numpy arrays) -> the port's ``FullSubNet`` state dict. Same keys and
    values as ``fullsubnet_tpu.checkpoint.export_fullsubnet``."""
    return {
        **_sequence_model_state(params["fb_model"], "fb_model"),
        **_sequence_model_state(params["sb_model"], "sb_model"),
    }
