"""Checkpoints (counterpart of ``fullsubnet_tpu/checkpoint.py``).

The port's modules carry the reference state-dict keys, so a reference
``.tar``/``.pth`` loads with ``load_state_dict`` after
:func:`load_torch_state_dict` unwraps it, and weights move between the
port and the JAX package by key mapping alone
(:func:`state_dict_from_jax_params`, :func:`jax_params_from_state_dict`):
both keep the torch layout, with no transposes or gate re-ordering. The
trainer writes its checkpoints in torch format with
:func:`save_checkpoint`.
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


def _sequence_model_params(state: dict, prefix: str) -> dict:
    """State-dict keys under ``prefix`` -> a unidirectional JAX
    ``SequenceModel`` param pytree with numpy float32 leaves."""
    def leaf(key):
        return state[key].detach().cpu().numpy().astype(np.float32)

    rnn = []
    layer = 0
    while f"{prefix}.sequence_model.weight_ih_l{layer}" in state:
        rnn.append([{
            name: leaf(f"{prefix}.sequence_model.{kind}_{name[2:]}_l{layer}")
            for name, kind in (("w_ih", "weight"), ("w_hh", "weight"),
                               ("b_ih", "bias"), ("b_hh", "bias"))
        }])
        layer += 1
    params = {"rnn": rnn}
    if f"{prefix}.fc_output_layer.weight" in state:
        params["fc"] = {
            "weight": leaf(f"{prefix}.fc_output_layer.weight"),
            "bias": leaf(f"{prefix}.fc_output_layer.bias"),
        }
    return params


def jax_params_from_state_dict(state: dict) -> dict:
    """The inverse of :func:`state_dict_from_jax_params`: the port's
    ``FullSubNet`` state dict -> the JAX package's FullSubNet params
    (numpy leaves), so the JAX package can start from the port's
    weights."""
    return {
        "fb_model": _sequence_model_params(state, "fb_model"),
        "sb_model": _sequence_model_params(state, "sb_model"),
    }


def save_checkpoint(path: str | os.PathLike, blob: dict) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename it
    into place, so a reader never sees a half-written checkpoint."""
    path = os.fspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
