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


# the stacks of each family by the tops of its param tree and its state-dict
# keys: (state-dict prefix, path into the tree); Improved FullSubNet's
# sections are counted from the tree or the keys (``_stacks``)
_FAMILY_STACKS = {
    "fullsubnet": (("fb_model", ("fb_model",)), ("sb_model", ("sb_model",))),
    "fullband_baseline": (("fullband_model", ("fullband_model",)),),
    "subband_baseline": (("sb_model", ("sb_model",)),),
    "fast_fullsubnet": (
        ("encoder.0", ("encoder", 0)), ("encoder.1", ("encoder", 1)),
        ("bottleneck", ("bottleneck",)),
        ("decoder_lstm.0", ("decoder_lstm", 0)), ("decoder_lstm.1", ("decoder_lstm", 1)),
    ),
}
_SECTIONS = "sb_model.sb_models."


def _stacks(family: str, sections: int) -> tuple:
    if family == "improved_fullsubnet":
        return (("fb_model", ("fb_model",)),) + tuple(
            (f"{_SECTIONS}{i}", ("sb_model", "sb_models", i)) for i in range(sections))
    return _FAMILY_STACKS[family]


def _family_of(tops, sections: bool) -> str:
    """The model family of a param tree's top keys or of a state dict's key
    prefixes (Fast FullSubNet's ``mel_scale`` buffer aside). Improved
    FullSubNet has the flagship's tops: its ``sb_model`` holds ``sections``
    (``sb_models``) where the flagship's holds one stack."""
    tops = set(tops) - {"mel_scale"}
    if sections and tops == {"fb_model", "sb_model"}:
        return "improved_fullsubnet"
    for family, stacks in _FAMILY_STACKS.items():
        if tops == {path[0] for _, path in stacks}:
            return family
    raise ValueError(f"no model family has the parameters {sorted(tops)}")


def state_dict_from_jax_params(params: dict, family: str | None = None,
                               sample_rate: int = 16000) -> dict[str, torch.Tensor]:
    """The weight bridge: the JAX package's params of a model (leaves as
    numpy arrays) -> the port's state dict of that model, with the keys
    and values of ``fullsubnet_tpu.checkpoint``'s exporter for its family
    (``export_fullsubnet``, ``export_fullband``, ``export_fast_fullsubnet``,
    ``export_improved_fullsubnet``; ``sb_model.*`` for the sub-band
    baseline). ``family`` (a registry name without ``.model.Model``)
    defaults to the one the tree names. Fast FullSubNet's ``mel_scale.fb``
    is the mel filterbank at ``sample_rate``, derived and not learned, as
    the JAX exporter regenerates it."""
    sections = params.get("sb_model", {}).get("sb_models", ())
    family = family or _family_of(params, bool(sections))
    out: dict[str, torch.Tensor] = {}
    for prefix, path in _stacks(family, len(sections)):
        node = params
        for step in path:
            node = node[step]
        out.update(_sequence_model_state(node, prefix))
    if family == "fast_fullsubnet":
        from fullsubnet_tpu_torch.acoustics.filterbank import mel_filterbank

        num_mels = np.shape(params["encoder"][0]["rnn"][0][0]["w_ih"])[1]
        num_freqs = np.shape(params["decoder_lstm"][1]["fc"]["weight"])[0] // 2
        out["mel_scale.fb"] = torch.from_numpy(
            mel_filterbank(num_freqs, num_mels, sample_rate, 0.0, sample_rate / 2))
    return out


# the JAX conv blocks' BatchNorm leaves -> the port's ``bn`` keys
_BN_KEYS = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
            "bn_var": "bn.running_var"}


def conv_state_from_jax_params(params) -> dict[str, torch.Tensor]:
    """The weight bridge of ``nn/conv.py``: the JAX package's parameters of
    a ``TemporalConvNet`` (a list of blocks), or of one causal conv or
    transposed-conv block (a dict), leaves as numpy arrays -> the state
    dict of the port's module."""
    if isinstance(params, (list, tuple)):  # the TCN's blocks
        return {f"blocks.{i}.{conv}.{leaf}": _tensor(v)
                for i, block in enumerate(params) for conv, leaves in block.items()
                for leaf, v in leaves.items()}
    out = {_BN_KEYS.get(k, f"conv.{k}"): _tensor(v) for k, v in params.items()}
    out["bn.num_batches_tracked"] = torch.tensor(0)
    return out


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


def jax_params_from_state_dict(state: dict, family: str | None = None) -> dict:
    """The inverse of :func:`state_dict_from_jax_params`: the port's state
    dict of a model -> the JAX package's params of that model (numpy
    leaves), so the JAX package can start from the port's weights.
    ``family`` defaults to the one the keys name; Fast FullSubNet's derived
    ``mel_scale.fb`` is left out, as the JAX model builds its own."""
    sections = {int(k[len(_SECTIONS):].split(".")[0]) for k in state if k.startswith(_SECTIONS)}
    family = family or _family_of({k.split(".")[0] for k in state}, bool(sections))
    params: dict = {}
    for prefix, path in _stacks(family, len(sections)):
        node = params
        for step, nxt in zip(path[:-1], path[1:]):
            node = node.setdefault(step, [] if isinstance(nxt, int) else {})
        stack = _sequence_model_params(state, prefix)
        if isinstance(path[-1], int):
            node.append(stack)  # listed in index order
        else:
            node[path[-1]] = stack
    return params


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
