"""The port's FullSubNet forward and weight bridge against the JAX
package: the same numpy-seeded weights go into fullsubnet_tpu's
FullSubNet as a param pytree and into the port's through
``state_dict_from_jax_params``; the same magnitudes go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.checkpoint import export_fullsubnet, save_torch_checkpoint
from fullsubnet_tpu.models import FullSubNet as JaxFullSubNet
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict, state_dict_from_jax_params
from fullsubnet_tpu_torch.config import build_model
from fullsubnet_tpu_torch.models import FullSubNet

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# the tiny model of tests/test_runtime.py
TINY = dict(
    num_freqs=161, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
    sb_num_neighbors=3, fb_output_activate_function="ReLU",
    sb_output_activate_function=None, fb_model_hidden_size=32,
    sb_model_hidden_size=24, num_groups_in_drop_band=2,
)
# fp32 through two LSTM stages and two norms; only the order of sums differs
ATOL = 1e-5


GATES = {"LSTM": 4, "GRU": 3}


def _sequence_params(rng, f_in, hidden, out_dim, cell):
    b = 1.0 / np.sqrt(hidden)
    gh = GATES[cell] * hidden

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    rnn = []
    in_dim = f_in
    for _ in range(2):
        rnn.append([{"w_ih": u(gh, in_dim), "w_hh": u(gh, hidden), "b_ih": u(gh), "b_hh": u(gh)}])
        in_dim = hidden
    return {"rnn": rnn, "fc": {"weight": u(out_dim, hidden), "bias": u(out_dim)}}


def tiny_params(seed=0, cell="LSTM"):
    """JAX FullSubNet params (numpy leaves) for ``TINY`` with ``cell``."""
    rng = np.random.default_rng(seed)
    unit = 2 * TINY["sb_num_neighbors"] + 1 + 2 * TINY["fb_num_neighbors"] + 1
    return {
        "fb_model": _sequence_params(rng, 161, 32, 161, cell),
        "sb_model": _sequence_params(rng, unit, 24, 2, cell),
    }


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jnp(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("norm_type", ["offline_laplace_norm", "cumulative_laplace_norm"])
@pytest.mark.parametrize("batch", [1, 2])
def test_fullsubnet_forward_matches_jax(norm_type, batch, cell):
    params = tiny_params(batch, cell)
    rng = np.random.default_rng(10 + batch)
    mag = np.abs(rng.standard_normal((batch, 1, 161, 50))).astype(np.float32) * 3
    config = {**TINY, "sequence_model": cell, "norm_type": norm_type}

    want = np.asarray(
        JaxFullSubNet(**config)(_jnp(params), jnp.asarray(mag), dropping_band=False)
    )
    model = FullSubNet(**config)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (batch, 2, 161, 50)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_weight_bridge_matches_export_fullsubnet(cell):
    params = tiny_params(3, cell)
    got = state_dict_from_jax_params(params)
    want = export_fullsubnet(params)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value)
    # the keys and shapes are exactly the port's module parameters
    model = FullSubNet(**{**TINY, "sequence_model": cell})
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in model.state_dict().items()}


@pytest.mark.parametrize("wrap", ["model", "model_state_dict", "module_prefix"])
def test_load_torch_state_dict_unwraps(tmp_path, wrap):
    params = tiny_params(4)
    state = state_dict_from_jax_params(params)
    path = tmp_path / "ckpt.tar"
    if wrap == "model_state_dict":
        save_torch_checkpoint(params, "fullsubnet", path)  # the JAX package's writer
    elif wrap == "model":
        torch.save({"model": state, "epoch": 3}, path)
    else:
        torch.save({f"module.{k}": v for k, v in state.items()}, path)
    loaded = load_torch_state_dict(path)
    model = FullSubNet(**TINY)
    model.load_state_dict(loaded)  # strict: every key present, none extra
    for key, value in state.items():
        assert torch.equal(loaded[key], value)


@pytest.mark.parametrize(
    "path, item",
    [
        ("fullband_baseline.model.Model", "A.9"),
        ("fast_fullsubnet.model.Model", "A.10"),
        ("improved_fullsubnet.model.Model", "A.11"),
        ("subband_baseline.model.Model", "A.12"),
    ],
)
def test_other_families_name_their_roadmap_item(path, item):
    """The families of A.9, A.10, A.11 and A.12 are ported: each builds, and
    its state dict holds the keys and shapes of the JAX package's export of
    the same model (Improved FullSubNet: ``export_improved_fullsubnet``'s)."""
    import jax

    from fullsubnet_tpu.checkpoint import (
        _export_sequence_model,
        export_fast_fullsubnet,
        export_fullband,
        export_improved_fullsubnet,
    )
    from fullsubnet_tpu.config import build_model as jax_build_model

    # the full-band model has no default width; the others build at theirs
    args = {"num_freqs": 161, "hidden_size": 32} if item == "A.9" else {}
    model, _ = build_model({"model": {"path": path, "args": dict(args)}})
    jax_model, _ = jax_build_model({"model": {"path": path, "args": dict(args)}})
    params = jax_model.init(jax.random.PRNGKey(0), weight_init=False)  # the keys, not values
    export = {"A.9": export_fullband, "A.10": export_fast_fullsubnet,
              "A.11": export_improved_fullsubnet,
              "A.12": lambda p: _export_sequence_model(p["sb_model"], "sb_model")}[item](params)
    state = model.state_dict()
    assert sorted(state) == sorted(export)
    for key, value in export.items():
        assert tuple(state[key].shape) == np.shape(value), key


def test_build_model_maps_false_activation_and_pops_weight_init():
    model, init_kwargs = build_model({"model": {"path": "fullsubnet.model.Model", "args": {
        **TINY, "sb_output_activate_function": False, "weight_init": False,
    }}})
    assert isinstance(model, FullSubNet)
    assert model.sb_model.output_activate_function is None
    assert init_kwargs == {"weight_init": False}


@pytest.mark.parametrize("section", ["model", "dataset"])
def test_a_dotted_path_outside_the_registry_builds(tmp_path, section):
    """A class named by its dotted path builds through ``build_model`` and
    ``build_dataset``, as the JAX package's config builds its own; a model
    class that takes a generator is seeded by it, as a registered one is."""
    from fullsubnet_tpu.config import build_dataset as jax_build_dataset
    from fullsubnet_tpu.config import build_model as jax_build_model
    from fullsubnet_tpu_torch.config import build_dataset
    from fullsubnet_tpu_torch.data.datasets import InferenceDataset

    if section == "model":
        args = {**TINY, "weight_init": False}
        model, init_kwargs = build_model(
            {"model": {"path": "fullsubnet_tpu_torch.models.fullsubnet.FullSubNet",
                       "args": args}}, generator=torch.Generator().manual_seed(5))
        jax_model, jax_kwargs = jax_build_model(
            {"model": {"path": "fullsubnet_tpu.models.fullsubnet.FullSubNet", "args": args}})
        assert isinstance(model, FullSubNet) and type(jax_model).__name__ == "FullSubNet"
        assert init_kwargs == jax_kwargs == {"weight_init": False}
        registered, _ = build_model({"model": {"path": "fullsubnet", "args": args}},
                                    generator=torch.Generator().manual_seed(5))
        for key, value in registered.state_dict().items():
            assert torch.equal(model.state_dict()[key], value), key
        linear, _ = build_model({"model": {"path": "torch.nn.Linear",
                                           "args": {"in_features": 3, "out_features": 2}}},
                                generator=torch.Generator())
        assert tuple(linear.weight.shape) == (2, 3)
        return
    (tmp_path / "noisy").mkdir()
    for name in ("b.wav", "a.wav"):
        (tmp_path / "noisy" / name).write_bytes(b"")
    args = {"dataset_dir_list": [str(tmp_path / "noisy")], "sr": 16000}
    got = build_dataset({"path": "fullsubnet_tpu_torch.data.datasets.InferenceDataset",
                         "args": args}, "inference")
    want = jax_build_dataset({"path": "fullsubnet_tpu.data.datasets.InferenceDataset",
                              "args": args}, "inference")
    assert isinstance(got, InferenceDataset)
    assert got.noisy_file_path_list == want.noisy_file_path_list
