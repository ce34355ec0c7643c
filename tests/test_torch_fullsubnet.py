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

# the tiny model of tests/test_runtime.py
TINY = dict(
    num_freqs=161, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
    sb_num_neighbors=3, fb_output_activate_function="ReLU",
    sb_output_activate_function=None, fb_model_hidden_size=32,
    sb_model_hidden_size=24, num_groups_in_drop_band=2,
)
# fp32 through two LSTM stages and two norms; only the order of sums differs
ATOL = 1e-5


def _sequence_params(rng, f_in, hidden, out_dim):
    b = 1.0 / np.sqrt(hidden)

    def u(*shape):
        return rng.uniform(-b, b, shape).astype(np.float32)

    rnn = []
    in_dim = f_in
    for _ in range(2):
        rnn.append([{
            "w_ih": u(4 * hidden, in_dim), "w_hh": u(4 * hidden, hidden),
            "b_ih": u(4 * hidden), "b_hh": u(4 * hidden),
        }])
        in_dim = hidden
    return {"rnn": rnn, "fc": {"weight": u(out_dim, hidden), "bias": u(out_dim)}}


def tiny_params(seed=0):
    """JAX FullSubNet params (numpy leaves) for ``TINY``."""
    rng = np.random.default_rng(seed)
    unit = 2 * TINY["sb_num_neighbors"] + 1 + 2 * TINY["fb_num_neighbors"] + 1
    return {
        "fb_model": _sequence_params(rng, 161, 32, 161),
        "sb_model": _sequence_params(rng, unit, 24, 2),
    }


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jnp(v) for v in tree]
    return jnp.asarray(tree)


@pytest.mark.parametrize("norm_type", ["offline_laplace_norm", "cumulative_laplace_norm"])
@pytest.mark.parametrize("batch", [1, 2])
def test_fullsubnet_forward_matches_jax(norm_type, batch):
    params = tiny_params(batch)
    rng = np.random.default_rng(10 + batch)
    mag = np.abs(rng.standard_normal((batch, 1, 161, 50))).astype(np.float32) * 3

    want = np.asarray(
        JaxFullSubNet(**TINY, norm_type=norm_type)(_jnp(params), jnp.asarray(mag), dropping_band=False)
    )
    model = FullSubNet(**TINY, norm_type=norm_type)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (batch, 2, 161, 50)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_weight_bridge_matches_export_fullsubnet():
    params = tiny_params(3)
    got = state_dict_from_jax_params(params)
    want = export_fullsubnet(params)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value)
    # the keys are exactly the port's module parameters
    assert sorted(got) == sorted(FullSubNet(**TINY).state_dict())


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
    with pytest.raises(NotImplementedError, match=item):
        build_model({"model": {"path": path, "args": {}}})


def test_build_model_maps_false_activation_and_pops_weight_init():
    model, init_kwargs = build_model({"model": {"path": "fullsubnet.model.Model", "args": {
        **TINY, "sb_output_activate_function": False, "weight_init": False,
    }}})
    assert isinstance(model, FullSubNet)
    assert model.sb_model.output_activate_function is None
    assert init_kwargs == {"weight_init": False}
