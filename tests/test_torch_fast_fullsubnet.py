"""The port's Fast FullSubNet against the JAX package on the same weights:
the time down- and up-sampling, the forward (fp32, LSTM and GRU, shrink 2
and 3, with a whole and a partial tail block), ``valid_frames`` against
the JAX model and the unpadded run (the masked statistics at both clocks),
the weight bridge, a train step against the JAX Trainer and the batched
Inferencer. Its encoder and decoder stacks keep the reference's fixed
widths (384, 257, 512, 512); the mel bins and the bottleneck are small."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.checkpoint import export_fast_fullsubnet
from fullsubnet_tpu.models import FastFullSubNet as JaxFastFullSubNet
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.models import FastFullSubNet

from test_torch_baselines import (
    ATOL,
    check_batched_inference,
    check_bridge_round_trip,
    check_train_step,
    jax_forward,
    model_section,
    write_inference_setup,
)
from test_torch_fullsubnet import _jnp

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

FAST = dict(look_ahead=2, shrink_size=2, num_mels=16, encoder_input_size=161,
            bottleneck_hidden_size=24, bottleneck_num_layers=2, noisy_input_num_neighbors=2,
            encoder_output_num_neighbors=0, norm_type="offline_laplace_norm")


def _fast(cell="LSTM", shrink=2, seed=0):
    config = {**FAST, "sequence_model": cell, "shrink_size": shrink}
    model = FastFullSubNet(**config, generator=torch.Generator().manual_seed(seed))
    return config, model, _jnp(jax_params_from_state_dict(model.state_dict()))


@pytest.mark.parametrize("shrink, frames", [(2, 17), (2, 18), (3, 19), (3, 20)])
def test_time_sampling_matches_jax(shrink, frames):
    """Frame 0, block means, the tail block whole (T - 1 divisible by the
    shrink) or partial; then the repeat and cut back."""
    config, model, _ = _fast(shrink=shrink)
    jax_model = JaxFastFullSubNet(**config)
    x = np.random.default_rng(frames).standard_normal((2, 1, 5, frames)).astype(np.float32)
    want = np.asarray(jax_model.real_time_downsampling(jnp.asarray(x)))
    got = model.real_time_downsampling(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 5, -(-(frames - 1) // shrink) + 1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = np.asarray(jax_model.real_time_upsampling(jnp.asarray(want), target_len=frames))
    got = model.real_time_upsampling(torch.from_numpy(got), target_len=frames).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("shrink, frames", [(2, 17), (2, 18), (3, 18)])
def test_fast_fullsubnet_matches_jax(cell, shrink, frames):
    """(frames + 2 look-ahead - 1) % shrink: 0 for (2, 17), 1 for (2, 18),
    1 for (3, 18): both tail branches of the downsampling."""
    config, model, params = _fast(cell, shrink, seed=1)
    mag = np.abs(np.random.default_rng(2).standard_normal((2, 1, 161, frames))).astype(np.float32)
    want = jax_forward(JaxFastFullSubNet(**config), params, mag)
    with torch.inference_mode():
        got = model(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (2, 2, 161, frames)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shrink", [2, 3])
def test_fast_valid_frames_matches_jax_and_the_unpadded_run(shrink):
    """Rows of 30, 19, 14 and 7 real frames zero-padded to 30 (true block
    counts with whole and partial tails at either shrink): against the JAX
    model with the same counts, and each row against its unpadded run."""
    config, model, params = _fast("LSTM", shrink, seed=3)
    counts = np.array([30, 19, 14, 7])
    mag = np.abs(np.random.default_rng(4).standard_normal((4, 1, 161, 30))).astype(np.float32)
    mag *= (np.arange(30) < counts[:, None])[:, None, None, :]
    want = jax_forward(JaxFastFullSubNet(**config), params, mag, valid_frames=counts)
    with torch.inference_mode():
        got = model(torch.from_numpy(mag), valid_frames=torch.from_numpy(counts)).numpy()
        alone = [model(torch.from_numpy(mag[b : b + 1, ..., :n])).numpy()
                 for b, n in enumerate(counts)]
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, ..., :n], want[b, ..., :n], atol=ATOL)
        np.testing.assert_allclose(got[b, ..., :n], alone[b][0], atol=ATOL)


def test_fast_bridge_keys_and_round_trip():
    """The state dict holds the JAX exporter's keys (``mel_scale.fb`` the
    regenerated filterbank) and survives the bridge both ways."""
    _, model, _ = _fast()
    state = check_bridge_round_trip(model)
    export = export_fast_fullsubnet(jax_params_from_state_dict(state), num_freqs=161, num_mels=16)
    assert sorted(export) == sorted(state)
    np.testing.assert_array_equal(export["mel_scale.fb"], state["mel_scale.fb"].numpy())
    assert not hasattr(model.encoder[0], "fc_output_layer")
    assert not hasattr(model.decoder_lstm[0], "fc_output_layer")


@pytest.mark.parametrize("use_amp", [False, True])
def test_train_step_matches_jax_trainer(tmp_path, use_amp):
    """Under the bf16 policy the mel projection promotes to the float32
    filterbank in both packages, so the stacks compute at fp32 there too."""
    check_train_step(tmp_path, model_section("fast_fullsubnet.model.Model",
                                             {**FAST, "sequence_model": "LSTM"}), use_amp)


def test_fast_batched_inferencer_matches_batch_one_and_jax(tmp_path):
    check_batched_inference(write_inference_setup(tmp_path, "fast_fullsubnet",
                                                  {**FAST, "sequence_model": "LSTM"}),
                            batched=True)
