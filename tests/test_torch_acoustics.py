"""The port's acoustics (fullsubnet_tpu_torch.acoustics) against their
JAX twins in fullsubnet_tpu.acoustics, on the same numpy inputs, fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics import feature as jax_feature
from fullsubnet_tpu.acoustics import mask as jax_mask
from fullsubnet_tpu.acoustics import norm as jax_norm
from fullsubnet_tpu.acoustics.stft import istft as jax_istft
from fullsubnet_tpu.acoustics.stft import stft_complex as jax_stft_complex
from fullsubnet_tpu_torch.acoustics import feature, mask, norm, stft

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)


def _wave(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


@pytest.mark.parametrize("n_fft, hop, win", [(512, 256, 512), (320, 160, 320), (512, 128, 400)])
def test_stft_complex_matches_jax(n_fft, hop, win):
    y = _wave(0, (2, 4001))
    want = np.asarray(jax_stft_complex(jnp.asarray(y), n_fft, hop, win))
    got = stft.stft_complex(torch.from_numpy(y), n_fft, hop, win).numpy()
    assert got.shape == want.shape
    # fp32 FFTs of different libraries: bins reach ~50, so 1e-4 absolute
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert want.shape[-1] == stft.num_stft_frames(4001, hop, n_fft)


@pytest.mark.parametrize("length_delta", [0, -300, 137])
@pytest.mark.parametrize("input_type", ["real_imag", "complex", "mag_phase"])
def test_istft_with_length_matches_jax(length_delta, input_type):
    """``length=`` keeps samples [n_fft//2 : n_fft//2 + length], padding
    with zeros past the signal (docs/parity.md, "Preserved exactly")."""
    n_fft, hop, win, n = 512, 256, 512, 8000
    y = _wave(1, (2, n))
    spec = np.asarray(jax_stft_complex(jnp.asarray(y), n_fft, hop, win))
    length = n + length_delta
    if input_type == "real_imag":
        jax_in, torch_in = (jnp.asarray(spec.real), jnp.asarray(spec.imag)), (
            torch.from_numpy(spec.real.copy()), torch.from_numpy(spec.imag.copy()))
    elif input_type == "mag_phase":
        m, p = np.abs(spec), np.angle(spec)
        jax_in, torch_in = (jnp.asarray(m), jnp.asarray(p)), (torch.from_numpy(m), torch.from_numpy(p))
    else:
        jax_in, torch_in = jnp.asarray(spec), torch.from_numpy(spec)
    want = np.asarray(jax_istft(jax_in, n_fft, hop, win, length=length, input_type=input_type))
    got = stft.istft(torch_in, n_fft, hop, win, length=length, input_type=input_type).numpy()
    assert got.shape == want.shape == (2, length)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if length_delta >= 0:  # the round trip returns the wave
        np.testing.assert_allclose(got[:, :n], y, atol=1e-5)


def test_cirm_masks_match_jax():
    rng = np.random.default_rng(2)
    m = rng.uniform(-12.0, 12.0, (2, 33, 40, 2)).astype(np.float32)  # crosses ±9.9
    np.testing.assert_allclose(
        mask.decompress_cIRM(torch.from_numpy(m)).numpy(),
        np.asarray(jax_mask.decompress_cIRM(jnp.asarray(m))), rtol=1e-5, atol=1e-5,
    )
    assert float(mask.decompress_cIRM(torch.tensor([50.0]))) == pytest.approx(
        -10 * np.log(0.1 / 19.9), rel=1e-5)
    big = rng.uniform(-300.0, 300.0, (64,)).astype(np.float32)
    np.testing.assert_allclose(
        mask.compress_cIRM(torch.from_numpy(big)).numpy(),
        np.asarray(jax_mask.compress_cIRM(jnp.asarray(big))), rtol=1e-5, atol=1e-5,
    )
    parts = [rng.standard_normal((3, 17, 9)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        mask.build_complex_ideal_ratio_mask(*map(torch.from_numpy, parts)).numpy(),
        np.asarray(jax_mask.build_complex_ideal_ratio_mask(*map(jnp.asarray, parts))),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("name", ["offline_laplace_norm", "cumulative_laplace_norm"])
def test_norms_match_jax(name):
    x = np.abs(_wave(3, (2, 1, 33, 40))) * 5
    want = np.asarray(jax_norm.norm_wrapper(name)(jnp.asarray(x)))
    got = norm.norm_wrapper(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_offline_laplace_norm_adds_1e5_not_epsilon():
    x = torch.zeros(1, 1, 2, 3)
    x[..., 0, 0] = 6e-5  # mean 1e-5: divisor 2e-5 with 1e-5, ~1e-5 with EPSILON
    np.testing.assert_allclose(float(norm.offline_laplace_norm(x).max()), 3.0, rtol=1e-4)


@pytest.mark.parametrize("name", ["offline_gaussian_norm", "forgetting_norm", "no_such_norm"])
def test_unported_norms_raise(name):
    """Once pinned as raising, the Gaussian and forgetting norms now
    dispatch and match JAX at fp32 (rtol 1e-5); an unknown name still
    raises, with the JAX message."""
    if name == "no_such_norm":
        with pytest.raises(NotImplementedError, match="Unknown norm 'no_such_norm'"):
            norm.norm_wrapper(name)
        return
    x = np.abs(_wave(3, (2, 1, 33, 40))) * 5
    want = np.asarray(jax_norm.norm_wrapper(name)(jnp.asarray(x)))
    got = norm.norm_wrapper(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_neighbors", [0, 3, 15])
def test_freq_unfold_matches_jax(num_neighbors):
    x = _wave(4, (2, 1, 33, 10))
    want = np.asarray(jax_feature.freq_unfold(jnp.asarray(x), num_neighbors))
    got = feature.freq_unfold(torch.from_numpy(x), num_neighbors).numpy()
    np.testing.assert_array_equal(got, want)  # a gather: exact
