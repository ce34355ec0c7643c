"""The port's norms (fullsubnet_tpu_torch.acoustics.norm) against the JAX
package's: each of the six on the same numpy inputs at fp32, the
forgetting norm's warm-up, the Gaussian statistics' clamp, the masked
Gaussian form, and the length-masked forwards (``valid_frames``,
``valid_samples``) of every family under the Gaussian norm and the causal
ones, each row against its unpadded run. The JAX references that scan run
under ``jax.jit``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics import norm as jax_norm
from fullsubnet_tpu.models import FastFullSubNet as JaxFastFullSubNet
from fullsubnet_tpu.models import FullSubNet as JaxFullSubNet
from fullsubnet_tpu.models import ImprovedFullSubNet as JaxImprovedFullSubNet
from fullsubnet_tpu_torch.acoustics import norm
from fullsubnet_tpu_torch.checkpoint import state_dict_from_jax_params
from fullsubnet_tpu_torch.models import FullSubNet

from test_torch_baselines import _fullband, jax_forward
from test_torch_fast_fullsubnet import _fast
from test_torch_fullsubnet import TINY, tiny_params
from test_torch_improved_fullsubnet import _improved, _waves

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32, the same formula; only the order of the sums differs
RTOL, NORM_ATOL = 1e-5, 1e-6
# fp32 through the norms and two stacks
ATOL = 1e-5


def _mag(seed, shape):
    return (np.abs(np.random.default_rng(seed).standard_normal(shape)) * 3).astype(np.float32)


def _jax_norm(name, **kwargs):
    fn = jax_norm.norm_wrapper(name)
    return jax.jit(lambda v: fn(v, **kwargs))


@pytest.mark.parametrize("name", ["offline_laplace_norm", "cumulative_laplace_norm",
                                  "offline_gaussian_norm", "cumulative_layer_norm",
                                  "forgetting_norm"])
def test_four_d_norm_matches_jax(name):
    x = _mag(1, (3, 2, 17, 30))
    want = np.asarray(_jax_norm(name)(jnp.asarray(x)))
    got = norm.norm_wrapper(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=NORM_ATOL)


@pytest.mark.parametrize("frames", [7, 40])
def test_hybrid_norm_matches_jax_below_and_above_the_training_length(frames):
    """[B, F, T] with ``sample_length_in_training`` 12: at T = 7 every frame
    takes the EMA, at T = 40 the frames from 12 on take the running mean."""
    x = _mag(2, (2, 9, frames))
    want = np.asarray(_jax_norm("hybrid_norm", sample_length_in_training=12)(jnp.asarray(x)))
    got = norm.hybrid_norm(torch.from_numpy(x), sample_length_in_training=12).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=NORM_ATOL)
    # the default training length (192) covers T = 40 with the EMA alone
    want = np.asarray(_jax_norm("hybrid_norm")(jnp.asarray(x)))
    np.testing.assert_allclose(norm.hybrid_norm(torch.from_numpy(x)).numpy(), want,
                               rtol=RTOL, atol=NORM_ATOL)


def test_forgetting_norm_warm_up():
    """alp_0 = -1, so mu_0 = 2·m_0; alp_1 = 0, so mu_1 = m_1."""
    x = torch.from_numpy(_mag(3, (2, 1, 5, 4)))
    out = norm.forgetting_norm(x)
    m = x.mean(dim=(1, 2))  # [B, T]
    torch.testing.assert_close(out[..., 0], x[..., 0] / (2 * m[:, None, None, 0] + 1e-10))
    torch.testing.assert_close(out[..., 1], x[..., 1] / (m[:, None, None, 1] + 1e-10))


def test_gaussian_norm_from_stats_clamps_a_near_constant_input():
    """1000 + 1e-4 noise: fp32 ``sumsq - count·mu²`` cancels to a negative
    number, which the clamp turns into a zero variance, not a NaN."""
    v = (1000.0 + 1e-4 * np.random.default_rng(4).standard_normal((1, 1, 64, 50))).astype(np.float32)
    count = float(v.size)
    total, sumsq = v.sum(dtype=np.float32), np.square(v).sum(dtype=np.float32)
    got = norm.gaussian_norm_from_stats(torch.from_numpy(v), torch.tensor(total),
                                        torch.tensor(sumsq), count).numpy()
    want = np.asarray(jax_norm.gaussian_norm_from_stats(jnp.asarray(v), total, sumsq, count))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


def test_masked_gaussian_norm_matches_the_unpadded_run_and_jax():
    """Rows of 30 and 11 real frames zero-padded to 30: each row's real
    frames equal the Gaussian norm of its prefix alone."""
    counts = np.array([30, 11])
    x = _mag(5, (2, 1, 17, 30)) * (np.arange(30) < counts[:, None])[:, None, None, :]
    valid = counts.astype(np.float32)[:, None, None, None]
    got = norm.masked_offline_norm(norm.offline_gaussian_norm, torch.from_numpy(valid))(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jax_norm.masked_offline_norm(jax_norm.offline_gaussian_norm,
                                                   jnp.asarray(valid))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=NORM_ATOL)
    for b, n in enumerate(counts):
        alone = norm.offline_gaussian_norm(torch.from_numpy(x[b : b + 1, ..., :n])).numpy()
        np.testing.assert_allclose(got[b, ..., :n], alone[0], rtol=RTOL, atol=NORM_ATOL)
    for causal in (norm.cumulative_laplace_norm, norm.cumulative_layer_norm,
                   norm.forgetting_norm):
        assert norm.masked_offline_norm(causal, torch.from_numpy(valid)) is None


# --------------------------------------------------------------------------
# the length-masked forwards under every norm
# --------------------------------------------------------------------------

# the norms a model's valid_frames path must keep exact beside the Laplace
# ones: the offline Gaussian through its masked statistics, the causal ones
# as they are
MASKED_NORMS = ["offline_gaussian_norm", "cumulative_layer_norm", "forgetting_norm"]


def _fullsubnet(norm_type):
    params = tiny_params(6)
    config = {**TINY, "sequence_model": "LSTM", "norm_type": norm_type}
    model = FullSubNet(**config)
    model.load_state_dict(state_dict_from_jax_params(params))
    return config, model, params


def _fullband_with(norm_type):
    config, model, params = _fullband("LSTM", seed=7)
    config["norm_type"] = norm_type
    model.norm = norm.norm_wrapper(norm_type)
    return config, model, params


def _fast_with(norm_type):
    """Fast FullSubNet at shrink 2 with no look-ahead: with look-ahead
    frames the partial tail block (at most shrink - 1 frames) would hold
    only their zeros, and its statistics would add next to nothing."""
    config, model, params = _fast("LSTM", 2, seed=8)
    config["norm_type"], config["look_ahead"] = norm_type, 0
    model.norm, model.look_ahead = norm.norm_wrapper(norm_type), 0
    return config, model, params


FAMILIES = {"fullsubnet": (_fullsubnet, JaxFullSubNet),
            "fullband_baseline": (_fullband_with, None),
            "fast_fullsubnet": (_fast_with, JaxFastFullSubNet)}
# Fast FullSubNet at shrink 2 with no look-ahead: an even count leaves the
# unpadded run a partial tail block, an odd one none
COUNTS = {"tail": np.array([30, 22, 8]), "no_tail": np.array([29, 21, 7])}


def _check_valid_frames(model, counts, frames, jax_model=None, params=None):
    mag = _mag(9, (len(counts), 1, 161, frames))
    mag *= (np.arange(frames) < counts[:, None])[:, None, None, :]
    kwargs = {"dropping_band": False} if isinstance(model, FullSubNet) else {}
    with torch.inference_mode():
        got = model(torch.from_numpy(mag), valid_frames=torch.from_numpy(counts), **kwargs).numpy()
        alone = [model(torch.from_numpy(mag[b : b + 1, ..., :n]), **kwargs).numpy()
                 for b, n in enumerate(counts)]
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, ..., :n], alone[b][0], atol=ATOL)
    if jax_model is not None:
        if kwargs:
            jax_model = functools.partial(jax_model, **kwargs)
        want = jax_forward(jax_model, params, mag, valid_frames=counts)
        for b, n in enumerate(counts):
            np.testing.assert_allclose(got[b, ..., :n], want[b, ..., :n], atol=ATOL)


@pytest.mark.parametrize("norm_type", MASKED_NORMS)
@pytest.mark.parametrize("family", ["fullsubnet", "fullband_baseline"])
def test_valid_frames_exact_under_every_norm(family, norm_type):
    """Rows of 30, 22 and 8 real frames zero-padded to 30, each against its
    unpadded run (and the flagship's Gaussian one against JAX)."""
    build, jax_cls = FAMILIES[family]
    config, model, params = build(norm_type)
    jax_model = jax_cls(**config) if jax_cls and norm_type == "offline_gaussian_norm" else None
    _check_valid_frames(model, COUNTS["tail"], 30, jax_model, params)


@pytest.mark.parametrize("tail", sorted(COUNTS))
@pytest.mark.parametrize("norm_type", MASKED_NORMS)
def test_fast_valid_frames_exact_under_every_norm(norm_type, tail):
    """Fast FullSubNet with the partial tail block present in every row or
    in none: the Gaussian statistics rebuild the block's sum and sum of
    squares (against JAX too); the causal norms are exact as they are. The
    bottleneck's normalised input is held to the unpadded run's too, over
    the blocks 0..n_full that both runs form: the random bottleneck can
    pass too little of it to the output to show an error there."""
    config, model, params = _fast_with(norm_type)
    jax_model = JaxFastFullSubNet(**config) if norm_type == "offline_gaussian_norm" else None
    seen = []
    hook = model.bottleneck.register_forward_hook(lambda mod, args, out: seen.append(args[0]))
    counts = COUNTS[tail]
    _check_valid_frames(model, counts, 30, jax_model, params)
    hook.remove()
    m = config["num_mels"]
    padded = seen[0].reshape(len(counts), m, *seen[0].shape[1:])
    for b, n in enumerate(counts):
        blocks = (n - 1) // config["shrink_size"] + 1  # 0..n_full
        np.testing.assert_allclose(padded[b, ..., :blocks].numpy(),
                                   seen[1 + b][..., :blocks].numpy(), atol=ATOL)


def test_improved_valid_samples_under_the_gaussian_norm():
    """Improved FullSubNet (16 kHz layout, small widths) with rows of 0.3,
    0.19 and 0.04 s zero-padded to one bucket: each row's samples against
    its unpadded run and against the JAX model."""
    config, model, params = _improved(16000, seed=10, norm_type="offline_gaussian_norm")
    most = int(0.3 * 16000)
    counts = np.array([most, most * 5 // 8 + 1, most * 7 // 48])
    y = _waves((3, most), 11)
    padded = np.zeros((3, most + config["n_fft"]), np.float32)
    for b, n in enumerate(counts):
        padded[b, :n] = y[b, :n]
    want = jax_forward(JaxImprovedFullSubNet(**config), params, padded, valid_samples=counts)
    with torch.inference_mode():
        got = model(torch.from_numpy(padded), valid_samples=torch.from_numpy(counts)).numpy()
        alone = [model(torch.from_numpy(y[b : b + 1, :n])).numpy() for b, n in enumerate(counts)]
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, 0, :n], want[b, 0, :n], atol=ATOL)
        np.testing.assert_allclose(got[b, 0, :n], alone[b][0, 0], atol=ATOL)
