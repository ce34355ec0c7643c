"""The port's library modules that no model builds, against the JAX
package's on the same numpy inputs at fp32: the rest of
``acoustics/feature.py``, ``acoustics/rvb.py``, ``nn/feature_norm.py``,
``nn/conv.py`` in eval mode through the weight bridge (and its BatchNorm
running statistics in training), and ``masked_waveform_loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics import feature as jax_feature
from fullsubnet_tpu.acoustics import rvb as jax_rvb
from fullsubnet_tpu.nn import conv as jax_conv
from fullsubnet_tpu.nn import feature_norm as jax_feature_norm
from fullsubnet_tpu.train import loss as jax_loss
from fullsubnet_tpu_torch.acoustics import feature, rvb
from fullsubnet_tpu_torch.checkpoint import conv_state_from_jax_params
from fullsubnet_tpu_torch.nn import conv, feature_norm
from fullsubnet_tpu_torch.train import loss

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32, the same formula; only the order of the sums differs
RTOL, ATOL = 1e-5, 1e-6
# fp32 convolutions of different libraries
CONV_ATOL = 1e-5


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# acoustics/feature.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("context", [0, 3])
def test_unfold_along_time_matches_jax(context):
    x = _x(0, (2, 3, 5, 11))
    want = np.asarray(jax_feature.unfold_along_time(jnp.asarray(x), context))
    got = feature.unfold_along_time(torch.from_numpy(x), context).numpy()
    assert got.shape == want.shape == (2, 11 - context, 3, 5, context + 1)
    np.testing.assert_array_equal(got, want)  # a gather: exact


def test_batch_shuffle_frequency_matches_jax_on_given_indices():
    """The ``indices=`` path is exact; a generator draws one permutation
    of the frequencies per row."""
    x = _x(1, (3, 2, 7, 4))
    indices = np.stack([np.random.default_rng(s).permutation(7) for s in range(3)])
    want, _ = jax_feature.batch_shuffle_frequency(jnp.asarray(x), indices=jnp.asarray(indices))
    got, idx = feature.batch_shuffle_frequency(torch.from_numpy(x),
                                               indices=torch.from_numpy(indices))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(idx.numpy(), indices)
    shuffled, drawn = feature.batch_shuffle_frequency(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert sorted(drawn[0].tolist()) == list(range(7))
    np.testing.assert_array_equal(shuffled.numpy(), np.take_along_axis(
        x, drawn.numpy()[:, None, :, None], axis=2))
    with pytest.raises(ValueError):
        feature.batch_shuffle_frequency(torch.from_numpy(x))


@pytest.mark.parametrize("dim", [-1, 0])
def test_overlap_cat_matches_jax(dim):
    chunks = [_x(s, (4, 10) if dim == -1 else (10, 4)) for s in range(3)]
    want = jax_feature.overlap_cat([jnp.asarray(c) for c in chunks], axis=dim)
    got = feature.overlap_cat([torch.from_numpy(c) for c in chunks], dim=dim)
    _close(got, want)


def test_channel_wise_layer_norm_matches_jax():
    x, scale, bias = _x(2, (2, 6, 9)), _x(3, (6,)), _x(4, (6,))
    want = jax_feature.channel_wise_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = feature.channel_wise_layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                          torch.from_numpy(bias))
    _close(got, want, atol=1e-5)


def test_reduce_complexity_separately_matches_jax():
    """14 frequencies give each group 4 (the JAX function needs equal
    counts, as FullSubNet's 257 give 85 each); 7 rows leave one out."""
    sb, fb = _x(5, (7, 14, 1, 5, 4)), _x(6, (7, 14, 1, 3, 4))
    want = np.asarray(jax_feature.reduce_complexity_separately(jnp.asarray(sb), jnp.asarray(fb)))
    got = feature.reduce_complexity_separately(torch.from_numpy(sb), torch.from_numpy(fb)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [900, 1000, 1300])
def test_aligned_subsample_matches_jax(length):
    a, b = _x(7, (2, length)), _x(8, (2, length))
    want = jax_feature.aligned_subsample(a, b, 1000, rng=np.random.default_rng(9))
    got = feature.aligned_subsample(a, b, 1000, rng=np.random.default_rng(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seconds", [0.7, 1.3])
def test_activity_detector_matches_jax(seconds):
    """Speech-like bursts in noise; the last 50 ms window partial at 0.7 s
    and whole at 1.3 s."""
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    bursts = (np.sin(2 * np.pi * 2.5 * t) > 0.2).astype(np.float32)
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * bursts + 0.01 * _x(10, (n,))).astype(np.float32)
    want = jax_feature.activity_detector(audio)
    np.testing.assert_allclose(feature.frame_energies_db(audio, 800),
                               np.asarray(jax_native_energies(audio, 800)), rtol=1e-6)
    assert feature.activity_detector(audio) == pytest.approx(want, abs=1e-12)
    assert 0.0 < want < 1.0


def jax_native_energies(audio, window):
    from fullsubnet_tpu import native

    return native.frame_energies_db(audio, window, 1e-6)


def test_reverberation_time_shortening_matches_jax():
    rir = (_x(11, (4000,)) * np.exp(-np.arange(4000) / 600)).astype(np.float32)
    rir[200] = 3.0
    want = jax_rvb.reverberation_time_shortening(rir, 0.8, 0.3)
    got = rvb.reverberation_time_shortening(rir, 0.8, 0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        rvb.reverberation_time_shortening(rir[None], 0.8, 0.3)


# --------------------------------------------------------------------------
# nn/feature_norm.py and masked_waveform_loss
# --------------------------------------------------------------------------


def test_cumulative_norm_matches_jax():
    x = np.abs(_x(12, (2, 2, 9, 20))) * 3
    _close(feature_norm.cumulative_norm(torch.from_numpy(x)),
           jax_feature_norm.cumulative_norm(jnp.asarray(x)))


@pytest.mark.parametrize("cumulative", [False, True])
@pytest.mark.parametrize("mid", [False, True])
def test_cumulative_mag_spectral_norm_matches_jax(cumulative, mid):
    x = np.abs(_x(13, (2, 1, 9, 20))) * 3
    _close(feature_norm.cumulative_mag_spectral_norm(torch.from_numpy(x), cumulative, mid),
           jax_feature_norm.cumulative_mag_spectral_norm(jnp.asarray(x), cumulative, mid))


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "si_snr_loss"])
def test_masked_waveform_loss_matches_jax_and_the_unpadded_loss(name):
    """Rows of 400 samples zero-padded to 512 with one true count: the JAX
    masked loss, and the plain loss of the unpadded rows."""
    pred, target = _x(14, (3, 400)), _x(15, (3, 400))
    pads = [np.pad(v, ((0, 0), (0, 112))) for v in (pred, target)]
    mask = (np.arange(512) < 400).astype(np.float32)
    fn, jax_fn = loss.LOSS_REGISTRY[name], jax_loss.LOSS_REGISTRY[name]
    got = loss.masked_waveform_loss(fn, *map(torch.from_numpy, pads), torch.from_numpy(mask), 400)
    want = jax_loss.masked_waveform_loss(jax_fn, *map(jnp.asarray, pads), jnp.asarray(mask), 400)
    _close(got, want, atol=1e-5)
    _close(got, fn(torch.from_numpy(pred), torch.from_numpy(target)), atol=1e-5)
    assert fn in loss.MASKED_WAVEFORM_LOSSES
    assert loss.masked_waveform_loss(lambda p, t: 0, *map(torch.from_numpy, pads),
                                     torch.from_numpy(mask), 400) is None


# --------------------------------------------------------------------------
# nn/conv.py through the bridge
# --------------------------------------------------------------------------


def test_temporal_conv_net_matches_jax_through_the_bridge():
    """Two blocks (the first with a 1x1 downsample, 8 -> 16 channels), a
    third at 16 -> 16, kernel 3, in eval mode; and causal: zeros from frame
    30 on leave the outputs before it as they were."""
    net = jax_conv.TemporalConvNet(8, [16, 16, 16], kernel_size=3, dropout=0.2)
    params = jax.tree_util.tree_map(np.asarray, net.init(jax.random.PRNGKey(0)))
    params[0]["conv1"]["g"] = _x(16, (16,))  # a magnitude other than 1
    x = _x(17, (2, 8, 40))
    want = np.asarray(jax.jit(net)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    port = conv.TemporalConvNet(8, [16, 16, 16], kernel_size=3, dropout=0.2).eval()
    port.load_state_dict(conv_state_from_jax_params(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
        x[..., 30:] = 0
        causal = port(torch.from_numpy(x)).numpy()
    _close(got, want, atol=CONV_ATOL)
    np.testing.assert_array_equal(causal[..., :30], got[..., :30])


def test_temporal_conv_net_dropout_takes_a_generator():
    port = conv.TemporalConvNet(4, [4], kernel_size=2, dropout=0.5).train()
    x = torch.from_numpy(_x(18, (1, 4, 20)))
    with pytest.raises(ValueError, match="Generator"):
        port(x)
    draws = [port(x, torch.Generator().manual_seed(1)) for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1])
    assert not torch.equal(draws[0], port.eval()(x))


@pytest.mark.parametrize("activation", ["ReLU", "ELU", "Tanh", "LeakyReLU"])
def test_causal_conv_block_matches_jax(activation):
    """Eval mode on stored running statistics, then one training step's
    output and running statistics (momentum 0.1, unbiased variance)."""
    params = jax.tree_util.tree_map(np.asarray, jax_conv.causal_conv_block_init(
        jax.random.PRNGKey(1), 2, 4))
    params.update(bn_scale=_x(19, (4,)), bn_bias=_x(20, (4,)), bn_mean=_x(21, (4,), 0.1),
                  bn_var=np.abs(_x(22, (4,))) + 0.5)
    x = _x(23, (2, 2, 33, 10))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    port = conv.CausalConvBlock(2, 4, activation).eval()
    port.load_state_dict(conv_state_from_jax_params(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got, jax_conv.causal_conv_block_apply(jparams, jnp.asarray(x), activation),
           atol=CONV_ATOL)
    want, new = jax_conv.causal_conv_block_apply(jparams, jnp.asarray(x), activation,
                                                 training=True, return_params=True)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    _close(got, want, atol=CONV_ATOL)
    _close(port.bn.running_mean, new["bn_mean"], atol=CONV_ATOL)
    _close(port.bn.running_var, new["bn_var"], atol=CONV_ATOL)


@pytest.mark.parametrize("is_last", [False, True])
def test_causal_trans_conv_block_matches_jax(is_last):
    params = jax.tree_util.tree_map(np.asarray, jax_conv.causal_trans_conv_block_init(
        jax.random.PRNGKey(2), 4, 2))
    params.update(bn_mean=_x(24, (2,), 0.1), bn_var=np.abs(_x(25, (2,))) + 0.5)
    x = _x(26, (2, 4, 16, 10))
    port = conv.CausalTransConvBlock(4, 2, is_last=is_last).eval()
    port.load_state_dict(conv_state_from_jax_params(params))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    want = jax_conv.causal_trans_conv_block_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), is_last=is_last)
    assert got.shape == want.shape == (2, 2, 33, 10)
    _close(got, want, atol=CONV_ATOL)
