"""The port's length-masked forward and batched inference against the JAX
package: ``masked_offline_norm``, the STFT helpers of the bucketed path,
``FullSubNet(valid_frames=...)``, ``pad_bucket_batch``, and the batched
Inferencer's outputs against the JAX Inferencer's ``_call_batched`` and
against the port's own ``batch_size = 1`` outputs."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullsubnet_tpu.acoustics.stft  # noqa: F401  (the module, not the function of that name)
from fullsubnet_tpu.acoustics import norm as jax_norm
from fullsubnet_tpu.checkpoint import save_torch_checkpoint
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.infer.host import pad_bucket_batch as jax_pad_bucket_batch
from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu.models import FullSubNet as JaxFullSubNet
from fullsubnet_tpu_torch.acoustics import norm, stft
from fullsubnet_tpu_torch.checkpoint import state_dict_from_jax_params
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
from fullsubnet_tpu_torch.infer.host import pad_bucket_batch
from fullsubnet_tpu_torch.infer.inferencer import Inferencer
from fullsubnet_tpu_torch.models import FullSubNet

from test_torch_fullsubnet import TINY, _jnp, tiny_params
from test_torch_inferencer import TINY_MODEL_TOML

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

jax_stft = sys.modules["fullsubnet_tpu.acoustics.stft"]

# fp32 on both sides; the masked statistics are a sum over the padded
# frames over a count where the unpadded run takes a mean, and the sums
# run in another order: the same tolerance as the unpadded forward's
# parity test (tests/test_torch_fullsubnet.py)
ATOL = 1e-5


def test_masked_offline_norm_matches_jax():
    rng = np.random.default_rng(0)
    v = np.abs(rng.standard_normal((3, 1, 20, 30))).astype(np.float32)
    counts = np.array([30, 17, 5], np.float32)
    v[..., 17:][1] = 0  # the caller zeroes the padded frames
    v[..., 5:][2] = 0
    total = counts[:, None, None, None]
    want = np.asarray(jax_norm.masked_offline_norm(jax_norm.offline_laplace_norm,
                                                   jnp.asarray(total))(jnp.asarray(v)))
    got = norm.masked_offline_norm(norm.offline_laplace_norm, torch.from_numpy(total))(
        torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a row's real frames equal the unmasked norm of its unpadded prefix
    np.testing.assert_allclose(got[1, ..., :17],
                               norm.offline_laplace_norm(torch.from_numpy(v[1:2, ..., :17]))[0],
                               rtol=1e-6)
    # causal norms need no mask
    assert norm.masked_offline_norm(norm.cumulative_laplace_norm, torch.ones(1)) is None
    a = np.float32([[2.0, 4.0]])
    np.testing.assert_allclose(norm.laplace_norm_from_stats(torch.from_numpy(a), 6.0, 2.0),
                               jax_norm.laplace_norm_from_stats(a, 6.0, 2.0), rtol=1e-7)


@pytest.mark.parametrize("length", [1, 2, 100, 160, 161, 500])
def test_stft_of_short_signals_matches_jax(length):
    """torch.stft refuses a reflect pad as long as the signal; the port pads
    such signals by repeated reflection as jnp.pad (and numpy) do."""
    y = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    want = np.asarray(jax_stft.stft_complex(jnp.asarray(y), 320, 160, 320))
    got = stft.stft_complex(torch.from_numpy(y), 320, 160, 320).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    if length <= 160:
        pad = stft._reflect_pad(torch.from_numpy(y), 160).numpy()
        np.testing.assert_array_equal(pad, np.pad(y, ((0, 0), (160, 160)), mode="reflect"))


def test_tail_reflection_and_frame_counts_match_jax():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((3, 4000)).astype(np.float32)
    lengths = np.array([3000, 161, 3840], np.int64)
    y[np.arange(4000)[None, :] >= lengths[:, None]] = 0
    got = stft.insert_tail_reflection(torch.from_numpy(y), torch.from_numpy(lengths), 320).numpy()
    for b, length in enumerate(lengths):
        want = np.asarray(jax_stft.insert_tail_reflection(jnp.asarray(y[b]), int(length), 320))
        np.testing.assert_array_equal(got[b], want)
        # the reflection torch's own center pad gives at that length
        np.testing.assert_array_equal(
            got[b, length : length + 160], np.pad(y[b, :length], (0, 160), mode="reflect")[length:])
    for n_fft, hop in ((320, 160), (512, 256), (511, 128)):
        counts = stft.traced_num_frames(torch.from_numpy(lengths), hop, n_fft).numpy()
        np.testing.assert_array_equal(counts, np.asarray(
            jax_stft.traced_num_frames(jnp.asarray(lengths), hop, n_fft)))
        assert [stft.num_stft_frames(int(n), hop, n_fft) for n in lengths] == counts.tolist()


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_fullsubnet_valid_frames_matches_jax(cell):
    """B = 3 rows of 40, 23 and 9 real frames, zero-padded to 40: the port
    against the JAX model with the same [B] counts, and each row's real
    frames against the unpadded run of its prefix."""
    params = tiny_params(4, cell)
    config = {**TINY, "sequence_model": cell}
    counts = np.array([40, 23, 9])
    rng = np.random.default_rng(5)
    mag = np.abs(rng.standard_normal((3, 1, 161, 40))).astype(np.float32) * 2
    mag *= (np.arange(40) < counts[:, None])[:, None, None, :]
    want = np.asarray(JaxFullSubNet(**config)(
        _jnp(params), jnp.asarray(mag), dropping_band=False, valid_frames=jnp.asarray(counts)))
    model = FullSubNet(**config)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(mag), dropping_band=False,
                    valid_frames=torch.from_numpy(counts)).numpy()
        alone = [model(torch.from_numpy(mag[b : b + 1, ..., :n]), dropping_band=False).numpy()
                 for b, n in enumerate(counts)]
    assert got.shape == want.shape == (3, 2, 161, 40)
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, ..., :n], want[b, ..., :n], atol=ATOL)
        np.testing.assert_allclose(got[b, ..., :n], alone[b][0], atol=ATOL)
    # a scalar count serves a batch of one length
    with torch.inference_mode():
        one = model(torch.from_numpy(mag[:1]), dropping_band=False, valid_frames=40).numpy()
    np.testing.assert_allclose(one, alone[0], atol=ATOL)


def test_valid_frames_refuse_drop_band():
    model = FullSubNet(**TINY)
    with pytest.raises(ValueError, match="inference-shaped"):
        model(torch.zeros(4, 1, 161, 10), dropping_band=True, valid_frames=torch.full((4,), 8))


def test_pad_bucket_batch_matches_jax():
    waves = [np.arange(n, dtype=np.float32) + 1 for n in (7, 3, 10)]
    got = pad_bucket_batch(waves, 5, 12)
    want = jax_pad_bucket_batch(waves, 5, 12)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], [7, 3, 10, 7, 7])  # fillers take the first length


# the batched and the exact runs' enhanced signals before peak scaling: the
# same fp32 model on the same frames, the norm statistics summed over the
# padded batch (sums in another order); and the port against JAX
BATCH_ATOL = 1e-5
SECONDS = (0.5, 1.2, 0.006, 1.0, 0.8, 1.9, 0.3, 0.6)  # 0.006 s: 96 samples <= n_fft // 2


@pytest.fixture
def mixed_lengths(tmp_path):
    """Noisy wavs of mixed lengths (one shorter than n_fft // 2), a .tar
    written by the JAX package, a tiny TOML per batch size."""
    sr = 16000
    rng = np.random.default_rng(2)
    noisy_dir = tmp_path / "noisy_in"
    noisy_dir.mkdir()
    waves = {}
    for i, seconds in enumerate(SECONDS):
        t = np.arange(int(seconds * sr)) / sr
        wave = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.standard_normal(t.size)
        name = f"utt{i}"
        write_wav(noisy_dir / f"{name}.wav", wave.astype(np.float32), sr)
        waves[name] = read_wav(noisy_dir / f"{name}.wav")[0]
    ckpt = tmp_path / "ckpt.tar"
    save_torch_checkpoint(tiny_params(6), "fullsubnet", ckpt)

    def config(batch_size):
        path = tmp_path / f"inference_{batch_size}.toml"
        path.write_text(TINY_MODEL_TOML.format(noisy_dir=noisy_dir, strategy="full_band_crm_mask",
                                               batch_size=batch_size))
        return path

    return {"waves": waves, "ckpt": ckpt, "config": config, "tmp": tmp_path}


def _recorded(inferencer):
    """Run an Inferencer and keep each enhanced signal before its int16 write."""
    out = {}
    write = inferencer._write_outputs

    def record(enhanced, noisy, name):
        out[name] = np.asarray(enhanced, np.float32)
        write(enhanced, noisy, name)

    inferencer._write_outputs = record
    inferencer()
    return out


def test_batched_inferencer_matches_jax_and_batch_one(mixed_lengths):
    s = mixed_lengths
    cfg4, cfg1 = s["config"](4), s["config"](1)
    port4 = Inferencer(load_config(cfg4), str(s["ckpt"]), str(s["tmp"] / "port4"), device="cpu")
    flushes = []
    enhance_bucket = port4.enhance_bucket
    port4.enhance_bucket = lambda waves, bucket: (flushes.append((len(waves), bucket)),
                                                  enhance_bucket(waves, bucket))[1]
    got = _recorded(port4)
    one = _recorded(Inferencer(load_config(cfg1), str(s["ckpt"]), str(s["tmp"] / "port1"),
                               device="cpu"))
    jax_inf = JaxInferencer(jax_load_config(cfg4), str(s["ckpt"]), str(s["tmp"] / "jax"))
    want = {}
    jax_write = jax_inf._write_outputs
    jax_inf._write_outputs = lambda e, n, name: (want.__setitem__(name, np.asarray(e, np.float32)),
                                                 jax_write(e, n, name))
    jax_inf._call_batched(4)

    # buckets of 1 s (length + n_fft, rounded up): 0.3-0.8 s in a full
    # flush of 1 s, 1.0-1.9 s in a partial one of 2 s; 0.006 s exact
    assert sorted(flushes) == [(3, 32000), (4, 16000)]
    assert sorted(got) == sorted(one) == sorted(want) == sorted(s["waves"])
    for name, noisy in s["waves"].items():
        assert got[name].shape == noisy.shape
        np.testing.assert_allclose(got[name], want[name], atol=BATCH_ATOL, err_msg=name)
        np.testing.assert_allclose(got[name], one[name], atol=BATCH_ATOL, err_msg=name)
    # the written files: int16 at peak 0.8, the input's length
    for name, noisy in s["waves"].items():
        out, sr = read_wav(s["tmp"] / "port4" / "enhanced" / f"{name}.wav")
        assert sr == 16000 and out.shape == noisy.shape and np.isfinite(out).all()
        assert abs(float(np.max(np.abs(out))) - 0.8) <= 1 / 32768


def test_partial_flush_runs_only_its_own_rows(mixed_lengths):
    """A flush of fewer waves than ``batch_size`` pads no filler rows: the
    model sees one row per wave."""
    s = mixed_lengths
    port = Inferencer(load_config(s["config"](4)), str(s["ckpt"]), None, device="cpu")
    rows = []
    port.model.register_forward_pre_hook(lambda _, args: rows.append(args[0].shape[0]))
    waves = [s["waves"]["utt0"], s["waves"]["utt6"]]  # 0.5 and 0.3 s: the 1 s bucket
    out = port.enhance_bucket(waves, 16000)
    assert rows == [2]
    assert [o.shape for o in out] == [w.shape for w in waves]


def test_bucket_seconds_zero_runs_each_utterance_alone(mixed_lengths):
    s = mixed_lengths
    cfg = s["config"](4)
    cfg.write_text(cfg.read_text().replace("batch_size = 4", "batch_size = 4\nbucket_seconds = 0"))
    port = Inferencer(load_config(cfg), str(s["ckpt"]), str(s["tmp"] / "alone"), device="cpu")
    port.enhance_bucket = None  # the batched path must not run
    assert sorted(_recorded(port)) == sorted(s["waves"])
