"""The port's host mixer (``fullsubnet_tpu_torch/native``) against the JAX
package's (``fullsubnet_tpu.native``): the same source, flags and compiler
give the same bits; against the numpy plain versions and scipy at
``tests/test_native.py``'s tolerances; ``TrainDataset`` items over two
epochs bit-equal to the JAX package's; a failed build raises; two
processes building at once each load a whole library."""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from fullsubnet_tpu import native as jax_native
from fullsubnet_tpu.data.datasets import TrainDataset as JaxTrainDataset
from fullsubnet_tpu_torch import native
from fullsubnet_tpu_torch.acoustics import feature
from fullsubnet_tpu_torch.data.datasets import TrainDataset
from test_torch_train_data import SR, write_lists

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# tests/test_native.py's tolerances: the mixer against the numpy mix
MIX_ATOL, MIX_RTOL = 2e-4, 1e-3
# the C++ radix-2 engine against scipy's pocketfft
CONV_ATOL, CONV_RTOL = 5e-3, 1e-3
# float64 window sums of float32 samples, the last step in float32
ENERGY_ATOL = 1e-3


def _signals(seed, n=16000):
    rng = np.random.default_rng(seed)
    clean = (0.5 * np.sin(2 * np.pi * 300 * np.arange(n) / SR)
             * (0.6 + 0.4 * rng.random(n))).astype(np.float32)
    noise = (0.3 * rng.standard_normal(n)).astype(np.float32)
    rir = (np.exp(-np.arange(500) / 80.0) * rng.standard_normal(500)).astype(np.float32)
    rir[0] = 1.0
    return clean, noise, rir


def test_the_port_keeps_its_own_source():
    assert native.SRC == REPO / "fullsubnet_tpu_torch" / "native" / "mixer.cpp"
    assert native.BUILD_DIR.parent == native.SRC.parent
    src = native.SRC.read_text()
    for symbol in ("fsn_abi_version", "fsn_snr_mix", "fsn_fft_convolve_trunc",
                   "fsn_frame_energies_db"):
        assert symbol in src
    assert "-ffast-math" not in " ".join(" ".join(f) for f in native.FLAG_SETS)


@pytest.mark.parametrize("with_rir", [False, True])
@pytest.mark.parametrize("seed, snr, noisy_target", [(1, 5.0, -20.0), (2, -5.0, -15.0),
                                                     (3, 20.0, -35.0)])
def test_snr_mix_is_the_jax_mixers_bits(seed, snr, noisy_target, with_rir):
    assert jax_native.available(), "g++ is here: the JAX package's mixer must build"
    clean, noise, rir = _signals(seed)
    rir = rir if with_rir else None
    got = native.snr_mix(clean, noise, snr, -25.0, noisy_target, rir=rir)
    want = jax_native.snr_mix(clean, noise, snr, -25.0, noisy_target, rir=rir)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_fft_convolve_and_energies_are_the_jax_mixers_bits():
    clean, noise, rir = _signals(4, n=10007)
    np.testing.assert_array_equal(native.fft_convolve_trunc(clean, rir),
                                  jax_native.fft_convolve_trunc(clean, rir))
    for window in (800, 333):
        np.testing.assert_array_equal(native.frame_energies_db(noise, window),
                                      jax_native.frame_energies_db(noise, window))


@pytest.mark.parametrize("with_rir", [False, True])
def test_snr_mix_matches_the_numpy_mix(with_rir):
    """``TrainDataset.snr_mix`` (scipy's reverb, then the mixer) against
    ``plain_snr_mix`` (the same reverb, then numpy) from the same RNG, and
    ``native.snr_mix`` with the C++ engine's own reverb against both."""
    clean, noise, rir = _signals(5)
    rir = rir if with_rir else None
    args = (clean, noise, 5, -25, 10, rir)
    got = TrainDataset.snr_mix(*args, rng=np.random.default_rng(6))
    want = TrainDataset.plain_snr_mix(*args, rng=np.random.default_rng(6))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=MIX_ATOL, rtol=MIX_RTOL)
    _, noisy_target = TrainDataset.mix_draws(np.random.default_rng(6), rir, -25, 10)
    engine = native.snr_mix(clean, noise, 5, -25, noisy_target, rir=rir)
    for g, w in zip(engine, want, strict=True):
        np.testing.assert_allclose(g, w, atol=MIX_ATOL, rtol=MIX_RTOL)


def test_convolution_and_energies_match_scipy_and_numpy():
    clean, noise, rir = _signals(7, n=10000)
    h = np.random.default_rng(8).standard_normal(1234).astype(np.float32)
    for x, taps in ((clean, rir), (noise, h)):
        np.testing.assert_allclose(native.fft_convolve_trunc(x, taps),
                                   fftconvolve(x, taps)[: len(x)], atol=CONV_ATOL,
                                   rtol=CONV_RTOL)
    for n in (4000, 4321):
        x = noise[:n]
        got = feature.frame_energies_db(x, 800)
        assert got.shape == (-(-n // 800),)
        np.testing.assert_allclose(got, feature.plain_frame_energies_db(x, 800),
                                   atol=ENERGY_ATOL)


def test_refusals():
    with pytest.raises(ValueError, match="differ in length"):
        native.snr_mix(np.zeros(4), np.zeros(5), 0.0, -25.0, -25.0)
    with pytest.raises(ValueError, match="one-dimensional"):
        native.frame_energies_db(np.zeros((2, 8)), 4)
    with pytest.raises(ValueError, match="window must be positive"):
        native.frame_energies_db(np.zeros(8), 0)


@pytest.mark.parametrize("reverb_proportion", [0.0, 0.5, 1.0])
def test_train_dataset_items_are_the_jax_packages_bits(tmp_path, reverb_proportion):
    """Every item of two epochs, from the same lists and seed: both
    packages mix with the same library, so the items are equal."""
    clean, noise, rir = write_lists(tmp_path)
    args = dict(
        clean_dataset=str(clean), noise_dataset=str(noise), rir_dataset=str(rir),
        snr_range=[-5, 20], reverb_proportion=reverb_proportion, silence_length=0.05,
        target_dB_FS=-25, target_dB_FS_floating_value=10, sub_sample_length=0.4, sr=SR,
        clean_dataset_limit=False, seed=3,
    )
    jax_ds, port_ds = JaxTrainDataset(**args), TrainDataset(**args)
    for epoch in (0, 1):
        jax_ds.set_epoch(epoch)
        port_ds.set_epoch(epoch)
        for item in range(len(port_ds)):
            for got, want in zip(port_ds[item], jax_ds[item], strict=True):
                np.testing.assert_array_equal(got, want)


def test_a_failed_build_raises(tmp_path):
    """No compiler, or one that fails: the build raises with what the
    compiler said, and nothing falls back to numpy."""
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build_library("no-such-compiler", build_dir=tmp_path)
    broken = tmp_path / "broken-g++"
    broken.write_text("#!/bin/sh\n"
                      "case \"$1\" in -dump*) echo 12.2.0; exit 0;; esac\n"
                      "echo 'mixer.cpp:1: error: the compiler broke' >&2; exit 1\n")
    broken.chmod(0o755)
    with pytest.raises(RuntimeError, match="the compiler broke") as err:
        native.build_library(str(broken), build_dir=tmp_path)
    assert "-march=native" in str(err.value)  # both flag sets were tried
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_the_path_raises_without_a_compiler(tmp_path, monkeypatch):
    """With no g++ on PATH the training set and the VAD's energies raise
    instead of mixing in numpy."""
    clean, noise, rir = write_lists(tmp_path / "lists", n_clean=2)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="'g\\+\\+' did not run"):
        TrainDataset(str(clean), str(noise), str(rir))
    with pytest.raises(RuntimeError, match="'g\\+\\+' did not run"):
        feature.activity_detector(np.ones(1600, np.float32))


def test_two_processes_building_at_once_load_a_whole_library(tmp_path):
    code = ("import sys; from fullsubnet_tpu_torch import native; "
            "path = native.build_library(build_dir=sys.argv[1]); "
            "print(native._open(path).fsn_abi_version(), path)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0] == lines[1] == [str(native.ABI_VERSION), lines[0][1]]
    # one library, no temporary file left behind, and it mixes as the default build
    assert [p.name for p in tmp_path.iterdir()] == [Path(lines[0][1]).name]
    x = np.random.default_rng(9).standard_normal(1000).astype(np.float32)
    out = np.empty(2, np.float32)
    count = ctypes.c_int64(0)
    native._open(Path(lines[0][1])).fsn_frame_energies_db(
        native._ptr(x), len(x), 800, 1e-6, native._ptr(out), ctypes.byref(count))
    np.testing.assert_array_equal(out[: count.value], native.frame_energies_db(x, 800))
