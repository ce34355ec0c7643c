"""The port's Inferencer and CLI end to end on the CPU, against the JAX
package's Inferencer on the same checkpoint (the tests/test_runtime.py
end-to-end check, with fullsubnet_tpu as the oracle)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fullsubnet_tpu.checkpoint import save_torch_checkpoint
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
from fullsubnet_tpu_torch.infer import cli
from fullsubnet_tpu_torch.infer.inferencer import Inferencer

from test_torch_fullsubnet import tiny_params

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TINY_MODEL_TOML = """
[acoustics]
n_fft = 320
win_length = 320
sr = 16000
hop_length = 160

[inferencer]
path = "inferencer.Inferencer"
type = "{strategy}"
batch_size = {batch_size}
[inferencer.args]

[dataset]
path = "dataset_inference.Dataset"
[dataset.args]
dataset_dir_list = ["{noisy_dir}"]
sr = 16000

[model]
path = "fullsubnet.model.Model"
[model.args]
sb_num_neighbors = 3
fb_num_neighbors = 0
num_freqs = 161
look_ahead = 2
sequence_model = "LSTM"
fb_output_activate_function = "ReLU"
sb_output_activate_function = false
fb_model_hidden_size = 32
sb_model_hidden_size = 24
weight_init = false
norm_type = "offline_laplace_norm"
num_groups_in_drop_band = 2
"""


@pytest.fixture
def tiny_setup(tmp_path):
    """A 1 s noisy wav, a .tar written by the JAX package, a tiny TOML."""
    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(sr) / sr
    noisy = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(sr)).astype(np.float32)
    noisy_dir = tmp_path / "noisy_in"
    noisy_dir.mkdir()
    write_wav(noisy_dir / "utt1.wav", noisy, sr)
    ckpt = tmp_path / "ckpt.tar"
    save_torch_checkpoint(tiny_params(0), "fullsubnet", ckpt)

    def config(strategy="full_band_crm_mask", batch_size=1):
        path = tmp_path / f"inference_{strategy}_{batch_size}.toml"
        path.write_text(TINY_MODEL_TOML.format(
            noisy_dir=noisy_dir, strategy=strategy, batch_size=batch_size))
        return path

    return {"noisy": read_wav(noisy_dir / "utt1.wav")[0], "ckpt": ckpt,
            "config": config, "tmp": tmp_path}


def test_inferencer_matches_jax_end_to_end(tiny_setup):
    cfg, ckpt, tmp = tiny_setup["config"](), tiny_setup["ckpt"], tiny_setup["tmp"]
    noisy = tiny_setup["noisy"]

    jax_inf = JaxInferencer(jax_load_config(cfg), str(ckpt), str(tmp / "out_jax"))
    want_dir = jax_inf()
    port = Inferencer(load_config(cfg), str(ckpt), str(tmp / "out_torch"), device="cpu")
    got_dir = port()

    # the enhanced signal before peak scaling: fp32 STFT, two LSTM stages, iSTFT
    want = np.asarray(jax_inf.full_band_crm_mask(noisy[None]))
    got = port.full_band_crm_mask(torch.from_numpy(noisy[None]))
    assert got.shape == want.shape == noisy.shape
    np.testing.assert_allclose(got, want, atol=1e-5)

    # the written files: int16, peak 0.8, equal up to one quantisation step
    out, sr = read_wav(got_dir / "utt1.wav")
    ref, _ = read_wav(want_dir / "utt1.wav")
    assert sr == 16000 and out.shape == noisy.shape
    assert abs(float(np.max(np.abs(out))) - 0.8) <= 1 / 32768
    np.testing.assert_allclose(out, ref, atol=1.01 / 32768)
    noisy_copy, _ = read_wav(tmp / "out_torch" / "noisy" / "utt1.wav")
    np.testing.assert_allclose(noisy_copy, noisy, atol=1 / 32768)


@pytest.mark.parametrize("strategy, batch_size", [("mag", 1), ("scaled_mask", 1)])
def test_unported_inference_modes_raise(tiny_setup, strategy, batch_size):
    """Once pinned as raising, ``mag`` and ``scaled_mask`` now construct on
    FullSubNet and match the JAX strategy: an STFT, the model, an iSTFT,
    all fp32, so 1e-5 absolute on a peak near 1."""
    cfg = tiny_setup["config"](strategy, batch_size)
    noisy = tiny_setup["noisy"]
    port = Inferencer(load_config(cfg), str(tiny_setup["ckpt"]), None, device="cpu")
    jax_inf = JaxInferencer(jax_load_config(cfg), str(tiny_setup["ckpt"]), None)
    want = np.asarray(getattr(jax_inf, strategy)(noisy[None]))
    got = getattr(port, strategy)(torch.from_numpy(noisy[None]))
    assert got.shape == want.shape == noisy.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cli_runs_on_cpu(tiny_setup):
    cfg, tmp = tiny_setup["config"](), tiny_setup["tmp"]
    cli.main(["-C", str(cfg), "-M", str(tiny_setup["ckpt"]), "-O", str(tmp / "cli"),
              "--device", "cpu"])
    out, sr = read_wav(tmp / "cli" / "enhanced" / "utt1.wav")
    assert sr == 16000 and out.shape == tiny_setup["noisy"].shape
    assert np.isfinite(out).all()


def test_cli_refuses_cuda_without_a_card(tiny_setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    cfg, tmp = tiny_setup["config"](), tiny_setup["tmp"]
    for device in ([], ["--device", "cuda"]):  # cuda is the default
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["-C", str(cfg), "-M", str(tiny_setup["ckpt"]), "-O", str(tmp / "x"), *device])
    assert not (tmp / "x").exists()  # refused before any output


def test_cli_import_leaves_jax_out():
    """The CLI, and then every module of the port, import torch and never
    JAX, nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fullsubnet_tpu_torch.infer.cli\n"
        "import fullsubnet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fullsubnet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
