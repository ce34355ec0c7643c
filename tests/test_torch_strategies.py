"""The port's ``mag``, ``scaled_mask`` and ``sub_band_crm_mask`` inference
strategies against the JAX Inferencer's ``_mag_fn``, ``_scaled_mask_fn``
and ``_sub_band_crm_mask_fn`` on bridged weights (the JAX functions run
jitted on a stand-in Inferencer that holds the JAX model: the JAX package
has no checkpoint reader for the sub-band baseline), the infer CLI writing
wavs under each strategy, and the refusals of a model that cannot take a
strategy's input."""

import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu.infer.inferencer import model_call_kwargs
from fullsubnet_tpu.models import FullBandModel as JaxFullBandModel
from fullsubnet_tpu.models import SubBandBaseline as JaxSubBandBaseline
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.config import build_model, load_config
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
from fullsubnet_tpu_torch.infer import cli
from fullsubnet_tpu_torch.infer.inferencer import Inferencer

from test_torch_baselines import FULLBAND, SUBBAND, model_section, with_model
from test_torch_fullsubnet import _jnp
from test_torch_inferencer import TINY_MODEL_TOML

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 through the STFT, one or two LSTM layers and the iSTFT, on outputs
# of a peak near 1
ATOL = 1e-5
ACOUSTICS = {"n_fft": 320, "hop_length": 160, "win_length": 320, "sr": 16000}
FAMILY_OF = {"mag": "fullband_baseline", "scaled_mask": "fullband_baseline",
             "sub_band_crm_mask": "subband_baseline"}
ARGS = {"fullband_baseline": {**FULLBAND, "sequence_model": "LSTM"},
        "subband_baseline": {**SUBBAND, "sequence_model": "LSTM"}}


def _noisy(seconds=0.5, seed=0):
    t = np.arange(int(seconds * 16000)) / 16000
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


def _port(tmp_path, strategy, inference_args="", batch_size=1, head_bias=None, noisy_dir=None):
    """The port's Inferencer of ``strategy`` on seeded weights of its
    family, and its model; ``head_bias`` overrides the head's bias."""
    family = FAMILY_OF[strategy]
    section = model_section(f"{family}.model.Model", ARGS[family])
    model, _ = build_model(tomllib.loads(section), generator=torch.Generator().manual_seed(3))
    if head_bias is not None:
        with torch.no_grad():
            model.sb_model.fc_output_layer.bias.copy_(torch.tensor(head_bias))
    ckpt = tmp_path / f"{family}.tar"
    torch.save({"model": model.state_dict()}, ckpt)
    toml = TINY_MODEL_TOML.format(noisy_dir=noisy_dir or tmp_path, strategy=strategy,
                                  batch_size=batch_size)
    toml = with_model(toml, section).replace("[inferencer.args]\n",
                                             f"[inferencer.args]\n{inference_args}\n")
    path = tmp_path / f"{strategy}_{batch_size}.toml"
    path.write_text(toml)
    return path, ckpt, Inferencer(load_config(path), str(ckpt), None, device="cpu"), model


def _jax_strategy(strategy, model, inference_args):
    """The JAX Inferencer's ``_<strategy>_fn`` on a stand-in that holds the
    JAX model of ``model``'s family, jitted, with the bridged weights."""
    jax_cls = JaxSubBandBaseline if strategy == "sub_band_crm_mask" else JaxFullBandModel
    args = {k: v for k, v in ARGS[FAMILY_OF[strategy]].items()}
    jax_inf = object.__new__(JaxInferencer)
    jax_inf.acoustics = ACOUSTICS
    jax_inf.inference_args = inference_args
    jax_inf.model = jax_cls(**args)
    jax_inf._model_kwargs = model_call_kwargs(jax_inf.model)
    params = _jnp(jax_params_from_state_dict(model.state_dict()))
    fn = jax.jit(getattr(jax_inf, f"_{strategy}_fn"))
    return lambda noisy: np.asarray(fn(params, jnp.asarray(noisy)))[0]


@pytest.mark.parametrize("strategy", ["mag", "scaled_mask"])
def test_full_band_strategies_match_jax(tmp_path, strategy):
    _, _, port, model = _port(tmp_path, strategy)
    noisy = _noisy()
    want = _jax_strategy(strategy, model, {})(noisy[None])
    got = port.__getattribute__(strategy)(torch.from_numpy(noisy[None]))
    assert got.shape == want.shape == noisy.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("pad_mode, clamp", [("reflect", False), ("constant", False),
                                             ("reflect", True)])
def test_sub_band_crm_mask_matches_jax(tmp_path, pad_mode, clamp):
    """Both unfold pads; and a head bias of (9.95, -12) that drives the
    cIRM past the default clamp of 9.9 and past 9.99, so the decompression
    must clamp at 9.99 (the 9.95 outputs decompress to about 60, where 9.9
    would give about 53)."""
    args = {"n_neighbor": 3, "pad_mode": pad_mode}
    _, _, port, model = _port(tmp_path, "sub_band_crm_mask",
                              f'n_neighbor = 3\npad_mode = "{pad_mode}"',
                              head_bias=[9.95, -12.0] if clamp else None)
    noisy = _noisy(seed=1)
    want = _jax_strategy("sub_band_crm_mask", model, args)(noisy[None])
    got = port.sub_band_crm_mask(torch.from_numpy(noisy[None]))
    assert got.shape == want.shape == noisy.shape
    # a mask near 60 amplifies the spectrum: hold the error to the peak
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))
    if clamp:
        with torch.inference_mode():
            spec = torch.stft(torch.from_numpy(noisy), 320, 160, window=torch.hann_window(320),
                              return_complex=True)
            units = torch.nn.functional.pad(spec.abs()[None, None], (0, 0, 3, 3),
                                            mode="reflect")
            units = units.unfold(2, 7, 1)[0, 0].permute(0, 2, 1)
            crm = model(units)
        assert float(crm[:, 0].min()) > 9.9 and float(crm[:, 1].max()) < -9.99


@pytest.mark.parametrize("strategy", ["mag", "scaled_mask", "sub_band_crm_mask"])
def test_cli_writes_each_strategy(tmp_path, strategy):
    """The infer CLI on two wavs with ``--device cpu``: finite wavs of the
    inputs' lengths, peak 0.8; ``batch_size = 4`` runs each utterance alone
    and writes the same files."""
    noisy_dir = tmp_path / "noisy_in"
    noisy_dir.mkdir()
    for i, seconds in enumerate((0.5, 0.83)):
        write_wav(noisy_dir / f"utt{i}.wav", _noisy(seconds, seed=i), 16000)
    outputs = {}
    for batch_size in (1, 4):
        cfg, ckpt, _, _ = _port(tmp_path, strategy, "n_neighbor = 3", batch_size,
                                noisy_dir=noisy_dir)
        out = tmp_path / f"out{batch_size}"
        cli.main(["-C", str(cfg), "-M", str(ckpt), "-O", str(out), "--device", "cpu"])
        outputs[batch_size] = {i: read_wav(out / "enhanced" / f"utt{i}.wav")[0] for i in range(2)}
    for i, seconds in enumerate((0.5, 0.83)):
        wave = outputs[1][i]
        assert wave.shape == (int(seconds * 16000),) and np.isfinite(wave).all()
        assert abs(float(np.abs(wave).max()) - 0.8) <= 1 / 32768
        np.testing.assert_array_equal(outputs[4][i], wave)


def test_strategies_refuse_a_model_that_cannot_take_their_input(tmp_path):
    """The units of ``sub_band_crm_mask`` need the sub-band baseline; an
    unknown strategy names the six."""
    cfg, ckpt, _, _ = _port(tmp_path, "mag")
    text = cfg.read_text()
    cfg.write_text(text.replace('type = "mag"', 'type = "sub_band_crm_mask"'))
    with pytest.raises(ValueError, match="FullBandModel does not run under"):
        Inferencer(load_config(cfg), str(ckpt), None, device="cpu")
    cfg.write_text(text.replace('type = "mag"', 'type = "bogus"'))
    with pytest.raises(NotImplementedError, match="mag, scaled_mask, sub_band_crm_mask"):
        Inferencer(load_config(cfg), str(ckpt), None, device="cpu")
