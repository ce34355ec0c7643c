"""The port's Improved FullSubNet against the JAX package on the same
weights: the STFT pair at the 48 kHz recipe's n_fft and the iSTFT's frame
mask, the strided unfold of every section of both recipes' layouts, the
wave-to-wave forward (16 kHz: 3 sections; 48 kHz: 4) and ``valid_samples``,
the weight bridge, a train step and the validation loss against the JAX
Trainer, the ``time_domain`` (exact and batched) and ``overlapped_chunk``
strategies against the JAX Inferencer, and each recipe at its full width.
The JAX references run under ``jax.jit``."""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics.stft import istft as eager_jax_istft
from fullsubnet_tpu.acoustics.stft import stft_complex as eager_jax_stft
from fullsubnet_tpu.checkpoint import (
    export_fullsubnet,
    export_improved_fullsubnet,
    save_torch_checkpoint,
)
from fullsubnet_tpu.config import acoustics_args as jax_acoustics_args
from fullsubnet_tpu.config import build_loss as jax_build_loss
from fullsubnet_tpu.config import build_model as jax_build_model
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu.models import ImprovedFullSubNet as JaxImprovedFullSubNet
from fullsubnet_tpu.models.improved_fullsubnet import _strided_freq_unfold as eager_jax_unfold
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.acoustics.stft import istft, stft_complex
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from fullsubnet_tpu_torch.config import build_model, load_config
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
from fullsubnet_tpu_torch.infer.inferencer import Inferencer
from fullsubnet_tpu_torch.models import FullSubNet, ImprovedFullSubNet, is_wave_to_wave
from fullsubnet_tpu_torch.models.improved_fullsubnet import _strided_freq_unfold
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_baselines import check_bridge_round_trip, jax_forward, model_section, with_model
from test_torch_batched_inference import BATCH_ATOL, _recorded
from test_torch_fullsubnet import TINY, _jnp
from test_torch_inferencer import TINY_MODEL_TOML
from test_torch_train import (
    BF16_VS_FP32_GRAD_RTOL,
    FP32_GRAD_RTOL,
    _close_by_key,
    write_config,
)

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RECIPES = {16000: REPO / "recipes/dns_interspeech_2020/improved_fullsubnet/train_16k.toml",
           48000: REPO / "recipes/dns_interspeech_2020/improved_fullsubnet/train_48k.toml"}

# fp32 through the STFT, the norms, the stacks and the iSTFT; only the order
# of the sums differs
ATOL = 1e-5

# the recipes' layouts (acoustics and sections) at small stack widths
LAYOUTS = {
    16000: dict(n_fft=512, hop_length=128, win_length=512, num_freqs=257,
                freq_cutoffs=[20, 80], sb_num_center_freqs=[1, 4, 8],
                sb_num_neighbor_freqs=[15, 15, 15], fb_num_center_freqs=[1, 4, 8],
                fb_num_neighbor_freqs=[15, 15, 15]),
    48000: dict(n_fft=960, hop_length=480, win_length=960, num_freqs=481,
                freq_cutoffs=[20, 120, 240], sb_num_center_freqs=[1, 4, 20, 60],
                sb_num_neighbor_freqs=[15, 15, 15, 15], fb_num_center_freqs=[1, 4, 20, 60],
                fb_num_neighbor_freqs=[15, 15, 15, 15]),
}
SMALL = dict(fb_hidden_size=16, sb_hidden_size=12, fdrc=0.5, sequence_model="LSTM",
             fb_output_activate_function=None, sb_output_activate_function=None,
             norm_type="offline_laplace_norm")


# the JAX functions jitted: one XLA program runs faster here than the eager
# dispatch of its many small operations
jax_stft = jax.jit(eager_jax_stft, static_argnums=(1, 2, 3))
jax_istft = jax.jit(eager_jax_istft, static_argnums=(1, 2, 3), static_argnames=("length",))
jax_unfold = jax.jit(eager_jax_unfold, static_argnums=(1, 2, 3, 4))


def _improved(sr=16000, seed=0, **changes):
    config = {**LAYOUTS[sr], **SMALL, **changes}
    model = ImprovedFullSubNet(**config, generator=torch.Generator().manual_seed(seed))
    return config, model, _jnp(jax_params_from_state_dict(model.state_dict()))


def _waves(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------------------
# the acoustics
# --------------------------------------------------------------------------


def test_stft_pair_at_960_matches_jax():
    """n_fft = win = 960, hop 480 (481 bins), the 48 kHz recipe's."""
    y = _waves((2, 4321), 0)
    want = np.asarray(jax_stft(jnp.asarray(y), 960, 480, 960))
    got = stft_complex(torch.from_numpy(y), 960, 480, 960)
    assert got.shape == want.shape == (2, 481, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    back = istft(got, 960, 480, 960, length=4321).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_istft(jnp.asarray(want), 960, 480, 960,
                                                          length=4321)), atol=ATOL)
    np.testing.assert_allclose(back, y, atol=ATOL)


@pytest.mark.parametrize("n_fft, hop", [(512, 128), (960, 480)])
def test_masked_istft_matches_jax(n_fft, hop):
    """A per-row [B, T'] and a shared [T'] frame mask: masked frames add
    neither signal nor envelope, so each row's first samples equal the iSTFT
    of its unpadded spectrum (where ``torch.istft`` over all frames would
    not, as n_fft / 2 > hop at 16 kHz). Compared where at least two frames
    overlap, up to (count - 1)·hop + n_fft / 2 - hop: past it only the last
    frame's window tail is left, near 0 in signal and envelope alike, and
    the quotient of the two amplifies each package's rounding."""
    y = _waves((3, 6000), 1)
    spec = stft_complex(torch.from_numpy(y), n_fft, hop, n_fft)
    t = spec.shape[-1]
    masks = {"rows": np.array([t, t - 9, 4]), "shared": np.array([t - 5] * 3)}
    for form, counts in masks.items():
        mask = (np.arange(t) < counts[:, None]).astype(np.float32)
        mask = mask if form == "rows" else mask[0]
        got = istft(spec, n_fft, hop, n_fft, length=6000,
                    frame_mask=torch.from_numpy(mask)).numpy()
        want = np.asarray(jax_istft(jnp.asarray(spec.numpy()), n_fft, hop, n_fft, length=6000,
                                    frame_mask=jnp.asarray(mask)))
        for b, count in enumerate(counts):
            end = min(6000, (count - 1) * hop + n_fft // 2 - hop)
            np.testing.assert_allclose(got[b, :end], want[b, :end], atol=ATOL)
            samples = (count - 1) * hop
            alone = istft(spec[b, :, :count], n_fft, hop, n_fft, length=samples).numpy()
            np.testing.assert_allclose(got[b, :samples], alone, atol=ATOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _sections(sr):
    layout = LAYOUTS[sr]
    cuts = [0, *layout["freq_cutoffs"], layout["num_freqs"] - 1]
    return [(sr, lo, hi, c) for lo, hi, c in zip(cuts, cuts[1:], layout["sb_num_center_freqs"])]


@pytest.mark.parametrize("sr, lower, upper, center", _sections(16000) + _sections(48000))
def test_strided_unfold_matches_jax(sr, lower, upper, center):
    """Every section of both recipes' layouts at their real F (256, 480):
    the edge sections reflect-padded, the interior ones reading their
    neighbours; equal, not close."""
    f = LAYOUTS[sr]["num_freqs"] - 1
    x = _waves((2, 1, f, 5), 2)
    got = _strided_freq_unfold(torch.from_numpy(x), lower, upper, center, 15).numpy()
    want = np.asarray(jax_unfold(jnp.asarray(x), lower, upper, center, 15))
    assert got.shape == want.shape == (2, (upper - lower) // center, 1, center + 30, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr, cell, norm_type", [
    (16000, "LSTM", "offline_laplace_norm"),
    (48000, "LSTM", "offline_laplace_norm"),
    (16000, "GRU", "cumulative_laplace_norm"),
])
def test_improved_matches_jax(sr, cell, norm_type):
    """0.3 s of audio in two rows: the waveform within ATOL."""
    config, model, params = _improved(sr, seed=3, sequence_model=cell, norm_type=norm_type)
    assert len(model.sb_model.sb_models) == len(LAYOUTS[sr]["sb_num_center_freqs"])
    y = _waves((2, int(0.3 * sr)), 4)
    want = jax_forward(JaxImprovedFullSubNet(**config), params, y)
    with torch.inference_mode():
        got = model(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (2, 1, y.shape[1])
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("form, sr", [
    pytest.param(form, sr, id=form if sr == 16000 else f"{form}-{sr}")
    for sr in (16000, 48000) for form in ("scalar", "vector")])
def test_valid_samples_matches_jax_and_the_unpadded_run(form, sr):
    """Rows of 0.3 s at most, zero-padded to one bucket with their true
    sample counts (one count for all rows, or a [B] vector): each row's
    first L samples, all of them, against its unpadded run and against the
    JAX model's ``valid_samples`` output. At 48 kHz (hop = n_fft / 2) the
    samples past the last frame's centre are the last frame's alone."""
    config, model, params = _improved(sr, seed=5)
    n_fft, most = config["n_fft"], int(0.3 * sr)
    counts = np.array([most] * 2) if form == "scalar" else np.array([most, most * 5 // 8 + 1,
                                                                     most * 7 // 48])
    y = _waves((len(counts), most), 6)
    padded = np.zeros((len(counts), most + n_fft), np.float32)
    for b, n in enumerate(counts):
        padded[b, :n] = y[b, :n]
    arg = counts[0] if form == "scalar" else counts
    want = jax_forward(JaxImprovedFullSubNet(**config), params, padded, valid_samples=arg)
    with torch.inference_mode():
        got = model(torch.from_numpy(padded), valid_samples=torch.as_tensor(arg)).numpy()
        alone = [model(torch.from_numpy(y[b : b + 1, :n])).numpy() for b, n in enumerate(counts)]
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, 0, :n], want[b, 0, :n], atol=ATOL)
        np.testing.assert_allclose(got[b, 0, :n], alone[b][0, 0], atol=ATOL)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_bridge_round_trips_the_sections(sr):
    """3 and 4 sections: the state dict holds ``export_improved_fullsubnet``'s
    keys and survives the bridge both ways; a FullSubNet tree, whose tops
    are the same, is still read as FullSubNet."""
    _, model, _ = _improved(sr)
    state = check_bridge_round_trip(model)
    params = jax_params_from_state_dict(state)
    assert len(params["sb_model"]["sb_models"]) == len(LAYOUTS[sr]["sb_num_center_freqs"])
    export = export_improved_fullsubnet(params)
    assert sorted(export) == sorted(state)
    for key, value in export.items():
        np.testing.assert_array_equal(value, state[key].numpy())
    flagship = FullSubNet(**TINY).state_dict()
    tree = jax_params_from_state_dict(flagship)
    assert sorted(tree["sb_model"]) == ["fc", "rnn"]
    assert sorted(state_dict_from_jax_params(tree)) == sorted(export_fullsubnet(tree))


# --------------------------------------------------------------------------
# training and validation
# --------------------------------------------------------------------------


def _train_config(tmp_path, use_amp):
    """tests/test_torch_train.py's tiny train TOML with the 16 kHz layout's
    acoustics and SI-SNR loss, and a small Improved FullSubNet."""
    cfg = write_config(tmp_path, use_amp=use_amp)
    toml = with_model(cfg.read_text(), model_section("improved_fullsubnet.model.Model",
                                                     {**LAYOUTS[16000], **SMALL}))
    toml = toml.replace("n_fft = 320\nwin_length = 320", "n_fft = 512\nwin_length = 512")
    toml = toml.replace("hop_length = 160", "hop_length = 128")
    cfg.write_text(toml.replace('name = "mse_loss"', 'name = "si_snr_loss"'))
    return cfg


def _jax_waveform_loss_fn(jt, use_bf16: bool):
    """The loss of the JAX Trainer's step for a wave-to-wave model
    (``trainer.py:254-264``) as a function of the params."""
    def loss_fn(params, noisy, clean):
        if use_bf16:
            params = jax.tree.map(
                lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, params)
        enhanced = jt.model(params, noisy, training=True)[:, 0]
        return jt.loss_function(enhanced.astype(jnp.float32), clean)

    return loss_fn


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The port's Trainer of one tiny TOML, and what the JAX Trainer's step
    and enhance function read of the same TOML (its model, loss and
    acoustics; the JAX model's own init is not needed), on the port's
    weights through the bridge."""
    tmp_path = tmp_path_factory.mktemp("train")
    cfg = _train_config(tmp_path, False)
    port = Trainer(load_config(cfg), output_dir=str(tmp_path / "port"), device="cpu")
    config = jax_load_config(cfg)
    jt = types.SimpleNamespace(
        model=jax_build_model(config)[0], loss_function=jax_build_loss(config),
        acoustics=jax_acoustics_args(config), _is_waveform_model=lambda: True,
        params=jax.tree.map(jnp.asarray, jax_params_from_state_dict(port.model.state_dict())))
    # the step's loss and gradients by policy (use_bf16), jitted: one XLA
    # program compiles faster than the scans' eager dispatch, once a policy
    jt.step = {bf16: jax.jit(jax.value_and_grad(_jax_waveform_loss_fn(jt, bf16)))
               for bf16 in (False, True)}
    return port, jt


def _as_the_kernels_round(params):
    """The JAX params as the bf16 policy leaves them for the fused kernels
    (JAX ``ops/subband_lstm.py:_prep_weights``, which the port's
    ``prep_weights`` follows): every weight rounded to bf16, and an LSTM
    layer's fused bias b_ih + b_hh summed in bf16 (kept in b_ih, b_hh 0).
    The JAX CPU scan that the JAX Trainer runs here keeps that sum in fp32."""
    def bf16(v):
        return v.astype(jnp.bfloat16)

    def stack(p):
        rnn = [[{"w_ih": bf16(l["w_ih"]), "w_hh": bf16(l["w_hh"]),
                 "b_ih": bf16(l["b_ih"]) + bf16(l["b_hh"]), "b_hh": jnp.zeros_like(l["b_hh"])}
                for l in layer] for layer in p["rnn"]]
        return jax.tree.map(lambda v: v.astype(jnp.float32),
                            {**p, "rnn": rnn, "fc": jax.tree.map(bf16, p["fc"])})

    return {"fb_model": stack(params["fb_model"]),
            "sb_model": {"sb_models": [stack(p) for p in params["sb_model"]["sb_models"]]}}


# use_amp against the JAX Trainer's own bf16 step: its CPU scan sums each
# LSTM bias pair in fp32 where the port (and the JAX kernels) round the sum
# to bf16, so the two steps compute on slightly other biases. Measured on
# this test: loss 7.4e-5 apart, gradients 1.8e-2 of a tensor's largest.
AMP_VS_JAX_LOSS_RTOL = 1e-3
# use_amp against the JAX fp32 step on the weights rounded as the kernels
# round them (``_as_the_kernels_round``): fp32 on both sides, but the port
# rounds each weight's gradient to bf16 on its way back to the fp32 master
# (2^-8 of a value at most). Measured on this test: loss 1.4e-7 apart,
# gradients 3.8e-3 of a tensor's largest.
AMP_GRAD_RTOL = FP32_GRAD_RTOL + 2.0**-8


def _grads_by_key(grads, names) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.device_get(grads)).items()
            if k in names}


@pytest.mark.parametrize("use_amp", [False, True])
def test_train_step_matches_jax_trainer(trainers, use_amp):
    """The waveform step: the SI-SNR loss of one batch and the gradients
    before clipping. Under use_amp, against the JAX Trainer's bf16 step and
    against the JAX fp32 step on the kernels' rounding of the weights."""
    port, jt = trainers
    port.use_amp = use_amp
    port.model.zero_grad(set_to_none=True)
    port.train_loader.set_epoch(1)
    noisy, clean = next(iter(port.train_loader))
    args = (jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy()))
    want_loss, want_grads = jt.step[use_amp](jt.params, *args)
    loss = port.compute_loss(noisy, clean)
    loss.backward()
    names = dict(port.model.named_parameters())
    got = {k: p.grad.numpy() for k, p in names.items()}
    want = _grads_by_key(want_grads, names)
    if not use_amp:
        np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
        _close_by_key(got, want, FP32_GRAD_RTOL)
        return
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=AMP_VS_JAX_LOSS_RTOL)
    _close_by_key(got, want, BF16_VS_FP32_GRAD_RTOL)
    rounded_loss, rounded_grads = jt.step[False](_as_the_kernels_round(jt.params), *args)
    np.testing.assert_allclose(float(loss.detach()), float(rounded_loss), rtol=1e-5)
    want = _grads_by_key(rounded_grads, names)
    for key in want:  # the fused bias's gradient reaches both biases
        if "bias_hh" in key:
            want[key] = want[key.replace("bias_hh", "bias_ih")]
    _close_by_key(got, want, AMP_GRAD_RTOL)


def test_enhance_utterance_matches_jax(trainers):
    """Validation's enhancement and loss, criterion(enhanced, clean), against
    the JAX Trainer's enhance function on one utterance."""
    port, jt = trainers
    noisy, clean = _waves((2, 7000), 7)
    enhanced, loss = port._enhance_utterance(noisy, clean)
    want_wave, want_loss = JaxTrainer._build_enhance_fn(jt)(jt.params, jnp.asarray(noisy[None]),
                                                             jnp.asarray(clean[None]))
    np.testing.assert_allclose(enhanced, np.asarray(want_wave)[0], atol=ATOL)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

INFER_TOML = """
[acoustics]
n_fft = 512
win_length = 512
sr = 16000
hop_length = 128

[inferencer]
path = "inferencer.Inferencer"
type = "{strategy}"
batch_size = {batch_size}
[inferencer.args]
chunk_length = 0.25

[dataset]
path = "dataset_inference.Dataset"
[dataset.args]
dataset_dir_list = ["{noisy_dir}"]
sr = 16000
"""


def _inference_setup(tmp_path, seconds):
    """Noisy wavs of ``seconds``, a .tar of seeded weights written by the
    JAX package, and a TOML per (strategy, batch size)."""
    noisy_dir = tmp_path / "noisy_in"
    noisy_dir.mkdir()
    waves = {}
    for i, s in enumerate(seconds):
        write_wav(noisy_dir / f"utt{i}.wav", _waves(int(s * 16000), 10 + i) * 3, 16000)
        waves[f"utt{i}"] = read_wav(noisy_dir / f"utt{i}.wav")[0]
    section = model_section("improved_fullsubnet.model.Model", {**LAYOUTS[16000], **SMALL})
    _, model, _ = _improved(seed=8)
    ckpt = tmp_path / "ckpt.tar"
    save_torch_checkpoint(jax_params_from_state_dict(model.state_dict()), "improved_fullsubnet",
                          ckpt)

    def run(package, strategy, batch_size):
        path = tmp_path / f"inference_{strategy}_{batch_size}.toml"
        path.write_text(INFER_TOML.format(strategy=strategy, batch_size=batch_size,
                                          noisy_dir=noisy_dir) + "\n" + section)
        out = tmp_path / f"{package}_{strategy}_{batch_size}"
        if package == "port":
            return _recorded(Inferencer(load_config(path), str(ckpt), str(out), device="cpu"))
        jax_inf = JaxInferencer(jax_load_config(path), str(ckpt), str(out))
        return _recorded(jax_inf)

    return waves, run


def test_time_domain_inferencer_matches_batch_one_and_jax(tmp_path):
    """``time_domain`` at ``batch_size = 4`` (two buckets of 1 and 2 s, a
    partial flush each; 0.006 s takes the exact path) against the port's
    exact path at ``batch_size = 1`` and against the JAX Inferencer's
    batched path."""
    waves, run = _inference_setup(tmp_path, (0.5, 1.2, 0.006, 0.8, 1.6, 0.3))
    port4 = run("port", "time_domain", 4)
    port1 = run("port", "time_domain", 1)
    want = run("jax", "time_domain", 4)
    for name, noisy in waves.items():
        assert port4[name].shape == port1[name].shape == noisy.shape
        np.testing.assert_allclose(port4[name], port1[name], atol=BATCH_ATOL, err_msg=name)
        np.testing.assert_allclose(port4[name], want[name], atol=BATCH_ATOL, err_msg=name)


def test_overlapped_chunk_matches_jax(tmp_path):
    """Chunks of 0.25 s (4000 samples, a hop of 2000): an utterance of 3000
    samples, shorter than a chunk (its short tail kept), and one of 9000,
    whose last two chunks are partial (3000 and 1000 samples)."""
    waves, run = _inference_setup(tmp_path, (0.5625, 0.1875))
    got = run("port", "overlapped_chunk", 1)
    want = run("jax", "overlapped_chunk", 1)
    for name, noisy in waves.items():
        assert got[name].shape == noisy.shape
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)


def test_strategies_refuse_the_other_kind_of_model(tmp_path):
    """``time_domain`` and ``overlapped_chunk`` take a wave-to-wave model
    only, ``full_band_crm_mask`` a mask model only."""
    _, run = _inference_setup(tmp_path, (0.5,))
    with pytest.raises(ValueError, match="full_band_crm_mask"):
        run("port", "full_band_crm_mask", 1)
    ckpt = tmp_path / "fullsubnet.tar"
    torch.save({"model": FullSubNet(**TINY).state_dict()}, ckpt)
    cfg = tmp_path / "fullsubnet_time_domain.toml"
    cfg.write_text(TINY_MODEL_TOML.format(noisy_dir=tmp_path, strategy="time_domain",
                                          batch_size=1))
    with pytest.raises(ValueError, match="time_domain"):
        Inferencer(load_config(cfg), str(ckpt), None, device="cpu")
    assert is_wave_to_wave(_improved()[1]) and not is_wave_to_wave(FullSubNet(**TINY))


# --------------------------------------------------------------------------
# the recipes at full width
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sr", [16000, 48000])
def test_recipe_width_forward_matches_jax(sr):
    """Each recipe's model as both registries build it, at its full width,
    on 0.05 s of audio: the keys and shapes of ``export_improved_fullsubnet``
    and the waveform."""
    config = load_config(RECIPES[sr])
    model, init = build_model(config, generator=torch.Generator().manual_seed(9))
    assert isinstance(model, ImprovedFullSubNet) and init == {"weight_init": True}
    jax_model, _ = jax_build_model(config)
    state = check_bridge_round_trip(model)
    params = jax_params_from_state_dict(state)
    export = export_improved_fullsubnet(params)
    assert sorted(export) == sorted(state)
    assert all(np.shape(v) == tuple(state[k].shape) for k, v in export.items())
    y = _waves((1, int(0.05 * sr)), 11)
    want = jax_forward(jax_model, _jnp(params), y)
    with torch.inference_mode():
        got = model(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (1, 1, y.shape[1])
    np.testing.assert_allclose(got, want, atol=ATOL)
