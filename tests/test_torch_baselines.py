"""The port's full-band and sub-band baselines (FullBandModel,
SubBandBaseline) against the JAX package on the same weights: the forward
(fp32, LSTM and GRU; the full-band model's ``valid_frames``; both input
forms of the sub-band model, drop_band on), the weight bridge of each
family, a train step against the JAX Trainer, and the Inferencer
(batched for the full-band model, the exact path for the sub-band one).
The helpers here serve tests/test_torch_fast_fullsubnet.py too."""

import functools
import re
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.checkpoint import (
    _export_sequence_model,
    export_fast_fullsubnet,
    export_fullband,
    save_torch_checkpoint,
)
from fullsubnet_tpu.config import build_model as jax_build_model
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.infer.inferencer import Inferencer as JaxInferencer
from fullsubnet_tpu.models import FullBandModel as JaxFullBandModel
from fullsubnet_tpu.models import SubBandBaseline as JaxSubBandBaseline
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from fullsubnet_tpu_torch.config import build_model, load_config
from fullsubnet_tpu_torch.data.wavio import read_wav, write_wav
from fullsubnet_tpu_torch.infer.inferencer import Inferencer
from fullsubnet_tpu_torch.models import FullBandModel, SubBandBaseline
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_batched_inference import BATCH_ATOL, SECONDS, _recorded
from test_torch_fullsubnet import _jnp
from test_torch_inferencer import TINY_MODEL_TOML
from test_torch_train import (
    BF16_GRAD_RTOL,
    BF16_VS_FP32_GRAD_RTOL,
    FP32_GRAD_RTOL,
    _close_by_key,
    write_config,
)

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

# fp32 through the norm and the stacks; only the order of the sums differs
ATOL = 1e-5

# small widths, n_fft 320 (161 bins)
FULLBAND = dict(num_freqs=161, hidden_size=32, look_ahead=2, output_activate_function=None,
                norm_type="offline_laplace_norm")
SUBBAND = dict(num_neighbors=3, look_ahead=2, hidden_size=24, num_layers=2,
               output_activate_function=None, norm_type="offline_laplace_norm",
               num_groups_in_drop_band=2)


def model_section(path: str, args: dict) -> str:
    """A TOML [model] section."""
    def value(v):
        if v is None or v is False:
            return "false"
        if v is True:
            return "true"
        return f'"{v}"' if isinstance(v, str) else str(v)

    body = "\n".join(f"{k} = {value(v)}" for k, v in args.items())
    return f'[model]\npath = "{path}"\n[model.args]\n{body}\nweight_init = false\n\n'


def with_model(toml: str, section: str) -> str:
    """``toml`` with its [model] section replaced by ``section``."""
    return re.sub(r"\[model\]\n.*?(?=\n\[(?:trainer|inferencer)\]|\Z)",
                  lambda _: section.rstrip("\n"), toml, count=1, flags=re.S)


def family_train_config(tmp_path, section: str, use_amp: bool = False):
    """tests/test_torch_train.py's tiny train TOML with ``section`` as its
    model, on crops of 0.2 s (21 frames)."""
    cfg = write_config(tmp_path, use_amp=use_amp)
    toml = with_model(cfg.read_text(), section)
    cfg.write_text(toml.replace("sub_sample_length = 0.4", "sub_sample_length = 0.2"))
    return cfg


def _groups(model) -> int:
    return int(getattr(model, "num_groups_in_drop_band", 0) or 0)


def _jax_loss_fn(jt: JaxTrainer, use_bf16: bool):
    """The loss of the JAX Trainer's step for any family, as a function of
    the params (tests/test_torch_train.py's, with the drop_band gate read
    as the JAX Trainer reads it)."""
    from fullsubnet_tpu.acoustics.feature import drop_band
    from fullsubnet_tpu.acoustics.mask import build_complex_ideal_ratio_mask as cirm_of
    from fullsubnet_tpu.acoustics.stft import stft_complex

    a, model, groups = jt.acoustics, jt.model, _groups(jt.model)

    def loss_fn(params, noisy, clean):
        if use_bf16:
            params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        noisy_spec = stft_complex(noisy, a["n_fft"], a["hop_length"], a["win_length"])
        clean_spec = stft_complex(clean, a["n_fft"], a["hop_length"], a["win_length"])
        cirm = cirm_of(noisy_spec.real, noisy_spec.imag, clean_spec.real, clean_spec.imag)
        if groups > 1 and noisy.shape[0] > groups:
            cirm = jnp.transpose(drop_band(jnp.transpose(cirm, (0, 3, 1, 2)), groups),
                                 (0, 2, 3, 1))
        noisy_mag = jnp.abs(noisy_spec)[:, None]
        if use_bf16:
            noisy_mag = noisy_mag.astype(jnp.bfloat16)
        crm = model(params, noisy_mag, training=True)
        crm = jnp.transpose(crm, (0, 2, 3, 1)).astype(jnp.float32)
        return jt.loss_function(crm, cirm)

    return loss_fn


def check_train_step(tmp_path, section: str, use_amp: bool):
    """The port's Trainer against the JAX Trainer built from the same TOML,
    from the port's weights through the bridge: the loss and the pre-clip
    gradients of one batch, at bf16 against the JAX bf16 and fp32 ones, as
    ``test_train_step_matches_jax_trainer`` holds them. The clipping and
    Adam after them are the family's own in neither package, and that test
    holds them to the JAX Trainer's."""
    cfg = family_train_config(tmp_path, section, use_amp)
    port = Trainer(load_config(cfg), output_dir=str(tmp_path / "port"), device="cpu")
    jt = JaxTrainer(jax_load_config(cfg), output_dir=str(tmp_path / "jax"))
    jt.state["params"] = jax.tree.map(jnp.asarray,
                                      jax_params_from_state_dict(port.model.state_dict()))
    jt.state["opt_state"] = jt.optimizer.init(jt.state["params"])

    def by_key(params):
        return {k: v.numpy() for k, v in
                state_dict_from_jax_params(jax.device_get(params)).items()
                if k in dict(port.model.named_parameters())}

    port.train_loader.set_epoch(1)
    noisy, clean = next(iter(port.train_loader))
    args = (jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy()))
    # jitted: one XLA program compiles faster than the scans' eager dispatch
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jt, use_amp)))(
        jt.state["params"], *args)
    loss = port.compute_loss(noisy, clean)
    loss.backward()
    got = {k: p.grad.numpy() for k, p in port.model.named_parameters()}
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-2 if use_amp else 1e-5)
    if not use_amp:
        _close_by_key(got, by_key(want_grads), FP32_GRAD_RTOL)
        return
    _, fp32_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jt, False)))(jt.state["params"], *args)
    want32 = by_key(fp32_grads)
    _close_by_key(got, want32, BF16_VS_FP32_GRAD_RTOL)
    # against the JAX bf16 gradients: BF16_GRAD_RTOL beyond the JAX bf16
    # scan's own distance from its fp32 gradients, which is larger than that
    # for some tensors of these models (the sub-band baseline's bias
    # gradients, summed in bf16 over T·N rows: 18-20% of their largest
    # value), while the port stays within 2% of the fp32 ones
    for key, w in by_key(want_grads).items():
        scale = float(np.max(np.abs(want32[key]))) or 1.0
        own = float(np.max(np.abs(w - want32[key]))) / scale
        np.testing.assert_allclose(got[key], w, atol=(BF16_GRAD_RTOL + own) * scale, rtol=0,
                                   err_msg=key)


def jax_forward(model, params, mag, **kwargs):
    """The JAX model's forward, jitted (one XLA program compiles faster than
    the scans' eager dispatch); array keyword arguments are traced."""
    return np.asarray(jax.jit(lambda p, x, kw: model(p, x, **kw))(
        params, jnp.asarray(mag), {k: jnp.asarray(v) for k, v in kwargs.items()}))


def check_bridge_round_trip(model):
    """state dict -> JAX params -> state dict, every key and value kept."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    back = state_dict_from_jax_params(jax_params_from_state_dict(state))
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    return state


# --------------------------------------------------------------------------
# the full-band baseline
# --------------------------------------------------------------------------


def _fullband(cell, seed=0):
    config = {**FULLBAND, "sequence_model": cell}
    model = FullBandModel(**config, generator=torch.Generator().manual_seed(seed))
    return config, model, _jnp(jax_params_from_state_dict(model.state_dict()))


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("norm_type", ["offline_laplace_norm", "cumulative_laplace_norm"])
def test_fullband_matches_jax(cell, norm_type):
    config, model, params = _fullband(cell)
    config["norm_type"] = norm_type
    model.norm = type(model)(**config).norm
    mag = np.abs(np.random.default_rng(1).standard_normal((2, 1, 161, 23))).astype(np.float32)
    want = jax_forward(JaxFullBandModel(**config), params, mag)
    with torch.inference_mode():
        got = model(torch.from_numpy(mag)).numpy()
    assert got.shape == want.shape == (2, 2, 161, 23)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_fullband_valid_frames_matches_jax(cell):
    """Rows of 30, 17 and 6 real frames zero-padded to 30: against the JAX
    model with the same counts, and each row against its unpadded run."""
    config, model, params = _fullband(cell, seed=1)
    counts = np.array([30, 17, 6])
    mag = np.abs(np.random.default_rng(2).standard_normal((3, 1, 161, 30))).astype(np.float32)
    mag *= (np.arange(30) < counts[:, None])[:, None, None, :]
    want = jax_forward(JaxFullBandModel(**config), params, mag, valid_frames=counts)
    with torch.inference_mode():
        got = model(torch.from_numpy(mag), valid_frames=torch.from_numpy(counts)).numpy()
        alone = [model(torch.from_numpy(mag[b : b + 1, ..., :n])).numpy()
                 for b, n in enumerate(counts)]
    for b, n in enumerate(counts):
        np.testing.assert_allclose(got[b, ..., :n], want[b, ..., :n], atol=ATOL)
        np.testing.assert_allclose(got[b, ..., :n], alone[b][0], atol=ATOL)


# --------------------------------------------------------------------------
# the sub-band baseline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_subband_matches_jax_both_forms(cell):
    """[B, 1, F, T] with drop_band (B = 5 > 2 groups: 80 bands a sample,
    regrouped group-major) and without; the pre-unfolded [F, F_s, T] form."""
    config = {**SUBBAND, "sequence_model": cell}
    model = SubBandBaseline(**config, generator=torch.Generator().manual_seed(3))
    params = _jnp(jax_params_from_state_dict(model.state_dict()))
    jax_model = JaxSubBandBaseline(**config)
    rng = np.random.default_rng(4)
    mag = np.abs(rng.standard_normal((5, 1, 161, 19))).astype(np.float32)
    units = np.abs(rng.standard_normal((161, 7, 19))).astype(np.float32)
    for dropping in (True, False):
        want = jax_forward(functools.partial(jax_model, dropping_band=dropping), params, mag)
        with torch.inference_mode():
            got = model(torch.from_numpy(mag), dropping_band=dropping).numpy()
        assert got.shape == want.shape == ((5, 2, 80, 19) if dropping else (5, 2, 161, 19))
        np.testing.assert_allclose(got, want, atol=ATOL)
    want = jax_forward(jax_model, params, units)
    with torch.inference_mode():
        got = model(torch.from_numpy(units)).numpy()
    assert got.shape == want.shape == (161, 2, 19)
    np.testing.assert_allclose(got, want, atol=ATOL)


# --------------------------------------------------------------------------
# the families as the registry builds them
# --------------------------------------------------------------------------


RECIPES = {
    "fullband_baseline": "recipes/dns_interspeech_2020/fullband_baseline/train.toml",
    "subband_baseline": "recipes/dns_interspeech_2020/subband_baseline/train.toml",
    "fast_fullsubnet": "recipes/dns_interspeech_2020/fast_fullsubnet/train_shrinkSize2.toml",
}


def jax_export(family: str, params: dict) -> dict:
    """The JAX package's state dict of a family's params."""
    if family == "fullband_baseline":
        return export_fullband(params)
    if family == "fast_fullsubnet":
        return export_fast_fullsubnet(params)
    return _export_sequence_model(params["sb_model"], "sb_model")


@pytest.mark.parametrize("family", sorted(RECIPES))
def test_recipe_width_forward_matches_jax(family):
    """Each family at its recipe's full width (the train TOML's
    [model.args]), built by both registries, on 0.3 s of audio (19
    frames): the bridge's keys equal the JAX exporter's, and the forward
    matches."""
    from pathlib import Path

    config = load_config(Path(__file__).resolve().parents[1] / RECIPES[family])
    model, init = build_model(config, generator=torch.Generator().manual_seed(5))
    jax_model, _ = jax_build_model(config)
    state = check_bridge_round_trip(model)
    params = jax_params_from_state_dict(state)
    assert sorted(jax_export(family, params)) == sorted(state)
    mag = np.abs(np.random.default_rng(6).standard_normal((1, 1, 257, 19))).astype(np.float32)
    want = jax_forward(jax_model, _jnp(params), mag)
    with torch.inference_mode():
        got = model(torch.from_numpy(mag), dropping_band=False).numpy()
    assert got.shape == want.shape == (1, 2, 257, 19)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_amp", [False, True])
@pytest.mark.parametrize("family", ["fullband_baseline", "subband_baseline"])
def test_train_step_matches_jax_trainer(tmp_path, family, use_amp):
    args = FULLBAND if family == "fullband_baseline" else SUBBAND
    check_train_step(tmp_path, model_section(f"{family}.model.Model",
                                             {**args, "sequence_model": "LSTM"}), use_amp)


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------


def write_inference_setup(tmp_path, family: str, args: dict, seed: int = 7):
    """Noisy wavs of SECONDS (one shorter than n_fft // 2), a .tar of the
    family's seeded weights, and a TOML per batch size."""
    sr = 16000
    rng = np.random.default_rng(2)
    noisy_dir = tmp_path / "noisy_in"
    noisy_dir.mkdir()
    waves = {}
    for i, seconds in enumerate(SECONDS):
        t = np.arange(int(seconds * sr)) / sr
        wave = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav(noisy_dir / f"utt{i}.wav", wave.astype(np.float32), sr)
        waves[f"utt{i}"] = read_wav(noisy_dir / f"utt{i}.wav")[0]
    section = model_section(f"{family}.model.Model", args)
    model, _ = build_model(tomllib.loads(section), generator=torch.Generator().manual_seed(seed))
    ckpt = tmp_path / "ckpt.tar"
    if family == "subband_baseline":  # the JAX package has no writer for it
        torch.save({"model": model.state_dict()}, ckpt)
    else:
        extra = {}
        if family == "fast_fullsubnet":  # the filterbank the JAX writer regenerates
            extra = dict(num_freqs=args["encoder_input_size"], num_mels=args["num_mels"])
        save_torch_checkpoint(jax_params_from_state_dict(model.state_dict()), family, ckpt,
                              **extra)

    def config(batch_size):
        path = tmp_path / f"inference_{batch_size}.toml"
        toml = TINY_MODEL_TOML.format(noisy_dir=noisy_dir, strategy="full_band_crm_mask",
                                      batch_size=batch_size)
        path.write_text(with_model(toml, section))
        return path

    return {"waves": waves, "ckpt": ckpt, "config": config, "tmp": tmp_path}


def check_batched_inference(setup, batched: bool):
    """``batch_size = 4`` against ``batch_size = 1`` and, for the models the
    JAX Inferencer loads, against it; ``batched`` says whether the port's
    batched path must run (the ``bucketed_capable`` models) or the exact
    path at any batch size (the JAX package has no checkpoint converter for
    the sub-band baseline, so that one is held to its batch-one run)."""
    s = setup
    port4 = Inferencer(load_config(s["config"](4)), str(s["ckpt"]), str(s["tmp"] / "port4"),
                       device="cpu")
    flushes = []
    enhance_bucket = port4.enhance_bucket
    port4.enhance_bucket = lambda waves, bucket: (flushes.append((len(waves), bucket)),
                                                  enhance_bucket(waves, bucket))[1]
    got = _recorded(port4)
    one = _recorded(Inferencer(load_config(s["config"](1)), str(s["ckpt"]),
                               str(s["tmp"] / "port1"), device="cpu"))
    want = one
    if batched:
        jax_inf = JaxInferencer(jax_load_config(s["config"](4)), str(s["ckpt"]),
                                str(s["tmp"] / "jax"))
        want = {}
        jax_write = jax_inf._write_outputs
        jax_inf._write_outputs = lambda e, n, name: (
            want.__setitem__(name, np.asarray(e, np.float32)), jax_write(e, n, name))
        jax_inf()
    assert sorted(flushes) == ([(3, 32000), (4, 16000)] if batched else [])
    assert sorted(got) == sorted(one) == sorted(want) == sorted(s["waves"])
    for name, noisy in s["waves"].items():
        assert got[name].shape == noisy.shape
        np.testing.assert_allclose(got[name], one[name], atol=BATCH_ATOL, err_msg=name)
        np.testing.assert_allclose(got[name], want[name], atol=BATCH_ATOL, err_msg=name)


def test_fullband_batched_inferencer_matches_batch_one_and_jax(tmp_path):
    check_batched_inference(write_inference_setup(tmp_path, "fullband_baseline",
                                                  {**FULLBAND, "sequence_model": "LSTM"}),
                            batched=True)


def test_subband_takes_the_exact_path_at_any_batch_size(tmp_path):
    check_batched_inference(write_inference_setup(tmp_path, "subband_baseline",
                                                  {**SUBBAND, "sequence_model": "LSTM"}),
                            batched=False)
