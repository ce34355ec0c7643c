"""The port's training step, Trainer and train CLI on the CPU, against the
JAX package's Trainer built from the same tiny TOML (the
tests/test_trainer_validation.py style, without a validation section),
started from the same weights through the weight bridge and fed the same
batches."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.acoustics.feature import drop_band as jax_drop_band
from fullsubnet_tpu.acoustics.mask import build_complex_ideal_ratio_mask as jax_cirm
from fullsubnet_tpu.acoustics.stft import stft_complex as jax_stft
from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.parallel.mesh import shard_batch
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.checkpoint import (
    jax_params_from_state_dict,
    load_torch_state_dict,
    state_dict_from_jax_params,
)
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.train import cli
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_fullsubnet import TINY, tiny_params
from test_torch_train_data import write_lists

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

TOML = """
[meta]
save_dir = "{save_dir}"
seed = 0
use_amp = {use_amp}

[acoustics]
n_fft = 320
win_length = 320
sr = 16000
hop_length = 160

[loss_function]
name = "mse_loss"
[loss_function.args]

[optimizer]
lr = 0.001
beta1 = 0.9
beta2 = 0.999

[train_dataset]
path = "dataset_train.Dataset"
[train_dataset.args]
clean_dataset = "{clean}"
noise_dataset = "{noise}"
rir_dataset = "{rir}"
reverb_proportion = 0.5
silence_length = 0.05
snr_range = [-5, 20]
sr = 16000
sub_sample_length = 0.4
target_dB_FS = -25
target_dB_FS_floating_value = 10

[train_dataset.dataloader]
batch_size = 4
num_workers = 0
drop_last = true

[model]
path = "fullsubnet.model.Model"
[model.args]
sb_num_neighbors = 3
fb_num_neighbors = 0
num_freqs = 161
look_ahead = 2
sequence_model = "{sequence_model}"
fb_output_activate_function = "ReLU"
sb_output_activate_function = false
fb_model_hidden_size = 32
sb_model_hidden_size = 24
weight_init = false
norm_type = "offline_laplace_norm"
num_groups_in_drop_band = 2

[trainer]
path = "trainer.Trainer"
[trainer.train]
clip_grad_norm_value = 10
epochs = {epochs}
save_checkpoint_interval = 1
grad_accum_steps = 1
[trainer.validation]
save_max_metric_score = true
validation_interval = {validation_interval}
[trainer.mesh]
data = 1
{extra}
"""

# use_amp = false: fp32 on both sides through the STFT, the norms, both
# LSTM stages and the loss; only the order of the sums differs
FP32_GRAD_RTOL = 1e-3
# use_amp = true: bf16 params and magnitudes on both sides, but the two
# round at other points. The JAX CPU path runs the full-band stage as an
# XLA scan in bf16 throughout, so its gradients there stray from its own
# fp32 ones by about a tenth of their largest value; the port's op
# computes in fp32 from the bf16 values and strays less. So the port is
# held to the JAX bf16 gradients within 15%, and to the JAX fp32 ones
# within 5%.
BF16_GRAD_RTOL = 0.15
BF16_VS_FP32_GRAD_RTOL = 0.05


def write_config(tmp_path, use_amp=False, epochs=2, validation_interval=1, extra="",
                 sequence_model="LSTM"):
    clean, noise, rir = write_lists(tmp_path / "data")
    path = tmp_path / "tiny_train.toml"
    path.write_text(TOML.format(
        save_dir=tmp_path / "exp", use_amp=str(use_amp).lower(), clean=clean, noise=noise,
        rir=rir, epochs=epochs, validation_interval=validation_interval, extra=extra,
        sequence_model=sequence_model,
    ))
    return path


def _jax_loss_fn(jt: JaxTrainer, use_bf16: bool):
    """The loss of the JAX Trainer's step (``trainer.py:254-284``) as a
    function of the params, to take its gradients before clipping."""
    a = jt.acoustics
    model, groups = jt.model, jt.model.num_groups_in_drop_band

    def loss_fn(params, noisy, clean):
        if use_bf16:
            params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        noisy_spec = jax_stft(noisy, a["n_fft"], a["hop_length"], a["win_length"])
        clean_spec = jax_stft(clean, a["n_fft"], a["hop_length"], a["win_length"])
        cirm = jax_cirm(noisy_spec.real, noisy_spec.imag, clean_spec.real, clean_spec.imag)
        if groups > 1 and noisy.shape[0] > groups:
            cirm = jnp.transpose(jax_drop_band(jnp.transpose(cirm, (0, 3, 1, 2)), groups),
                                 (0, 2, 3, 1))
        noisy_mag = jnp.abs(noisy_spec)[:, None]
        if use_bf16:
            noisy_mag = noisy_mag.astype(jnp.bfloat16)
        crm = model(params, noisy_mag, training=True)
        crm = jnp.transpose(crm, (0, 2, 3, 1)).astype(jnp.float32)
        return jt.loss_function(crm, cirm)

    return loss_fn


def _by_key(jax_params) -> dict:
    """A JAX FullSubNet pytree -> numpy arrays under the state-dict keys."""
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.device_get(jax_params)).items()}


def _close_by_key(got: dict, want: dict, rtol: float):
    """Each tensor within ``rtol`` of the largest magnitude of its reference."""
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key], np.float32)
        scale = float(np.max(np.abs(w))) or 1.0
        np.testing.assert_allclose(np.asarray(got[key], np.float32), w, atol=rtol * scale,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("sequence_model", ["LSTM", "GRU"])
@pytest.mark.parametrize("use_amp", [False, True])
def test_train_step_matches_jax_trainer(tmp_path, use_amp, sequence_model):
    """The loss and the pre-clip gradients of one batch, then the params
    after three steps (after one Adam step the update is only about
    ±lr·sign(g), which would say little)."""
    cfg_path = write_config(tmp_path, use_amp=use_amp, sequence_model=sequence_model)
    port = Trainer(load_config(cfg_path), output_dir=str(tmp_path / "port"), device="cpu")
    jt = JaxTrainer(jax_load_config(cfg_path), output_dir=str(tmp_path / "jax"))
    # the same weights: the port's, through the bridge
    start = jax_params_from_state_dict(port.model.state_dict())
    jt.state["params"] = jax.tree.map(jnp.asarray, start)
    jt.state["opt_state"] = jt.optimizer.init(jt.state["params"])

    port.train_loader.set_epoch(1)
    batches = [(n, c) for n, c in port.train_loader][:3]
    assert len(batches) == 2  # 8 clean files, batch 4, drop_last
    batches.append(batches[0])
    noisy, clean = batches[0]
    assert noisy.shape == (4, 6400)

    want_loss, want_grads = jax.value_and_grad(_jax_loss_fn(jt, use_amp))(
        jt.state["params"], jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
    )
    loss = port.compute_loss(noisy, clean)
    loss.backward()
    got_grads = {k: p.grad.numpy() for k, p in port.model.named_parameters()}
    rtol = BF16_GRAD_RTOL if use_amp else FP32_GRAD_RTOL
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-2 if use_amp else 1e-5)
    assert all(g.dtype == np.float32 for g in got_grads.values())
    _close_by_key(got_grads, _by_key(want_grads), rtol)
    if use_amp:
        _, fp32_grads = jax.value_and_grad(_jax_loss_fn(jt, False))(
            jt.state["params"], jnp.asarray(noisy.numpy()), jnp.asarray(clean.numpy())
        )
        _close_by_key(got_grads, _by_key(fp32_grads), BF16_VS_FP32_GRAD_RTOL)
        return  # three bf16 steps would compare rounding, not the port

    state = jt.state
    for n, c in batches:
        port.train_step(n, c)
        state, _ = jt._train_step(state, *shard_batch((jnp.asarray(n.numpy()),
                                                        jnp.asarray(c.numpy())), jt.mesh))
    want = _by_key(state["params"])
    got = {k: v.detach().numpy() for k, v in port.model.state_dict().items()}
    # where a gradient is near zero, Adam's first steps amplify the order
    # of the sums into up to lr; hold the params to a tenth of lr
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_weight_bridge_round_trip(cell):
    params = tiny_params(5, cell)
    back = jax_params_from_state_dict(state_dict_from_jax_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_cli_trains_two_epochs_and_resumes(tmp_path):
    cfg = write_config(tmp_path, epochs=2)
    out = tmp_path / "runs"
    trainer = cli.main(["-C", str(cfg), "-O", str(out), "--device", "cpu"])
    ckpt = out / "tiny_train" / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "best_model.tar", "latest_model.tar", "model_0001.pth", "model_0002.pth",
    ]
    assert trainer.steps == 4 and set(trainer.epoch_losses) == {1, 2}
    assert all(np.isfinite(v) for v in trainer.epoch_losses.values())
    latest = torch.load(ckpt / "latest_model.tar", weights_only=True)
    assert sorted(latest) == ["best_score", "epoch", "model", "optimizer"]
    assert latest["epoch"] == 2
    # model_NNNN.pth holds the weights alone, in the reference keys
    weights = load_torch_state_dict(ckpt / "model_0002.pth")
    assert sorted(weights) == sorted(trainer.model.state_dict())

    # -R with epochs = 3 starts at epoch 3, from the saved state
    cfg.write_text(cfg.read_text().replace("epochs = 2", "epochs = 3"))
    resumed = cli.main(["-C", str(cfg), "-O", str(out), "--device", "cpu", "-R"])
    assert resumed.steps == 2 and set(resumed.epoch_losses) == {3}
    assert (ckpt / "model_0003.pth").exists()
    # -P loads the epoch-2 weights into a fresh trainer
    warm = tmp_path / "warm"
    preloaded = Trainer(load_config(cfg), preloaded_model_path=str(ckpt / "model_0002.pth"),
                        output_dir=str(warm), device="cpu")
    for key, value in weights.items():
        assert torch.equal(preloaded.model.state_dict()[key], value)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    cfg = write_config(tmp_path)
    for device in ([], ["--device", "cuda"]):  # cuda is the default
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["-C", str(cfg), "-O", str(tmp_path / "x"), *device])
    assert not (tmp_path / "x").exists()  # refused before any output


def test_train_cli_import_leaves_jax_out():
    """The train CLI imports torch and never JAX, nor the JAX package."""
    code = (
        "import sys\n"
        "import fullsubnet_tpu_torch.train.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fullsubnet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


VALIDATION = """
[validation_dataset]
path = "dataset_validation.Dataset"
[validation_dataset.args]
dataset_dir_list = ["{val}"]
sr = 16000
"""


@pytest.mark.parametrize(
    "kwargs, item",
    [
        (dict(validation_interval=1, extra=VALIDATION), "A.19"),
        (dict(extra=""), "A.20"),
    ],
)
def test_unported_training_features_raise_at_construction(tmp_path, kwargs, item):
    """Both features are ported now, and the configs that raised construct.
    Validation (A.19): its epoch runs (an empty set scores 0.0). Gradient
    accumulation (A.20): ``grad_accum_steps = 2`` splits a batch of 4 into
    two microbatches of 2, and the step's loss is the mean of the JAX
    loss over those two (tests/test_torch_accum.py holds the gradients and
    the steps)."""
    cfg = write_config(tmp_path, **{**kwargs, "extra": kwargs["extra"].format(val=tmp_path)})
    if item == "A.19":
        trainer = Trainer(load_config(cfg), output_dir=str(tmp_path / "x"), device="cpu")
        assert len(trainer.valid_dataset) == 0
        assert trainer._validation_epoch(1) == 0.0
        return
    cfg.write_text(cfg.read_text().replace("grad_accum_steps = 1", "grad_accum_steps = 2"))
    trainer = Trainer(load_config(cfg), output_dir=str(tmp_path / "x"), device="cpu")
    jt = JaxTrainer(jax_load_config(cfg), output_dir=str(tmp_path / "jax"))
    params = jax.tree.map(jnp.asarray, jax_params_from_state_dict(trainer.model.state_dict()))
    trainer.train_loader.set_epoch(1)
    noisy, clean = next(iter(trainer.train_loader))
    assert trainer.accum_split(noisy.shape[0]) == 2
    loss_fn = jax.jit(_jax_loss_fn(jt, False))
    want = np.mean([float(loss_fn(params, jnp.asarray(noisy[k:k + 2].numpy()),
                                  jnp.asarray(clean[k:k + 2].numpy()))) for k in (0, 2)])
    np.testing.assert_allclose(float(trainer.train_step(noisy, clean)), want, rtol=1e-5)
    assert trainer.steps == 1


def test_validation_set_beyond_the_last_epoch_is_accepted(tmp_path):
    """A validation set that no epoch reaches never runs, so it is fine."""
    cfg = write_config(tmp_path, epochs=1, validation_interval=2,
                       extra=VALIDATION.format(val=tmp_path))
    trainer = Trainer(load_config(cfg), output_dir=str(tmp_path / "x"), device="cpu")
    trainer.train()
    assert trainer.epoch_losses and trainer.epoch == 1


def test_unchanged_inference_forward_keeps_every_band():
    """Inference passes dropping_band=False: a B = 4 forward keeps all
    bins; a training forward drops to F // 2."""
    from fullsubnet_tpu_torch.models import FullSubNet

    model = FullSubNet(**TINY)
    mag = torch.rand(4, 1, 161, 20)
    with torch.no_grad():
        assert model(mag, dropping_band=False).shape == (4, 2, 161, 20)
        assert model(mag).shape == (4, 2, 80, 20)
        assert model(mag[:2]).shape == (2, 2, 161, 20)  # B <= groups: no drop
