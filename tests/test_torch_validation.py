"""The port's validation in the train loop against the JAX package:
``ValidationDataset`` on every DNS layout, one validation epoch of the
port's Trainer against the JAX Trainer's ``_validation_epoch`` on the same
weights (through the weight bridge), the metrics alone on the same
waveforms, best-model selection in the train loop, ``-V`` and a minimize
metric. The tiny TOML of tests/test_torch_train.py, with two synthetic
validation directories (With_reverb, No_reverb)."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_tpu.config import load_config as jax_load_config
from fullsubnet_tpu.data.datasets import ValidationDataset as JaxValidationDataset
from fullsubnet_tpu.train.trainer import Trainer as JaxTrainer
from fullsubnet_tpu_torch.checkpoint import jax_params_from_state_dict
from fullsubnet_tpu_torch.config import load_config
from fullsubnet_tpu_torch.data.datasets import ValidationDataset
from fullsubnet_tpu_torch.data.wavio import write_wav
from fullsubnet_tpu_torch.train import cli
from fullsubnet_tpu_torch.train.trainer import Trainer

from test_torch_train import write_config

# PyTorch's intra-op threads: one per process. The tier-1 run starts six
# pytest-xdist workers on eight cores, and every worker imports every test
# module, so this cap holds for the whole worker, whichever tests it runs.
torch.set_num_threads(1)

SR = 16000
REPO = Path(__file__).resolve().parents[1]

VALIDATION = """
[validation_dataset]
path = "dataset_validation.Dataset"
[validation_dataset.args]
dataset_dir_list = ["{with_reverb}", "{no_reverb}"]
sr = 16000

[trainer.visualization]
n_samples = 2
num_workers = {num_workers}
"""


def _speech(seconds: float, f0: float) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
            ).astype(np.float32)


def write_validation_dirs(root, seconds=(1.0, 1.3), seed=0):
    """DNS test-set layouts ``root/{with_reverb,no_reverb}/{noisy,clean}``:
    per split one noisy ``..._fileid_N.wav`` and its ``clean_fileid_N.wav``
    for each length in ``seconds``."""
    rng = np.random.default_rng(seed)
    dirs = []
    for split in ("with_reverb", "no_reverb"):
        base = root / split
        (base / "noisy").mkdir(parents=True)
        (base / "clean").mkdir()
        for i, s in enumerate(seconds):
            clean = _speech(s, 180 + 60 * i)
            noisy = clean + (0.1 * rng.standard_normal(clean.size)).astype(np.float32)
            write_wav(base / "noisy" / f"clnsp{i}_snr10_tl-25_fileid_{i}.wav", noisy, SR)
            write_wav(base / "clean" / f"clean_fileid_{i}.wav", clean, SR)
        dirs.append(base)
    return dirs


def validation_config(tmp_path, num_workers=0, **kwargs):
    with_reverb, no_reverb = write_validation_dirs(tmp_path / "val")
    extra = VALIDATION.format(with_reverb=with_reverb, no_reverb=no_reverb,
                              num_workers=num_workers)
    return write_config(tmp_path, extra=extra, **kwargs)


LAYOUTS = {
    # parent dir: (noisy name, clean name, speech type, reported name)
    "with_reverb": ("clnsp3_snr5_fileid_3", "clean_fileid_3", "With_reverb",
                    "with_reverbclnsp3_snr5_fileid_3"),
    "no_reverb": ("clnsp7_snr0_fileid_7", "clean_fileid_7", "No_reverb", "clnsp7_snr0_fileid_7"),
    "dns_2_non_english": ("noisy_fileid_1", "synthetic_clean_fileid_1", "Non_english",
                          "noisy_fileid_1"),
    "dns_2_emotion": ("noisy_fileid_2", "synthetic_emotion_clean_fileid_2", "Emotion",
                      "noisy_fileid_2"),
    "dns_2_singing": ("noisy_fileid_4", "synthetic_singing_clean_fileid_4", "Singing",
                      "noisy_fileid_4"),
}


def test_validation_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    dirs = []
    for parent, (noisy_name, clean_name, _, _) in LAYOUTS.items():
        base = tmp_path / "synthetic" / parent
        (base / "noisy").mkdir(parents=True)
        (base / "clean").mkdir()
        write_wav(base / "noisy" / f"{noisy_name}.wav",
                  (0.1 * rng.standard_normal(800)).astype(np.float32), SR)
        write_wav(base / "clean" / f"{clean_name}.wav",
                  (0.1 * rng.standard_normal(800)).astype(np.float32), SR)
        dirs.append(str(base))
    port, ref = ValidationDataset(dirs), JaxValidationDataset(dirs)
    assert len(port) == len(ref) == len(LAYOUTS)
    for i in range(len(port)):
        noisy, clean, name, speech_type = port[i]
        want = ref[i]
        np.testing.assert_array_equal(noisy, want[0])
        np.testing.assert_array_equal(clean, want[1])
        assert (name, speech_type) == (want[2], want[3]) == (port.clean_path_of(i)[1], speech_type)
        assert port.speech_type_of(i) == ref.speech_type_of(i) == speech_type
        parent = dirs[i].rsplit("/", 1)[1]
        _, clean_name, want_type, want_name = LAYOUTS[parent]
        assert (speech_type, name) == (want_type, want_name)
        assert port.clean_path_of(i)[0] == f"{dirs[i]}/clean/{clean_name}.wav"

    other = tmp_path / "other"
    (other / "noisy").mkdir(parents=True)
    write_wav(other / "noisy" / "x_fileid_0.wav", np.zeros(100, np.float32), SR)
    for dataset in (ValidationDataset([str(other)]), JaxValidationDataset([str(other)])):
        with pytest.raises(NotImplementedError, match="Not supported dir: other"):
            dataset.speech_type_of(0)


def _jax_trainer(cfg_path, port: Trainer, out) -> tuple[JaxTrainer, dict]:
    """A JAX Trainer on the port's weights, its scalars recorded by epoch."""
    jt = JaxTrainer(jax_load_config(cfg_path), output_dir=str(out))
    jt.state["params"] = jax.tree.map(jnp.asarray, jax_params_from_state_dict(port.model.state_dict()))
    logged = {}
    jt._log_scalar = lambda tag, value, step: logged.setdefault(step, {}).__setitem__(tag, float(value))
    return jt, logged


# the validation losses and metric means, port (each utterance at its exact
# length) against the JAX Trainer (the same utterance zero-padded to a
# length bucket, exact by construction): fp32 through the STFT, two LSTM
# stages and the iSTFT on both sides, the sums in another order. The
# enhanced waveforms differ by about 1e-7 of their scale; the metrics
# move by less than these
LOSS_RTOL = 1e-5
METRIC_ATOL = {"STOI": 1e-5, "SI_SDR": 1e-3, "WB_PESQ": 1e-3, "Score": 1e-4}


def test_validation_epoch_matches_jax(tmp_path):
    cfg_path = validation_config(tmp_path, num_workers=2)
    port = Trainer(load_config(cfg_path), output_dir=str(tmp_path / "port"), device="cpu")
    jt, want = _jax_trainer(cfg_path, port, tmp_path / "jax")

    score = port._validation_epoch(1)
    want_score = jt._validation_epoch(1)
    got = port.scalars[1]
    assert sorted(got) == sorted(want[1])
    assert sorted(got) == sorted(
        [f"Validation/Loss_{t}" for t in ("No_reverb", "With_reverb")]
        + [f"Validation/{m}_{t}_{k}" for m in ("STOI", "SI_SDR", "WB_PESQ")
           for t in ("No_reverb", "With_reverb") for k in ("Noisy", "Enhanced")]
        + ["Validation/Score"]
    )
    for tag, value in got.items():
        assert math.isfinite(value), tag
        kind = tag.split("/")[1]
        kind = next((m for m in METRIC_ATOL if kind.startswith(f"{m}_")), kind)
        if tag.endswith("_Noisy"):  # no enhancement in between: the same bits
            assert value == want[1][tag], tag
        elif kind.startswith("Loss_"):
            np.testing.assert_allclose(value, want[1][tag], rtol=LOSS_RTOL, err_msg=tag)
        else:
            np.testing.assert_allclose(value, want[1][tag], atol=METRIC_ATOL[kind], rtol=0,
                                       err_msg=tag)
    assert score == got["Validation/Score"]
    np.testing.assert_allclose(score, want_score, atol=METRIC_ATOL["Score"], rtol=0)
    # the score is the With_reverb split's (STOI + PESQ in [0, 1]) / 2
    stoi, pesq = got["Validation/STOI_With_reverb_Enhanced"], got["Validation/WB_PESQ_With_reverb_Enhanced"]
    assert score == (stoi + (pesq + 0.5) / 5) / 2


def test_metrics_visualization_is_bit_equal_to_jax(tmp_path):
    """On the same waveforms the two Trainers' metric scalars are the same
    bits (the port's pool of 2 spawned workers, the JAX package's joblib)."""
    cfg_path = validation_config(tmp_path, num_workers=2)
    port = Trainer(load_config(cfg_path), output_dir=str(tmp_path / "port"), device="cpu")
    jt, want = _jax_trainer(cfg_path, port, tmp_path / "jax")
    rows = []
    for i in range(len(port.valid_dataset)):
        noisy, clean, _, speech_type = port.valid_dataset[i]
        enhanced, _ = port._enhance_utterance(noisy, clean)
        rows.append((noisy, clean, enhanced, speech_type))
    rows.append(rows[0])  # a type's mean over more than one row
    assert port.metrics_visualization(rows, 3) == jt.metrics_visualization(rows, 3)
    assert port.scalars[3] == want[3]
    # serially (num_workers 0) the same bits again
    port.vis_cfg["num_workers"] = 0
    assert port.metrics_visualization(rows, 4) == jt.metrics_visualization(rows, 4)
    assert port.scalars[4] == port.scalars[3]


def test_train_loop_keeps_the_best_epoch(tmp_path):
    """Validation at every epoch: best_model.tar holds the weights and the
    score of the best epoch (the later one on a tie), latest_model.tar the
    last; with a minimize metric best_score starts at +inf."""
    cfg_path = validation_config(tmp_path, epochs=3, validation_interval=1)
    out = tmp_path / "runs"
    trainer = cli.main(["-C", str(cfg_path), "-O", str(out), "--device", "cpu"])
    scores = {e: trainer.scalars[e]["Validation/Score"] for e in (1, 2, 3)}
    assert all(math.isfinite(s) for s in scores.values())
    assert all("Loss/Train" in trainer.scalars[e] for e in (1, 2, 3))
    best_epoch = max(scores, key=lambda e: (scores[e], e))
    ckpt = out / "tiny_train" / "checkpoints"
    best = torch.load(ckpt / "best_model.tar", weights_only=True)
    # the best score is kept rounded to float32, as in the JAX package (C.1)
    best_score = float(np.float32(scores[best_epoch]))
    assert best["epoch"] == best_epoch and best["best_score"] == best_score
    weights = torch.load(ckpt / f"model_{best_epoch:04d}.pth", weights_only=True)["model"]
    for key, value in weights.items():
        assert torch.equal(best["model"][key], value), key
    assert torch.load(ckpt / "latest_model.tar", weights_only=True)["epoch"] == 3
    assert trainer.best_score == best_score

    cfg_path.write_text(cfg_path.read_text().replace("save_max_metric_score = true",
                                                     "save_max_metric_score = false"))
    minimize = Trainer(load_config(cfg_path), output_dir=str(tmp_path / "min"), device="cpu")
    assert minimize.best_score == math.inf
    assert minimize._is_best_epoch(0.5) and not minimize._is_best_epoch(0.6)
    assert minimize._is_best_epoch(0.4) and minimize.best_score == float(np.float32(0.4))


@pytest.mark.parametrize("maximize", [True, False])
def test_best_epoch_decisions_match_jax(maximize):
    """C.1: the best score is kept in float32 and each new score compared
    with it unrounded, as the JAX Trainer does. A later score within float32
    rounding of the best (f, then f + 2e-9, then f + 1e-9, all rounding to
    f) is a new best in both packages, or in neither."""
    from types import SimpleNamespace

    f = float(np.float32(0.8123457))
    sign = 1.0 if maximize else -1.0
    scores = [f, f + sign * 2e-9, f + sign * 1e-9]
    start = -math.inf if maximize else math.inf
    port = SimpleNamespace(best_score=start, save_max_metric_score=maximize)
    jax_side = SimpleNamespace(state={"best_score": jnp.asarray(start, jnp.float32)},
                               save_max_metric_score=maximize)
    got = [Trainer._is_best_epoch(port, s) for s in scores]
    want = [JaxTrainer._is_best_epoch(jax_side, s) for s in scores]
    assert got == want == [True, True, True]
    assert port.best_score == float(np.asarray(jax_side.state["best_score"])) == f


def test_only_validation_runs_one_validation_epoch(tmp_path):
    """-V trains nothing: one validation epoch of the weights at hand, from
    -P (a fresh experiment, epoch 1) or from -R (the epoch after the last
    trained one); best_model.tar holds its score and latest_model.tar
    still names the last trained epoch."""
    cfg_path = validation_config(tmp_path, epochs=1, validation_interval=5)
    out = tmp_path / "runs"
    trained = cli.main(["-C", str(cfg_path), "-O", str(out), "--device", "cpu"])
    assert trained.steps == 2 and "Validation/Score" not in trained.scalars[1]
    ckpt = out / "tiny_train" / "checkpoints"
    assert not (ckpt / "best_model.tar").exists()  # epoch 1 < validation_interval
    weights = torch.load(ckpt / "model_0001.pth", weights_only=True)["model"]

    fresh = tmp_path / "fresh"
    only = cli.main(["-C", str(cfg_path), "-O", str(fresh), "--device", "cpu",
                     "-P", str(ckpt / "model_0001.pth"), "-V"])
    assert only.steps == 0 and list(only.scalars) == [1]
    assert float(np.float32(only.scalars[1]["Validation/Score"])) == only.best_score
    best = torch.load(fresh / "tiny_train" / "checkpoints" / "best_model.tar", weights_only=True)
    assert best["epoch"] == 0 and best["best_score"] == only.best_score
    for key, value in weights.items():
        assert torch.equal(best["model"][key], value), key

    cfg_path.write_text(cfg_path.read_text().replace("epochs = 1", "epochs = 2"))
    resumed = cli.main(["-C", str(cfg_path), "-O", str(out), "--device", "cpu", "-R", "-V"])
    assert resumed.steps == 0 and list(resumed.scalars) == [2]
    assert resumed.scalars[2]["Validation/Score"] == only.scalars[1]["Validation/Score"]
    assert torch.load(ckpt / "latest_model.tar", weights_only=True)["epoch"] == 1
    assert torch.load(ckpt / "best_model.tar", weights_only=True)["epoch"] == 1


@pytest.mark.parametrize("recipe", ["train.toml", "train_cumulativeLaplaceNorm.toml"])
def test_flagship_recipe_trains_as_shipped(tmp_path, recipe):
    """Both shipped FullSubNet train recipes, with only their data paths
    pointed at synthetic data, construct the port's Trainer at full width
    with their validation set (validation every 2 epochs, the recipe's
    visualization settings) and run a validation epoch."""
    import re

    from test_torch_train_data import write_lists

    clean, noise, rir = write_lists(tmp_path / "data")
    dirs = write_validation_dirs(tmp_path / "val", seconds=(0.6,))
    toml = (REPO / "recipes" / "dns_interspeech_2020" / "fullsubnet" / recipe).read_text()
    for kind, path in (("clean", clean), ("noise", noise), ("rir", rir)):
        toml = re.sub(rf"(?m)^{kind}_dataset = .*$", f'{kind}_dataset = "{path}"', toml)
    toml, n_sub = re.subn(r"(?ms)^dataset_dir_list = \[.*?\]",
                          f"dataset_dir_list = {[str(d) for d in dirs]}".replace("'", '"'), toml)
    assert n_sub == 1
    cfg_path = tmp_path / recipe
    cfg_path.write_text(toml)
    config = load_config(cfg_path)
    assert config["trainer"]["validation"]["validation_interval"] == 2
    trainer = Trainer(config, output_dir=str(tmp_path / "runs"), device="cpu")
    assert trainer.epochs == 9999 and len(trainer.valid_dataset) == 2
    score = trainer._validation_epoch(2)
    scalars = trainer.scalars[2]
    assert len(scalars) == 15 and all(math.isfinite(v) for v in scalars.values())
    assert score == scalars["Validation/Score"]
