"""Training runtime (counterpart of ``fullsubnet_tpu/train/trainer.py``):
one device, or one device in each process of a data-parallel group.

The step follows the JAX package's (``trainer.py:254-284``): the STFT of
both signals in fp32, the cIRM target, target-side ``drop_band`` when
``groups > 1 and B > groups``, the model in training (drop_band on the
sub-band input too), the mask back to fp32, the loss; then global-norm
clipping and Adam over fp32 master weights. With ``use_amp`` the compute
policy is bf16: every fp32 parameter is cast to bf16 inside the loss
(``torch.func.functional_call`` over the casts, which sit in the autograd
graph, so the gradients reach the masters in fp32, as JAX's ``astype``
inside the loss gives them) and the magnitude goes in as bf16. On CUDA
both stages train through the K2/K3 kernels (LSTM) or K2-GRU/K4 (GRU).
A wave-to-wave model (Improved FullSubNet) takes the noisy waveform in
fp32 instead, under the same casts, and the loss compares its enhanced
waveform with the clean one (JAX ``trainer.py:262-264``): no cIRM, no
drop_band; its stacks compute at fp32 from the fp32 STFT.

Validation (JAX ``trainer.py:601-1008``) runs every
``validation_interval`` epochs over ``[validation_dataset]``: each
utterance is enhanced at its exact length under ``torch.inference_mode``
(so the stages run K1 or K1-GRU on CUDA, not the training kernels) with
the validation loss, the cRM against the cIRM without drop_band; then
STOI, SI-SDR and WB-PESQ of the noisy and the enhanced signal, computed
in a pool of ``[trainer.visualization] num_workers`` spawned processes
(serially at 0 or 1), their means per speech type, and the selection
score (STOI + PESQ mapped to [0, 1]) / 2 of the With_reverb split (else
the mean over types) picks ``best_model.tar``. A config without a
validation set scores every validation epoch 0.0, as in the JAX package.
Every logged scalar is kept in ``scalars`` by epoch, besides TensorBoard
when tensorboardX is installed.

Checkpoints are the reference's set, in torch format:
``latest_model.tar`` ({model, optimizer, epoch, best_score}),
``model_NNNN.pth`` ({model}, loadable by the port's infer CLI) and
``best_model.tar``. ``-R`` resumes from ``latest_model.tar``; ``-P``
starts from a torch checkpoint's weights; ``-V`` runs one validation
epoch and no training.

``[trainer.train] grad_accum_steps`` = G > 1 splits each step into G
equal, contiguous microbatches (``train/accum.py``; 0 and 1 mean one).
``[train_dataset.args] device_synthesis`` makes the loader ship raw
mixture components, which the step mixes on the device first
(``data/device_mixer.py``), before the microbatch split.

Data parallel (``parallel/mesh.py``): under a process group of P
processes ``batch_size`` is the global batch and each process loads
``batch_size // P`` rows of its shard; microbatch k is the k-th
contiguous slice of every process's rows, drop_band's gate and groups
follow the global microbatch (``band_rows``), and the gradients and the
loss are averaged over the processes once a step, before clipping.
Validation is sharded: process p enhances utterances p, p + P, ..., and
the per-type loss and metric sums are summed over the processes, so
every process computes the same score and best-model decision. Only
process 0 writes the config dump, TensorBoard logs and checkpoints.
The host-RSS recycle and the preemption hook are TPU-side and not ported;
so is the ``subband`` mesh axis (ROADMAP A.25).
"""

from __future__ import annotations

import json
import logging
import math
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from fullsubnet_tpu_torch import config as config_lib
from fullsubnet_tpu_torch.acoustics.feature import drop_band, drops_band
from fullsubnet_tpu_torch.acoustics.mask import (
    build_complex_ideal_ratio_mask,
    complex_mul,
    decompress_cIRM,
)
from fullsubnet_tpu_torch.acoustics.stft import istft, stft_complex
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict, save_checkpoint
from fullsubnet_tpu_torch.data.device_mixer import make_device_synthesis
from fullsubnet_tpu_torch.data.loader import DataLoader
from fullsubnet_tpu_torch.metrics import (
    pesq_available,
    transform_pesq_range,
    validation_metrics,
)
from fullsubnet_tpu_torch.models import is_wave_to_wave
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.parallel.mesh import (
    all_reduce_mean_,
    check_mesh,
    local_shard_info,
    psum_across_processes,
)
from fullsubnet_tpu_torch.train.accum import accumulated_loss, largest_compatible_accum
from fullsubnet_tpu_torch.utils import prepare_empty_dir, resolve_device

logger = logging.getLogger(__name__)


class Trainer:
    # fold the per-step losses to the host every N steps: a NaN surfaces
    # within a window, and an epoch holds a bounded number of them
    _LOSS_FOLD_STEPS = 256

    def __init__(
        self,
        config: dict,
        resume: bool = False,
        only_validation: bool = False,
        preloaded_model_path: str | None = None,
        output_dir: str | None = None,
        experiment_name: str = "experiment",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.acoustics = config_lib.acoustics_args(config)
        trainer_cfg = config.get("trainer", {})
        train_cfg = trainer_cfg.get("train", {})
        val_cfg = trainer_cfg.get("validation", {})
        self.vis_cfg = trainer_cfg.get("visualization", {})
        self.only_validation = only_validation

        self.epochs = int(train_cfg.get("epochs", 9999))
        self.save_checkpoint_interval = int(train_cfg.get("save_checkpoint_interval", 1))
        self.validation_interval = int(val_cfg.get("validation_interval", 1))
        if self.save_checkpoint_interval < 1 or self.validation_interval < 1:
            raise ValueError("save_checkpoint_interval and validation_interval must be >= 1")
        self.grad_accum_steps = int(train_cfg.get("grad_accum_steps", 0))
        self._accum_warned: set[int] = set()
        self.rank, self.world = local_shard_info()
        check_mesh(trainer_cfg.get("mesh", {}), self.world)
        if resume and preloaded_model_path:
            raise ValueError("Resume conflicts with preloaded model.")
        self.save_max_metric_score = bool(val_cfg.get("save_max_metric_score", True))
        meta = config.get("meta", {})
        self.seed = int(meta.get("seed", 0))
        self.use_amp = bool(meta.get("use_amp", False))

        generator = torch.Generator().manual_seed(self.seed)
        self.model, init_kwargs = config_lib.build_model(config, generator=generator)
        if init_kwargs["weight_init"]:
            # the reference's weight_init (orthogonal stacks, xavier heads),
            # drawn from the same seeded generator after the default init
            for module in self.model.modules():
                if isinstance(module, SequenceModel):
                    module.orthogonal_init_(generator)
        self.model.to(self.device)
        self.loss_function = config_lib.build_loss(config)
        self.clip = float(train_cfg.get("clip_grad_norm_value", 0) or 0)
        self.optimizer = config_lib.build_optimizer(config, self.model.parameters())
        self.epoch = 0
        # reference base_trainer.py:90: -inf when selecting on a maximize metric
        self.best_score = -math.inf if self.save_max_metric_score else math.inf
        self.steps = 0
        self.epoch_losses: dict[int, float] = {}
        self.scalars: dict[int, dict[str, float]] = {}  # epoch -> tag -> value

        save_dir = output_dir or meta.get("save_dir", "runs")
        self.save_dir = Path(save_dir).expanduser().absolute() / experiment_name
        self.checkpoints_dir = self.save_dir / "checkpoints"
        self.logs_dir = self.save_dir / "logs"
        prepare_empty_dir([self.checkpoints_dir, self.logs_dir])
        if resume:
            self._resume_checkpoint()
        if preloaded_model_path:
            self._preload_model(preloaded_model_path)

        self.train_dataset = config_lib.build_dataset(config["train_dataset"], "train")
        self.synthesize = (
            make_device_synthesis(target_db_fs=float(self.train_dataset.target_dB_FS))
            if getattr(self.train_dataset, "device_synthesis", False)
            else None
        )
        dl_cfg = config["train_dataset"].get("dataloader", {})
        # batch_size is the global batch; each process loads its shard of it
        batch_size = int(dl_cfg.get("batch_size", 32))
        if batch_size % self.world != 0:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the number of devices "
                f"on the data axis ({self.world})."
            )
        self.train_loader = DataLoader(
            self.train_dataset,
            batch_size=batch_size // self.world,
            shuffle=True,
            drop_last=bool(dl_cfg.get("drop_last", True)),
            num_workers=int(dl_cfg.get("num_workers", 0)),
            seed=self.seed,
            shard_index=self.rank,
            num_shards=self.world,
        )
        self.valid_dataset = (
            config_lib.build_dataset(config["validation_dataset"], "validation")
            if "validation_dataset" in config
            else None
        )
        self.writer = self._make_writer()
        self._dump_config()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def compute_loss(self, noisy: torch.Tensor, clean: torch.Tensor,
                     band_rows: tuple[int, int] | None = None) -> torch.Tensor:
        """The training loss of a batch of waveforms [B, S] on the device.
        ``band_rows`` = (row offset, rows): these B rows are a slice of a
        batch of that many rows (a process's share of a microbatch), whose
        drop_band gate and groups apply, as in the JAX step."""
        a = self.acoustics
        n_fft, hop, win = a["n_fft"], a["hop_length"], a["win_length"]
        params = dict(self.model.named_parameters())
        if self.use_amp:
            params = {
                k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                for k, p in params.items()
            }
        if is_wave_to_wave(self.model):
            enhanced = functional_call(self.model, params, (noisy,))[:, 0]
            return self.loss_function(enhanced.float(), clean)
        noisy_spec = stft_complex(noisy, n_fft, hop, win)
        clean_spec = stft_complex(clean, n_fft, hop, win)
        cirm = build_complex_ideal_ratio_mask(
            noisy_spec.real, noisy_spec.imag, clean_spec.real, clean_spec.imag
        )  # [B, F, T, 2]
        groups = int(getattr(self.model, "num_groups_in_drop_band", 0) or 0)
        kwargs = {"dropping_band": True}
        if groups:
            kwargs["band_rows"] = band_rows
        if drops_band(noisy.shape[0], groups, band_rows):
            cirm = drop_band(cirm.permute(0, 3, 1, 2), groups, band_rows).permute(0, 2, 3, 1)
        noisy_mag = noisy_spec.abs()[:, None]
        if self.use_amp:
            noisy_mag = noisy_mag.to(torch.bfloat16)
        crm = functional_call(self.model, params, (noisy_mag,), kwargs)
        crm = crm.permute(0, 2, 3, 1).float()  # [B, F', T, 2]
        return self.loss_function(crm, cirm)

    def accum_split(self, batch: int) -> int:
        """The microbatch count G for a global batch of ``batch`` rows: the
        configured ``grad_accum_steps``, or the nearest smaller split that
        divides the batch over the processes (with the JAX warning, once a
        batch size); 1 when it is 0 or 1."""
        if self.grad_accum_steps <= 1:
            return 1
        g = largest_compatible_accum(self.grad_accum_steps, batch, self.world)
        if g != self.grad_accum_steps and batch not in self._accum_warned:
            self._accum_warned.add(batch)
            logger.warning(
                "grad_accum_steps=%d does not divide batch %d (data axis %d); using the "
                "nearest compatible split G=%d",
                self.grad_accum_steps, batch, self.world, g,
            )
        return g

    def loss_and_grads(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """The step's loss over this process's rows [B, S] of the global
        batch, with each parameter's ``.grad`` the gradient before
        clipping: over G microbatches (microbatch k: rows k·B/G to
        (k+1)·B/G here, the same slice on every process), then averaged
        over the processes. Returns the global mean loss (on the device)."""
        local = noisy.shape[0]
        g = self.accum_split(local * self.world)
        micro = local // g
        band_rows = (self.rank * micro, micro * self.world)
        params = list(self.model.parameters())

        def micro_loss(k):
            rows = slice(k * micro, (k + 1) * micro)
            return self.compute_loss(noisy[rows], clean[rows], band_rows)

        loss = accumulated_loss(micro_loss, params, g)
        return all_reduce_mean_(params, loss)

    def train_step(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch; returns the loss (on the device,
        not synchronised)."""
        loss = self.loss_and_grads(noisy, clean)
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.clip)
        self.optimizer.step()
        self.steps += 1
        return loss

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _resume_checkpoint(self):
        blob = torch.load(self.checkpoints_dir / "latest_model.tar",
                          map_location=self.device, weights_only=True)
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.epoch = int(blob["epoch"])
        self.best_score = float(blob["best_score"])
        print(f"Model checkpoint loaded. Training will begin at {self.epoch + 1} epoch.")

    def _preload_model(self, path: str):
        path = Path(path).expanduser().absolute()
        if not path.is_file():
            raise FileNotFoundError(f"no torch checkpoint at {path}")
        self.model.load_state_dict(load_torch_state_dict(path))
        print(f"Model preloaded successfully from {path}.")

    def _save_checkpoint(self, epoch: int, is_best: bool = False):
        # "epoch" is the last trained epoch: a validation-only run (-V) at
        # epoch e leaves -R to train e next. Every process holds the same
        # state; process 0 writes it
        if self.rank != 0:
            return
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "best_score": self.best_score,
        }
        save_checkpoint(self.checkpoints_dir / "latest_model.tar", state)
        save_checkpoint(self.checkpoints_dir / f"model_{epoch:04d}.pth", {"model": state["model"]})
        if is_best:
            save_checkpoint(self.checkpoints_dir / "best_model.tar", state)

    def _is_best_epoch(self, score: float) -> bool:
        # the best score is kept rounded to float32, as the JAX package keeps
        # it, and each new score compared with it unrounded; a Python float,
        # so checkpoints load with weights_only=True
        score = float(score)
        if self.save_max_metric_score and score >= self.best_score:
            self.best_score = float(np.float32(score))
            return True
        if not self.save_max_metric_score and score <= self.best_score:
            self.best_score = float(np.float32(score))
            return True
        return False

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------

    def _make_writer(self):
        if self.rank != 0:
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(log_dir=str(self.logs_dir), flush_secs=30)

    def _dump_config(self):
        if self.rank != 0:
            return
        stamp = time.strftime("%Y-%m-%d--%H-%M-%S")
        with open(self.save_dir / f"{stamp}.json", "w") as f:
            json.dump(self.config, f, indent=2, default=str)

    def _log_scalar(self, tag: str, value: float, step: int):
        self.scalars.setdefault(step, {})[tag] = float(value)
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _train_epoch(self, epoch: int) -> float:
        totals = [0.0, 0]  # sum and count of the folded losses

        def fold(pending):
            window = torch.stack(pending).double().cpu().numpy()
            if not np.isfinite(window).all():
                bad = int(np.flatnonzero(~np.isfinite(window))[0])
                raise FloatingPointError(
                    f"non-finite training loss at epoch {epoch} step "
                    f"~{totals[1] + bad}: {window[bad]}"
                )
            totals[0] += float(window.sum())
            totals[1] += len(window)

        self.train_loader.set_epoch(epoch)
        losses = []
        for batch in self.train_loader:
            # (noisy, clean), or the six raw components under device synthesis
            batch = [x.to(self.device, non_blocking=True) for x in batch]
            noisy, clean = self.synthesize(batch) if self.synthesize else batch
            losses.append(self.train_step(noisy, clean))
            if len(losses) > self._LOSS_FOLD_STEPS:
                fold(losses[:-1])
                losses = losses[-1:]
        if losses:
            fold(losses)
        mean = totals[0] / totals[1] if totals[1] else 0.0
        self.epoch_losses[epoch] = mean
        print(f"epoch {epoch}: mean training loss {mean:.6f} over {totals[1]} steps")
        self._log_scalar("Loss/Train", mean, epoch)
        return mean

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def _enhance_utterance(self, noisy: np.ndarray, clean: np.ndarray):
        """Enhance one utterance at its exact length and compute its
        validation loss: criterion(cRM, cIRM) without drop_band for a mask
        model (reference ``fullsubnet/trainer.py:160-169``),
        criterion(enhanced, clean) for a wave-to-wave one. Returns
        (enhanced [L] float32, loss)."""
        a = self.acoustics
        n_fft, hop, win = a["n_fft"], a["hop_length"], a["win_length"]
        length = int(min(len(noisy), len(clean)))

        def wave(y):
            return torch.from_numpy(np.asarray(y[:length], np.float32))[None].to(self.device)

        if is_wave_to_wave(self.model):
            with torch.inference_mode():
                enhanced = self.model(wave(noisy))[:, 0]
                loss = self.loss_function(enhanced, wave(clean))
            return enhanced[0].cpu().numpy(), float(loss)
        with torch.inference_mode():
            spec = stft_complex(wave(noisy), n_fft, hop, win)
            crm = self.model(spec.abs()[:, None], dropping_band=False).permute(0, 2, 3, 1)
            clean_spec = stft_complex(wave(clean), n_fft, hop, win)
            cirm = build_complex_ideal_ratio_mask(
                spec.real, spec.imag, clean_spec.real, clean_spec.imag
            )
            loss = self.loss_function(crm, cirm)
            crm = decompress_cIRM(crm)
            real, imag = complex_mul(spec.real, spec.imag, crm[..., 0], crm[..., 1])
            enhanced = istft((real, imag), n_fft, hop, win, length=length,
                             input_type="real_imag")
        return enhanced[0].cpu().numpy(), float(loss)

    def spec_audio_visualization(self, noisy, enhanced, clean, name, epoch, sr):
        """Audio clips and a magma spectrogram triptych to TensorBoard
        (reference ``base_trainer.py:277-314``); only with a writer, and
        each part only where its optional package is installed (the audio
        encoding needs soundfile, the figure matplotlib)."""
        if self.writer is None:
            return
        try:
            for y, label in ((noisy, "Noisy"), (enhanced, "Enhanced"), (clean, "Clean")):
                self.writer.add_audio(f"Audio/{name}_{label}", y[:, None], epoch, sample_rate=sr)
        except ImportError:
            pass
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        a = self.acoustics
        n_fft, hop = a["n_fft"], a["hop_length"]
        # a host spectrogram (numpy): the figure costs no device time
        win = np.hanning(a["win_length"] + 1)[:-1]
        if len(win) < n_fft:  # torch-style center pad to n_fft
            lp = (n_fft - len(win)) // 2
            win = np.pad(win, (lp, n_fft - len(win) - lp))
        fig, axes = plt.subplots(3, 1, figsize=(6, 6))
        for ax, (y, label) in zip(
            axes, [(noisy, "Noisy"), (enhanced, "Enhanced"), (clean, "Clean")]
        ):
            yp = np.pad(np.asarray(y, np.float32), (n_fft // 2, n_fft // 2), mode="reflect")
            starts = np.arange(0, len(yp) - n_fft + 1, hop)
            frames = yp[starts[:, None] + np.arange(n_fft)] * win
            mag = np.abs(np.fft.rfft(frames, axis=1)).T
            ax.imshow(20 * np.log10(mag + 1e-8), origin="lower", aspect="auto", cmap="magma")
            ax.set_title(f"{label}: mean {np.mean(y):.3f}, std {np.std(y):.3f}")
        plt.tight_layout()
        self.writer.add_figure(f"Spectrogram/{name}", fig, epoch)
        plt.close(fig)

    def _row_metrics(self, rows, with_pesq: bool) -> list[dict]:
        """``validation_metrics`` of each (noisy, clean, enhanced, type)
        row, in row order: in a pool of ``[trainer.visualization]
        num_workers`` spawned processes (numpy only, never CUDA), or here
        at 0 or 1."""
        sr = self.acoustics["sr"]
        workers = min(int(self.vis_cfg.get("num_workers", 10)), len(rows))
        args = [(n, c, e, sr, with_pesq) for n, c, e, _ in rows]
        if workers <= 1:
            return [validation_metrics(*a) for a in args]
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            return list(pool.map(validation_metrics, *zip(*args)))

    def metrics_visualization(self, rows, epoch: int, all_types=None) -> float:
        """Metric means per speech type, Noisy vs Enhanced, as scalars, and
        the model-selection score (reference ``base_trainer.py:316-370``).
        rows: (noisy, clean, enhanced, speech_type), this process's shard;
        the per-type sums are summed over the processes before the means,
        so every process returns the same score. ``all_types`` the speech
        types to report (the same on every process), by default the rows'
        own."""
        use_pesq = pesq_available()
        keys = ["stoi_n", "stoi_e", "sisdr_n", "sisdr_e"]
        if use_pesq:
            keys += ["pesq_n", "pesq_e"]
        per_type: dict[str, list] = {}
        for (_, _, _, speech_type), res in zip(rows, self._row_metrics(rows, use_pesq)):
            per_type.setdefault(speech_type, []).append(res)
        if all_types is None:
            all_types = sorted(per_type)
        # [type, metric sums (in row order) + count]: one reduction for all
        mat = np.array(
            [[float(sum(it[k] for it in per_type.get(t, []))) for k in keys]
             + [float(len(per_type.get(t, [])))] for t in all_types],
            np.float64,
        ).reshape(len(all_types), len(keys) + 1)
        mat = psum_across_processes(mat)

        scores = {}
        for speech_type, row in zip(all_types, mat):
            if row[-1] == 0:
                continue
            mean = dict(zip(keys, row[:-1] / row[-1]))
            self._log_scalar(f"Validation/STOI_{speech_type}_Noisy", mean["stoi_n"], epoch)
            self._log_scalar(f"Validation/STOI_{speech_type}_Enhanced", mean["stoi_e"], epoch)
            self._log_scalar(f"Validation/SI_SDR_{speech_type}_Noisy", mean["sisdr_n"], epoch)
            self._log_scalar(f"Validation/SI_SDR_{speech_type}_Enhanced", mean["sisdr_e"], epoch)
            if use_pesq:
                self._log_scalar(f"Validation/WB_PESQ_{speech_type}_Noisy", mean["pesq_n"], epoch)
                self._log_scalar(
                    f"Validation/WB_PESQ_{speech_type}_Enhanced", mean["pesq_e"], epoch
                )
                # the reference's model-selection score (base_trainer.py:364-370)
                scores[speech_type] = (mean["stoi_e"] + transform_pesq_range(mean["pesq_e"])) / 2
            else:
                scores[speech_type] = mean["stoi_e"]

        # the reference selects on the With_reverb split (fullsubnet/trainer.py:181)
        if "With_reverb" in scores:
            score = scores["With_reverb"]
        else:
            score = float(np.mean(list(scores.values()))) if scores else 0.0
        self._log_scalar("Validation/Score", score, epoch)
        return float(score)

    def _validation_epoch(self, epoch: int) -> float:
        """Enhance this process's utterances (p, p + P, ...), log the
        per-type validation loss, show those of the first ``[trainer.visualization]
        n_samples``, and return the selection score (0.0 without a
        validation set); the sums are taken over every process."""
        if self.valid_dataset is None:
            return 0.0
        sr = self.acoustics["sr"]
        n_samples_vis = int(self.vis_cfg.get("n_samples", 10))
        total = len(self.valid_dataset)
        rows = []
        loss_sum: dict[str, float] = {}
        loss_cnt: dict[str, int] = {}
        for i in range(self.rank, total, self.world):
            noisy, clean, name, speech_type = self.valid_dataset[i]
            enhanced, val_loss = self._enhance_utterance(noisy, clean)
            length = min(len(enhanced), len(clean))
            enhanced, clean_c, noisy_c = enhanced[:length], clean[:length], noisy[:length]
            rows.append((noisy_c, clean_c, enhanced, speech_type))
            loss_sum[speech_type] = loss_sum.get(speech_type, 0.0) + val_loss
            loss_cnt[speech_type] = loss_cnt.get(speech_type, 0) + 1
            if i < n_samples_vis:
                self.spec_audio_visualization(
                    noisy_c, enhanced, clean_c, f"{speech_type}_{name}", epoch, sr
                )
        all_types = sorted({self.valid_dataset.speech_type_of(i) for i in range(total)})
        # per-type validation loss (reference fullsubnet/trainer.py:160-169)
        loss_mat = np.array(
            [[loss_sum.get(t, 0.0), float(loss_cnt.get(t, 0))] for t in all_types], np.float64
        ).reshape(len(all_types), 2)
        for speech_type, (total_loss, count) in zip(all_types,
                                                    psum_across_processes(loss_mat)):
            if count > 0:
                self._log_scalar(f"Validation/Loss_{speech_type}", total_loss / count, epoch)
        return self.metrics_visualization(rows, epoch, all_types=all_types)

    def train(self):
        for epoch in range(self.epoch + 1, self.epochs + 1):
            print(f"{'=' * 15} epoch {epoch} {'=' * 15}")
            t0 = time.perf_counter()
            if self.only_validation:
                if self._is_best_epoch(self._validation_epoch(epoch)):
                    self._save_checkpoint(epoch, is_best=True)
                break
            self._train_epoch(epoch)
            self.epoch = epoch
            if epoch % self.save_checkpoint_interval == 0:
                self._save_checkpoint(epoch)
            if epoch % self.validation_interval == 0:
                print(f"[{time.perf_counter() - t0:.2f} seconds] Training has finished, "
                      "validation is in progress...")
                if self._is_best_epoch(self._validation_epoch(epoch)):
                    self._save_checkpoint(epoch, is_best=True)
            print(f"[{time.perf_counter() - t0:.2f} seconds] This epoch is finished.")
        if self.writer is not None:
            self.writer.close()
