"""Training runtime (counterpart of ``fullsubnet_tpu/train/trainer.py``),
on one device.

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

Not ported yet: gradient accumulation (ROADMAP A.20); a config with
``grad_accum_steps`` > 1 raises at construction. The host-RSS recycle,
the preemption hook, the device mesh and the cross-host reductions of
validation are TPU-side and not ported.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from fullsubnet_tpu_torch import config as config_lib
from fullsubnet_tpu_torch.acoustics.feature import drop_band
from fullsubnet_tpu_torch.acoustics.mask import (
    build_complex_ideal_ratio_mask,
    complex_mul,
    decompress_cIRM,
)
from fullsubnet_tpu_torch.acoustics.stft import istft, stft_complex
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict, save_checkpoint
from fullsubnet_tpu_torch.data.loader import DataLoader
from fullsubnet_tpu_torch.metrics import (
    pesq_available,
    transform_pesq_range,
    validation_metrics,
)
from fullsubnet_tpu_torch.models import is_wave_to_wave
from fullsubnet_tpu_torch.nn.sequence_model import SequenceModel
from fullsubnet_tpu_torch.utils import prepare_empty_dir, resolve_device


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
        if int(train_cfg.get("grad_accum_steps", 0)) > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet (ROADMAP A.20)"
            )
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
        dl_cfg = config["train_dataset"].get("dataloader", {})
        self.train_loader = DataLoader(
            self.train_dataset,
            batch_size=int(dl_cfg.get("batch_size", 32)),
            shuffle=True,
            drop_last=bool(dl_cfg.get("drop_last", True)),
            num_workers=int(dl_cfg.get("num_workers", 0)),
            seed=self.seed,
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

    def compute_loss(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """The training loss of a batch of waveforms [B, S] on the device."""
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
        if groups > 1 and noisy.shape[0] > groups:
            cirm = drop_band(cirm.permute(0, 3, 1, 2), groups).permute(0, 2, 3, 1)
        noisy_mag = noisy_spec.abs()[:, None]
        if self.use_amp:
            noisy_mag = noisy_mag.to(torch.bfloat16)
        crm = functional_call(self.model, params, (noisy_mag,), {"dropping_band": True})
        crm = crm.permute(0, 2, 3, 1).float()  # [B, F', T, 2]
        return self.loss_function(crm, cirm)

    def train_step(self, noisy: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch; returns the loss (on the device,
        not synchronised)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.compute_loss(noisy, clean)
        loss.backward()
        if self.clip:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.clip)
        self.optimizer.step()
        self.steps += 1
        return loss.detach()

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
        # epoch e leaves -R to train e next
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
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(log_dir=str(self.logs_dir), flush_secs=30)

    def _dump_config(self):
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
        for noisy, clean in self.train_loader:
            noisy = noisy.to(self.device, non_blocking=True)
            clean = clean.to(self.device, non_blocking=True)
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
        rows: (noisy, clean, enhanced, speech_type); ``all_types`` the
        speech types to report, by default the rows' own."""
        use_pesq = pesq_available()
        keys = ["stoi_n", "stoi_e", "sisdr_n", "sisdr_e"]
        if use_pesq:
            keys += ["pesq_n", "pesq_e"]
        per_type: dict[str, list] = {}
        for (_, _, _, speech_type), res in zip(rows, self._row_metrics(rows, use_pesq)):
            per_type.setdefault(speech_type, []).append(res)
        if all_types is None:
            all_types = sorted(per_type)

        scores = {}
        for speech_type in all_types:
            items = per_type.get(speech_type, [])
            if not items:
                continue
            # the JAX package's sums in row order, then one division
            row = np.array([float(sum(it[k] for it in items)) for k in keys], np.float64)
            mean = dict(zip(keys, row / float(len(items))))
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
        """Enhance every validation utterance, log the per-type validation
        loss, show the first ``[trainer.visualization] n_samples``, and
        return the selection score (0.0 without a validation set)."""
        if self.valid_dataset is None:
            return 0.0
        sr = self.acoustics["sr"]
        n_samples_vis = int(self.vis_cfg.get("n_samples", 10))
        rows = []
        loss_sum: dict[str, float] = {}
        loss_cnt: dict[str, int] = {}
        for i in range(len(self.valid_dataset)):
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
        all_types = sorted(
            {self.valid_dataset.speech_type_of(i) for i in range(len(self.valid_dataset))}
        )
        # per-type validation loss (reference fullsubnet/trainer.py:160-169)
        for speech_type in all_types:
            if loss_cnt.get(speech_type):
                self._log_scalar(f"Validation/Loss_{speech_type}",
                                 loss_sum[speech_type] / loss_cnt[speech_type], epoch)
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
