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

Checkpoints are the reference's set, in torch format:
``latest_model.tar`` ({model, optimizer, epoch, best_score}),
``model_NNNN.pth`` ({model}, loadable by the port's infer CLI) and
``best_model.tar``. ``-R`` resumes from ``latest_model.tar``; ``-P``
starts from a torch checkpoint's weights.

Not ported yet: validation (``ValidationDataset``, STOI/PESQ; ROADMAP
A.19) and gradient accumulation (A.20). A config whose validation would
run, or with ``grad_accum_steps`` > 1, raises at construction. As in the
JAX package, a config without a validation set scores every validation
epoch 0.0, so ``best_model.tar`` is written then. The host-RSS recycle,
the preemption hook and the device mesh are TPU-side and not ported.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from fullsubnet_tpu_torch import config as config_lib
from fullsubnet_tpu_torch.acoustics.feature import drop_band
from fullsubnet_tpu_torch.acoustics.mask import build_complex_ideal_ratio_mask
from fullsubnet_tpu_torch.acoustics.stft import stft_complex
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict, save_checkpoint
from fullsubnet_tpu_torch.data.loader import DataLoader
from fullsubnet_tpu_torch.utils import prepare_empty_dir, resolve_device


class Trainer:
    # fold the per-step losses to the host every N steps: a NaN surfaces
    # within a window, and an epoch holds a bounded number of them
    _LOSS_FOLD_STEPS = 256

    def __init__(
        self,
        config: dict,
        resume: bool = False,
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

        self.epochs = int(train_cfg.get("epochs", 9999))
        self.save_checkpoint_interval = int(train_cfg.get("save_checkpoint_interval", 1))
        self.validation_interval = int(val_cfg.get("validation_interval", 1))
        if self.save_checkpoint_interval < 1 or self.validation_interval < 1:
            raise ValueError("save_checkpoint_interval and validation_interval must be >= 1")
        if "validation_dataset" in config and self.validation_interval <= self.epochs:
            raise NotImplementedError(
                "validation (ValidationDataset, STOI/PESQ) is not ported yet (ROADMAP "
                "A.19); remove [validation_dataset] or set validation_interval above epochs"
            )
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

        self.model, init_kwargs = config_lib.build_model(
            config, generator=torch.Generator().manual_seed(self.seed)
        )
        if init_kwargs["weight_init"]:
            raise NotImplementedError(
                "weight_init = true (orthogonal / xavier init, nn/init.py) is not "
                "ported (ROADMAP A.3); the flagship recipes set weight_init = false"
            )
        self.model.to(self.device)
        self.loss_function = config_lib.build_loss(config)
        self.clip = float(train_cfg.get("clip_grad_norm_value", 0) or 0)
        self.optimizer = config_lib.build_optimizer(config, self.model.parameters())
        self.epoch = 0
        # reference base_trainer.py:90: -inf when selecting on a maximize metric
        self.best_score = -math.inf if self.save_max_metric_score else math.inf
        self.steps = 0
        self.epoch_losses: dict[int, float] = {}

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
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": epoch,
            "best_score": self.best_score,
        }
        save_checkpoint(self.checkpoints_dir / "latest_model.tar", state)
        save_checkpoint(self.checkpoints_dir / f"model_{epoch:04d}.pth", {"model": state["model"]})
        if is_best:
            save_checkpoint(self.checkpoints_dir / "best_model.tar", state)

    def _is_best_epoch(self, score: float) -> bool:
        if self.save_max_metric_score and score >= self.best_score:
            self.best_score = score
            return True
        if not self.save_max_metric_score and score <= self.best_score:
            self.best_score = score
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
        if self.writer is not None:
            self.writer.add_scalar("Loss/Train", mean, epoch)
        return mean

    def train(self):
        for epoch in range(self.epoch + 1, self.epochs + 1):
            print(f"{'=' * 15} epoch {epoch} {'=' * 15}")
            t0 = time.perf_counter()
            self._train_epoch(epoch)
            self.epoch = epoch
            if epoch % self.save_checkpoint_interval == 0:
                self._save_checkpoint(epoch)
            # no validation set (construction refuses one that would run):
            # the score is 0.0, as the JAX package's empty validation epoch
            if epoch % self.validation_interval == 0 and self._is_best_epoch(0.0):
                self._save_checkpoint(epoch, is_best=True)
            print(f"[{time.perf_counter() - t0:.2f} seconds] This epoch is finished.")
        if self.writer is not None:
            self.writer.close()
