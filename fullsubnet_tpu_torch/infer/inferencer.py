"""Inference runtime (counterpart of ``fullsubnet_tpu/infer/inferencer.py``).

The ``full_band_crm_mask`` strategy, which every shipped FullSubNet
config uses: STFT -> magnitude -> model -> cIRM decompression (clamp
±9.9) -> complex mask -> iSTFT at the input length, then an
unconditional peak normalisation to 0.8 full scale on write. Each
utterance runs at its exact length: PyTorch runs eagerly, so the JAX
package's length bucketing (which exists to avoid one XLA compile per
length, and is exact by construction) has no counterpart here.

Not ported yet (ROADMAP A.13): the other strategies and batched
inference (``batch_size > 1``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fullsubnet_tpu_torch import config as config_lib
from fullsubnet_tpu_torch.acoustics.mask import complex_mul, decompress_cIRM
from fullsubnet_tpu_torch.acoustics.stft import istft, stft_complex
from fullsubnet_tpu_torch.checkpoint import load_torch_state_dict
from fullsubnet_tpu_torch.data.wavio import write_wav
from fullsubnet_tpu_torch.utils import prepare_empty_dir, resolve_device


class Inferencer:
    def __init__(
        self,
        config: dict,
        checkpoint_path: str,
        output_dir: str | None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config
        self.acoustics = config_lib.acoustics_args(config)
        self.inference_config = config.get("inferencer", {})
        self.strategy = self.inference_config.get("type", "full_band_crm_mask")
        if self.strategy != "full_band_crm_mask":
            raise NotImplementedError(
                f"inference type {self.strategy!r} is not ported yet (ROADMAP A.13)"
            )
        if int(self.inference_config.get("batch_size", 1)) > 1:
            raise NotImplementedError(
                "batched inference (batch_size > 1) is not ported yet (ROADMAP A.13)"
            )
        self.sr = self.acoustics["sr"]

        ds_section = config.get("dataset", config.get("inference_dataset"))
        self.dataset = (
            config_lib.build_dataset(ds_section, "inference")
            if ds_section is not None
            else None
        )

        self.model, _ = config_lib.build_model(config)
        self.model.load_state_dict(load_torch_state_dict(Path(checkpoint_path).expanduser()))
        self.model.to(self.device).eval()

        if output_dir is not None:
            self.output_dir = Path(output_dir).expanduser().absolute()
            self.enhanced_dir = self.output_dir / "enhanced"
            self.noisy_dir = self.output_dir / "noisy"
            prepare_empty_dir([self.enhanced_dir, self.noisy_dir])
        else:
            self.output_dir = self.enhanced_dir = self.noisy_dir = None

    def predict_crm(self, noisy: torch.Tensor):
        """noisy [B, T] on the model's device -> (decompressed cIRM
        [B, F, T', 2], complex STFT [B, F, T'])."""
        a = self.acoustics
        with torch.inference_mode():
            spec = stft_complex(noisy, a["n_fft"], a["hop_length"], a["win_length"])
            crm = self.model(spec.abs()[:, None], dropping_band=False)  # [B, 2, F, T']
            crm = decompress_cIRM(crm.permute(0, 2, 3, 1))
        return crm, spec

    def full_band_crm_mask(self, noisy: torch.Tensor) -> np.ndarray:
        """noisy [1, T] -> enhanced [T] (float32, before peak scaling)."""
        a = self.acoustics
        crm, spec = self.predict_crm(noisy)
        with torch.inference_mode():
            real, imag = complex_mul(spec.real, spec.imag, crm[..., 0], crm[..., 1])
            enhanced = istft(
                (real, imag), a["n_fft"], a["hop_length"], a["win_length"],
                length=noisy.shape[-1], input_type="real_imag",
            )
        return enhanced[0].cpu().numpy()

    def _write_outputs(self, enhanced: np.ndarray, noisy, name: str):
        enhanced = np.asarray(enhanced, dtype=np.float32)
        # unconditional peak normalisation to 0.8 full scale, exactly the
        # reference's `0.8 * enhanced / max(|enhanced|)`
        peak = np.max(np.abs(enhanced))
        if peak > 0:
            enhanced = enhanced / peak * 0.8
        write_wav(self.enhanced_dir / f"{name}.wav", enhanced, self.sr)
        # the noisy copy: first channel, trimmed to the enhanced length
        noisy_out = np.asarray(noisy, np.float32)
        if noisy_out.ndim > 1:
            noisy_out = noisy_out[0]
        noisy_out = noisy_out[: enhanced.shape[-1]]
        write_wav(self.noisy_dir / f"{name}.wav", noisy_out, self.sr)

    def __call__(self):
        if self.dataset is None or self.enhanced_dir is None:
            raise RuntimeError(
                "Inferencer was built without a dataset/output_dir; "
                "batch enhancement needs both"
            )
        for i in range(len(self.dataset)):
            noisy, name = self.dataset[i]
            wave = torch.from_numpy(np.asarray(noisy, np.float32)[None]).to(self.device)
            self._write_outputs(self.full_band_crm_mask(wave), noisy, name)
        return self.enhanced_dir
