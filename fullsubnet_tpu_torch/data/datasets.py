"""Inference dataset listing (counterpart of the inference part of
``fullsubnet_tpu/data/datasets.py``). Training datasets come with the
training slice (ROADMAP A.7)."""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from fullsubnet_tpu_torch.data.wavio import load_wav
from fullsubnet_tpu_torch.utils import basename

_AUDIO_EXTS = (".wav", ".flac", ".aif", ".aiff", ".ogg")


def find_audio_files(directory: str | os.PathLike) -> list[str]:
    """Recursively list audio files, sorted."""
    out = []
    for root, _dirs, files in os.walk(os.fspath(directory)):
        for f in files:
            if f.lower().endswith(_AUDIO_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


class InferenceDataset:
    """Noisy-only recursive listing; returns (waveform, basename)."""

    def __init__(self, dataset_dir_list, sr=16000):
        if not isinstance(dataset_dir_list, list):
            raise TypeError("dataset_dir_list must be a list of directories")
        self.sr = sr
        self.noisy_file_path_list = []
        for dataset_dir in dataset_dir_list:
            d = Path(dataset_dir).expanduser().absolute()
            self.noisy_file_path_list += find_audio_files(d)
        self.length = len(self.noisy_file_path_list)

    def __len__(self):
        return self.length

    def __getitem__(self, item: int):
        noisy_file_path = self.noisy_file_path_list[item]
        noisy_y = load_wav(noisy_file_path, sr=self.sr).astype(np.float32)
        return noisy_y, basename(noisy_file_path)[0]
