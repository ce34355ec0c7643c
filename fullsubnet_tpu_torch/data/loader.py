"""The training data loader (counterpart of ``fullsubnet_tpu/data/loader.py``).

``torch.utils.data.DataLoader`` with a sampler that yields the JAX
package's epoch permutation, ``default_rng(SeedSequence([seed, epoch]))
.permutation(n)``, so the port sees the batches the JAX package sees from
the same seed. ``set_epoch`` moves both the permutation and the dataset's
per-item RNG stream to the epoch. Items are collated by torch's default
collate (float32 arrays to float32 tensors, int16 to int16, numpy scalars
to [B] tensors).

Data-parallel training gives each process its shard (``shard_index`` of
``num_shards``): the epoch's permutation padded by wrapping to a multiple
of ``num_shards`` and strided by shard, as ``DistributedSampler`` and the
JAX loader do, so every shard has the same length.
"""

from __future__ import annotations

import numpy as np
import torch


class EpochPermutationSampler(torch.utils.data.Sampler):
    """Indices 0..n-1 in the epoch's permutation (in order when not
    shuffling)."""

    def __init__(self, n: int, seed: int = 0, shuffle: bool = True, shard_index: int = 0,
                 num_shards: int = 1):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
            idx = rng.permutation(self.n)
        else:
            idx = np.arange(self.n)
        if self.num_shards > 1:
            total = -(-self.n // self.num_shards) * self.num_shards
            if total > self.n:
                idx = np.concatenate([idx, idx[: total - self.n]])
            idx = idx[self.shard_index :: self.num_shards]
        return idx

    def __iter__(self):
        return iter(int(i) for i in self.indices())

    def __len__(self) -> int:
        return -(-self.n // self.num_shards)  # the padded shard


class DataLoader:
    """Batches of a map-style dataset in the epoch's permutation; items are
    made in ``num_workers`` worker processes (0: in this process); with
    ``num_shards`` > 1, only shard ``shard_index`` of each epoch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.sampler = EpochPermutationSampler(len(dataset), seed, shuffle, shard_index,
                                               num_shards)
        self._loader = torch.utils.data.DataLoader(
            dataset, batch_size=batch_size, sampler=self.sampler, drop_last=drop_last,
            num_workers=num_workers,
        )

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self._loader)

    def __iter__(self):
        return iter(self._loader)
