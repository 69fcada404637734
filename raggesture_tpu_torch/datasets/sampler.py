"""Epoch-seeded shuffling sampler + host data loader.

Port of ``raggesture_tpu/datasets/sampler.py`` (``EpochSampler``,
``DataLoader``, ``build_dataloader``; the prefetching loader comes with the
training runtime), after the reference's DistributedSampler +
build_dataloader (mogen/datasets/samplers/distributed_sampler.py:5-42,
mogen/datasets/builder.py:95-168): epoch-seeded deterministic shuffle
(numpy ``RandomState``, so a seed gives the JAX package's batch order),
round-up padding so every shard sees the same number of samples, and
``indices[shard::num_shards]`` interleaved subsampling.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np

from .beatx import collate


class EpochSampler:
    """Deterministic per-epoch index stream with shard subsampling."""

    def __init__(self, num_samples: int, shuffle: bool = True,
                 num_shards: int = 1, shard: int = 0, round_up: bool = True,
                 seed: int = 0):
        assert 0 <= shard < num_shards
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard = shard
        self.round_up = round_up
        self.seed = seed
        self.epoch = 0
        if round_up:
            self.per_shard = int(math.ceil(num_samples / num_shards))
            self.total = self.per_shard * num_shards
        else:
            self.total = num_samples
            self.per_shard = len(range(shard, num_samples, num_shards))

    def set_epoch(self, epoch: int):
        """mmcv DistSamplerSeedHook equivalent — reseed per epoch."""
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            g = np.random.RandomState(self.seed + self.epoch)
            idx = g.permutation(self.num_samples)
        else:
            idx = np.arange(self.num_samples)
        if self.round_up and self.total > self.num_samples:
            # tile (not a single slice) so even num_shards >> num_samples
            # fills every shard to per_shard — a short shard would deadlock
            # the collectives of the other processes' steps
            reps = int(math.ceil(self.total / self.num_samples))
            idx = np.tile(idx, reps)[: self.total]
        return idx[self.shard::self.num_shards]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())

    def __len__(self) -> int:
        return self.per_shard


class DataLoader:
    """Batches dataset records through ``collate`` into host arrays.

    ``drop_last=True`` (train) keeps every batch the same shape; eval uses
    ``drop_last=False`` and pads the tail batch, returning a validity
    mask."""

    def __init__(self, dataset, batch_size: int, sampler: Optional[EpochSampler]
                 = None, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, collate_fn=collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or EpochSampler(len(dataset), shuffle=shuffle,
                                               seed=seed)
        self.drop_last = drop_last
        self.collate_fn = collate_fn

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else int(
            math.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[Dict]:
        buf: List[int] = []
        for idx in self.sampler:
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield self._make_batch(buf)
                buf = []
        if buf and not self.drop_last:
            pad = buf + [buf[-1]] * (self.batch_size - len(buf))
            batch = self._make_batch(pad)
            batch["valid_mask"] = np.arange(self.batch_size) < len(buf)
            yield batch

    def _make_batch(self, indices: List[int]) -> Dict:
        records = [self.dataset[i] for i in indices]
        batch = self.collate_fn(records)
        batch["valid_mask"] = np.ones((len(indices),), bool)
        return batch


def build_dataloader(dataset, samples_per_device: int, num_devices: int,
                     shuffle: bool = True, round_up: bool = True,
                     num_shards: int = 1, shard: int = 0, seed: int = 0,
                     drop_last: bool = True) -> DataLoader:
    """Reference build_dataloader contract (mogen/datasets/builder.py:95-168):
    global batch = samples_per_device * num_devices, sharded per host."""
    sampler = EpochSampler(len(dataset), shuffle=shuffle,
                           num_shards=num_shards, shard=shard,
                           round_up=round_up, seed=seed)
    return DataLoader(dataset, samples_per_device * num_devices,
                      sampler=sampler, drop_last=drop_last)
