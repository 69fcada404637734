"""Epoch-seeded shuffling sampler + host data loader.

Port of ``raggesture_tpu/datasets/sampler.py`` (``EpochSampler``,
``DataLoader``, ``build_dataloader``, ``PrefetchLoader``,
``prefetch_iter``), after the reference's DistributedSampler +
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


class PrefetchLoader:
    """A loader whose batches are read and collated by a thread pool while
    the card runs the current step (the reference's ``workers_per_gpu``
    loading), ``depth`` batches in flight; the batches and their order are
    the wrapped loader's.  Threads suffice: the work is file reads and
    numpy, which release the GIL."""

    def __init__(self, loader: DataLoader, num_workers: int = 4,
                 depth: Optional[int] = None):
        self.loader = loader
        self.num_workers = max(1, num_workers)
        # at least num_workers in flight, or the pool's last threads idle
        self.depth = max(1, depth if depth is not None else self.num_workers)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import concurrent.futures as cf
        from collections import deque

        bs = self.loader.batch_size
        idx_stream = list(self.loader.sampler)
        chunks = [idx_stream[i:i + bs] for i in range(0, len(idx_stream), bs)]
        if self.loader.drop_last:
            chunks = [c for c in chunks if len(c) == bs]

        def make(chunk):
            pad = chunk + [chunk[-1]] * (bs - len(chunk))
            batch = self.loader._make_batch(pad)
            if len(chunk) < bs:
                batch["valid_mask"] = np.arange(bs) < len(chunk)
            return batch

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            inflight = deque()
            it = iter(chunks)
            for _ in range(self.depth):
                c = next(it, None)
                if c is not None:
                    inflight.append(pool.submit(make, c))
            while inflight:
                fut = inflight.popleft()
                c = next(it, None)
                if c is not None:
                    inflight.append(pool.submit(make, c))
                yield fut.result()


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """``it`` driven from a background thread, up to ``depth`` items ahead
    of the consumer: the training runner's staging (the copy to the card)
    of batch j + 1 overlaps step j.  An exception in the worker
    is raised in the consumer, after the items made before it; a consumer
    that stops early leaves the worker blocked on the full queue (a daemon
    thread)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:      # raised again on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
