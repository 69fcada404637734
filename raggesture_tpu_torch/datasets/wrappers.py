"""Dataset wrappers.  Port of ``raggesture_tpu/datasets/wrappers.py``
(reference mogen/datasets/dataset_wrappers.py:7-41)."""

from __future__ import annotations

import bisect
from typing import Sequence


class ConcatDataset:
    """Datasets of one record schema, one after the other."""

    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative.append(total)

    def __len__(self):
        return self.cumulative[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        ds = bisect.bisect_right(self.cumulative, idx)
        prev = self.cumulative[ds - 1] if ds > 0 else 0
        return self.datasets[ds][idx - prev]


class RepeatDataset:
    """A dataset ``times`` times over (fewer, longer epochs)."""

    def __init__(self, dataset, times: int):
        if times < 1:
            raise ValueError(f"times must be at least 1, got {times}")
        self.dataset = dataset
        self.times = times
        self._len = len(dataset) * times

    def __len__(self):
        return self._len

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += self._len
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        return self.dataset[idx % len(self.dataset)]
