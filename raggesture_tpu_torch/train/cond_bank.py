"""A device-resident bank of per-sample training rows.  Port of
``raggesture_tpu/train/cond_bank.py`` (``DeviceSampleBank``).

Every field the train step reads is constant per sample: the condition
features (word, audio), the latent cache's (mu, logvar), the motion and
its mask of a fixed window.  The loader nevertheless ships all of it to
the card every step.  The bank keeps one row per sample on the card (an
LRU of ``capacity`` rows keyed by the dataset's ``sample_idx``); a batch
copies only the rows the bank lacks, and takes the others from the bank
with one gather a field on the card.

Design (two faults of the JAX bank not copied).  The JAX bank protects
only the current batch's ids from eviction, and its runner gathers a
k-batch stack's rows in the step, later: when the capacity is below the
unique ids of a stack, a later batch of the stack evicts a row an earlier
batch still needs, and that batch gathers another sample's row.  And in
torch the bank is written in place while the prefetch worker stages
batch j + 1 and step j may still be queued.  Here :meth:`stage` gathers
the batch's rows out of the bank at once, into tensors of their own: no
later write to the bank can reach rows already staged, whatever the
capacity, so nothing has to be pinned.  The bank's writes and gathers
are all made by the one thread that stages, on its stream, in order.
Eviction takes the least recently used id outside the current batch; a
batch of more unique ids than the capacity raises ValueError (the runner
streams such a batch).  A batch's ids take their slots only once its rows
are written, so a stage that fails maps no id to a row it did not write
(the victims whose rows it began to overwrite leave the bank).  The
gathered rows are the values the loader would have shipped, so a banked
run equals a streaming one bitwise.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .runner import device_batch


class DeviceSampleBank:
    """An LRU of per-sample rows on ``device``, ``capacity`` rows a field,
    keyed by ``sample_idx``.  ``hits``, ``misses`` and ``evictions`` count
    rows taken from the bank, rows copied in and rows evicted."""

    def __init__(self, capacity: int,
                 device: Union[str, torch.device] = "cpu",
                 bf16_conditions: bool = False):
        if capacity <= 0:
            raise ValueError(f"bank capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.device = torch.device(device)
        # rows copied in as device_batch ships them (the bf16 wire cast of
        # word and audio included, as the JAX runner stages its cast batch)
        self.bf16_conditions = bool(bf16_conditions)
        self.banks: Optional[Dict[str, torch.Tensor]] = None
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()  # id -> slot
        self._free = list(range(capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def stage(self, batch: Dict, sample_idx) -> Dict[str, torch.Tensor]:
        """The model's fields of ``batch`` (a ``collate`` batch), as
        ``device_batch`` would ship them, with the rows the bank holds
        taken from it and only the missing rows copied in.  The returned
        tensors are the bank's rows gathered into tensors of their own."""
        ids = [int(i) for i in np.asarray(sample_idx).reshape(-1)]
        if len(set(ids)) > self.capacity:
            raise ValueError(f"batch has {len(set(ids))} unique samples > "
                             f"bank capacity {self.capacity}")
        in_batch = set(ids)
        missing = list(OrderedDict.fromkeys(
            i for i in ids if i not in self._slot_of))
        free = list(self._free)
        lru = (k for k in self._slot_of if k not in in_batch)
        victims, new_slots = [], {}
        for sid in missing:
            if free:
                new_slots[sid] = free.pop()
            else:
                victims.append(next(lru))
                new_slots[sid] = self._slot_of[victims[-1]]
        if missing:
            pos = {sid: p for p, sid in reversed(list(enumerate(ids)))}
            rows = device_batch({k: np.asarray(v)[[pos[s] for s in missing]]
                                 for k, v in batch.items()
                                 if isinstance(v, np.ndarray)}, self.device,
                                self.bf16_conditions)
            rows = {k: v for k, v in rows.items()
                    if isinstance(v, torch.Tensor)}
            if self.banks is None:
                self.banks = {k: torch.zeros((self.capacity,) + v.shape[1:],
                                             dtype=v.dtype, device=self.device)
                              for k, v in rows.items()}
            slots = torch.tensor([new_slots[s] for s in missing],
                                 device=self.device)
            try:
                for k, bank in self.banks.items():
                    bank.index_copy_(0, slots, rows[k])
            except BaseException:
                # a victim's row may be overwritten in part: it goes too
                for victim in victims:
                    self._free.append(self._slot_of.pop(victim))
                raise
        # the rows are written: the new ids take their slots
        self._free = free
        for victim in victims:
            del self._slot_of[victim]
        self._slot_of.update(new_slots)
        self.evictions += len(victims)
        self.misses += len(missing)
        self.hits += len(ids) - len(missing)
        for sid in ids:
            self._slot_of.move_to_end(sid)
        idx = torch.tensor([self._slot_of[s] for s in ids],
                           device=self.device)
        return {k: bank.index_select(0, idx) for k, bank in self.banks.items()}

    def resident(self) -> List[int]:
        """The ids the bank holds, least recently used first."""
        return list(self._slot_of)
