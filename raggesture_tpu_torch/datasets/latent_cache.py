"""Parameter fingerprints.  Port of ``tree_fingerprint`` of
``raggesture_tpu/datasets/latent_cache.py``; the rest of that module (the
frozen-codec latent cache) is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
from typing import Mapping

import numpy as np
import torch


def tree_fingerprint(state: Mapping[str, torch.Tensor]) -> str:
    """Order-stable fingerprint of a ``state_dict``: for every tensor its
    name, float64 sum and float64 absolute sum, sorted and hashed (SHA-1,
    16 hex digits)."""
    acc = []
    for name, t in state.items():
        a = np.asarray(t.detach().to("cpu", torch.float64).numpy())
        acc.append((name, float(a.sum()), float(np.abs(a).sum())))
    acc.sort()
    return hashlib.sha1(json.dumps(acc).encode()).hexdigest()[:16]
