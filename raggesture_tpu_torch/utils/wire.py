"""Host→device wire format of the condition features.

Port of ``raggesture_tpu/utils/wire.py``.  The raw condition features
(audio 499×768 and word 150×768 float32, ~2 MB a sample) are the largest
host→device copy of a batch, and their first use on the device is a
product.  ``bf16_conditions`` ships them as bfloat16: half the bytes, at the
cost of rounding them to bf16 (their products then run in float32 on the
rounded values, as jnp promotes a bf16 operand against float32 weights).

One policy for the training runner (``train/runner.py::device_batch``) and
the generator (``StagedGenerator(bf16_conditions=...)``, the batch's and the
retrieved exemplars' features), so the key set and the cast cannot diverge.
The JAX retrieval database also casts the rows of its device payload bank
on a TPU; the port keeps no such bank, and its exemplar rows reach the
device through the generator's cast.
NumPy has no bfloat16 without ``ml_dtypes``, so the cast goes through
``torch.from_numpy``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# raw condition features eligible for the bf16 wire cast
CONDITION_FEATURE_KEYS = ("word", "audio")


def cast_condition_features(d: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``d`` whose float32 NumPy condition features are bfloat16
    tensors on the host (round to nearest even, as ``ml_dtypes`` casts).

    Host NumPy arrays only: that is where the copy is saved.  A tensor is
    already where it will be used and passes through untouched, as a
    device array does in the JAX package."""
    out = dict(d)
    for k in CONDITION_FEATURE_KEYS:
        v = out.get(k)
        if isinstance(v, np.ndarray) and v.dtype == np.float32:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                torch.bfloat16)
    return out
