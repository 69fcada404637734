"""Moving a collated batch onto the device.  Port of ``device_batch`` of
``raggesture_tpu/train/runner.py`` (its training loop comes with the
training runtime)."""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

# the tensor fields the model reads; everything else in a collated batch
# (strings, discourse tuples, ...) stays on the host
DEVICE_BATCH_KEYS = (
    "motion_upper", "motion_lower", "motion_face", "motion_hands",
    "trans", "facial", "contact", "motion_mask", "word", "audio",
    "speaker_ids", "latent_mu", "latent_logvar",
)

# with cached latents the motion fields never reach the train step: the
# loss samples z0 from (mu, logvar) and masks by motion_mask only
_MOTION_KEYS = ("motion_upper", "motion_lower", "motion_face",
                "motion_hands", "trans", "facial", "contact")


def device_batch(batch: Dict[str, Any], device: Union[str, torch.device]
                 ) -> Dict[str, torch.Tensor]:
    """The model's fields of a ``collate`` batch (``DEVICE_BATCH_KEYS``) as
    tensors on ``device`` (float32, the speaker ids int64), and its ragged
    fields (names, transcripts, labels) as the host lists they are; the
    other arrays are left out, as in the JAX package."""
    keys = DEVICE_BATCH_KEYS
    if "latent_mu" in batch:
        keys = tuple(k for k in keys if k not in _MOTION_KEYS)
    out = {k: v for k, v in batch.items() if isinstance(v, list)}
    for k in keys:
        if k in batch:
            dtype = torch.int64 if k == "speaker_ids" else torch.float32
            out[k] = torch.as_tensor(np.asarray(batch[k])).to(
                device=device, dtype=dtype)
    return out
