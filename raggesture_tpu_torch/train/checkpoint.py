"""The inference artifact: a model's parameters as one file.  Port of
``save_params`` and ``load_params`` of ``raggesture_tpu/train/checkpoint.py``
(its ``CheckpointManager``, with the optimizer state and exact resume,
comes with the training runtime).

The file is a torch ``state_dict`` (tensors on the CPU, loaded with
``weights_only=True``) and beside it ``<path>.meta.json``, the host
metadata.  A JAX params tree reaches the format through
``utils/convert_jax.py::load_jax_params`` followed by ``save_params``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch
from torch import nn


def save_params(path: str, model: nn.Module, meta: Optional[Dict] = None
                ) -> None:
    """Write ``model.state_dict()`` (moved to the CPU) to ``path`` and
    ``meta`` to ``path + ".meta.json"``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().to("cpu") for k, v in
                model.state_dict().items()}, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(dict(meta or {}), f)


@torch.no_grad()
def load_params(path: str, model: nn.Module) -> Dict:
    """Copy the parameters at ``path`` into ``model`` in place, on the
    model's device, and return the metadata.  Raises, before anything is
    copied, on a key of the model the file lacks, a key of the file the
    model does not have, or a shape that differs."""
    state = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"{path}: {len(missing)} parameters missing, e.g. "
                       f"{missing[:3]}; {len(unused)} unused, e.g. "
                       f"{unused[:3]}")
    shapes = [k for k, v in state.items() if v.shape != own[k].shape]
    if shapes:
        k = shapes[0]
        raise ValueError(f"{path}: {len(shapes)} parameters mis-shaped, e.g. "
                         f"{k} {tuple(state[k].shape)} against "
                         f"{tuple(own[k].shape)}")
    for k, v in state.items():
        own[k].copy_(v)
    meta_path = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)
