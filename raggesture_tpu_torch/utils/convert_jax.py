"""Load a JAX-package parameter tree into the port's modules.

The port's modules carry the JAX tree's names, so the mapping is
mechanical: the leaf at ``denoiser/block_0/sa_block/query/kernel`` is the
parameter ``denoiser.block_0.sa_block.query.weight``.  A Dense ``kernel``
(in, out) becomes a Linear ``weight`` (out, in); a LayerNorm ``scale`` and
an Embed ``embedding`` become ``weight``; ``bias``, ``pe`` and
``global_motion_token`` keep their names.  The tree is nested dicts of
array-likes (numpy arrays), so nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "pe": "pe",
               "global_motion_token": "global_motion_token"}


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping) -> None:
    """Fill every parameter of ``model`` from ``tree`` ({"params": {...}} or
    the inner dict).  Raises on a leaf with no counterpart, a parameter the
    tree does not fill, a leaf used twice, or a shape mismatch."""
    params = tree["params"] if "params" in tree else tree
    expected = dict(model.named_parameters())
    assigned = set()

    def walk(node: Mapping, path: list) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [key])
                continue
            leaf = "/".join(path + [key])
            if key not in _LEAF_NAMES:
                raise KeyError(f"JAX leaf {leaf}: unknown leaf name {key!r}")
            target = ".".join(path + [_LEAF_NAMES[key]])
            if target not in expected:
                raise KeyError(f"JAX leaf {leaf} has no counterpart {target}")
            if target in assigned:
                raise KeyError(f"JAX leaf {leaf} fills {target} twice")
            arr = np.array(val, dtype=np.float32)
            if key == "kernel":
                arr = np.ascontiguousarray(arr.T)
            param = expected[target]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"JAX leaf {leaf} has shape {arr.shape}, "
                                 f"{target} {tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
            assigned.add(target)

    walk(params, [])
    missing = sorted(set(expected) - assigned)
    if missing:
        raise KeyError(f"{len(missing)} parameters have no JAX leaf, e.g. "
                       f"{missing[:5]}")
