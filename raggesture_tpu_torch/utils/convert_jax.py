"""Load a JAX-package parameter tree into the port's modules.

The port's modules carry the JAX tree's names, so the mapping is
mechanical: the leaf at ``denoiser/block_0/sa_block/query/kernel`` is the
parameter ``denoiser.block_0.sa_block.query.weight``.  A Dense ``kernel``
(in, out) becomes a Linear ``weight`` (out, in); a LayerNorm ``scale`` and
an Embed ``embedding`` become ``weight``; ``bias``, ``pe`` and
``global_motion_token`` keep their names.  The FGD embedder's raw
parameters keep their names and layouts: a ``SkeletonConv``'s ``weight``
(out, in, k) and the conv decoder's ``{name}_w`` / ``{name}_b``; only a
Dense ``kernel`` is transposed.  A flax ``MultiHeadDotProductAttention``
(the condition encoders' ``attn_{i}``) has 3-D kernels: its ``query``,
``key`` and ``value`` kernels (D, H, Dh) and biases (H, Dh) are flattened
to (D, H·Dh) and (H·Dh,), its ``out`` kernel (H, Dh, D) to (H·Dh, D),
before the transpose (``_mha_leaf``).  The tree is nested dicts of
array-likes (numpy arrays), so nothing of JAX is imported here.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "pe": "pe",
               "global_motion_token": "global_motion_token",
               "weight": "weight"}


_MHA_PROJECTIONS = ("query", "key", "value", "out")


def _mha_leaf(path: list, key: str, arr: np.ndarray) -> np.ndarray:
    """A flax attention projection's leaf at the port's 2-D / 1-D shape;
    every other leaf as it is.  Only a leaf of ``attn_*/{query, key,
    value, out}`` of the 3-D kernel / 2-D bias rank is reshaped."""
    if (len(path) < 2 or not path[-2].startswith("attn_")
            or path[-1] not in _MHA_PROJECTIONS):
        return arr
    if key == "kernel" and arr.ndim == 3:
        if path[-1] == "out":
            return arr.reshape(-1, arr.shape[-1])       # (H·Dh, D)
        return arr.reshape(arr.shape[0], -1)            # (D, H·Dh)
    if key == "bias" and arr.ndim == 2:
        return arr.reshape(-1)                          # (H·Dh,)
    return arr


def _leaf_name(key: str):
    """The port's parameter name for a JAX leaf name, or None."""
    if key in _LEAF_NAMES:
        return _LEAF_NAMES[key]
    if key.endswith(("_w", "_b")):   # the FGD conv decoder's raw leaves
        return key
    return None


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
            name = _leaf_name(key)
            if name is None:
                raise KeyError(f"JAX leaf {leaf}: unknown leaf name {key!r}")
            target = ".".join(path + [name])
            if target not in expected:
                raise KeyError(f"JAX leaf {leaf} has no counterpart {target}")
            if target in assigned:
                raise KeyError(f"JAX leaf {leaf} fills {target} twice")
            arr = _mha_leaf(path, key, np.array(val, dtype=np.float32))
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
