"""The reference's torch checkpoints onto the port's modules.

Port of ``raggesture_tpu/utils/convert_torch.py`` for the FGD embedder
(``load_torch_state`` :40-56, ``convert_fgd`` :278-336): the reference's
VAESKConv checkpoint (``AESKConv_240_100.bin``) goes straight onto
``models/eval_fgd.py::FGDEmbedder``, its SkeletonConv masks baked into the
weights as the JAX package does.  The other converters (the part VAEs and
the denoiser) are not ported yet (ROADMAP §A).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def strip_prefix(state: Dict[str, np.ndarray], prefix: str
                 ) -> Dict[str, np.ndarray]:
    """Remove a key prefix (DDP "module." / mmcv "model.") where a key has
    it; other keys are kept verbatim."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in state.items()}


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file as {name: np.ndarray}, out of the
    reference's containers ({"model_state": ...} for the VAEs and the FGD
    model, {"state_dict": ...} for mmcv) or a raw state dict; tensors only,
    DDP's "module." prefix stripped.  Read with ``weights_only=True``:
    tensors and plain containers, no arbitrary pickled objects."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state", "state_dict", "model"):
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            blob = blob[key]
            break
    state = {k: v.detach().cpu().numpy() for k, v in blob.items()
             if isinstance(v, torch.Tensor)}
    return strip_prefix(state, "module.")


@torch.no_grad()
def convert_fgd(state: Mapping[str, np.ndarray], model: nn.Module) -> None:
    """Fill ``model`` (an ``FGDEmbedder``) from a VAESKConv state dict
    (reference mogen/models/eval_models/model.py:244-252).

    Encoder stage i: ``encoder.layers.{i}.0.residual.0`` SkeletonConv (its
    ``.mask`` baked into the weight), ``.residual.1`` GroupNorm,
    ``.0.shortcut`` SkeletonConv, and ``.0.common.0.weight`` the stage's
    mean-pool matrix where it pools.  Decoder (VQDecoderV3): two ResBlocks
    (``decoder.main.{idx}.model.{0,2}``), then the upsample stages' convs
    and the final conv, all (out, in, k) as the port's.  The released file
    carries ``fc_mu`` / ``fc_logvar`` (VAEConv always makes them); a
    non-variational embedder, as evaluation runs it, does not read them.

    Raises on a key nothing reads, a parameter nothing fills, a shape
    mismatch, or a mask or pool matrix other than the model's topology."""
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    used = set()

    def take(key):
        used.add(key)
        return state[key]

    def same_constant(key, want: torch.Tensor):
        if not np.array_equal(take(key), want.cpu().numpy()):
            raise ValueError(f"{key} is not the model's skeleton topology")

    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"encoder.layers.{i}.0.residual.0.weight" in state:
        base = f"encoder.layers.{i}.0"
        layer = getattr(model.encoder, f"layer_{i}", None)
        if layer is None:
            raise KeyError(f"{base}: the model has {i} encoder stages")
        for src, dst in (("residual.0", "conv"), ("shortcut", "shortcut")):
            w = take(f"{base}.{src}.weight")
            if f"{base}.{src}.mask" in state:
                same_constant(f"{base}.{src}.mask", getattr(layer, dst).mask)
                w = w * state[f"{base}.{src}.mask"]
            out[f"encoder.layer_{i}.{dst}.weight"] = w
            out[f"encoder.layer_{i}.{dst}.bias"] = take(f"{base}.{src}.bias")
        out[f"encoder.layer_{i}.norm.weight"] = take(f"{base}.residual.1.weight")
        out[f"encoder.layer_{i}.norm.bias"] = take(f"{base}.residual.1.bias")
        pool = f"{base}.common.0.weight"
        if (pool in state) != layer.do_pool:
            raise ValueError(f"{base}: the checkpoint and the model disagree "
                             f"on whether stage {i} pools")
        if layer.do_pool:
            same_constant(pool, layer.pool_w)
        i += 1
    if i == 0:
        raise KeyError("no encoder.layers.*.0.residual.0.weight in the state "
                       "dict: is this a VAESKConv checkpoint?")

    # decoder.main.{idx}: ResBlocks carry .model.{0,2}, convs .weight
    res_idx = sorted({int(k.split(".")[2]) for k in state
                      if k.startswith("decoder.main.") and ".model." in k})
    conv_idx = sorted({int(k.split(".")[2]) for k in state
                       if k.startswith("decoder.main.")
                       and ".model." not in k and k.endswith(".weight")})
    for n, idx in enumerate(res_idx):
        for m, sub in ((1, 0), (2, 2)):
            for suffix, leaf in (("w", "weight"), ("b", "bias")):
                out[f"decoder.res{n}_c{m}_{suffix}"] = take(
                    f"decoder.main.{idx}.model.{sub}.{leaf}")
    # the upsample stages' convs are all but the last plain conv
    names = [f"up{n}" for n in range(len(conv_idx) - 1)] + ["final"]
    for name, idx in zip(names, conv_idx):
        out[f"decoder.{name}_w"] = take(f"decoder.main.{idx}.weight")
        out[f"decoder.{name}_b"] = take(f"decoder.main.{idx}.bias")

    for fc in ("fc_mu", "fc_logvar"):
        for leaf in ("weight", "bias"):
            key = f"{fc}.{leaf}"
            if key in state:
                if model.cfg.variational:
                    out[key] = state[key]
                used.add(key)

    unused = sorted(set(state) - used)
    if unused:
        raise KeyError(f"{len(unused)} checkpoint keys map to nothing, e.g. "
                       f"{unused[:5]}")
    params = dict(model.named_parameters())
    extra = sorted(set(out) - set(params))
    missing = sorted(set(params) - set(out))
    if extra or missing:
        raise KeyError(f"checkpoint and model differ: no parameter for "
                       f"{extra[:5]}, nothing fills {missing[:5]}")
    for name, arr in out.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: checkpoint {arr.shape}, model "
                             f"{tuple(params[name].shape)}")
    for name, arr in out.items():
        params[name].copy_(torch.from_numpy(arr))
