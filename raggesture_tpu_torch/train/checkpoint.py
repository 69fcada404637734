"""Checkpoints: the training state for an exact resume, and the inference
artifact (a model's parameters as one file).  Port of
``raggesture_tpu/train/checkpoint.py`` (``CheckpointManager`` on
``torch.save`` instead of orbax, ``save_params``, ``load_params``,
``load_codec_params``).

The file is a torch ``state_dict`` (tensors on the CPU, loaded with
``weights_only=True``) and beside it ``<path>.meta.json``, the host
metadata.  A JAX params tree reaches the format through
``utils/convert_jax.py::load_jax_params`` followed by ``save_params``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

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


def load_codec_params(model: nn.Module, vae_cfg: Optional[Dict],
                      logger=None) -> List[str]:
    """Graft pretrained part VAEs into ``model.codec`` in place: each
    ``{part}_ckpt`` of the config's ``vae_cfg`` names a file that
    :func:`save_params` wrote for that part's module
    (``model.codec.{part}_vae``), loaded strictly.  A part without an entry
    keeps its weights; an entry whose file is missing is skipped with a
    warning, keeping the init, as the JAX package does.  Returns the parts
    loaded."""
    loaded = []
    for part in ("upper", "hands", "face", "lowertrans"):
        path = (vae_cfg or {}).get(f"{part}_ckpt")
        if not path:
            continue
        if not os.path.exists(path):
            if logger:
                logger.warning("codec %s checkpoint %s not found, keeping "
                               "the fresh init", part, path)
            continue
        load_params(path, getattr(model.codec, f"{part}_vae"))
        loaded.append(part)
    if logger and loaded:
        logger.info("loaded pretrained codec parts: %s", loaded)
    return loaded


class CheckpointManager:
    """The training state by epoch under ``workdir/checkpoints``: one
    ``epoch_{n}.pt`` (``torch.save``) each, the newest ``max_to_keep``
    kept.  A checkpoint holds everything a resumed run needs to take the
    next step bitwise as the uninterrupted run would: the model's
    parameters, the optimizer's state (its moments and step counts), the
    train state's step (the cosine schedule's position), the meta (with
    ``epoch``), and the state of the ``torch.Generator`` the steps draw
    from when one is given.  The JAX package needs no such state: its
    step folds the step count into a fixed key.  A torch generator
    carries its position, so a run that draws from one saves it here, and
    its resume takes the draws the uninterrupted run would.  Saves are
    synchronous."""

    def __init__(self, workdir: str, interval: int = 2, max_to_keep: int = 5):
        self.dir = os.path.abspath(os.path.join(workdir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.interval = interval
        self.max_to_keep = max_to_keep
        self._saved_epochs = set()     # saved by this manager

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The epochs the directory holds, oldest first."""
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"epoch_(\d+)\.pt", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def maybe_save(self, epoch: int, state, meta: Optional[Dict] = None,
                   generator: Optional[torch.Generator] = None) -> bool:
        """Save at every ``interval``-th epoch (epoch + 1 a multiple of it);
        the caller saves the final epoch with :meth:`save`."""
        if (epoch + 1) % self.interval != 0:
            return False
        self.save(epoch, state, meta, generator)
        return True

    def save(self, epoch: int, state, meta: Optional[Dict] = None,
             generator: Optional[torch.Generator] = None) -> None:
        """Write ``state`` (a ``train.loop.TrainState``) as ``epoch``, with
        ``generator``'s state when it is given.  An
        epoch at or below the directory's newest is not written: that is a
        no-op when this manager saved it or it is the newest (the re-save
        of a finished run's last epoch), and raises RuntimeError otherwise,
        a fresh run in a directory that holds another run's checkpoints."""
        latest = self.latest_epoch()
        if latest is not None and epoch <= latest:
            if epoch in self._saved_epochs or epoch == latest:
                return
            raise RuntimeError(
                f"refusing to save epoch {epoch}: the checkpoint dir "
                f"{self.dir} already holds epoch {latest} from an earlier "
                "run; resume from it or use a fresh work dir")
        payload = {
            "model": {k: v.detach().to("cpu")
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "meta": dict(meta or {}, epoch=epoch),
        }
        if generator is not None:
            payload["generator"] = generator.get_state()
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        self._saved_epochs.add(epoch)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state, epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[object, Dict]:
        """Load ``epoch`` (default the newest) into ``state`` in place: the
        model's parameters, the optimizer's state and the step, and into
        ``generator`` its saved state; a ``generator`` given for a
        checkpoint saved without one raises ValueError, before anything is
        loaded.  Returns (state, meta)."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        payload = torch.load(self._path(epoch), map_location="cpu",
                             weights_only=True)
        if generator is not None and "generator" not in payload:
            raise ValueError(f"{self._path(epoch)} holds no generator state: "
                             "its run did not save the generator it drew "
                             "from, so a resume cannot take its draws")
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        if generator is not None:
            generator.set_state(payload["generator"])
        return state, payload["meta"]
