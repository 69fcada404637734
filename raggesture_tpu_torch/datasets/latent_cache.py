"""The frozen codec's latent cache: each training window's (mu, logvar),
computed once.  Port of ``raggesture_tpu/datasets/latent_cache.py``
(``tree_fingerprint``, ``codec_fingerprint``, ``build_latent_cache``,
``LatentCachedDataset``).

The codec is frozen for diffusion training, and its encode draws z from
(mu, logvar); caching the distribution and drawing z in the train step
(``models/architecture.py::training_loss`` on a batch with
``latent_mu``/``latent_logvar``) gives the same distribution as the live
encode, without the encode.

The files are the JAX package's: shards of ``SHARD`` windows,
``latents_{id:05d}.npz`` with float32 ``mu`` and ``logvar`` (n, 43, D), and
``index.json`` with the window names in order, ``shard_size`` and the
codec's fingerprint.  Each package reads the other's shards.  A shard
holds ``SHARD`` windows, the reader's layout; the JAX package's build
counts its shards in encode batches instead, so a cache of more than
``SHARD`` windows that it builds does not read back, while the port's
reads back in both packages.  The
fingerprints never match across the packages (the port's hashes a
``state_dict``, the JAX package's a parameter tree, under other names), so
a cache built by the other package is read with ``params=None``, which
skips the check.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

SHARD = 1024

_MOTION_FIELDS = ("motion_upper", "motion_lower", "motion_face",
                  "motion_hands", "trans", "facial", "contact", "motion_mask")


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


def codec_fingerprint(model) -> str:
    """The fingerprint of a model's codec parameters."""
    return tree_fingerprint(model.codec.state_dict())


@torch.no_grad()
def build_latent_cache(dataset, model, path: str, batch_size: int = 64,
                       logger=None, overwrite: bool = False) -> str:
    """One codec encode (``encode_motion_dist``, on the model's device)
    over ``dataset``'s windows into (mu, logvar) shards at ``path``.  An
    existing cache with the model's fingerprint and the dataset's window
    count is kept; one with another fingerprint raises RuntimeError unless
    ``overwrite``.  The tail batch is padded by repeating its last record,
    so every encode has ``batch_size`` rows."""
    from .beatx import collate

    os.makedirs(path, exist_ok=True)
    index_path = os.path.join(path, "index.json")
    fp = codec_fingerprint(model)
    if os.path.exists(index_path) and not overwrite:
        with open(index_path) as f:
            index = json.load(f)
        if index["fingerprint"] != fp:
            raise RuntimeError(
                f"latent cache at {path} was built with different codec "
                f"weights (cache {index['fingerprint']} != params {fp}); "
                "rebuild with overwrite=True")
        if len(index["names"]) == len(dataset):
            if logger:
                logger.info("using existing latent cache %s (%d windows)",
                            path, len(index["names"]))
            return path

    dev = next(model.parameters()).device
    names: List[str] = []
    mu_buf: List[np.ndarray] = []
    lv_buf: List[np.ndarray] = []
    shard_id = 0

    def flush(final: bool = False):
        nonlocal shard_id, mu_buf, lv_buf
        while sum(len(m) for m in mu_buf) >= SHARD or (final and mu_buf):
            mu_all, lv_all = np.concatenate(mu_buf), np.concatenate(lv_buf)
            np.savez(os.path.join(path, f"latents_{shard_id:05d}.npz"),
                     mu=mu_all[:SHARD], logvar=lv_all[:SHARD])
            mu_buf = [mu_all[SHARD:]] if len(mu_all) > SHARD else []
            lv_buf = [lv_all[SHARD:]] if len(lv_all) > SHARD else []
            shard_id += 1

    n = len(dataset)
    for start in range(0, n, batch_size):
        recs = [dataset[i] for i in range(start, min(start + batch_size, n))]
        batch = collate(recs + [recs[-1]] * (batch_size - len(recs)))
        batch = {k: torch.as_tensor(np.asarray(batch[k])).to(
                     device=dev, dtype=torch.float32)
                 for k in _MOTION_FIELDS if k in batch}
        mu, logvar = model.encode_motion_dist(batch)
        mu_buf.append(mu[:len(recs)].cpu().numpy())
        lv_buf.append(logvar[:len(recs)].cpu().numpy())
        names.extend(r["sample_name"] for r in recs)
        flush()
        if logger and (start // batch_size) % 20 == 0:
            logger.info("latent cache: %d/%d windows", len(names), n)
    flush(final=True)

    with open(index_path, "w") as f:
        json.dump({"names": names, "shard_size": SHARD, "fingerprint": fp},
                  f)
    if logger:
        logger.info("built latent cache %s (%d windows, %d shards)",
                    path, len(names), shard_id)
    return path


class LatentCachedDataset:
    """A window dataset whose records carry ``latent_mu`` and
    ``latent_logvar`` from the cache at ``path`` (by ``sample_name``).
    ``params``, a model, is checked against the cache's fingerprint; None
    skips the check (a cache the JAX package built)."""

    def __init__(self, dataset, path: str, params=None):
        self.dataset = dataset
        self.path = path
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        if params is not None:
            fp = codec_fingerprint(params)
            if index["fingerprint"] != fp:
                raise RuntimeError(
                    f"latent cache at {path} was built with different codec "
                    f"weights (cache {index['fingerprint']} != params {fp})")
        self.name_to_idx: Dict[str, int] = {
            n: i for i, n in enumerate(index["names"])}
        self.shard_size = int(index["shard_size"])
        self._shards: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return len(self.dataset)

    def _shard(self, sid: int) -> Dict[str, np.ndarray]:
        hit = self._shards.get(sid)
        if hit is None:
            with np.load(os.path.join(self.path,
                                      f"latents_{sid:05d}.npz")) as z:
                hit = {"mu": z["mu"], "logvar": z["logvar"]}
            self._shards[sid] = hit
            while len(self._shards) > 8:     # ~8 x 1024 x 43 x D floats
                self._shards.pop(next(iter(self._shards)))
        return hit

    def __getitem__(self, i):
        rec = dict(self.dataset[i])
        j = self.name_to_idx[rec["sample_name"]]
        shard = self._shard(j // self.shard_size)
        rec["latent_mu"] = shard["mu"][j % self.shard_size]
        rec["latent_logvar"] = shard["logvar"][j % self.shard_size]
        return rec

    def __getattr__(self, name):
        # the wrapped dataset's attributes (cfg, names, cache, ...)
        return getattr(self.dataset, name)
