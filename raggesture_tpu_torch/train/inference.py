"""Inference over a loader, on one process or gathered over the ranks.
Port of ``raggesture_tpu/train/inference.py`` (``single_device_test``,
``encode_result_blob``, ``pad_result_blob``, ``merge_result_blobs``,
``multi_device_test``), after the reference's single_gpu_test and
multi_gpu_test (mogen/apis/test.py:13-160).

Each rank runs the generator over its loader shard; the per-rank result
lists travel as pickled byte blobs, zero-padded to the largest and
all-gathered (``parallel/mesh.py::all_gather_rows``), then concatenated in
rank order.  The blobs are the JAX package's: pickles of lists of dicts of
numpy arrays, so either package reads the other's.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.logger import get_root_logger


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x) if hasattr(x, "shape") else x


def single_device_test(generate_fn: Callable[[Dict], Dict], data_loader,
                       max_batches: Optional[int] = None) -> List[Dict]:
    """``generate_fn(batch)`` over the loader: one result a valid sample
    (``valid_mask``, all valid when absent), its ``sample_name`` and its
    row of every output whose first axis is the batch's, as numpy."""
    logger = get_root_logger()
    results = []
    for bi, batch in enumerate(data_loader):
        if max_batches is not None and bi >= max_batches:
            break
        out = {k: _host(v) for k, v in generate_fn(batch).items()}
        valid = np.asarray(batch.get(
            "valid_mask", np.ones(len(batch["sample_name"]), bool)))
        for j, name in enumerate(batch["sample_name"]):
            if not valid[j]:
                continue
            results.append({
                "sample_name": name,
                **{k: v[j] for k, v in out.items()
                   if hasattr(v, "shape") and v.shape[:1] == valid.shape},
            })
        logger.info("test batch %d: %d samples", bi, int(valid.sum()))
    return results


def encode_result_blob(results: List[Dict]) -> np.ndarray:
    """A result list as a uint8 byte blob (a pickle) for the gather."""
    return np.frombuffer(pickle.dumps(results), dtype=np.uint8)


def pad_result_blob(blob: np.ndarray, size: int) -> np.ndarray:
    """``blob`` zero-padded to ``size`` bytes (a gather takes equal
    shapes)."""
    padded = np.zeros(size, np.uint8)
    padded[:blob.size] = blob
    return padded


def merge_result_blobs(gathered: np.ndarray, sizes) -> List[Dict]:
    """(R, max size) gathered blobs and each rank's true size -> the result
    lists concatenated in rank order."""
    results: List[Dict] = []
    for r in range(gathered.shape[0]):
        results.extend(pickle.loads(
            np.asarray(gathered[r][:int(sizes[r])]).tobytes()))
    return results


def multi_device_test(generate_fn: Callable[[Dict], Dict], data_loader,
                      max_batches: Optional[int] = None) -> List[Dict]:
    """:func:`single_device_test` on each rank's loader shard, every
    rank's results gathered to every rank in rank order (one all-gather of
    the sizes, one of the padded blobs).  On one process, its results."""
    from ..parallel.mesh import all_gather_rows, spans_processes

    local = single_device_test(generate_fn, data_loader, max_batches)
    if not spans_processes():
        return local
    blob = encode_result_blob(local)
    sizes = all_gather_rows(torch.tensor([blob.size])).numpy()
    gathered = all_gather_rows(torch.from_numpy(
        pad_result_blob(blob, int(sizes.max())))[None])
    return merge_result_blobs(gathered.numpy(), sizes)
