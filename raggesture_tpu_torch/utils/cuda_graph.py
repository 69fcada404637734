"""Captured pipelines: a function of tensors run as one CUDA graph replay.

A ``GraphCache`` holds one ``torch.cuda.CUDAGraph`` per key: the pipeline's
name, every input tensor's shape and dtype, and the static arguments that
reach the capture.  The first call with a key runs the function once eagerly
(the warm-up: every kernel library is built and loaded, every kernel's
shared-memory attribute and K1's grid-barrier word are set up, and the
allocator's blocks are reserved), then copies the inputs into static
buffers and captures the function on them.  Every call, the first too,
copies its inputs into those buffers, replays the graph and returns clones
of the outputs: the next replay overwrites the static outputs, never a
result the caller holds.

A cache's graphs share one memory pool (``torch.cuda.graph_pool_handle``)
and replay one at a time on one stream, the cache's own.  That is what K1
needs: its launches share one grid-barrier word per device, so two of them
must never run at once on two streams.  A failure in the capture or in a
replay raises; nothing falls back to an eager run.

The function must make no host sync and no host-to-device copy (every draw
and every host-built index map is an input), and must read nothing but its
inputs and tensors that outlive the graph (the model's parameters, the
generator's packs): a capture records addresses, not values.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Captured:
    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Tensors, outputs):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs


class GraphCache:
    """The captured pipelines of one generator on ``device``."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs run on a CUDA device, not "
                             f"{device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: Dict[Hashable, _Captured] = {}
        self.captures = 0       # graphs captured since the cache was made
        self.capture_s = 0.0    # their seconds: warm-up run and capture

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every captured graph (their pool memory returns to the
        allocator once no graph holds it)."""
        self._graphs.clear()

    def run(self, name: str, fn: Callable[..., object], inputs: Tensors,
            static: Tuple = ()):
        """``fn(**inputs)`` as a replay of its graph (captured at the first
        call with this key); returns clones of its outputs (a tensor or a
        dict, tuple or list of them)."""
        for k, v in inputs.items():
            if v.device != self.device:
                raise ValueError(f"graph input {k} is on {v.device}, the "
                                 f"graphs on {self.device}")
        key = (name, static) + tuple(
            (k, tuple(v.shape), v.dtype) for k, v in sorted(inputs.items()))
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(fn, inputs)
                self._graphs[key] = entry
            for k, v in inputs.items():
                entry.inputs[k].copy_(v)
            entry.graph.replay()
            out = _tree_map(lambda t: t.clone(), entry.outputs)
        caller.wait_stream(self.stream)
        # the clones were made on the cache's stream and are used on the
        # caller's: their blocks are not reused before the caller is done
        _tree_map(lambda t: t.record_stream(caller), out)
        return out

    def _capture(self, fn, inputs: Tensors) -> _Captured:
        t0 = time.perf_counter()
        fn(**inputs)                     # the warm-up, eager
        static = {k: v.clone() for k, v in inputs.items()}
        self.stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            outputs = fn(**static)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, static, outputs)
