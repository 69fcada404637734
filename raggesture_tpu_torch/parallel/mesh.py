"""Data parallelism over ``torch.distributed``.  Port of
``raggesture_tpu/parallel/mesh.py``, after the reference's NCCL DDP and
DistributedSampler (mogen/apis/train.py:84-92).

The JAX package shards the batch over a 1-D device mesh and lets XLA insert
the gradient all-reduce.  Here one process drives one device (rank r on
``cuda:{r % device_count}``, or the CPU), each process loads its own rows
of the global batch (``datasets/sampler.py``, ``indices[rank::world]``),
and the training step calls :func:`all_reduce_grads_` after
``loss.backward()``: one flat ``all_reduce(SUM)`` of the trained
parameters' gradients a step, before the clip and the update.  The global
batch is laid out as the JAX package lays it: rank 0's rows, then rank
1's, and so on (:func:`shard_batch`).

``init_distributed`` is given its address, world size and rank: nothing
is read from the environment.  The backend is ``nccl`` for a CUDA device
and ``gloo`` for the CPU; with ``gloo`` the collectives stage CUDA
tensors through host memory, which also puts two ranks on one card.

``sharded_sampler`` and ``sharded_guided_sampler`` run a
``StagedGenerator``'s plain and insertion-guided pipelines on each rank's
rows of a global batch and gather the rows back in rank order; sampling
needs no other collective.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist


# The step's collectives fail after STEP_TIMEOUT.  A rank that waits for
# rank 0 to write files (a window cache of the BEAT2 train split takes
# about an hour to build) waits on a gloo group of its own, whose timeout
# is WAIT_TIMEOUT; a rank that dies ends the wait at once, its connection
# closed.
STEP_TIMEOUT = datetime.timedelta(seconds=600)
WAIT_TIMEOUT = datetime.timedelta(hours=24)
_wait_group = None


def init_distributed(init_method: str, world_size: int, rank: int,
                     device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = STEP_TIMEOUT
                     ) -> torch.device:
    """Join the process group at ``init_method`` (``tcp://host:port``) as
    ``rank`` of ``world_size`` and return this rank's device: for a CUDA
    ``device`` (None means the card) ``cuda:{rank % device_count}``, made
    the current device; else the CPU.  ``backend`` defaults to ``nccl`` on
    a CUDA device and ``gloo`` on the CPU; ``timeout`` is its collectives'.
    Also makes the gloo group that :func:`barrier` waits on."""
    global _wait_group
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    _wait_group = dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)
    return dev


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _wait_group
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _wait_group = None


def in_group() -> bool:
    """True inside a process group, of any size: the collectives below then
    run (at world size 1 each is the identity, on the backend)."""
    return dist.is_available() and dist.is_initialized()


def spans_processes() -> bool:
    """True inside a process group of more than one rank."""
    return in_group() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def barrier() -> None:
    """Wait for every rank, up to ``WAIT_TIMEOUT`` (the ranks wait here
    while rank 0 writes files); nothing outside a process group."""
    if in_group():
        dist.barrier(group=_wait_group)


def rank0_first(fn: Callable):
    """``fn()`` on rank 0, then on the other ranks: what rank 0 writes (a
    cache), the others read.  Returns this rank's result; rank 0 lets the
    others go on when ``fn`` raises, so that they meet its error too."""
    if rank() != 0:
        barrier()
        return fn()
    try:
        return fn()
    finally:
        barrier()


def _comm_device(like: torch.device) -> torch.device:
    """Where a collective's buffer lives: on the card for NCCL, in host
    memory for gloo (a CUDA tensor is staged through the host)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_rows(global_batch: int, rank_: Optional[int] = None,
               world: Optional[int] = None) -> slice:
    """The rows of ``rank_`` in a global batch of ``global_batch`` rows:
    the ``rank_``-th of ``world`` equal blocks, as the JAX package lays a
    global batch out over the processes."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split over {world} ranks")
    n = global_batch // world
    return slice(rank_ * n, (rank_ + 1) * n)


def shard_batch(batch, rank_: Optional[int] = None,
                world: Optional[int] = None):
    """This rank's rows of a global batch: a tensor, an array, a list, or a
    dict of them (each along its first axis)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank_, world) for k, v in batch.items()}
    return batch[shard_rows(len(batch), rank_, world)]


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's rows ``start:start + B`` of a global batch of
    ``global_batch`` rows (``models/architecture.py::training_loss``);
    ``sum`` all-reduces a tensor over the ranks."""

    start: int
    global_batch: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t)


def local_shard(batch_rows: int) -> Optional[Shard]:
    """The :class:`Shard` of this rank's ``batch_rows`` rows (every rank
    holds as many), or None outside a process group."""
    if not in_group():
        return None
    return Shard(rank() * batch_rows, world_size() * batch_rows)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor on ``t``'s device
    (``t`` itself outside a process group).  Carries no gradient."""
    if not in_group():
        return t
    buf = t.detach().to(_comm_device(t.device), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


class _AllReduceGrads:
    """``all_reduce_grads_(params)``: sum the gradients of ``params`` over
    the ranks in place with one flat ``all_reduce(SUM)``, the gradient psum
    XLA inserts into the JAX package's data-parallel step.  The parameters
    without a gradient are left out (the same ones on every rank: one
    model, one loss).  Returns the number of elements reduced; ``calls``
    counts the collectives launched (on this object, so that a caller may
    wrap the module's name, to time it, and still read the count)."""

    calls = 0

    @torch.no_grad()
    def __call__(self, params: Sequence[torch.Tensor]) -> int:
        grads = [p.grad for p in params if p.grad is not None]
        if not in_group() or not grads:
            return 0
        flat = torch.cat([g.reshape(-1) for g in grads])
        buf = flat.to(_comm_device(flat.device))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        self.calls += 1
        pieces = buf.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g).to(g.device)
                                     for v, g in zip(pieces, grads)])
        return flat.numel()


all_reduce_grads_ = _AllReduceGrads()


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the first axis
    in rank order: the inverse of :func:`shard_batch`."""
    if not in_group():
        return t
    buf = t.detach().contiguous().to(_comm_device(t.device))
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(out, buf)
    return torch.cat(out).to(t.device)


def all_gather_ragged(arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Every rank's 1-D host arrays of a length of its own, concatenated in
    rank order, array by array.  As the JAX package gathers ragged shards:
    all-gather the lengths, pad each array to the largest, all-gather, cut
    each rank's back to its length.  The arrays keep their dtypes (sent as
    raw bytes)."""
    arrays = [np.ascontiguousarray(a).reshape(-1) for a in arrays]
    if not in_group():
        return arrays
    n = all_gather_rows(torch.tensor([len(arrays[0])])).numpy()
    cap = int(n.max())
    out = []
    for a in arrays:
        if len(a) != n[dist.get_rank()]:
            raise ValueError("the arrays of one rank differ in length")
        width = a.dtype.itemsize
        raw = np.zeros(cap * width, np.uint8)
        raw[:a.nbytes] = a.view(np.uint8)
        got = all_gather_rows(torch.from_numpy(raw)[None]).numpy()
        out.append(np.concatenate([got[r, :int(n[r]) * width].view(a.dtype)
                                   for r in range(len(n))]))
    return out


@torch.no_grad()
def replicate_tree(tree: Union[torch.nn.Module, Dict[str, torch.Tensor]]
                   ) -> bool:
    """Give every rank rank 0's values of a module's state (or of a dict of
    tensors) in place: one flat broadcast from rank 0 a dtype, then a
    check that every rank holds the same values (a float64 checksum of the
    broadcast buffer, all-gathered).  Returns whether this rank's values
    were rank 0's already (the ranks start from one seed or one
    checkpoint, as the JAX package's replicas do).  Raises when a rank's
    checksum differs after the broadcast."""
    state = tree.state_dict() if isinstance(tree, torch.nn.Module) else tree
    if not in_group():
        return True
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for v in state.values():
        by_dtype.setdefault(v.dtype, []).append(v)
    same = True
    sums = []
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        buf = flat.to(_comm_device(flat.device), copy=True)
        dist.broadcast(buf, src=0)
        same &= bool(torch.equal(buf.to(flat.device), flat))
        offset = 0
        for t in ts:
            t.copy_(buf[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        sums.append(buf.double().sum() if buf.is_floating_point()
                    else buf.long().sum().double())
    check = all_gather_rows(torch.stack(sums)[None])
    if not bool((check == check[:1]).all()):
        raise RuntimeError("replicate_tree: the ranks' values differ after "
                           "the broadcast from rank 0")
    return same


# ------------------------------------------------------------------ sampling

def _gather_results(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: all_gather_rows(v) for k, v in out.items()}


def sharded_sampler(gen):
    """Data-parallel plain sampling: ``sample_fn(batch, noise,
    coef_table=None, query_masks=None)`` with the global batch (word,
    audio, speaker_ids, motion_mask), its start noise (B, T, D) and query
    masks ({key: (B, T)}), ``coef_table`` replicated.  Each rank runs
    ``gen.sample`` on its rows; the results come back whole, rows in rank
    order, on every rank.  No draw is made: the start noise and the
    coefficients are given (or the scale function is off)."""

    @torch.no_grad()
    def sample_fn(batch, noise, coef_table=None, query_masks=None):
        qm = None if query_masks is None else shard_batch(query_masks)
        return _gather_results(gen.sample(
            shard_batch({k: batch[k] for k in ("word", "audio",
                                               "speaker_ids",
                                               "motion_mask")}),
            noise=shard_batch(noise), coef_table=coef_table,
            query_masks=qm))

    return sample_fn


def sharded_guided_sampler(gen):
    """Data-parallel insertion-guided sampling:
    ``sample_fn(batch, start, inv_all, in_seq_noise, coef_table=None,
    query_masks=None, init_in_seq=None)`` with the global batch, its
    spliced start noise (B, T, D), the per-step guidance targets
    ``inv_all`` (S, B, T, D) and the in-seq overwrite's draw
    ``in_seq_noise`` (S, B, T, D), both sharded on axis 1 as the JAX
    package's spec has them, and the handoff ``init_in_seq`` (B, T, D),
    zeros when None.  Each rank runs the guided DDIM loop and the decode on
    its rows; the results come back whole in rank order."""
    from ..diffusion.sampling import ddim_guided_sample_loop

    @torch.no_grad()
    def sample_fn(batch, start, inv_all, in_seq_noise, coef_table=None,
                  query_masks=None, init_in_seq=None):
        rows = shard_rows(start.shape[0])
        mine = shard_batch({k: batch[k] for k in ("word", "audio",
                                                  "speaker_ids",
                                                  "motion_mask")})
        core = gen._core(mine, None, start[rows], coef_table,
                         None if query_masks is None
                         else shard_batch(query_masks))
        noise = core.pop("noise")
        model_fn = gen._pipeline_prologue(**core)
        init = (torch.zeros_like(noise) if init_in_seq is None
                else gen._tensor(init_in_seq)[rows])
        out = ddim_guided_sample_loop(
            model_fn, gen.sched, noise,
            inverted_latents=gen._tensor(inv_all)[:, rows],
            guidance_iters=None, init_in_seq=init,
            in_seq_noise=gen._tensor(in_seq_noise)[:, rows], **gen._common)
        return _gather_results(gen._results(out))

    return sample_fn
