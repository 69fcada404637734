"""The epoch loop of denoiser training.  Port of
``raggesture_tpu/train/runner.py`` (``device_batch``, ``train_model``),
after the reference's mmcv EpochBasedRunner and its hooks
(mogen/apis/train.py:41-173): the codec frozen (``train.loop``), the
cosine schedule in the step, checkpoints every ``interval`` epochs with
an exact resume, validation, the retrieval memo saved after the first
epoch, and metrics to ``metrics.jsonl`` (``utils/logger.MetricWriter``).

Data parallel inside a process group (``parallel/mesh.py``): each rank
runs this loop on its loader shard and its device, the step all-reduces
the gradients and the logs, and only rank 0 writes (the metrics, the
checkpoints, the retrieval memo); the others get a ``NullWriter`` and wait
at a barrier after each save.  Every rank restores a resumed run, its
draws' generator included, and the model is broadcast from rank 0 at the
start (``replicate_tree``).
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, Optional, Union

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


def device_batch(batch: Dict[str, Any], device: Union[str, torch.device],
                 bf16_conditions: bool = False) -> Dict[str, torch.Tensor]:
    """The model's fields of a ``collate`` batch (``DEVICE_BATCH_KEYS``) as
    tensors on ``device`` (float32, the speaker ids int64), and its ragged
    fields (names, transcripts, labels) as the host lists they are; the
    other arrays are left out, as in the JAX package.  ``bf16_conditions``
    copies word and audio as bfloat16 (``utils/wire.py``) and widens them
    back to float32 on the device: the values of the JAX runner's bf16
    features under jnp's promotion against float32 weights."""
    keys = DEVICE_BATCH_KEYS
    if "latent_mu" in batch:
        keys = tuple(k for k in keys if k not in _MOTION_KEYS)
    out = {k: v for k, v in batch.items() if isinstance(v, list)}
    host = {k: np.asarray(batch[k]) for k in keys if k in batch}
    if bf16_conditions:
        from ..utils.wire import cast_condition_features

        host = cast_condition_features(
            {k: v.astype(np.float32) if k in ("word", "audio") else v
             for k, v in host.items()})
    for k, v in host.items():
        dtype = torch.int64 if k == "speaker_ids" else torch.float32
        if isinstance(v, torch.Tensor):      # bf16 on the wire
            out[k] = v.to(device).to(dtype)
        else:
            out[k] = torch.as_tensor(v).to(device=device, dtype=dtype)
    return out


def _tensors(b: Dict) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in b.items() if isinstance(v, torch.Tensor)}


def val_generator(seed: int, epoch: int, batch_index: int,
                  device: torch.device) -> torch.Generator:
    """The draws of validation batch ``batch_index`` at ``epoch``: a
    generator of their own (never the one the training steps draw from,
    so validation leaves a resumed run's draws as they were), decorrelated
    per epoch and batch, as the JAX runner folds its key."""
    s = np.random.SeedSequence([seed, 7919 + epoch, batch_index])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> 1))


def _restore_source(path: str, interval: int):
    """(manager, epoch) of an explicit ``--resume-from`` path: a
    checkpoint file ``.../checkpoints/epoch_{n}.pt``, or a work dir (its
    newest checkpoint)."""
    from .checkpoint import CheckpointManager

    path = os.path.abspath(path)
    m = re.fullmatch(r"epoch_(\d+)\.pt", os.path.basename(path))
    if m:
        return (CheckpointManager(os.path.dirname(os.path.dirname(path)),
                                  interval=interval), int(m.group(1)))
    return CheckpointManager(path, interval=interval), None


def train_model(model, train_loader, optim_cfg, *,
                max_epochs: int = 500,
                workdir: str = "work_dirs/run",
                checkpoint_interval: int = 2,
                checkpoint_max_to_keep: int = 5,
                log_interval: int = 10,
                tensorboard: bool = True,
                resume: bool = False,
                resume_checkpoint: Optional[str] = None,
                seed: int = 0,
                retrieval_db=None,
                retrieval_save_dir: Optional[str] = None,
                val_loader=None,
                val_interval: int = 1,
                val_max_batches: int = 8,
                schedule_sampler: str = "uniform",
                device_prefetch: int = 1,
                log_per_sample: bool = False,
                cond_bank: int = 0,
                stats: Optional[Dict] = None):
    """Train ``model`` (on its device) over ``train_loader``'s epochs;
    returns the final ``TrainState``.

    The steps draw from one ``torch.Generator`` seeded with ``seed``,
    which the checkpoints carry, so a resumed run takes the draws of the
    uninterrupted one; validation draws from generators of its own
    (:func:`val_generator`).  ``schedule_sampler`` other than uniform
    draws t and its weights on the host from ``RandomState(seed + 17)``
    and feeds the per-sample losses back, a step at a time.  Each batch
    is one step; ``device_prefetch`` > 0 stages the next batch (its
    collation and its copy to the card) in a background thread
    (``prefetch_iter``).  ``cond_bank`` > 0 keeps each sample's rows on
    the card (``cond_bank.DeviceSampleBank``); a batch without
    ``sample_idx``, or of more unique samples than the capacity, streams.
    ``log_per_sample`` writes the per-sample losses into each metrics row,
    as in JAX.  Logs are read at the next log event, so the host stays a
    step ahead; the step count is kept on the host.  ``stats``, when
    given, is filled with each epoch's steps and seconds, the validation
    batches run and the bank's hits, misses and evictions.

    In a process group the loader is this rank's shard (every rank as many
    batches of as many rows), ``seed`` is every rank's, the importance
    sampler draws from ``RandomState(seed + 17 + 1000003 * rank)`` and its
    history is gathered over the ranks; ``cond_bank`` streams across
    processes, as in the JAX package."""
    from ..datasets.sampler import prefetch_iter
    from ..parallel.mesh import (
        barrier,
        in_group,
        rank,
        replicate_tree,
        spans_processes,
        world_size,
    )
    from ..utils.logger import MetricWriter, NullWriter, get_root_logger
    from .checkpoint import CheckpointManager
    from .loop import create_train_state, make_train_step, make_val_step

    logger = get_root_logger()
    dev = next(model.parameters()).device
    is_main = rank() == 0
    writer = (MetricWriter(workdir, interval=log_interval,
                           tensorboard=tensorboard)
              if is_main else NullWriter())
    logger.info("training on %s (rank %d of %d), %d steps/epoch, %d epochs",
                dev, rank(), world_size(), len(train_loader), max_epochs)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator(device=dev).manual_seed(seed)

    ckpt = CheckpointManager(workdir, interval=checkpoint_interval,
                             max_to_keep=checkpoint_max_to_keep)
    start_epoch = 0
    if resume_checkpoint:
        src, epoch = _restore_source(resume_checkpoint, checkpoint_interval)
        state, meta = src.restore(state, epoch=epoch, generator=generator)
        start_epoch = int(meta["epoch"]) + 1
        logger.info("resumed from %s (epoch %d, step %d)", resume_checkpoint,
                    int(meta["epoch"]), state.step)
    elif resume:
        latest = ckpt.latest_epoch()
        if latest is not None:
            state, meta = ckpt.restore(state, generator=generator)
            start_epoch = int(meta.get("epoch", latest)) + 1
            logger.info("resumed from epoch %d (step %d)", latest, state.step)
        else:
            logger.info("resume requested but no checkpoint found; "
                        "starting fresh")
    if in_group():
        replicate_tree(model)
    if retrieval_db is not None and retrieval_save_dir:
        retrieval_db.load_memo(retrieval_save_dir)

    # None is the JAX package's auto, which is on only on a TPU: off here
    bf16_conds = bool(optim_cfg.bf16_conditions)
    if bf16_conds:
        logger.info("shipping condition features (word/audio) as bfloat16")

    sched_train = model.cfg.diffusion_train.schedule(device=dev)
    t_sampler = None
    if schedule_sampler != "uniform":
        from ..diffusion.samplers import build_sampler

        t_sampler = build_sampler(schedule_sampler, sched_train.num_timesteps)
        t_rng = np.random.RandomState(seed + 17 + 1000003 * rank())
    step_fn = make_train_step(sched_train,
                              bf16_compute=optim_cfg.bf16_compute,
                              with_timesteps=t_sampler is not None,
                              fused_codec=optim_cfg.fused_codec,
                              log_per_sample=log_per_sample,
                              fused_ctx=optim_cfg.fused_ctx)
    bank = None
    if cond_bank > 0 and spans_processes():
        logger.warning("cond_bank requested but the mesh spans processes "
                       "— falling back to streaming")
    elif cond_bank > 0:
        from .cond_bank import DeviceSampleBank

        bank = DeviceSampleBank(cond_bank, dev,
                                bf16_conditions=bool(bf16_conds))
        logger.info("device sample bank enabled (capacity %d samples)",
                    cond_bank)
    streamed = set()     # why a batch streamed past the bank, warned once

    def to_device(batch):
        """The batch's tensors on the card, through the bank when on."""
        if bank is not None:
            ids = batch.get("sample_idx")
            if ids is None:
                why = "loader batches carry no sample_idx"
            elif len(set(np.asarray(ids).reshape(-1).tolist())) \
                    > bank.capacity:
                why = "a batch has more unique samples than the capacity"
            else:
                return bank.stage(batch, ids)
            if why not in streamed:
                streamed.add(why)
                logger.warning("cond_bank: %s, streaming it", why)
        return _tensors(device_batch(batch, dev, bf16_conds))

    val_fn = (make_val_step(sched_train, optim_cfg.fused_ctx)
              if val_loader is not None else None)
    if stats is not None:
        stats.setdefault("epochs", [])

    global_step = state.step
    try:
        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(epoch)
            t_epoch = time.time()
            n_batches = 0
            # each interval's logs are read at the next log event, when
            # its step has finished: the host stays a step ahead
            pending_logs = []

            def flush_logs():
                while pending_logs:
                    step_no, lg = pending_logs.pop(0)
                    host_logs = {
                        key: (v.detach().cpu().reshape(-1).tolist()
                              if key == "per_sample_loss"
                              else v.detach().float().mean().item())
                        for key, v in lg.items()}
                    host_logs["epoch_time"] = time.time() - t_epoch
                    writer.write(step_no, host_logs, epoch=epoch, force=True)

            def log_step(logs):
                nonlocal n_batches, global_step
                n_batches += 1
                global_step += 1
                flush_logs()
                if global_step % log_interval == 0 or n_batches == 1:
                    pending_logs.append((global_step, logs))

            stream = (to_device(b) for b in train_loader)
            if device_prefetch > 0:
                stream = prefetch_iter(stream, depth=device_prefetch)
            for db in stream:
                draws = {}
                if t_sampler is not None:
                    B = next(iter(db.values())).shape[0]
                    t_np, w_np = t_sampler.sample_np(t_rng, B)
                    draws = dict(t=torch.as_tensor(t_np, device=dev).long(),
                                 t_weights=torch.as_tensor(
                                     w_np, dtype=torch.float32, device=dev))
                logs = step_fn(state, db, generator, **draws)
                if hasattr(t_sampler, "update_with_losses"):
                    t_sampler.update_with_losses(
                        t_np, logs.pop("per_sample_loss").cpu().numpy())
                    logs.pop("t", None)
                log_step(logs)
            flush_logs()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.time() - t_epoch
            if stats is not None:
                stats["epochs"].append({"epoch": epoch, "steps": n_batches,
                                        "wall_s": wall})
            if val_fn is not None and (epoch + 1) % val_interval == 0:
                val_logs = []
                for vb_i, vbatch in enumerate(val_loader):
                    if vb_i >= val_max_batches:
                        break
                    val_logs.append(val_fn(
                        state, _tensors(device_batch(vbatch, dev,
                                                     bf16_conds)),
                        val_generator(seed, epoch, vb_i, dev)))
                if stats is not None:
                    stats["val_batches"] = (stats.get("val_batches", 0)
                                            + len(val_logs))
                if val_logs:
                    agg = {k: float(np.mean([l[k].item() for l in val_logs]))
                           for k in val_logs[0]}
                    writer.write(global_step, agg, prefix="val",
                                 epoch=epoch, force=True)
            if (retrieval_db is not None and retrieval_save_dir and is_main
                    and epoch == start_epoch):
                retrieval_db.save_memo(retrieval_save_dir)
            if is_main:
                ckpt.maybe_save(epoch, state, meta={"workdir": workdir},
                                generator=generator)
            barrier()
        if is_main:
            ckpt.save(max_epochs - 1, state,
                      meta={"workdir": workdir, "final": True},
                      generator=generator)
        barrier()
    finally:
        writer.close()
    if stats is not None and bank is not None:
        stats["bank"] = {"hits": bank.hits, "misses": bank.misses,
                         "evicted": bank.evictions}
    return state
