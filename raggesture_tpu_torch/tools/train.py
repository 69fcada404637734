#!/usr/bin/env python
"""Train the gesture diffusion model with the PyTorch/CUDA port.  Port of
``tools/train.py`` (the config, ``--options``, the work dir with
``config.py``, the timestamped log and ``metrics.jsonl``, the dataset and
its window cache, the model, ``train_model``), with the same flags plus
``--device``:

    python -m raggesture_tpu_torch.tools.train \\
        configs/raggesture_beatx/basegesture_len150_beat.py \\
        [--work-dir DIR] [--resume-from [latest|PATH]] [--load-from PARAMS] \\
        [--seed 0] [--options key.sub=value ...] [--device cpu]

It runs on the CUDA card unless ``--device`` names another, and raises
without one.  ``--load-from`` takes a file of ``train/checkpoint.py::
save_params``; otherwise the model has random weights from ``--seed``, and
the config's ``vae_cfg.{part}_ckpt`` files, where they exist, replace its
part VAEs.  ``--multi-step`` (and the config's ``runner.multi_step``) and
``--multi-step-unroll`` are accepted for the JAX tool's command lines and
change nothing: each batch is one step (ROADMAP §C).

``--distributed`` trains data-parallel, one process a rank, each started
with the same flags and its own ``--process-id``:

    python -m raggesture_tpu_torch.tools.train CONFIG --distributed \
        --coordinator localhost:29500 --num-processes 2 --process-id 0 ...

The ranks join ``tcp://COORDINATOR`` (NCCL on the card, rank r on
``cuda:{r % device_count}``; gloo with ``--device cpu``), each loads its
shard of every batch (``indices[rank::world]``, ``--device-batch-size``
rows a rank), and the step all-reduces the gradients
(``parallel/mesh.py``).  Rank 0 builds the window cache and the latent
cache while the others wait, and only rank 0 writes the work dir's files.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a gesture diffusion model")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", nargs="?", const="latest", default=None,
                   help="resume from the latest checkpoint in work-dir, or "
                        "from a checkpoint file or work dir")
    p.add_argument("--load-from", default=None,
                   help="parameters file (save_params) to initialize from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--options", nargs="+", default=[],
                   help="config overrides: key.subkey=value")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over several processes "
                        "(torch.distributed)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="with --distributed: the address rank 0 listens on")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --distributed: the process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --distributed: this process's rank")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--device-batch-size", type=int, default=None,
                   help="override data.samples_per_device")
    p.add_argument("--latent-cache", default=None, metavar="DIR",
                   help="encode every training window's codec latent "
                        "distribution into DIR once (kept when it matches) "
                        "and train from it, without the frozen encode")
    p.add_argument("--multi-step", type=int, default=None,
                   help="accepted for the JAX tool's command lines; each "
                        "batch is one step")
    p.add_argument("--device-prefetch", type=int, default=1,
                   help="batches staged (collated and copied to the "
                        "device) ahead of the step in a background thread; "
                        "0 disables")
    p.add_argument("--multi-step-unroll", type=int, default=1,
                   help="accepted for the JAX tool's command lines; "
                        "nothing unrolls")
    p.add_argument("--cond-bank", type=int, default=0, metavar="CAPACITY",
                   help="device sample bank capacity (samples): each "
                        "sample's rows are copied to the device once and "
                        "gathered there afterwards; 0 disables")
    p.add_argument("--schedule-sampler", default="uniform",
                   choices=["uniform", "loss-second-moment"],
                   help="diffusion timestep sampler")
    p.add_argument("--profile", action="store_true",
                   help="trace the training with torch.profiler into "
                        "<work-dir>/profile (Chrome trace JSON)")
    p.add_argument("--log-per-sample", action="store_true",
                   help="write per-sample losses into each metrics.jsonl "
                        "row")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (slow)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the tool.  Returns the run's stats: per epoch its steps and
    seconds, the validation batches, the bank's hits and misses, the
    checkpoints written, the final step and the devices of the model's
    parameters, and the rank and world size."""
    args = parse_args(argv)
    if args.distributed and (args.coordinator is None
                             or args.num_processes is None
                             or args.process_id is None):
        raise SystemExit("--distributed needs --coordinator HOST:PORT, "
                         "--num-processes and --process-id: nothing is read "
                         "from the environment")

    from ..device import resolve_device
    from ..parallel import mesh

    dev = resolve_device(args.device)
    if args.distributed:
        dev = mesh.init_distributed(f"tcp://{args.coordinator}",
                                    args.num_processes, args.process_id,
                                    device=dev)
    try:
        return _run(args, dev)
    finally:
        if args.distributed:
            mesh.shutdown()


def _run(args, dev) -> Dict:
    import torch

    from ..builders import (
        beatx_config_from,
        build_architecture,
        optim_config_from,
        retrieval_config_from,
    )
    from ..config import Config
    from ..datasets.build import (
        build_dataset,
        cache_exists,
        make_default_extractor,
    )
    from ..datasets.sampler import PrefetchLoader, build_dataloader
    from ..parallel import mesh
    from ..train.checkpoint import load_codec_params, load_params
    from ..train.runner import train_model
    from ..utils.logger import collect_env, get_root_logger
    from ..utils.profiling import enable_debug_nans, trace

    if args.debug_nans:
        enable_debug_nans()
    is_main = mesh.rank() == 0
    world = mesh.world_size()

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_option_strings(args.options)
    workdir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(workdir, exist_ok=True)
    log_file = None
    if is_main:
        cfg.dump(os.path.join(workdir, "config.py"))
        timestamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        log_file = os.path.join(workdir, f"{timestamp}.log")
    logger = get_root_logger(log_file)
    for k, v in collect_env().items():
        logger.info("env: %s = %s", k, v)
    logger.info("config: %s", args.config)

    dcfg = beatx_config_from(cfg.data.train)
    extractor = None if cache_exists(dcfg) else make_default_extractor(dev)
    dataset = mesh.rank0_first(lambda: build_dataset(dcfg, extractor,
                                                     device=dev))
    logger.info("train dataset: %d windows", len(dataset))

    model = build_architecture(cfg.model, device=dev, seed=args.seed)
    batch_per_device = args.device_batch_size or cfg.data.get(
        "samples_per_device", 128)
    workers = cfg.data.get("workers_per_device",
                           cfg.data.get("workers_per_gpu", 0))

    def make_loader(ds):
        ldr = build_dataloader(ds, batch_per_device, 1, num_shards=world,
                               shard=mesh.rank(), seed=args.seed)
        return PrefetchLoader(ldr, num_workers=workers) if workers else ldr

    loader = make_loader(dataset)
    max_epochs = cfg.runner.get("max_epochs", 500)
    optim_cfg = optim_config_from(cfg, max(len(loader) * max_epochs, 1))

    if args.load_from:
        load_params(args.load_from, model)
        logger.info("loaded params from %s", args.load_from)
    else:
        load_codec_params(model, cfg.model.model.get("vae_cfg", {}), logger)

    if args.latent_cache:
        from ..datasets.latent_cache import (
            LatentCachedDataset,
            build_latent_cache,
        )

        if is_main:
            build_latent_cache(dataset, model, args.latent_cache,
                               logger=logger)
        mesh.barrier()
        dataset = LatentCachedDataset(dataset, args.latent_cache,
                                      params=model)
        loader = make_loader(dataset)

    retrieval_db = None
    retrieval_save_dir = None
    if cfg.model.model.get("retrieval_train", False):
        from ..retrieval.database import RetrievalCorpus, RetrievalDatabase

        rcfg = retrieval_config_from(cfg.model.model)
        retrieval_db = RetrievalDatabase(RetrievalCorpus.build(dataset, rcfg),
                                         rcfg, dataset)
        for hook in cfg.get("custom_hooks", []):
            if hook.get("type") == "DatabaseSaveHook":
                retrieval_save_dir = hook.get("save_dir")

    val_loader = None
    if not args.no_validate:
        try:
            val_dcfg = beatx_config_from(cfg.data.val)
            if extractor is None and not cache_exists(val_dcfg):
                extractor = make_default_extractor(dev)
            val_ds = mesh.rank0_first(lambda: build_dataset(
                val_dcfg, extractor, device=dev))
            if len(val_ds) > 0:
                val_loader = build_dataloader(val_ds, batch_per_device, 1,
                                              shuffle=False,
                                              num_shards=world,
                                              shard=mesh.rank(),
                                              seed=args.seed,
                                              drop_last=True)
                logger.info("val dataset: %d windows", len(val_ds))
        except Exception as e:
            logger.warning("no validation data (%s)", e)

    ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
    log_cfg = cfg.get("log_config", {}) or {}
    profile_ctx = contextlib.nullcontext()
    if args.profile and is_main:
        profile_ctx = trace(os.path.join(workdir, "profile"))
        logger.info("profiling into %s", os.path.join(workdir, "profile"))

    stats: Dict = {}
    t0 = time.perf_counter()
    with profile_ctx:
        state = train_model(
            model, loader, optim_cfg,
            max_epochs=max_epochs,
            workdir=workdir,
            checkpoint_interval=ckpt_cfg.get("interval", 2),
            checkpoint_max_to_keep=ckpt_cfg.get("max_to_keep", 5),
            log_interval=log_cfg.get("interval", 10),
            tensorboard=log_cfg.get("tensorboard", True),
            resume=args.resume_from is not None,
            resume_checkpoint=(args.resume_from
                               if args.resume_from not in (None, "latest")
                               else None),
            seed=args.seed,
            retrieval_db=retrieval_db,
            retrieval_save_dir=retrieval_save_dir,
            val_loader=val_loader,
            schedule_sampler=args.schedule_sampler,
            device_prefetch=args.device_prefetch,
            log_per_sample=args.log_per_sample,
            cond_bank=args.cond_bank,
            stats=stats,
        )
    stats["train_s"] = time.perf_counter() - t0
    stats["final_step"] = state.step
    stats["param_devices"] = sorted({str(p.device)
                                     for p in model.parameters()})
    stats["checkpoints"] = sorted(os.listdir(os.path.join(workdir,
                                                          "checkpoints")))
    stats["rank"], stats["world_size"] = mesh.rank(), world
    logger.info("training done at step %d", state.step)
    # this run's log file closes with it (a caller may run the tool again)
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)
              and log_file is not None
              and h.baseFilename == os.path.abspath(log_file)]:
        logger.removeHandler(h)
        h.close()
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
