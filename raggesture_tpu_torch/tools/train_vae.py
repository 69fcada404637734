#!/usr/bin/env python
"""Train one body-part TransformerVAE (a part of the diffusion's latent
codec) with the PyTorch/CUDA port.  Port of ``tools/train_vae.py``: the
masked reconstruction, velocity and KL losses
(``models/vae_architecture.py``) on the cached BEAT2 windows, Adam with
cosine decay to ``lr * 1e-6``, with the same flags plus ``--device``:

    python -m raggesture_tpu_torch.tools.train_vae CONFIG --part upper \\
        [--epochs 100] [--lr 1e-4] [--kl-weight 1e-4] [--vel-weight 1.0] \\
        [--batch-size 64] [--work-dir DIR] [--seed 0] [--options ...] \\
        [--device cpu]

It runs on the CUDA card unless ``--device`` names another, and exits
non-zero without one.  The VAE starts from random weights made from
``--seed``; each step's rsample draw comes from a generator seeded with
``--seed``.  It writes ``train_vae.log``, ``metrics.jsonl`` (a row every
10 steps and at each epoch's last step) and, after every epoch,
``{part}.pt`` (``train/checkpoint.py::save_params`` of the part's
``TransformerVAE``), which ``load_codec_params`` grafts into a model
through the config's ``vae_cfg.{part}_ckpt``.  On the card the decoder's
attention runs kernel K2 (its forward; the backward is the plain
recompute).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="train a body-part VAE")
    p.add_argument("config")
    p.add_argument("--part", default="upper",
                   choices=["upper", "hands", "face", "lowertrans"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--kl-weight", type=float, default=1e-4)
    p.add_argument("--vel-weight", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--options", nargs="+", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    return p.parse_args(argv)


def build_vae(vcfg, device, seed: int):
    """A ``TransformerVAE`` of ``vcfg`` on ``device`` with random weights
    made from ``seed`` (the model's initializer, ``init_weights``)."""
    import torch

    from ..models.architecture import init_weights
    from ..models.vae import TransformerVAE

    with torch.device("meta"):
        vae = TransformerVAE(vcfg)
    vae = vae.to_empty(device=device)
    init_weights(vae, torch.Generator(device=device).manual_seed(seed))
    return vae


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the tool.  Returns the run's stats: per epoch its steps and
    seconds, the steps, the last logs, the parameters' file and devices."""
    args = parse_args(argv)

    import torch

    from ..builders import arch_config_from, beatx_config_from
    from ..config import Config
    from ..datasets.build import build_dataset
    from ..datasets.sampler import DataLoader
    from ..device import resolve_device
    from ..models.vae_architecture import (
        VAETrainConfig,
        cosine_decay,
        make_vae_train_step,
    )
    from ..train.checkpoint import save_params
    from ..train.runner import device_batch
    from ..utils.logger import MetricWriter, get_root_logger

    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_option_strings(args.options)
    workdir = args.work_dir or os.path.join("work_dirs", f"vae_{args.part}")
    log_file = os.path.join(workdir, "train_vae.log")
    logger = get_root_logger(log_file)
    writer = MetricWriter(workdir, interval=10, tensorboard=False)

    vcfg = arch_config_from(cfg.model).codec.vae_config(args.part)
    dataset = build_dataset(beatx_config_from(cfg.data.train), device=dev)
    loader = DataLoader(dataset, args.batch_size, shuffle=True,
                        drop_last=True, seed=args.seed)
    logger.info("training %s VAE (%d feats) on %d windows, on %s", args.part,
                vcfg.nfeats, len(dataset), dev)

    vae = build_vae(vcfg, dev, args.seed).train()
    total_steps = max(len(loader) * args.epochs, 1)
    opt = torch.optim.Adam(vae.parameters(), lr=args.lr, eps=1e-8)
    step_fn = make_vae_train_step(
        vae, opt, VAETrainConfig(part=args.part, kl_weight=args.kl_weight,
                                 vel_weight=args.vel_weight),
        args.part, schedule=cosine_decay(args.lr, total_steps, 1e-6))
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    out = os.path.join(workdir, f"{args.part}.pt")
    stats: Dict = {"epochs": []}
    step = 0
    logs = {}
    try:
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n_batches = len(loader)
            for bi, batch in enumerate(loader):
                db = {k: v for k, v in device_batch(batch, dev).items()
                      if isinstance(v, torch.Tensor)}
                logs = step_fn(db, step, generator=generator)
                step += 1
                if step % 10 == 0 or bi == n_batches - 1:
                    writer.write(step, {k: v.item() for k, v in logs.items()},
                                 epoch=epoch, force=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats["epochs"].append({"epoch": epoch, "steps": n_batches,
                                    "wall_s": time.perf_counter() - t0})
            save_params(out, vae, meta={"part": args.part, "epoch": epoch})
    finally:
        writer.close()
    logger.info("saved %s VAE params to %s", args.part, out)
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)
              and h.baseFilename == os.path.abspath(log_file)]:
        logger.removeHandler(h)
        h.close()
    stats.update(steps=step, params_path=out,
                 logs={k: v.item() for k, v in logs.items()},
                 param_devices=sorted({str(p.device)
                                       for p in vae.parameters()}))
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
