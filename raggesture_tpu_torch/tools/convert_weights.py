"""Convert the released torch checkpoints into the port's files.

Port of ``tools/convert_weights.py``.  Inputs (the layout the reference's
release unpacks to, reference tools/download_weights.py:1-60):

  experiments/vae/<run>/<run>.yaml + the checkpoint its ``test_ckpt`` names
  experiments/diffusion/.../epoch_64.pth        (mmcv checkpoint)
  datasets/assets_deps/.../AESKConv_240_100.bin (FGD embedder)

Outputs, each a ``train/checkpoint.py::save_params`` file with its
``.meta.json``:

  experiments/vae/{upper,hands,face,lowertrans}.pt  per-part VAE states,
      grafted by ``load_codec_params`` (``model.model.vae_cfg.<part>_ckpt``)
  experiments/diffusion/params.pt   the whole model, read by
      ``python -m raggesture_tpu_torch.tools.visualize CONFIG params.pt``
  experiments/fgd/aesconv.pt        the FGD embedder, read by
      ``python -m raggesture_tpu_torch.tools.evaluate --fgd-weights``

    python -m raggesture_tpu_torch.tools.convert_weights --denoiser PATH \\
        [--vae-dir experiments/vae] [--fgd PATH] [--out PATH] [--fgd-out PATH]
    python -m raggesture_tpu_torch.tools.convert_weights --all --root .

The conversion is host work (numpy and ``torch.load``); nothing runs on a
device.  Every converter is strict: a checkpoint key that maps to nothing
raises, but the buffers the port recomputes (``convert_torch.BUFFERS``).
``main(argv)`` returns the parts found, the files written with their bytes,
and the seconds.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time
from typing import Dict, List, Optional

PART_HINTS = {
    "upper": "upper",
    "hands": "hands",
    "face": "face",
    "lowertrans": "lowerplustrans",
}

# the run yaml's architecture keys, carried into each part's meta so the
# codec config can be checked against them (activation and
# normalize_before change the math, not the state's keys)
META_KEYS = ("transformer_activation", "transformer_normalize_before",
             "position_embedding", "num_heads", "num_layers", "ff_size",
             "latent_dim", "frame_chunk_size", "decoder_arch", "vae_dist")


def find_vae_ckpts(vae_dir: str) -> Dict[str, str]:
    """The four per-part VAE checkpoints by their run-name hints (the
    release's run names hold 'upper' / 'hands' / 'face' /
    'lowerplustrans'): the checkpoint a matching yaml's ``test_ckpt``
    names, next to the yaml; else any .pth/.bin in a matching directory."""
    found = {}
    for part, hint in PART_HINTS.items():
        for yml in glob.glob(os.path.join(vae_dir, "**", "*.yaml"),
                             recursive=True):
            if hint in os.path.basename(yml):
                with open(yml) as f:
                    m = re.search(r"test_ckpt:\s*(\S+)", f.read())
                if m:
                    ckpt = os.path.join(os.path.dirname(yml),
                                        os.path.basename(m.group(1)))
                    if os.path.exists(ckpt):
                        found[part] = ckpt
                        break
        if part not in found:
            cands = (glob.glob(os.path.join(vae_dir, f"*{hint}*", "*.pth"))
                     + glob.glob(os.path.join(vae_dir, f"*{hint}*", "*.bin")))
            if cands:
                found[part] = cands[0]
    return found


def vae_meta(ckpt: str) -> Dict[str, str]:
    """``{"source": ckpt}`` and the META_KEYS of the first yaml beside the
    checkpoint, as strings."""
    meta = {"source": ckpt}
    for yml in glob.glob(os.path.join(os.path.dirname(ckpt), "*.yaml")):
        with open(yml) as f:
            txt = f.read()
        for key in META_KEYS:
            m = re.search(rf"^{key}:\s*(\S+)", txt, re.M)
            if m:
                meta[key] = m.group(1)
        break
    return meta


def write_release_layout(root: str, release: Dict, vae_states: Dict[str, Dict],
                         vae_yaml: Dict[str, Dict], fgd_state: Dict) -> int:
    """The layout ``main(["--all", "--root", root])`` reads, written from
    states in the reference's names, for a test or a check that has no
    download: for each part, ``experiments/vae/gesture_{hint}_vae/`` with
    its run yaml (``test_ckpt`` as the training run named it, whose
    basename ``find_vae_ckpts`` takes beside the yaml, then ``vae_yaml``'s
    keys) and ``best.pth`` (``{"model_state": ...}``);
    ``experiments/diffusion/raggesture_beatx/epoch_64.pth`` (mmcv:
    ``{"state_dict": release, "meta": ...}``);
    ``datasets/assets_deps/beat2_eval/AESKConv_240_100.bin``
    (``{"model_state": fgd_state}``).  Returns the bytes written."""
    import torch

    written = 0

    def save(obj, *path):
        nonlocal written
        os.makedirs(os.path.join(root, *path[:-1]), exist_ok=True)
        torch.save(obj, os.path.join(root, *path))
        written += os.path.getsize(os.path.join(root, *path))

    for part, state in vae_states.items():
        run = ("experiments", "vae", f"gesture_{PART_HINTS[part]}_vae")
        os.makedirs(os.path.join(root, *run), exist_ok=True)
        with open(os.path.join(root, *run, f"{run[-1]}.yaml"), "w") as f:
            f.write(f"test_ckpt: experiments/vae/{part}/best.pth\n")
            for k, v in vae_yaml[part].items():
                f.write(f"{k}: {v}\n")
        save({"model_state": state}, *run, "best.pth")
    save({"state_dict": release, "meta": {"epoch": 64}}, "experiments",
         "diffusion", "raggesture_beatx", "epoch_64.pth")
    save({"model_state": fgd_state}, "datasets", "assets_deps", "beat2_eval",
         "AESKConv_240_100.bin")
    return written


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="torch checkpoints -> the port")
    p.add_argument("--denoiser", default=None,
                   help="mmcv diffusion checkpoint (epoch_64.pth)")
    p.add_argument("--vae-dir", default="experiments/vae")
    p.add_argument("--fgd", default=None,
                   help="AESKConv_240_100.bin for the FGD eval model")
    p.add_argument("--out", default="experiments/diffusion/params.pt")
    p.add_argument("--fgd-out", default="experiments/fgd/aesconv.pt")
    p.add_argument("--all", action="store_true",
                   help="convert everything found under --root")
    p.add_argument("--root", default=".")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)

    from ..models.eval_fgd import FGDConfig, FGDEmbedder
    from ..train.checkpoint import save_params, save_state_dict
    from ..utils.convert_torch import (
        convert_fgd,
        convert_release,
        convert_vae,
        load_torch_state,
    )
    from ..utils.logger import get_root_logger

    logger = get_root_logger()
    t_start = time.perf_counter()
    if args.all:
        diff = sorted(glob.glob(os.path.join(args.root, "experiments/diffusion",
                                             "**", "*.pth"), recursive=True))
        args.denoiser = args.denoiser or (diff[0] if diff else None)
        args.vae_dir = os.path.join(args.root, "experiments/vae")
        fgd = sorted(glob.glob(os.path.join(args.root, "**", "AESKConv*.bin"),
                               recursive=True))
        args.fgd = args.fgd or (fgd[0] if fgd else None)
        if args.out == parse_args([]).out:
            args.out = os.path.join(args.root, args.out)
        if args.fgd_out == parse_args([]).fgd_out:
            args.fgd_out = os.path.join(args.root, args.fgd_out)

    written: Dict[str, int] = {}

    def wrote(path):
        written[path] = os.path.getsize(path)
        logger.info("wrote %s (%d bytes)", path, written[path])

    parts = find_vae_ckpts(args.vae_dir)
    vae_states, metas = {}, {}
    for part, ckpt in parts.items():
        logger.info("loading %s VAE from %s", part, ckpt)
        vae_states[part] = load_torch_state(ckpt)
        out = os.path.join(args.vae_dir, f"{part}.pt")
        metas[part] = vae_meta(ckpt)
        save_state_dict(out, convert_vae(vae_states[part]), meta=metas[part])
        if metas[part].get("transformer_activation", "gelu") != "gelu":
            logger.warning(
                "%s VAE was trained with activation=%s: set "
                "model.model.vae_cfg.transformer_activation accordingly",
                part, metas[part]["transformer_activation"])
        wrote(out)

    if args.denoiser:
        logger.info("loading denoiser from %s", args.denoiser)
        state = load_torch_state(args.denoiser)
        save_state_dict(args.out,
                        convert_release(state, vae_states=vae_states or None),
                        meta={"source": args.denoiser})
        wrote(args.out)

    if args.fgd:
        logger.info("loading FGD embedder from %s", args.fgd)
        model = FGDEmbedder(FGDConfig())
        convert_fgd(load_torch_state(args.fgd), model)
        save_params(args.fgd_out, model, meta={"source": args.fgd})
        wrote(args.fgd_out)
    return {"parts": parts, "meta": metas, "written": written,
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main(sys.argv[1:])
