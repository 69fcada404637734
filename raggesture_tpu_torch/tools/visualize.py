"""Retrieval-guided inference and result export: the port's serving tool.

Port of ``tools/visualize.py``: windowed-test inference with retrieval
(discourse / gesture_type / llm), DDIM inversion + insertion guidance,
full-pose reassembly from the 4 body parts, 15→30 fps interpolation in 6d
rotation space, and per-sample result directories with the smplx2020 npz
schema (pred_motion.npz / gt_motion.npz / retrieval_0.npz + gt_text.txt +
gt_audio.wav + sem_score.npy + retrieval_list.txt, and inversion_check_b*/
with ``--visualize-inversion``).

    python -m raggesture_tpu_torch.tools.visualize CONFIG CKPT --out-dir DIR \\
        [--retrieval-method discourse|gesture_type|llm|none] \\
        [--use-inversion] [--insertion-guidance] \\
        [--guidance-iters decreasing_till_25] [--guidance-lr 0.1] \\
        [--inv-cache PATH] [--test-batchsize 16] [--seed 0] \\
        [--device cuda|cpu] [--options key=value ...]

CKPT is a file written by ``train/checkpoint.py::save_params``.  The tool
runs on the CUDA card unless ``--device`` names another device, and raises
without one.  Its generator is ``StagedGenerator(fused=False)``, the
uncached denoiser call (kernels K5 and K6) with the part-by-part decode
(K2), as the JAX tool's constructor default.  The codec encode of the
exemplars is masked attention, which takes the plain path (as in the JAX
package), so it launches no kernel.  ``--render`` (the SMPL-X renders) is
not ported yet (ROADMAP A11) and raises.

The random draws come from one ``torch.Generator`` on the device, seeded
from ``--seed``.  ``main`` returns what it timed: the seconds of the cache
build, the corpus build and the model load, and per batch the retrieval's
host ms, the exemplar encode ms, the generation ms (CUDA events on the
card; the first call of each shape includes its CUDA graph capture), the
export ms, the exemplar count and the inversion cache's hits and misses.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RAG-Gesture inference")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a save_params file")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--retrieval-method", default="gesture_type",
                   choices=["discourse", "gesture_type", "llm", "none"])
    p.add_argument("--use-inversion", action="store_true")
    p.add_argument("--insertion-guidance", action="store_true")
    p.add_argument("--guidance-iters", default="decreasing_till_25",
                   help="schedule name or comma list of ints")
    p.add_argument("--guidance-lr", type=float, default=0.1)
    p.add_argument("--inv-cache", default=None, metavar="PATH",
                   help="persist the exemplar-inversion cache here (.npz): "
                        "loaded at start, saved at exit")
    p.add_argument("--outpaint", action="store_true")
    p.add_argument("--visualize-inversion", action="store_true",
                   help="run the DDIM inversion round-trip self-check and "
                        "save the reconstructed exemplars")
    p.add_argument("--test-batchsize", type=int, default=16)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render", action="store_true",
                   help="side-by-side videos (not ported yet: raises)")
    p.add_argument("--smplx-asset", default=None,
                   help="SMPLX_NEUTRAL_2020.npz for --render")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    p.add_argument("--options", nargs="+", default=[])
    args = p.parse_args(argv)
    if args.retrieval_method == "none" and (args.use_inversion
                                            or args.outpaint):
        p.error("--use-inversion/--outpaint need retrieved exemplars; "
                "pick a --retrieval-method other than 'none'")
    if args.insertion_guidance and not args.use_inversion:
        p.error("--insertion-guidance requires --use-inversion "
                "(reference inference_kwargs contract)")
    return args


def parse_guidance_iters(spec: str, num_steps: int):
    """--guidance-iters: a named schedule or a comma list of ints."""
    from ..models.architecture import guidance_iters_schedule

    if "," in spec:
        return guidance_iters_schedule([int(v) for v in spec.split(",")],
                                       num_steps)
    return guidance_iters_schedule(spec, num_steps)


def save_hook_dirs(cfg) -> List[str]:
    """The ``save_dir`` of every DatabaseSaveHook of the config."""
    return [h["save_dir"] for h in cfg.get("custom_hooks", [])
            if h.get("type") == "DatabaseSaveHook" and h.get("save_dir")]


def build_retrieval_db(cfg, train_ds, logger):
    """The RetrievalDatabase with the corpus cache and the DatabaseSaveHook
    memo loaded, as the reference does at tool startup."""
    from ..builders import retrieval_config_from
    from ..retrieval.database import RetrievalCorpus, RetrievalDatabase

    rcfg = retrieval_config_from(cfg.model.model)
    rcache = cfg.model.model.retrieval_cfg.get("cache_path")
    if rcache and os.path.exists(os.path.join(rcache, "meta.json")) \
            and not cfg.model.model.retrieval_cfg.get("new_cache", False):
        corpus = RetrievalCorpus.load(rcache)
        logger.info("loaded retrieval corpus from %s", rcache)
    else:
        corpus = RetrievalCorpus.build(train_ds, rcfg)
        if rcache:
            corpus.save(rcache)
    db = RetrievalDatabase(corpus, rcfg, train_ds)
    for save_dir in save_hook_dirs(cfg):
        db.load_memo(save_dir)
    return db


def make_encode_fn(model) -> Callable:
    """The exemplars' codec encode for ``RetrievalDatabase``: the stacked
    motion fields moved to the model's device, the mean latents (no draw,
    as the JAX tool's ``sample=False``) and the token mask."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def encode(batch):
        return model.encode_motion(
            {k: v.to(dev, non_blocking=True) for k, v in batch.items()})

    return encode


def _resample(x, factor: int) -> np.ndarray:
    from ..utils.motion_io import linear_resample

    return linear_resample(x, factor) if factor > 1 else x


def _upsample_pose(x, factor: int) -> np.ndarray:
    from ..utils.motion_io import upsample_pose_aa

    return upsample_pose_aa(x, factor) if factor > 1 else x


def export_sample(smp_dir: str, out: Dict, j: int, rec: Dict,
                  re_dict: Optional[Dict] = None, factor: int = 2) -> None:
    """Write sample ``j`` of a batch to ``smp_dir``: ``out`` is the
    generator's result with its tensors as numpy arrays (pred_upper,
    pred_hands, pred_lower, pred_facepose (B, T, ·), pred_exps,
    pred_transl), ``rec`` the sample's test record, ``re_dict`` the batch's
    retrieval (its exemplar is written when it has any), ``factor`` the
    upsampling to 30 fps."""
    from scipy.io import wavfile

    from ..utils.motion_io import (
        linear_resample,
        reassemble_full_pose,
        save_smplx_npz,
        upsample_pose_aa,
    )

    os.makedirs(smp_dir, exist_ok=True)
    pred_pose = reassemble_full_pose(
        {k: np.asarray(out[k])[j] for k in ("pred_upper", "pred_hands",
                                            "pred_lower", "pred_facepose")})
    save_smplx_npz(os.path.join(smp_dir, "pred_motion.npz"),
                   _upsample_pose(pred_pose, factor),
                   _resample(np.asarray(out["pred_exps"])[j], factor),
                   _resample(np.asarray(out["pred_transl"])[j], factor),
                   fps=30)
    # as the JAX tool: the prediction is resampled only for factor > 1,
    # the ground truth and the exemplar always
    save_smplx_npz(os.path.join(smp_dir, "gt_motion.npz"),
                   upsample_pose_aa(np.asarray(rec["motion"]), factor),
                   linear_resample(np.asarray(rec["facial"]), factor),
                   linear_resample(np.asarray(rec["trans"]), factor),
                   betas=rec.get("beta", [None])[0], fps=30)
    with open(os.path.join(smp_dir, "gt_text.txt"), "w") as f:
        f.write(str(rec.get("raw_word", "")))
    if "sem_score" in rec:
        # per-frame semantic scores for SRGR, interpolated to 30 fps
        np.save(os.path.join(smp_dir, "sem_score.npy"),
                linear_resample(np.asarray(rec["sem_score"], np.float32),
                                factor))
    raw_audio = rec.get("raw_audio")
    if raw_audio is not None and np.asarray(raw_audio).size:
        wavfile.write(os.path.join(smp_dir, "gt_audio.wav"), 16000,
                      (np.asarray(raw_audio) * 32767).astype(np.int16))
    if re_dict is not None and re_dict["num_queries"] > 0:
        rm = np.asarray(re_dict["raw_motion"])[j, 0]
        rt = np.asarray(re_dict["raw_trans"])[j, 0]
        rf = np.asarray(re_dict["raw_facial"])[j, 0]
        save_smplx_npz(os.path.join(smp_dir, "retrieval_0.npz"),
                       upsample_pose_aa(rm[:, :165], factor),
                       linear_resample(rf, factor),
                       linear_resample(rt, factor), fps=30)
        with open(os.path.join(smp_dir, "retrieval_list.txt"), "w") as f:
            json.dump({
                "names": re_dict["raw_sample_names"][j],
                "type2words": {
                    str(k): list(v) for k, v in
                    re_dict["raw_type2words"][j].items()},
                "query_startends": {
                    str(k): list(v) for k, v in
                    re_dict["query_startends"][j].items()},
            }, f, indent=1)


def _export_inversion_check(gen, re_dict, inv_dir: str, factor: int,
                            logger) -> None:
    """--visualize-inversion: the round trip's error curve and the decoded
    reconstructions of the exemplars."""
    from ..utils.motion_io import (
        linear_resample,
        reassemble_full_pose,
        save_smplx_npz,
    )

    chk = gen.inversion_self_check(re_dict)
    curve = chk["error_curve"].cpu().numpy()          # (S, Q)
    logger.info("inversion error curve (should grow with t): %s",
                np.round(curve.mean(axis=1), 3).tolist())
    logger.info("inversion round-trip recon error (should be small): %s",
                np.round(chk["recon_error"].cpu().numpy(), 5).tolist())
    dec = {k: v.cpu().numpy() for k, v in chk["recon_decoded"].items()}
    inv_pose = reassemble_full_pose(dec)
    os.makedirs(inv_dir, exist_ok=True)
    for q in range(inv_pose.shape[0]):
        save_smplx_npz(os.path.join(inv_dir, f"inv_recon_{q}.npz"),
                       _upsample_pose(inv_pose[q], factor),
                       linear_resample(dec["pred_exps"][q], factor),
                       linear_resample(dec["pred_transl"][q], factor), fps=30)
    np.save(os.path.join(inv_dir, "error_curve.npy"), curve)


class _Clock:
    """Milliseconds of work on ``device``: CUDA events on the card, the
    host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, t0) -> float:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return t0.elapsed_time(ev)
        return (time.perf_counter() - t0) * 1e3


def main(argv: Optional[List[str]] = None,
         on_batch: Optional[Callable[[Dict], None]] = None) -> Dict:
    """Run the tool; ``on_batch`` (for a caller in the same process, such
    as a test) is given each batch's inputs, retrieval, result and stats
    after its export.  Returns the stage seconds and the per-batch
    stats."""
    args = parse_args(argv)
    if args.render:
        raise NotImplementedError(
            "--render (SMPL-X mesh or skeleton videos) is not ported yet "
            "(ROADMAP A11)")

    from ..builders import beatx_config_from, build_architecture
    from ..config import Config
    from ..datasets.build import (
        build_dataset,
        cache_exists,
        make_default_extractor,
    )
    from ..datasets.sampler import DataLoader
    from ..device import resolve_device
    from ..models.architecture import InferenceOptions, StagedGenerator
    from ..retrieval.database import host_batch_from_records
    from ..train.checkpoint import load_params
    from ..train.runner import device_batch
    from ..utils.logger import get_root_logger

    dev = resolve_device(args.device)
    logger = get_root_logger()
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_option_strings(args.options)
    # the tool processes the TEST dataset: its fps decides the 30 fps
    # upsample factor
    fps = cfg.data.test.get("pose_fps", 15)
    stages: Dict[str, float] = {}

    def dataset(dcfg):
        return build_dataset(dcfg, None if cache_exists(dcfg)
                             else make_default_extractor(), device=dev)

    t0 = time.perf_counter()
    test_ds = dataset(beatx_config_from(cfg.data.test))
    train_ds = (dataset(beatx_config_from(cfg.data.train))
                if args.retrieval_method != "none" else None)
    stages["cache_s"] = time.perf_counter() - t0
    logger.info("test dataset: %d windows", len(test_ds))

    t0 = time.perf_counter()
    db = (build_retrieval_db(cfg, train_ds, logger)
          if train_ds is not None else None)
    stages["corpus_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = build_architecture(cfg.model, device=dev)
    load_params(args.checkpoint, model)
    logger.info("loaded checkpoint %s", args.checkpoint)
    sched = model.cfg.diffusion_test.schedule()
    # the JAX tool's StagedGenerator(model, params, sched) takes the JAX
    # constructor's default fused=False: the uncached denoiser call and the
    # part-by-part decode.  The port's constructor defaults to the cached
    # path, so the choice is made here.
    gen = StagedGenerator(model, sched, fused=False)
    if args.inv_cache:
        n_inv = gen.load_inv_cache(args.inv_cache)
        logger.info("inversion cache: %d entries loaded from %s",
                    n_inv, args.inv_cache)
        stages["inv_cache_loaded"] = n_inv
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stages["load_s"] = time.perf_counter() - t0
    encode_model = make_encode_fn(model)
    clock = _Clock(dev)
    enc_ms: List[float] = []

    def encode_fn(b):
        t = clock.start()
        out = encode_model(b)
        enc_ms.append(clock.ms(t))
        return out

    gi = None
    if args.insertion_guidance:
        gi = parse_guidance_iters(args.guidance_iters, sched.num_timesteps)
    opts = InferenceOptions(
        use_inversion=args.use_inversion,
        insertion_guidance=args.insertion_guidance,
        guidance_lr=args.guidance_lr,
        outpaint=args.outpaint,
    )
    opts.validate()

    loader = DataLoader(test_ds, args.test_batchsize, shuffle=True,
                        drop_last=False, seed=args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    factor = 30 // fps
    batches = []

    for bi, batch in enumerate(loader):
        if args.max_batches is not None and bi >= args.max_batches:
            break
        names = batch["sample_name"]
        records = [test_ds[n] for n in names]
        stats = {"batch": bi, "num_queries": 0, "encode_ms": 0.0}
        re_dict = None
        if db is not None:
            enc_ms.clear()
            t0 = time.perf_counter()
            re_dict = db(host_batch_from_records(records), names, encode_fn,
                         method=args.retrieval_method)
            stats["encode_ms"] = sum(enc_ms)
            stats["retrieval_host_ms"] = ((time.perf_counter() - t0) * 1e3
                                          - stats["encode_ms"])
            stats["num_queries"] = re_dict["num_queries"]
        if (args.visualize_inversion and re_dict is not None
                and re_dict["num_queries"] > 0):
            _export_inversion_check(
                gen, re_dict, os.path.join(args.out_dir,
                                           f"inversion_check_b{bi}"),
                factor, logger)

        hits, misses = gen.inv_cache_hits, gen.inv_cache_misses
        t = clock.start()
        out = gen(device_batch(batch, dev), generator, opts, re_dict, gi)
        stats["generate_ms"] = clock.ms(t)
        stats["inv_cache_hits"] = gen.inv_cache_hits - hits
        stats["inv_cache_misses"] = gen.inv_cache_misses - misses

        t0 = time.perf_counter()
        pred = {k: v.float().cpu().numpy() for k, v in out.items()}
        valid = batch.get("valid_mask", np.ones(len(names), bool))
        for j, name in enumerate(names):
            if valid[j]:
                export_sample(os.path.join(args.out_dir, name), pred, j,
                              records[j], re_dict, factor)
        stats["export_ms"] = (time.perf_counter() - t0) * 1e3
        logger.info("batch %d: wrote %d samples (%s)", bi, int(np.sum(valid)),
                    {k: round(v, 3) if isinstance(v, float) else v
                     for k, v in stats.items()})
        batches.append(stats)
        if on_batch is not None:
            on_batch({"stats": stats, "batch": batch, "records": records,
                      "re_dict": re_dict, "out": out, "generator": gen,
                      "database": db})

    # persist the retrieval memo (DatabaseSaveHook after the test epoch)
    if db is not None:
        for save_dir in save_hook_dirs(cfg):
            db.save_memo(save_dir)
    if args.inv_cache:
        n_inv = gen.save_inv_cache(args.inv_cache)
        logger.info("inversion cache: %d entries saved to %s",
                    n_inv, args.inv_cache)
    logger.info("results in %s", args.out_dir)
    return {"stages": stages, "batches": batches}


if __name__ == "__main__":
    main(sys.argv[1:])
