"""Arbitrary-length gesture synthesis by overlapped window chunking: the
port's long-form tool.

Port of ``tools/longform_synthesis.py``: the full-clip test cache, chunk
starts ``[0] + range(150 - 15, L - 15, 150 - 15)`` with the tail padded,
every modality sliced per chunk and the audio and text features taken
anew from each chunk's raw audio and transcript, the ``use_prev_latent``
handoff (each chunk's final latent tokens seed the next chunk's first),
wave batching of clips (``--clip-batch``), the 15-frame overlap
cross-faded in 6d rotation space, and per clip ``chunk_{k:03d}.npz``,
``full_pred_motion.npz``, ``full_gt_motion.npz`` and ``gt_audio.wav``.

    python -m raggesture_tpu_torch.tools.longform_synthesis CONFIG CKPT \\
        --out-dir DIR [--retrieval-method gesture_type] [--use-inversion] \\
        [--insertion-guidance] [--guidance-iters decreasing_till_25] \\
        [--guidance-lr 0.1] [--inv-cache PATH] [--max-clips 10] \\
        [--clip-batch 1] [--seed 0] [--no-refeaturize-chunks] \\
        [--device cuda|cpu] [--options key=value ...]

CKPT is a file written by ``train/checkpoint.py::save_params``.  The tool
runs on the CUDA card unless ``--device`` names another device, and raises
without one.  Its generator is ``StagedGenerator(fused=False)``, the JAX
tool's constructor default: the uncached denoiser call (kernels K5 and K6)
and the part-by-part decode (K2), each route one CUDA graph replay on the
card.  A chunk after the first takes the handoff route: with inversion and
guidance ``_guided_inseq_pipeline``, whose exemplars are neither bucketed
nor cached, so a graph is captured for each distinct (batch, exemplar
count).  ``--refeaturize-chunks`` takes the per-chunk features from the
cache's featurizer: the stub on a stub-built cache, else the HF
featurizers on the tool's device (``make_default_extractor``), as the JAX
tool does.

The random draws come from one ``torch.Generator`` on the device, seeded
from ``--seed``: per wave the start noise, the scale function's
coefficients and the in-seq bulk draw, in that order.  ``main`` returns
what it timed: the stage seconds, per wave the retrieval host ms, the
exemplar encode ms, the generation ms (CUDA events on the card; a wave
that captures a graph includes the capture), the export ms, the exemplar
count, the graph captures and the inversion cache's hits, and per clip its
chunks and stitched frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .visualize import _Clock, build_retrieval_db, make_encode_fn

INCOMPATIBLE_BATCHING = (
    "--no-refeaturize-chunks is incompatible with --clip-batch > 1: per-clip "
    "sliced audio feature lengths differ and zero-padded frames would "
    "condition the shorter clips; use the default per-chunk re-extraction "
    "(fixed-length chunks) for batching")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="long-form gesture synthesis")
    p.add_argument("config")
    p.add_argument("checkpoint", help="a save_params file")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--retrieval-method", default="none",
                   choices=["discourse", "gesture_type", "llm", "none"])
    p.add_argument("--use-inversion", action="store_true")
    p.add_argument("--insertion-guidance", action="store_true")
    p.add_argument("--guidance-iters", default="decreasing_till_25")
    p.add_argument("--guidance-lr", type=float, default=0.1)
    p.add_argument("--inv-cache", default=None, metavar="PATH",
                   help="persist the exemplar-inversion cache here (.npz): "
                        "loaded at start, saved at exit")
    p.add_argument("--max-clips", type=int, default=10)
    p.add_argument("--clip-batch", type=int, default=1,
                   help="synthesize N clips as one batch: at chunk position "
                        "k, the k-th chunks of the group's clips run as one "
                        "generator call (the handoff serializes the chunks "
                        "within a clip)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--refeaturize-chunks",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="take each chunk's audio and text features anew from "
                        "its raw audio and transcript; "
                        "--no-refeaturize-chunks slices the full clip's "
                        "audio features in proportion instead")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    p.add_argument("--options", nargs="+", default=[])
    return p.parse_args(argv)


def chunk_starts(n_frames: int, window: int, overlap: int) -> List[int]:
    """The reference's chunking: [0] + range(window - overlap, L - overlap,
    window - overlap)."""
    stride = window - overlap
    return [0] + list(range(stride, max(n_frames - overlap, 1), stride))


def plan_waves(chunk_counts, clip_batch: int):
    """The wave-batching schedule: ``[(group, waves)]``, ``group`` a list of
    at most ``clip_batch`` clip indices, ``waves[k]`` those of its clips
    that have a k-th chunk (never empty, a prefix of ``group``).  With
    ``clip_batch`` 1 the clips keep the dataset's order (and the draws the
    reference's sequence); above it they are sorted by descending chunk
    count, so a group's active set shrinks only at its tail, where the
    caller pads the wave back to the group's size: one batch shape per
    group."""
    if clip_batch < 1:
        raise ValueError(f"clip_batch must be >= 1, got {clip_batch}")
    if clip_batch == 1:
        return [([i], [[i]] * c) for i, c in enumerate(chunk_counts)]
    order = sorted(range(len(chunk_counts)), key=lambda i: -chunk_counts[i])
    groups = []
    for g0 in range(0, len(order), clip_batch):
        group = order[g0:g0 + clip_batch]
        waves = [[ci for ci in group if k < chunk_counts[ci]]
                 for k in range(chunk_counts[group[0]])]
        groups.append((group, waves))
    return groups


def run_group_waves(group, waves, make_chunk, run_wave, on_chunk) -> None:
    """Run one wave-batched group, threading each clip's handoff latents.

    - ``make_chunk(ci, k)``: clip ``ci``'s k-th chunk record (active clips
      only);
    - ``run_wave(k, chunks_padded, prev_rows, n_active) -> (prev_out,
      payload)``: ``prev_out[i:i + 1]`` is row i's handoff latent;
      ``prev_rows`` is None at the first wave, else one row per padded
      chunk; rows from ``n_active`` on are padding (the last active row
      repeated) whose outputs are dropped;
    - ``on_chunk(ci, k, row, payload)``: clip ``ci``'s output at batch row
      ``row``."""
    B = len(group)
    prev = {ci: None for ci in group}
    for k, active in enumerate(waves):
        chunks = [make_chunk(ci, k) for ci in active]
        pad = B - len(active)
        chunks_p = chunks + [chunks[-1]] * pad
        prev_rows = None
        if k > 0:
            rows = [prev[ci] for ci in active]
            prev_rows = rows + [rows[-1]] * pad
        prev_out, payload = run_wave(k, chunks_p, prev_rows, len(active))
        for bi, ci in enumerate(active):
            prev[ci] = prev_out[bi:bi + 1]
            on_chunk(ci, k, bi, payload)


_FRAME_FIELDS = ("motion", "motion_upper", "motion_face", "motion_lower",
                 "motion_hands", "trans", "facial", "contact", "word", "emo",
                 "sem_score", "beta")


def slice_chunk(rec: Dict, s: int, e: int, fps: int,
                audio_sr: int = 16000) -> Dict:
    """Every modality of a full-clip record sliced to frames [s, e), the
    tail padded with zeros (raw audio with 1e-4); the audio features in
    proportion to the clip's feature timeline; the transcript segments,
    discourse relations, prominence and gesture labels inside the window,
    their times made relative to its start."""
    T = e - s
    start_sec, end_sec = s / fps, e / fps
    out = {}
    for k in _FRAME_FIELDS:
        if k not in rec:
            continue
        a = np.asarray(rec[k])[s:e]
        if a.shape[0] < T:
            a = np.concatenate(
                [a, np.zeros((T - a.shape[0],) + a.shape[1:], a.dtype)])
        out[k] = a
    af = np.asarray(rec["audio"])
    n_clip_frames = np.asarray(rec["motion"]).shape[0]
    fs = int(round(af.shape[0] * s / max(n_clip_frames, 1)))
    fe = int(round(af.shape[0] * e / max(n_clip_frames, 1)))
    a = af[fs:fe]
    if a.shape[0] < fe - fs:
        a = np.concatenate([a, np.zeros((fe - fs - a.shape[0], af.shape[1]),
                                        af.dtype)])
    out["audio"] = a
    raw_audio = np.asarray(rec.get("raw_audio", np.zeros(0, np.float32)))
    a_s, a_e = int(start_sec * audio_sr), int(end_sec * audio_sr)
    ra = raw_audio[a_s:a_e]
    if ra.shape[0] < a_e - a_s:
        ra = np.concatenate([ra, np.full(a_e - a_s - ra.shape[0], 1e-4,
                                         np.float32)])
    out["raw_audio"] = ra
    out["motion_mask"] = np.ones((T,), np.float32)
    out["motion_length"] = np.asarray(T, np.int32)
    out["speaker_id"] = np.asarray(rec["speaker_id"]).reshape(-1)[:1]
    out["raw_word"] = rec.get("raw_word", "")
    out["text_feature"] = np.asarray(rec.get("text_feature",
                                             np.zeros((1, 768), np.float32)))
    out["text_segments"] = [
        [[t[0][0] - start_sec, t[0][1] - start_sec], t[1]]
        for t in rec.get("text_segments", [])
        if t[0][0] >= start_sec and t[0][1] <= end_sec]
    out["discourse"] = [
        tuple(d[:4]) + (d[4] - start_sec, d[5] - start_sec,
                        d[6] - start_sec, d[7] - start_sec)
        for d in rec.get("discourse", [])
        if len(d) >= 8 and d[4] >= start_sec and d[5] <= end_sec]
    out["prominence"] = [
        (w, ps - start_sec, pe - start_sec, pv)
        for (w, ps, pe, pv) in rec.get("prominence", [])
        if ps >= start_sec and pe <= end_sec]
    out["gesture_labels"] = [
        dict(g, start=g["start"] - start_sec, end=g["end"] - start_sec)
        for g in rec.get("gesture_labels", [])
        if g["start"] >= start_sec and g["end"] <= end_sec]
    out["sample_name"] = f"{rec['sample_name']}@{s}"
    return out


def refeaturize_chunk(chunk: Dict, extractor, audio_sr: int = 16000) -> Dict:
    """The chunk's audio features from its own raw audio and its text
    feature from its merged transcript segments (an empty sentence too: a
    silent chunk must not keep the whole clip's transcript), in place.  The
    frame-aligned ``word`` features stay sliced, as in the reference."""
    from ..datasets.disco import merge_textsegs

    ra = np.asarray(chunk["raw_audio"])
    chunk["audio"] = (
        np.asarray(extractor.audio_features(ra, audio_sr), np.float32)
        if ra.size else np.zeros((1, extractor.audio_dim), np.float32))
    merged = merge_textsegs(chunk.get("text_segments", []))
    sentence = " ".join(t[1] for t in merged).strip()
    _, tf = extractor.word_embeddings(sentence)
    if tf is not None:
        chunk["text_feature"] = np.asarray(tf, np.float32)
        chunk["raw_word"] = sentence
    return chunk


def stitch(state: Dict, pose: np.ndarray, exps: np.ndarray,
           trans: np.ndarray, overlap: int) -> None:
    """Append one chunk to a clip's stitched buffers (``state``'s pose,
    exps and trans, None before the first), cross-fading the ``overlap``
    frames: the pose in 6d rotation space, the rest linearly."""
    from ..utils.motion_io import crossfade_linear, crossfade_pose_aa

    if state["pose"] is None:
        state["pose"], state["exps"], state["trans"] = pose, exps, trans
        return
    state["pose"] = np.concatenate(
        [state["pose"][:-overlap],
         crossfade_pose_aa(state["pose"][-overlap:], pose[:overlap]),
         pose[overlap:]])
    for key, new in (("exps", exps), ("trans", trans)):
        state[key] = np.concatenate(
            [state[key][:-overlap],
             crossfade_linear(state[key][-overlap:], new[:overlap]),
             new[overlap:]])


def draw_wave(gen, generator: torch.Generator, B: int
              ) -> Dict[str, torch.Tensor]:
    """One wave's draws from ``generator``, in the tool's order: the start
    noise (B, T, D), the scale function's coefficient table (S, 4), the
    in-seq bulk draw (S, B, T, D)."""
    from ..models.conditioning import scale_func_table

    cfg = gen.model.cfg
    dc = cfg.denoiser
    S = gen.sched.num_timesteps
    shape = (B, dc.num_tokens, dc.latent_dim)
    noise = torch.randn(shape, generator=generator, device=gen.device)
    coef = (scale_func_table(gen.sched, cfg.scale_func,
                             cfg.diffusion_train.diffusion_steps,
                             generator=generator)
            if cfg.scale_func is not None
            else torch.zeros(S, 4, device=gen.device))
    in_seq = torch.randn((S,) + shape, generator=generator,
                         device=gen.device)
    return {"noise": noise, "coef_table": coef, "in_seq_noise": in_seq}


def main(argv: Optional[List[str]] = None,
         on_wave: Optional[Callable[[Dict], None]] = None) -> Dict:
    """Run the tool; ``on_wave`` (for a caller in the same process, such as
    a test) is given each wave's stats, chunks, retrieval and result after
    its export.  Returns the stage seconds, the per-wave stats and the
    per-clip summary."""
    args = parse_args(argv)
    if args.clip_batch > 1 and not args.refeaturize_chunks:
        raise SystemExit(INCOMPATIBLE_BATCHING)

    from ..builders import beatx_config_from, build_architecture
    from ..config import Config
    from ..datasets.beatx import StubFeatureExtractor, collate
    from ..datasets.build import (
        build_dataset,
        cache_exists,
        make_default_extractor,
    )
    from ..device import resolve_device
    from ..models.architecture import InferenceOptions, StagedGenerator
    from ..retrieval.database import host_batch_from_records
    from ..train.checkpoint import load_params
    from ..train.runner import device_batch
    from ..utils.logger import get_root_logger
    from ..utils.motion_io import (
        linear_resample,
        reassemble_full_pose,
        save_smplx_npz,
        upsample_pose_aa,
    )
    from .visualize import parse_guidance_iters

    dev = resolve_device(args.device)
    logger = get_root_logger()
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_option_strings(args.options)
    stages: Dict[str, float] = {}

    ext = []    # the real featurizers, made once, when a cache is missing

    def extractor():
        if not ext:
            ext.append(make_default_extractor(dev))
        return ext[0]

    def dataset(dcfg):
        return build_dataset(dcfg, None if cache_exists(dcfg)
                             else extractor(), device=dev)

    # the full-clip test cache, as the reference pins it
    t0 = time.perf_counter()
    test_ds = dataset(dataclasses.replace(beatx_config_from(cfg.data.test),
                                          test_cache_mode="full"))
    logger.info("test dataset (full clips): %d", len(test_ds))
    train_ds = (dataset(beatx_config_from(cfg.data.train))
                if args.retrieval_method != "none" else None)
    stages["cache_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = (build_retrieval_db(cfg, train_ds, logger)
          if train_ds is not None else None)
    stages["corpus_s"] = time.perf_counter() - t0

    chunk_ext = None
    if args.refeaturize_chunks:
        # a stub-built cache keeps the chunks in the stub's feature space
        cache_ext = test_ds.cache.extractor_name
        chunk_ext = (StubFeatureExtractor()
                     if cache_ext == "StubFeatureExtractor"
                     else extractor())
        if chunk_ext is None:
            logger.warning("no HF featurizers available: per-chunk "
                           "re-extraction uses the deterministic stub")
            chunk_ext = StubFeatureExtractor()
        if cache_ext and type(chunk_ext).__name__ != cache_ext:
            logger.warning("per-chunk featurizer %s differs from the "
                           "cache's %s", type(chunk_ext).__name__, cache_ext)

    t0 = time.perf_counter()
    model = build_architecture(cfg.model, device=dev)
    load_params(args.checkpoint, model)
    window = model.cfg.denoiser.max_seq_len          # 150
    overlap = model.cfg.denoiser.frame_chunk_size    # 15
    fps = cfg.data.test.get("pose_fps", 15)
    sched = model.cfg.diffusion_test.schedule()
    # the JAX tool takes the JAX constructor's default fused=False; the
    # port's constructor defaults to the cached path
    gen = StagedGenerator(model, sched, fused=False)
    if args.inv_cache:
        stages["inv_cache_loaded"] = gen.load_inv_cache(args.inv_cache)
        logger.info("inversion cache: %d entries loaded from %s",
                    stages["inv_cache_loaded"], args.inv_cache)
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

    gi = (parse_guidance_iters(args.guidance_iters, sched.num_timesteps)
          if args.insertion_guidance else None)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    factor = 30 // fps

    n_clips = min(len(test_ds), args.max_clips)
    plans = [chunk_starts(int(np.asarray(test_ds[ci]["motion"]).shape[0]),
                          window, overlap) for ci in range(n_clips)]
    waves_stats: List[Dict] = []
    clips: List[Dict] = []
    t_take = time.perf_counter()
    for group_idx, (group, waves) in enumerate(
            plan_waves([len(p) for p in plans], args.clip_batch)):
        recs = {ci: test_ds[ci] for ci in group}
        st = {}
        for ci in group:
            name = recs[ci]["sample_name"].split("/")[0]
            logger.info("clip %s: %d frames -> %d chunks", name,
                        np.asarray(recs[ci]["motion"]).shape[0],
                        len(plans[ci]))
            clip_dir = os.path.join(args.out_dir, name)
            os.makedirs(clip_dir, exist_ok=True)
            st[ci] = {"pose": None, "exps": None, "trans": None,
                      "dir": clip_dir, "name": name}

        def make_chunk(ci, k):
            s = plans[ci][k]
            chunk = slice_chunk(recs[ci], s, s + window, fps)
            if chunk_ext is not None:
                refeaturize_chunk(chunk, chunk_ext)
            return chunk

        def run_wave(k, chunks_p, prev_rows, n_active):
            stats = {"group": group_idx, "chunk": k, "rows": len(chunks_p),
                     "active": n_active, "num_queries": 0, "encode_ms": 0.0,
                     "export_ms": 0.0}
            batch = collate(chunks_p)
            re_dict = None
            if db is not None:
                # retrieval for the active rows only: the padding rows are
                # appended, so the splice rows address the same rows of the
                # padded batch and the padding runs unspliced
                act = chunks_p[:n_active]
                enc_ms.clear()
                t0 = time.perf_counter()
                re_dict = db(host_batch_from_records(act),
                             [c["sample_name"] for c in act], encode_fn,
                             method=args.retrieval_method)
                stats["encode_ms"] = sum(enc_ms)
                stats["retrieval_host_ms"] = ((time.perf_counter() - t0)
                                              * 1e3 - stats["encode_ms"])
                stats["num_queries"] = re_dict["num_queries"]
            # the handoff rows stay on the device
            prev_latent = (torch.cat(prev_rows) if prev_rows is not None
                           else None)
            opts = InferenceOptions(
                use_inversion=args.use_inversion and re_dict is not None,
                insertion_guidance=args.insertion_guidance
                and re_dict is not None,
                guidance_lr=args.guidance_lr,
                use_prev_latent=prev_latent is not None)
            draws = draw_wave(gen, generator, len(chunks_p))
            hits = gen.inv_cache_hits
            captures = gen.graphs.captures if gen.graphs is not None else 0
            capture_s = gen.graphs.capture_s if gen.graphs is not None else 0
            t = clock.start()
            out = gen(device_batch(batch, dev), None, opts, re_dict, gi,
                      prev_latent, **draws)
            stats["generate_ms"] = clock.ms(t)
            stats["inv_cache_hits"] = gen.inv_cache_hits - hits
            if gen.graphs is not None:
                stats["graph_captures"] = gen.graphs.captures - captures
                stats["capture_s"] = gen.graphs.capture_s - capture_s
            pred = {k_: v.float().cpu().numpy() for k_, v in out.items()
                    if k_.startswith("pred_")}
            waves_stats.append(stats)
            wave = {"stats": stats, "chunks": chunks_p, "re_dict": re_dict,
                    "out": out, "prev_latent": prev_latent,
                    "generator": gen, "opts": opts, "draws": draws}
            return out["prev_latentout"], (reassemble_full_pose(pred), pred,
                                           wave)

        def on_chunk(ci, k, row, payload):
            poses, pred, wave = payload
            stats = wave["stats"]
            t0 = time.perf_counter()
            pose = poses[row]
            exps, trans = pred["pred_exps"][row], pred["pred_transl"][row]
            stitch(st[ci], pose, exps, trans, overlap)
            save_smplx_npz(
                os.path.join(st[ci]["dir"], f"chunk_{k:03d}.npz"),
                upsample_pose_aa(pose, factor),
                linear_resample(exps, factor),
                linear_resample(trans, factor), fps=30)
            stats["export_ms"] += (time.perf_counter() - t0) * 1e3
            if row == stats["active"] - 1:
                logger.info("wave %d.%d: %s", group_idx, k, {
                    n: round(v, 3) if isinstance(v, float) else v
                    for n, v in stats.items()})
                if on_wave is not None:
                    on_wave(wave)

        run_group_waves(group, waves, make_chunk, run_wave, on_chunk)

        for ci in group:
            rec, s = recs[ci], st[ci]
            n_frames = np.asarray(rec["motion"]).shape[0]
            save_smplx_npz(os.path.join(s["dir"], "full_pred_motion.npz"),
                           upsample_pose_aa(s["pose"][:n_frames], factor),
                           linear_resample(s["exps"][:n_frames], factor),
                           linear_resample(s["trans"][:n_frames], factor),
                           fps=30)
            save_smplx_npz(os.path.join(s["dir"], "full_gt_motion.npz"),
                           upsample_pose_aa(np.asarray(rec["motion"]),
                                            factor),
                           linear_resample(np.asarray(rec["facial"]),
                                           factor),
                           linear_resample(np.asarray(rec["trans"]), factor),
                           fps=30)
            raw_audio = np.asarray(rec.get("raw_audio", np.zeros(0)))
            if raw_audio.size:
                from scipy.io import wavfile

                wavfile.write(os.path.join(s["dir"], "gt_audio.wav"), 16000,
                              (raw_audio * 32767).astype(np.int16))
            clips.append({"name": s["name"], "frames": int(n_frames),
                          "chunks": len(plans[ci]),
                          "stitched_frames": int(s["pose"].shape[0])})
    stages["take_s"] = time.perf_counter() - t_take
    motion_s = sum(c["frames"] for c in clips) / fps
    stages["motion_s"] = motion_s
    stages["real_time_factor"] = motion_s / stages["take_s"]
    if args.inv_cache:
        n_inv = gen.save_inv_cache(args.inv_cache)
        logger.info("inversion cache: %d entries saved to %s", n_inv,
                    args.inv_cache)
    logger.info("long-form results in %s", args.out_dir)
    return {"stages": stages, "waves": waves_stats, "clips": clips}


if __name__ == "__main__":
    main(sys.argv[1:])
