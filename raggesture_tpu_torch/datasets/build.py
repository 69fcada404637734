"""Raw BEAT2 → window cache builder + config-driven dataset construction.

Port of ``raggesture_tpu/datasets/build.py`` (host numpy), after the
reference's cache build path (mogen/datasets/beatx_dataset.py:119-180
split selection, :291-988 ``build_cache``/``cache_generation``): reads
``train_test_split.csv``, filters speakers, loads each clip's SMPL-X npz /
16 kHz wav / whisper-relations JSON / sem txt / prom file, featurizes
windows (``featurize_clip``), and writes the ShardCache.  ``debug``/``tiny``
modes truncate to 10/1 files with separate cache dirs (:159-167).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logger import get_root_logger
from . import disco
from .beatx import (
    BeatXConfig,
    BeatXDataset,
    FeatureExtractor,
    MelFeatureExtractor,
    ShardCache,
    StubFeatureExtractor,
    featurize_clip,
)


def read_split_csv(data_root: str) -> List[Tuple[str, str]]:
    """(file_id, type) rows of train_test_split.csv."""
    path = os.path.join(data_root, "train_test_split.csv")
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append((row["id"], row["type"]))
    return rows


def select_files(cfg: BeatXConfig, additional_data: bool = True) -> List[str]:
    """Split + speaker filtering (beatx_dataset.py:127-146): train also pulls
    'additional' rows; empty selections fall back to the train rows."""
    rows = read_split_csv(cfg.data_root)
    speakers = set(int(s) for s in cfg.training_speakers)

    def pick(split):
        return [fid for fid, typ in rows
                if typ == split and int(fid.split("_")[0]) in speakers]

    selected = pick(cfg.split)
    if cfg.split == "train" and additional_data:
        selected += pick("additional")
    if not selected:
        get_root_logger().warning(
            "%s split empty for speakers %s; falling back to train[:8]",
            cfg.split, sorted(speakers))
        selected = pick("train")[:8]
    if cfg.tiny:
        selected = selected[:1]
    elif cfg.debug:
        selected = selected[:10]
    return selected


def load_wav(path: str, expect_sr: int = 16000) -> np.ndarray:
    from scipy.io import wavfile

    sr, wave = wavfile.read(path)
    if wave.dtype == np.int16:
        wave = wave.astype(np.float32) / 32768.0
    elif wave.dtype == np.int32:
        wave = wave.astype(np.float32) / 2147483648.0
    else:
        wave = wave.astype(np.float32)
    if wave.ndim > 1:
        wave = wave.mean(axis=1)
    if sr != expect_sr:
        # linear resample (librosa-free)
        n_out = int(round(len(wave) * expect_sr / sr))
        x_old = np.linspace(0.0, 1.0, num=len(wave), endpoint=False)
        x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        wave = np.interp(x_new, x_old, wave).astype(np.float32)
    return wave


def parse_sem_txt(path: str) -> List[Dict]:
    """sem/<id>.txt: name \\t start \\t end \\t duration \\t score \\t keywords
    (beatx_dataset.py:588-591); class names normalized to
    beat/deictic/iconic/metaphoric (:625-634)."""
    entries = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            name, start, end, _dur, score = parts[:5]
            word = parts[5] if len(parts) > 5 else ""
            cls = next((c for c in ("beat", "deictic", "iconic", "metaphoric")
                        if c in name), None)
            if cls is None:
                continue
            entries.append({
                "name": cls,
                "start_time": float(start),
                "end_time": float(end),
                "score": float(score),
                "word": (word or "").strip(),
            })
    return entries


def parse_prom(path: str) -> List[Tuple[str, float, float, float]]:
    """prom/<id>.prom rows: basename \\t start \\t end \\t word \\t prominence
    \\t boundary (beatx_dataset.py:662-670) → (word, start, end, prom)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            _, start, end, word, prom = parts[:5]
            try:
                out.append((word or "", float(start), float(end), float(prom)))
            except ValueError:
                continue
    return out


def load_raw_clip(cfg: BeatXConfig, file_id: str) -> Optional[Dict]:
    """All modalities of one clip, reference directory layout
    (beatx_dataset.py:338,469,514,588,662)."""
    root = cfg.data_root
    pose_path = os.path.join(root, cfg.pose_rep, file_id + ".npz")
    if not os.path.exists(pose_path):
        get_root_logger().warning("missing pose file %s; skipping", pose_path)
        return None
    npz = np.load(pose_path, allow_pickle=True)
    raw: Dict = {
        "poses30": npz["poses"],
        "trans30": npz["trans"],
        "betas": npz["betas"],
        "expressions30": npz["expressions"],
    }
    wav_path = os.path.join(root, "wave16k", file_id + ".wav")
    raw["audio"] = load_wav(wav_path, cfg.audio_sr) if os.path.exists(wav_path) \
        else np.zeros(0, np.float32)

    disco_path = os.path.join(root, "discourse_rels",
                              file_id + "_whisper_relations.json")
    if os.path.exists(disco_path):
        with open(disco_path) as f:
            raw["relations"] = json.load(f)
        raw["tokens"] = disco.parse_discourse_tokens(disco_path)
    else:
        raw["relations"] = None
        raw["tokens"] = None

    raw["sem"] = parse_sem_txt(os.path.join(root, "sem", file_id + ".txt"))
    raw["prominence"] = parse_prom(os.path.join(root, "prom", file_id + ".prom"))
    return raw


def cache_dir_for(cfg: BeatXConfig) -> str:
    sub = cfg.split
    if cfg.split == "test":
        sub = f"test_{cfg.test_cache_mode}"
    if cfg.tiny:
        sub += "_tiny"
    elif cfg.debug:
        sub += "_debug"
    return os.path.join(cfg.cache_dir, sub)


def cache_exists(cfg: BeatXConfig) -> bool:
    """True when a usable window cache is already on disk (so callers can
    skip constructing featurizers entirely)."""
    cache = ShardCache(cache_dir_for(cfg))
    return not cfg.new_cache and len(cache) > 0 and cache.is_complete


def make_default_extractor() -> Optional[FeatureExtractor]:
    """The real featurizers (wav2vec2-base-960h + bert-base-cased) need
    ~1 GB of weights that are not in the repository and are not ported:
    always None, so ``build_cache`` takes the stub with its warning, as the
    JAX package does without the weights."""
    return None


def build_cache(cfg: BeatXConfig, extractor: Optional[FeatureExtractor] = None,
                smplx_model=None, additional_data: bool = True,
                device=None) -> ShardCache:
    """Featurize every selected clip into the window cache (idempotent:
    returns the existing cache unless cfg.new_cache).  ``cfg.smplx_asset``
    is loaded onto ``device`` (default: the card) for the contacts' FK."""
    logger = get_root_logger()
    cache = ShardCache(cache_dir_for(cfg))
    if len(cache) and cache.is_complete and not cfg.new_cache:
        logger.info("using existing cache %s (%d windows)", cache.path,
                    len(cache))
        return cache
    if len(cache):
        # new_cache requested, or a PARTIAL cache from an interrupted build
        # (no COMPLETE marker) — serving it would silently train on a
        # fraction of the data, so rebuild from scratch
        if not cache.is_complete:
            logger.warning("cache %s is incomplete (interrupted build?) — "
                           "rebuilding", cache.path)
        import shutil

        shutil.rmtree(cache.path)
        cache = ShardCache(cache_dir_for(cfg))

    if extractor is None:
        if cfg.audio_rep in ("melspec", "onset+amplitude"):
            extractor = MelFeatureExtractor(cfg.audio_rep, cfg.num_mels,
                                            cfg.hop_length)
        else:
            logger.warning(
                "building cache %s with the DETERMINISTIC STUB featurizer "
                "(no real wav2vec2/BERT models were provided) — fine for "
                "tests, but a model conditioned on real features will "
                "produce garbage on this cache", cache_dir_for(cfg))
            extractor = StubFeatureExtractor()
    elif cfg.audio_rep in ("melspec", "onset+amplitude"):
        # keep the given text path but swap the audio features
        extractor = MelFeatureExtractor(cfg.audio_rep, cfg.num_mels,
                                        cfg.hop_length,
                                        text_extractor=extractor)
    if smplx_model is None and cfg.smplx_asset:
        if os.path.exists(cfg.smplx_asset):
            from ..models.smplx import load_smplx

            smplx_model = load_smplx(cfg.smplx_asset, device=device)
            logger.info("loaded SMPL-X asset %s for contact FK on %s",
                        cfg.smplx_asset, smplx_model.device)
        elif not cfg.allow_fake_contacts:
            raise FileNotFoundError(
                f"BeatXConfig.smplx_asset={cfg.smplx_asset!r} does not exist "
                "— required for foot-contact FK during cache build")
    files = select_files(cfg, additional_data)
    logger.info("building cache %s from %d clips", cache.path, len(files))
    is_test = cfg.split == "test"
    for i, fid in enumerate(files):
        raw = load_raw_clip(cfg, fid)
        if raw is None:
            continue
        records = featurize_clip(fid, raw, cfg, extractor, is_test=is_test,
                                 smplx_model=smplx_model)
        cache.write(records)
        logger.info("[%d/%d] %s -> %d windows (total %d)", i + 1, len(files),
                    fid, len(records), len(cache))
    cache.mark_complete(extractor_name=type(extractor).__name__)
    return cache


def build_dataset(cfg: BeatXConfig, extractor: Optional[FeatureExtractor] = None,
                  smplx_model=None, device=None) -> BeatXDataset:
    """Config → served dataset (reference build_dataset,
    mogen/datasets/builder.py:31-52)."""
    cache = build_cache(cfg, extractor, smplx_model, device=device)
    return BeatXDataset(cache, pose_fps=cfg.pose_fps)
