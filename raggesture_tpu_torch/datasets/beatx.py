"""BEAT2 dataset: featurization, window cache, and serving.

Port of ``raggesture_tpu/datasets/beatx.py`` (host numpy, no device code):
``BeatXConfig``, ``idmapping``, ``emotion_from_filename``,
``window_starts``, ``featurize_clip``, the stub and mel feature
extractors, ``ShardCache``, ``BeatXDataset`` and ``collate``.

  featurize (one-time, per clip): load SMPL-X npz @30fps, stride to
  ``pose_fps``, split pose into upper/face/lower/hands via joint masks
  (reference beatx_dataset.py:426-440), window with train stride 5 / test
  windowed / test full modes (:753-766), per window: audio features,
  frame-aligned word embeddings (:846-869), discourse relations/tokens,
  semantic gesture labels, prosodic prominence, emotion-from-filename
  (:559-583), speaker id remap (:195-200), foot contacts by SMPL-X forward
  kinematics (:381-424) on the SMPL-X model's device (``models/smplx.py``).

  cache: one .npz per window (arrays) + a .json per window (ragged
  string/tuple fields) + ``name_to_idx.json`` + ``COMPLETE``, byte for byte
  the JAX package's format, so each package reads the other's cache.

  serving: ``BeatXDataset[idx or "file/window"]`` returns the reference's
  24-field record (:1182-1295); ``collate`` stacks fixed-shape arrays and
  leaves ragged metadata as host-side lists (mogen/datasets/builder.py:55-92).

The real feature extractors (wav2vec2-base-960h, bert-base-cased) need
weights that are not in the repository and are not ported;
``StubFeatureExtractor`` produces deterministic random-projection features
(the JAX package's fallback too) and ``MelFeatureExtractor`` mel or
onset+amplitude audio features.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import disco
from .joints import POSE_DIM, split_pose

# BEAT2 training speaker ids (beatx config: 30 speakers; idmapping squeezes
# the 25 used by the shipped model to 0-24, beatx_dataset.py:195-200)
DEFAULT_TRAIN_SPEAKERS = list(range(1, 31))


def idmapping(spk: int) -> int:
    if spk == 30:
        spk = 8
    if spk == 28:
        spk = 14
    if spk == 27:
        spk = 19
    return spk - 1


def emotion_from_filename(file_id: str, num_frames: int) -> np.ndarray:
    """Emotion label from the recording index in the BEAT filename
    (beatx_dataset.py:559-583)."""
    parts = file_id.split("_")
    score = 0
    if len(parts) > 3:
        try:
            rtype = int(parts[3])
            start = int(parts[3])
            if rtype in (0, 2, 4, 6):
                brackets = [
                    (1, 64, 0), (65, 72, 1), (73, 80, 2), (81, 86, 3),
                    (87, 94, 4), (95, 102, 5), (103, 110, 6), (111, 118, 7),
                ]
                for lo, hi, s in brackets:
                    if lo <= start <= hi:
                        score = s
                        break
        except ValueError:
            pass
    return np.full((num_frames, 1), score, np.int32)


# ---------------------------------------------------------------------------
# mel filterbank and onsets (copies of raggesture_tpu/eval/metrics.py's)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def _mel_filterbank(sr, n_fft, n_mels=128, fmin=0.0, fmax=None):
    fmax = fmax or sr / 2
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    freqs = _mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower, center, upper = freqs[i], freqs[i + 1], freqs[i + 2]
        left = (fft_freqs - lower) / max(center - lower, 1e-9)
        right = (upper - fft_freqs) / max(upper - center, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(left, right))
    # slaney normalization
    enorm = 2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels])
    fb *= enorm[:, None]
    return fb


def onset_strength(y: np.ndarray, sr: int = 16000, hop_length: int = 512,
                   n_fft: int = 2048, n_mels: int = 128) -> np.ndarray:
    """Spectral-flux onset envelope on a log-mel spectrogram (librosa
    onset_strength semantics, incl. its 1-frame lag and center padding)."""
    y = np.asarray(y, np.float32)
    pad = n_fft // 2
    ypad = np.pad(y, (pad, pad), mode="reflect") if len(y) > pad else np.pad(
        y, (pad, pad), mode="constant")
    n_frames = 1 + (len(ypad) - n_fft) // hop_length
    window = np.hanning(n_fft)
    frames = np.lib.stride_tricks.as_strided(
        ypad, shape=(n_frames, n_fft),
        strides=(ypad.strides[0] * hop_length, ypad.strides[0]),
    )
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2  # (T, F)
    mel = _mel_filterbank(sr, n_fft, n_mels) @ spec.T  # (M, T)
    logmel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 80.0)
    flux = np.maximum(0.0, logmel[:, 1:] - logmel[:, :-1]).mean(axis=0)
    # librosa pads the envelope start by lag + n_fft // (2*hop) frames
    # (compensating the centered STFT), then trims to the frame count
    pad_width = 1 + n_fft // (2 * hop_length)
    env = np.concatenate([np.zeros(pad_width, flux.dtype), flux])
    return env[:n_frames]


def detect_onsets(y: np.ndarray, sr: int = 16000, hop_length: int = 512
                  ) -> np.ndarray:
    """Onset times in seconds (librosa.onset.onset_detect(units='time')
    equivalent: peak-pick the strength envelope with its default windows)."""
    env = onset_strength(y, sr, hop_length)
    if env.size == 0 or env.max() <= 0:
        return np.zeros((0,))
    # librosa onset_detect(normalize=True) rescales the envelope to [0, 1]
    # before peak picking, so delta=0.07 is 7%-of-max
    env = env - env.min()
    env = env / max(env.max(), 1e-10)
    pre_max = int(np.ceil(0.03 * sr / hop_length))
    post_max = int(np.ceil(0.0 * sr / hop_length)) + 1
    pre_avg = int(np.ceil(0.1 * sr / hop_length))
    post_avg = int(np.ceil(0.1 * sr / hop_length)) + 1
    wait = int(np.ceil(0.03 * sr / hop_length))
    delta = 0.07
    peaks = []
    last = -1 - wait
    for n in range(len(env)):
        lo_max = max(0, n - pre_max)
        hi_max = min(len(env), n + post_max)
        lo_avg = max(0, n - pre_avg)
        hi_avg = min(len(env), n + post_avg)
        if env[n] != env[lo_max:hi_max].max():
            continue
        if env[n] < env[lo_avg:hi_avg].mean() + delta:
            continue
        if n - last <= wait:
            continue
        peaks.append(n)
        last = n
    return np.asarray(peaks) * hop_length / sr


# ---------------------------------------------------------------------------
# feature extractors (audio / text)
# ---------------------------------------------------------------------------


class FeatureExtractor:
    """wav2vec2 audio features + BERT word embeddings protocol."""

    audio_dim: int = 768
    text_dim: int = 768

    def audio_features(self, wave: np.ndarray, sr: int) -> np.ndarray:
        raise NotImplementedError

    def word_embeddings(self, sentence: str):
        """Returns (per-word vectors list, per-token features (N, D)) or
        (None, None) when the sentence exceeds the position limit."""
        raise NotImplementedError


class MelFeatureExtractor(FeatureExtractor):
    """librosa-free melspectrogram / onset+amplitude audio features
    (reference audio_rep="melspec" and "onset+amplitude" branches,
    beatx_dataset.py:476-496), with this module's copies of the numpy
    mel filterbank and onset detector.  Word embeddings delegate to another
    extractor (default: the deterministic stub)."""

    def __init__(self, rep: str = "melspec", num_mels: int = 80,
                 hop_length: int = 512, text_extractor: Optional[
                     "FeatureExtractor"] = None):
        assert rep in ("melspec", "onset+amplitude")
        self.rep = rep
        self.num_mels = num_mels
        self.hop_length = hop_length
        self.audio_dim = num_mels if rep == "melspec" else 2
        self._text = text_extractor or StubFeatureExtractor()
        self.text_dim = self._text.text_dim

    def audio_features(self, wave, sr):
        wave = np.asarray(wave, np.float32)
        if self.rep == "melspec":
            n_fft = 2048
            hop = self.hop_length
            pad = n_fft // 2
            if len(wave) < 2:  # degenerate tail windows
                return np.zeros((1, self.num_mels), np.float32)
            # reflect-pad width is capped at len(wave)-1 on BOTH sides — a
            # sub-n_fft tail window would otherwise raise in np.pad
            y = np.pad(wave, (min(pad, len(wave) - 1),
                              min(pad, len(wave) - 1)), mode="reflect")
            if len(y) < n_fft:
                y = np.pad(y, (0, n_fft - len(y)))
            n_frames = 1 + (len(y) - n_fft) // hop
            window = np.hanning(n_fft)
            frames = np.lib.stride_tricks.as_strided(
                y, shape=(n_frames, n_fft),
                strides=(y.strides[0] * hop, y.strides[0])).copy()
            spec = np.abs(np.fft.rfft(frames * window, axis=1)) ** 2
            mel = _mel_filterbank(sr, n_fft, self.num_mels)
            return (spec @ mel.T).astype(np.float32)  # (frames, n_mels)
        # onset + amplitude at the raw sample rate (:477-490)
        frame_length = 1024
        if wave.shape[-1] < frame_length:  # shorter than one analysis frame
            wave = np.pad(wave, (0, frame_length - wave.shape[-1]))
        shape = (wave.shape[-1] - frame_length + 1, frame_length)
        strides = (wave.strides[-1], wave.strides[-1])
        rolling = np.lib.stride_tricks.as_strided(wave, shape=shape,
                                                  strides=strides)
        env = np.max(np.abs(rolling), axis=1)
        env = np.pad(env, (0, frame_length - 1), mode="constant",
                     constant_values=env[-1] if len(env) else 0.0)
        onset_times = detect_onsets(wave, sr, hop_length=512)  # seconds
        onset = np.zeros(len(wave), np.float32)
        if len(onset_times):
            onset[np.clip((onset_times * sr).astype(int), 0,
                          len(wave) - 1)] = 1.0
        return np.stack([env, onset], axis=1).astype(np.float32)

    def word_embeddings(self, sentence):
        return self._text.word_embeddings(sentence)


class StubFeatureExtractor(FeatureExtractor):
    """Deterministic hash-seeded features (hermetic tests / no egress):
    audio at the wav2vec2 frame rate (sr/320), text as per-word vectors."""

    def __init__(self, audio_dim=768, text_dim=768, seed=0):
        self.audio_dim = audio_dim
        self.text_dim = text_dim
        self.seed = seed

    def audio_features(self, wave, sr):
        n_frames = max(1, len(wave) // 320 - 1)
        r = np.random.RandomState((abs(int(np.sum(wave[:100]) * 1e4)) + self.seed)
                                  % (2**31))
        return r.randn(n_frames, self.audio_dim).astype(np.float32)

    def word_embeddings(self, sentence):
        import zlib

        words = sentence.split()
        vecs = []
        for w in words:
            # stable digest, NOT builtin hash(): str hashing is randomized
            # per process (PYTHONHASHSEED), which would make the "same"
            # stub cache differ between the build and a later serving run
            r = np.random.RandomState(
                (zlib.crc32(w.encode()) + self.seed) % (2**31))
            vecs.append(r.randn(self.text_dim).astype(np.float32))
        feats = np.stack(vecs) if vecs else np.zeros((1, self.text_dim), np.float32)
        return vecs, feats


# ---------------------------------------------------------------------------
# config + featurization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BeatXConfig:
    """configs/_base_/datasets/beatx_len150_15fps.py:21-68."""

    data_root: str = "datasets/beat_english_v2.0.0"
    cache_dir: str = "datasets/cache"
    split: str = "train"             # train | val | test
    pose_rep: str = "smplxflame_30"
    pose_fps: int = 15
    pose_length: int = 150
    stride: int = 5
    audio_sr: int = 16000
    test_cache_mode: str = "windowed"  # windowed | full
    audio_rep: str = "wav2vec"       # wav2vec | melspec | onset+amplitude
    num_mels: int = 80
    hop_length: int = 512
    training_speakers: Sequence[int] = tuple(DEFAULT_TRAIN_SPEAKERS)
    clean_first_seconds: int = 0
    clean_final_seconds: int = 0
    debug: bool = False   # 10 files
    tiny: bool = False    # 1 file
    new_cache: bool = False
    # SMPL-X npz used for foot-contact FK during cache build; a cache built
    # without it gets all-ones contacts, which silently corrupts training —
    # hence the hard error unless allow_fake_contacts is set (tests).
    smplx_asset: Optional[str] = None
    allow_fake_contacts: bool = False


def window_starts(n_pose_frames: int, cfg: BeatXConfig, is_test: bool
                  ) -> Tuple[List[int], int]:
    """Window subdivision (beatx_dataset.py:743-771): train stride 5, test
    windowed stride = length, test full = single full-clip window."""
    fps = cfg.pose_fps
    clip_s = cfg.clean_first_seconds * fps
    clip_e = (n_pose_frames // fps - cfg.clean_final_seconds) * fps
    if is_test and cfg.test_cache_mode == "full":
        cut = clip_e - clip_s
        stride = cut
    elif is_test:
        cut = cfg.pose_length
        stride = cfg.pose_length
    else:
        cut = cfg.pose_length
        stride = cfg.stride
    if clip_e - clip_s <= 0 or cut <= 0 or stride <= 0:
        # degenerate clip (shorter than a second, or clean_final_seconds
        # consumed it): no windows — the caller skips the clip instead of
        # a ZeroDivisionError aborting the whole cache build
        return [], max(cut, 0)
    n = math.floor((clip_e - clip_s - cut) / stride) + 1
    return [clip_s + i * stride for i in range(max(n, 0))], cut


def featurize_clip(
    file_id: str,
    raw: Dict,
    cfg: BeatXConfig,
    extractor: FeatureExtractor,
    is_test: bool = False,
    smplx_model=None,
) -> List[Dict]:
    """One clip -> per-window records.

    raw fields: poses30 (T30, 165), trans30 (T30, 3), betas (300,),
    expressions30 (T30, 100), audio (S,) @16 kHz, tokens (disco token dict),
    relations (relations JSON dict), sem (list of {name, start_time,
    end_time, score, word}), prominence (list of (word, start, end, prom)).
    """
    fps = cfg.pose_fps
    stride30 = 30 // fps
    pose = np.asarray(raw["poses30"], np.float32)[::stride30]
    trans = np.asarray(raw["trans30"], np.float32)[::stride30]
    exps = np.asarray(raw["expressions30"], np.float32)[::stride30]
    betas = np.asarray(raw["betas"], np.float32).reshape(-1)
    n = pose.shape[0]

    # foot contacts by one batched FK on the model's device (reference
    # beatx_dataset.py:381-424: chunked CUDA smplx)
    if smplx_model is not None:
        import torch

        from ..models.smplx import lbs

        dev = smplx_model.device
        nb = smplx_model.shapedirs.shape[-1]
        ne = smplx_model.exprdirs.shape[-1]
        joints, _ = lbs(
            smplx_model,
            torch.as_tensor(betas[:nb], device=dev).expand(n, nb),
            torch.as_tensor(pose, device=dev),
            expression=torch.as_tensor(exps[:, :ne], device=dev),
            transl=torch.as_tensor(trans, device=dev),
            return_verts=False)
        fj = joints[:, (7, 8, 10, 11)].cpu().numpy()
        feetv = np.zeros((4, n), np.float32)
        feetv[:, :-1] = np.linalg.norm(
            fj[1:].transpose(1, 0, 2) - fj[:-1].transpose(1, 0, 2), axis=-1)
        contacts = (feetv < 0.01).astype(np.float32).T
    elif cfg.allow_fake_contacts:
        warnings.warn("no SMPL-X model provided; foot contacts set to 1")
        contacts = np.ones((n, 4), np.float32)
    else:
        raise RuntimeError(
            "featurize_clip needs an SMPL-X model for foot-contact FK "
            "(reference beatx_dataset.py:381-424); building a cache without "
            "one would train on all-ones contact bits. Set "
            "BeatXConfig.smplx_asset to the SMPLX_NEUTRAL_2020.npz path, or "
            "set allow_fake_contacts=True to accept degraded contacts "
            "(tests only).")

    parts = split_pose(pose)
    pose_with_contacts = np.concatenate([pose, contacts], axis=1)  # 169-d
    audio = np.asarray(raw.get("audio", np.zeros(0)), np.float32)
    tokens = raw.get("tokens")
    relations = raw.get("relations")
    sem_entries = raw.get("sem", [])
    prominence = raw.get("prominence", [])
    speaker = idmapping(int(file_id.split("_")[0]))
    emo = emotion_from_filename(file_id, n)

    starts, cut = window_starts(n, cfg, is_test)
    audio_len = math.floor(cut / fps * cfg.audio_sr)

    records = []
    for w_idx, s in enumerate(starts):
        e = s + cut
        start_sec, end_sec = s / fps, e / fps
        rec: Dict = {}
        rec["motion"] = pose_with_contacts[s:e]
        for part in ("upper", "face", "lower", "hands"):
            rec[f"motion_{part}"] = parts[part][s:e]
        rec["trans"] = trans[s:e]
        rec["facial"] = exps[s:e]
        rec["beta"] = np.tile(betas[None, :300], (cut, 1))
        a_s = math.floor(s * cfg.audio_sr / fps)
        rec["raw_audio"] = audio[a_s : a_s + audio_len]
        rec["audio"] = extractor.audio_features(rec["raw_audio"], cfg.audio_sr) \
            if len(rec["raw_audio"]) else np.zeros((1, extractor.audio_dim), np.float32)

        if tokens is not None:
            text, textsegs = disco.window_tokens(tokens, start_sec, end_sec)
            if text == "":
                continue  # reference skips empty-transcript windows (:842-843)
            merged = disco.merge_textsegs(textsegs)
            vecs, text_feature = extractor.word_embeddings(text)
            if vecs is None:
                continue  # BERT too long (:849-856)
            wordenc = np.zeros((cut, extractor.text_dim), np.float32)
            for i, v in enumerate(vecs[: len(merged)]):
                fs = int(merged[i][0][0] * fps)
                fe = int(merged[i][0][1] * fps)
                wordenc[fs:fe] = v
            rec["raw_word"] = text
            rec["word"] = wordenc
            rec["text_feature"] = np.asarray(text_feature, np.float32)
            rec["text_segments"] = textsegs
        else:
            rec["raw_word"] = ""
            rec["word"] = np.zeros((cut, extractor.text_dim), np.float32)
            rec["text_feature"] = np.zeros((1, extractor.text_dim), np.float32)
            rec["text_segments"] = []

        rec["discourse"] = (
            disco.window_relations(relations, start_sec, end_sec)
            if relations is not None else []
        )
        rec["prominence"] = [
            (w, float(ps) - start_sec, float(pe) - start_sec, float(pv))
            for (w, ps, pe, pv) in prominence
            if ps >= start_sec and pe <= end_sec
        ]
        rec["gesture_labels"] = [
            {
                "name": g["name"],
                "start": float(g["start_time"]) - start_sec,
                "end": float(g["end_time"]) - start_sec,
                "word": g.get("word", g.get("keywords", "")),
            }
            for g in sem_entries
            if g["start_time"] >= start_sec and g["end_time"] <= end_sec
        ]
        # per-frame semantic score (beatx_dataset.py:586-600)
        sem_score = np.zeros((cut, 1), np.float32)
        for g in sem_entries:
            fs = max(0, int((g["start_time"] - start_sec) * fps))
            fe = min(cut, int((g["end_time"] - start_sec) * fps))
            if fe > fs:
                sem_score[fs:fe] = float(g.get("score", 0.0))
        rec["sem_score"] = sem_score
        rec["emo"] = emo[s:e]
        rec["speaker_id"] = np.array([speaker], np.int32)
        rec["contact"] = contacts[s:e]
        rec["motion_length"] = cut
        rec["sample_name"] = f"{file_id}/{w_idx}"
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# shard cache
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = (
    "motion", "motion_upper", "motion_face", "motion_lower", "motion_hands",
    "trans", "facial", "beta", "raw_audio", "audio", "word", "text_feature",
    "sem_score", "emo", "speaker_id", "contact",
)
_META_FIELDS = ("raw_word", "text_segments", "discourse", "prominence",
                "gesture_labels", "sample_name", "motion_length")


class ShardCache:
    """Directory of per-window .npz + meta.json with a name index.

    Windows are grouped into subdirectories of 1000 (BEAT2 produces ~200k
    train windows — a flat directory of 400k files is pathological on most
    filesystems; the reference used LMDB for the same reason,
    beatx_dataset.py:951-988).  Pre-subdirectory flat caches remain
    readable."""

    GROUP = 1000

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._index_path = os.path.join(path, "name_to_idx.json")
        self._complete_path = os.path.join(path, "COMPLETE")
        self.name_to_idx: Dict[str, int] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.name_to_idx = json.load(f)

    def __len__(self):
        return len(self.name_to_idx)

    @property
    def is_complete(self) -> bool:
        """True once build_cache finished every clip.  The index flushes
        after every clip (crash safety), so WITHOUT this marker a build
        interrupted at clip 50/1945 would be indistinguishable from — and
        silently served as — a complete cache."""
        return os.path.exists(self._complete_path)

    @property
    def extractor_name(self) -> Optional[str]:
        """Featurizer class the cache was built with (None for pre-marker
        caches) — lets tools warn when per-chunk re-featurization would
        mix feature spaces (tools/longform_synthesis.py)."""
        if not os.path.exists(self._complete_path):
            return None
        with open(self._complete_path) as f:
            raw = f.read().strip()
        try:
            return json.loads(raw).get("extractor")
        except (ValueError, AttributeError):
            return None  # legacy "1" marker

    def mark_complete(self, extractor_name: Optional[str] = None):
        with open(self._complete_path, "w") as f:
            json.dump({"extractor": extractor_name}, f)

    def _base(self, idx: int, write: bool = False) -> str:
        grouped = os.path.join(self.path, f"g{idx // self.GROUP:04d}",
                               f"{idx:06d}")
        if write:
            os.makedirs(os.path.dirname(grouped), exist_ok=True)
            return grouped
        if os.path.exists(grouped + ".npz"):
            return grouped
        return os.path.join(self.path, f"{idx:06d}")  # legacy flat layout

    def write(self, records: List[Dict]):
        for rec in records:
            # a re-written sample_name reuses its idx (overwrite in place) —
            # appending would collide two names onto one later idx
            idx = self.name_to_idx.get(rec["sample_name"],
                                       len(self.name_to_idx))
            base = self._base(idx, write=True)
            arrays = {k: np.asarray(rec[k]) for k in _ARRAY_FIELDS if k in rec}
            np.savez_compressed(base + ".npz", **arrays)
            meta = {k: rec[k] for k in _META_FIELDS if k in rec}
            with open(base + ".json", "w") as f:
                json.dump(meta, f)
            self.name_to_idx[rec["sample_name"]] = idx
        with open(self._index_path, "w") as f:
            json.dump(self.name_to_idx, f)

    def read(self, idx: int) -> Dict:
        base = self._base(idx)
        arrays = dict(np.load(base + ".npz", allow_pickle=False))
        with open(base + ".json") as f:
            meta = json.load(f)
        # json round-trips tuples as lists — restore tuple-typed fields
        meta["discourse"] = [tuple(d) for d in meta.get("discourse", [])]
        meta["prominence"] = [tuple(p) for p in meta.get("prominence", [])]
        arrays.update(meta)
        return arrays


class BeatXDataset:
    """Serves cached window records with the reference's field schema."""

    def __init__(self, cache: ShardCache, pose_fps: int = 15):
        self.cache = cache
        self.pose_fps = pose_fps
        self.names = sorted(cache.name_to_idx, key=cache.name_to_idx.get)

    def __len__(self):
        return len(self.names)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, key):
        if isinstance(key, str):
            idx = self.cache.name_to_idx[key]
        else:
            idx = self.cache.name_to_idx[self.names[key]]
        rec = self.cache.read(idx)
        T = rec["motion"].shape[0]
        # the cached full motion carries 4 contact dims appended (:442);
        # split them back out like __getitem__ does (:1182-1295)
        rec["contact"] = rec["motion"][:, POSE_DIM:]
        rec["motion"] = rec["motion"][:, :POSE_DIM]
        rec["motion_mask"] = np.ones((T,), np.float32)
        rec["motion_length"] = np.asarray(rec.get("motion_length", T), np.int32)
        rec["sample_idx"] = np.asarray(idx, np.int32)
        return rec


def collate(records: List[Dict]) -> Dict:
    """Fixed-shape fields stacked into arrays; ragged fields stay lists
    (reference beatx_collate_fn, mogen/datasets/builder.py:55-92)."""
    batch: Dict = {}
    stack_fields = (
        "motion", "motion_upper", "motion_face", "motion_lower",
        "motion_hands", "trans", "facial", "beta", "audio", "word",
        "text_feature", "sem_score", "emo", "contact", "motion_mask",
        "motion_length", "speaker_id", "sample_idx",
        "latent_mu", "latent_logvar",  # frozen-codec latent cache
    )
    for k in stack_fields:
        if k not in records[0]:
            continue
        vals = [np.asarray(r[k]) for r in records]
        if k in ("audio", "text_feature"):  # variable length -> pad
            mx = max(v.shape[0] for v in vals)
            out = np.zeros((len(vals), mx) + vals[0].shape[1:], vals[0].dtype)
            for i, v in enumerate(vals):
                out[i, : v.shape[0]] = v
            batch[k] = out
        else:
            batch[k] = np.stack(vals)
    batch["speaker_ids"] = batch.pop("speaker_id").reshape(len(records), -1)[:, 0]
    for k in ("raw_word", "text_segments", "discourse", "prominence",
              "gesture_labels", "sample_name", "raw_audio"):
        batch[k] = [r.get(k) for r in records]
    return batch
