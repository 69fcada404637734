"""RetrievalDatabase: corpus caches, memoization, exemplar window placement.

Port of ``raggesture_tpu/retrieval/database.py``, after the reference's
``RetrievalDatabase`` (mogen/models/transformers/raggesture.py:157-884):

  host side: string/dict scoring (discourse / gesture-type / LLM),
  per-sample metadata caches, memoization of retrieval results, and the
  integer window-placement math (seconds -> frames -> latent tokens,
  centering each exemplar window on the query midpoint with overlap
  bookkeeping);

  device side: ONE batched VAE encode of all retrieved exemplars (the
  caller's ``encode_fn``; the reference encodes each exemplar at batch
  size 1 — diffusion_architecture.py:323-354).

Storage: a directory of .npz + .json files with the reference's logical
keys (sample-name strings), the JAX package's format: each package loads
the other's corpus and memo.  The memo dicts (train/test indexes/dbounds/
qbounds) persist as JSON with a corpus fingerprint (DatabaseSaveHook,
mogen/core/model_freeze_hooks.py:48-181).

The re_dict payloads are float32 host arrays, as the JAX package keeps
them off the TPU; the generator moves them onto its device at dispatch.
"""

from __future__ import annotations

import dataclasses
import warnings
import json
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logger import get_root_logger
from .discourse import discourse_retrieval
from .gesture_type import gesture_type_retrieval
from .llm import llm_retrieval
from .scoring import map_conns_to_prominence

METHODS = ("discourse", "gesture_type", "llm")


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """configs/raggesture_beatx/basegesture_len150_beat.py:101-133."""

    num_retrieval: int = 1
    topk: int = 2
    max_seq_len: int = 150
    motion_fps: int = 15
    frame_chunk_size: int = 15
    latent_dim: int = 512
    text_latent_dim: int = 768
    stratified: bool = True
    stratification_interval: int = 15

    @property
    def latent_len(self) -> int:
        return self.max_seq_len // self.frame_chunk_size

    @property
    def num_tokens(self) -> int:
        return 4 * self.latent_len + 3


class RetrievalCorpus:
    """The six per-sample metadata caches, keyed by sample name."""

    def __init__(self):
        self.idx_2_text: Dict[str, Tuple[np.ndarray, int]] = {}
        self.idx_2_sense: Dict[str, list] = {}
        self.idx_2_discbounds: Dict[str, list] = {}
        self.idx_2_gesture_labels: Dict[str, list] = {}
        self.idx_2_prominence: Dict[str, dict] = {}
        self.idx_2_gestprom: Dict[str, dict] = {}

    @classmethod
    def build(cls, dataset, cfg: RetrievalConfig) -> "RetrievalCorpus":
        """Iterate the (train) dataset, keeping stratified windows
        (per-clip window index % interval == 0, raggesture.py:251-254)."""
        corpus = cls()
        for smp in dataset:
            name = smp["sample_name"]
            if cfg.stratified:
                win_idx = int(name.split("/")[1])
                if win_idx % cfg.stratification_interval != 0:
                    continue
            spk = int(np.asarray(smp["speaker_id"]).reshape(-1)[0])
            tf = np.asarray(smp["text_feature"], np.float32)
            tf = tf / np.maximum(np.linalg.norm(tf, axis=-1, keepdims=True), 1e-8)
            corpus.idx_2_text[name] = (tf, spk)
            corpus.idx_2_sense[name] = [spk] + [
                (d[1], d[0]) for d in smp["discourse"]
            ]
            corpus.idx_2_discbounds[name] = [
                (d[1], d[0], d[4], d[5], d[6], d[7]) for d in smp["discourse"]
            ]
            corpus.idx_2_gesture_labels[name] = [spk] + list(smp["gesture_labels"])
            conns = [d[0] for d in smp["discourse"]]
            corpus.idx_2_prominence[name] = map_conns_to_prominence(
                conns, smp["prominence"]
            )
            gest_words = [g["word"] for g in smp["gesture_labels"]]
            corpus.idx_2_gestprom[name] = map_conns_to_prominence(
                gest_words, smp["prominence"]
            )
        return corpus

    # -- persistence (npz for features, json for metadata) ------------------

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "text_features.npz"),
            **{n: f for n, (f, _) in self.idx_2_text.items()},
        )
        meta = {
            "speakers": {n: s for n, (_, s) in self.idx_2_text.items()},
            "sense": self.idx_2_sense,
            "discbounds": self.idx_2_discbounds,
            "gesture_labels": self.idx_2_gesture_labels,
            "prominence": {n: {str(k): v for k, v in d.items()}
                           for n, d in self.idx_2_prominence.items()},
            "gestprom": {n: {str(k): v for k, v in d.items()}
                         for n, d in self.idx_2_gestprom.items()},
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str) -> "RetrievalCorpus":
        corpus = cls()
        feats = np.load(os.path.join(path, "text_features.npz"))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        for n in feats.files:
            corpus.idx_2_text[n] = (feats[n], meta["speakers"][n])
        corpus.idx_2_sense = {k: [v[0]] + [tuple(x) for x in v[1:]]
                              for k, v in meta["sense"].items()}
        corpus.idx_2_discbounds = {k: [tuple(x) for x in v]
                                   for k, v in meta["discbounds"].items()}
        corpus.idx_2_gesture_labels = meta["gesture_labels"]
        corpus.idx_2_prominence = {
            n: {int(k): (None if v is None else tuple(v)) for k, v in d.items()}
            for n, d in meta["prominence"].items()
        }
        corpus.idx_2_gestprom = {
            n: {int(k): (None if v is None else tuple(v)) for k, v in d.items()}
            for n, d in meta["gestprom"].items()
        }
        return corpus


def place_window(retr_len: int, query_mid_lat: int, latent_len: int,
                 prev_end: int) -> Tuple[int, int, int]:
    """Center an exemplar window of ``retr_len`` latent tokens on the query
    midpoint, with boundary clamps and overlap bookkeeping
    (raggesture.py:676-733). Returns (start, end, kept_len); kept_len <
    retr_len means the window was trimmed, <= 0 means skip."""
    if retr_len == 1:
        start, end = query_mid_lat, query_mid_lat + 1
    elif retr_len == 2:
        start, end = query_mid_lat, query_mid_lat + 2
    elif retr_len % 2 == 1:
        side = retr_len // 2
        start, end = query_mid_lat - side - 1, query_mid_lat + side
    else:
        side = retr_len // 2
        start, end = query_mid_lat - side, query_mid_lat + side

    if start < 0:
        start, end = 0, retr_len
    if end > latent_len:
        start -= end - latent_len
        end = latent_len
    kept = retr_len
    if start < prev_end:
        start = prev_end
        end = start + retr_len
        if end > latent_len:
            end = latent_len
            kept = end - start
    return start, end, kept


def bounds_to_latent_window(
    start_s: float, end_s: float, cfg: RetrievalConfig, pad_small: bool
) -> Optional[Tuple[int, int]]:
    """Seconds -> padded exemplar latent-token window (raggesture.py:622-651).

    ``pad_small`` selects the reduced padding used for long gesture-label
    annotations (gesture_type/llm with duration > 0.9 s)."""
    motion_len = cfg.max_seq_len
    if pad_small:
        start_s = max(0.0, start_s - 0.2)
        end_s = min(motion_len / cfg.motion_fps, end_s + 0.1)
    else:
        start_s = max(0.0, start_s - 0.666)
        end_s = min(motion_len / cfg.motion_fps, end_s + 0.333)
    start = int(start_s * cfg.motion_fps)
    end = int(end_s * cfg.motion_fps)
    if start == end:
        return None
    if end == motion_len:
        end = motion_len - 1
        start = max(0, start - 1)
    return start // cfg.frame_chunk_size, end // cfg.frame_chunk_size + 1


class RetrievalDatabase:
    """Retrieval dispatch + memoization + re_dict assembly.

    ``dataset`` must support ``dataset[sample_name] -> sample dict`` with the
    BEATXDataset field schema; ``encode_fn(batch_dict) -> (latents, mask)``
    is a bound codec encode over stacked exemplar arrays.
    """

    def __init__(self, corpus: RetrievalCorpus, cfg: RetrievalConfig,
                 dataset, llm_fn: Optional[Callable[[str], str]] = None,
                 rng: Optional[random.Random] = None):
        self.corpus = corpus
        self.cfg = cfg
        self.dataset = dataset
        self.llm_fn = llm_fn
        self.rng = rng or random.Random(0)
        self.train_indexes: Dict = {}
        self.train_dbounds: Dict = {}
        self.train_qbounds: Dict = {}
        self.test_indexes: Dict = {}
        self.test_dbounds: Dict = {}
        self.test_qbounds: Dict = {}

    # -- memoization persistence (DatabaseSaveHook equivalent) --------------

    def corpus_fingerprint(self) -> str:
        """Cheap identity of the retrieval corpus: memoized results are only
        valid against the corpus that produced them (the reference's
        DatabaseSaveHook JSONs silently go stale when the corpus changes —
        observed as permanently-empty retrievals)."""
        names = sorted(self.corpus.idx_2_text)
        return f"{len(names)}:{names[0] if names else ''}:{names[-1] if names else ''}"

    def save_memo(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        for name in ("train_indexes", "train_dbounds", "train_qbounds",
                     "test_indexes", "test_dbounds", "test_qbounds"):
            with open(os.path.join(save_dir, f"{name}.json"), "w") as f:
                json.dump(getattr(self, name), f)
        with open(os.path.join(save_dir, "memo_meta.json"), "w") as f:
            json.dump({"corpus_fingerprint": self.corpus_fingerprint()}, f)

    def load_memo(self, save_dir: str):
        meta_path = os.path.join(save_dir, "memo_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("corpus_fingerprint") != self.corpus_fingerprint():
                warnings.warn(
                    f"retrieval memo in {save_dir} was built against a "
                    "different corpus; ignoring it")
                return
        elif any(os.path.exists(os.path.join(save_dir, f"{n}.json"))
                 for n in ("test_indexes", "train_indexes")):
            warnings.warn(
                f"retrieval memo in {save_dir} has no corpus fingerprint "
                "(pre-fingerprint format); ignoring it")
            return
        for name in ("train_indexes", "train_dbounds", "train_qbounds",
                     "test_indexes", "test_dbounds", "test_qbounds"):
            p = os.path.join(save_dir, f"{name}.json")
            if os.path.exists(p):
                with open(p) as f:
                    raw = json.load(f)
                # JSON stringifies int query keys — restore them
                fixed = {
                    idx: {m: {int(k) if k.lstrip("-").isdigit() else k: v
                              for k, v in per_m.items()}
                          for m, per_m in methods.items()}
                    for idx, methods in raw.items()
                }
                setattr(self, name, fixed)

    # -- retrieval dispatch (raggesture.py:313-477) --------------------------

    def retrieve(self, method: str, *, text, text_features, discourse,
                 gesture_labels, text_times, prominence, speaker_id,
                 idx=None, training=False):
        if method == "prosody":
            # parity with the reference's explicit stub
            # (raggesture.py:426-430 + empty rag/prosodic_prominence.py)
            raise NotImplementedError("prosody retrieval is not implemented")
        if method not in METHODS:
            raise ValueError(f"unknown retrieval method {method!r}; one of "
                             f"{METHODS}")
        if text_features is not None and len(np.shape(text_features)):
            # the tie-break similarity contract is cosine: corpus token
            # features are L2-normalized at cache build (RetrievalCorpus,
            # :88) — the query must be too, or per-token magnitudes skew
            # the mean dot and tier ordering diverges from the reference
            tf = np.asarray(text_features, np.float32)
            text_features = tf / np.maximum(
                np.linalg.norm(tf, axis=-1, keepdims=True), 1e-8)
        if training and idx in self.train_indexes and idx is not None:
            per_idx = self.train_indexes[idx]
            if not per_idx:
                return {}, {}, {}
            m = self.rng.choice(sorted(per_idx.keys()))
            db_indexes = per_idx[m]
            db_bounds = self.train_dbounds[idx][m]
            q_bounds = self.train_qbounds[idx][m]
            data = {}
            for q, smp_idxs in db_indexes.items():
                cands = [s for s in smp_idxs if s != idx][: self.cfg.topk]
                self.rng.shuffle(cands)
                data[q] = cands[: self.cfg.num_retrieval]
            return data, db_bounds, q_bounds

        if (not training) and idx in self.test_indexes and idx is not None:
            per_idx = self.test_indexes[idx]
            if method in per_idx:
                data = {
                    q: [s for s in smp_idxs if s != idx][: self.cfg.num_retrieval]
                    for q, smp_idxs in per_idx[method].items()
                }
                return (data, self.test_dbounds[idx][method],
                        self.test_qbounds[idx][method])
            # the memo (possibly loaded from a previous run's save_memo) was
            # built with a DIFFERENT method — fall through to the cold
            # scorer instead of silently returning zero exemplars for every
            # sample (the reference warns here, raggesture.py:368-372)
            get_root_logger().warning(
                "retrieval memo for idx %s has no %r entry (methods: %s) — "
                "running the cold scorer", idx, method, sorted(per_idx))

        # cold path: run the scorer
        c = self.corpus
        if method == "discourse":
            si, db, qb = discourse_retrieval(
                text, discourse, prominence, speaker_id, c.idx_2_sense,
                c.idx_2_discbounds, c.idx_2_prominence, text_features,
                c.idx_2_text,
            )
        elif method == "gesture_type":
            si, db, qb = gesture_type_retrieval(
                text, gesture_labels, speaker_id, c.idx_2_gesture_labels,
                text_features, c.idx_2_text,
            )
        else:
            si, db, qb = llm_retrieval(
                text, text_times, speaker_id, prominence,
                c.idx_2_gesture_labels, c.idx_2_gestprom, text_features,
                c.idx_2_text, llm_fn=self.llm_fn,
            )

        memo_i = self.test_indexes if not training else self.train_indexes
        memo_d = self.test_dbounds if not training else self.train_dbounds
        memo_q = self.test_qbounds if not training else self.train_qbounds
        memo_i.setdefault(idx, {})[method] = si
        memo_d.setdefault(idx, {})[method] = db
        memo_q.setdefault(idx, {})[method] = qb

        data = {
            q: [s for s in smp_idxs if s != idx][: self.cfg.num_retrieval]
            for q, smp_idxs in si.items()
        }
        return data, db, qb

    # -- re_dict assembly (raggesture.py:479-884) ----------------------------

    def __call__(self, host_batch: Dict[str, list], sample_names: List[str],
                 encode_fn: Callable, method: str = "gesture_type",
                 training: bool = False) -> Dict:
        """host_batch fields are per-batch-item python lists: text (str),
        text_features (tokens,768 np), discourse, gesture_labels, text_times,
        prominence, speaker_ids (int).  ``encode_fn`` takes the exemplars'
        stacked motion fields as float32 CPU tensors and returns their
        (latents (n, T, D), token mask (n, T)) on any device.  Returns the
        re_dict that ``StagedGenerator.__call__`` takes."""
        cfg = self.cfg
        B = len(host_batch["text"])
        L, T = cfg.latent_len, cfg.num_tokens
        chunk = cfg.frame_chunk_size

        # phase 1: retrieve + collect exemplar names and window math
        plans = []          # (b_ix, q_idx, smp_name, retr_lat_win, splice)
        exemplar_names: List[str] = []
        type2words: List[Dict] = [dict() for _ in range(B)]
        retr_startends: List[Dict] = [dict() for _ in range(B)]
        query_startends: List[Dict] = [dict() for _ in range(B)]
        names_per_b: List[Dict] = [dict() for _ in range(B)]

        for b in range(B):
            data, db_bounds, q_bounds = self.retrieve(
                method,
                text=host_batch["text"][b],
                text_features=host_batch["text_features"][b],
                discourse=host_batch["discourse"][b],
                gesture_labels=host_batch["gesture_labels"][b],
                text_times=host_batch["text_times"][b],
                prominence=host_batch["prominence"][b],
                speaker_id=int(host_batch["speaker_ids"][b]),
                idx=sample_names[b] if sample_names is not None else None,
                training=training,
            )
            prev_end = -1
            for q_idx, smp_idxs in data.items():
                if len(smp_idxs) == 0 or q_idx not in q_bounds:
                    continue
                q_word, q_type, q_start_s, q_end_s = q_bounds[q_idx]
                if q_start_s > q_end_s:
                    continue
                smp_name = smp_idxs[0]  # num_retrieval == 1
                r_word, r_type, r_start_s, r_end_s = db_bounds[q_idx][smp_name]

                # query window (frames -> latent tokens)
                q_start = int(max(0.0, q_start_s) * cfg.motion_fps)
                q_end = int(min(cfg.max_seq_len / cfg.motion_fps, q_end_s)
                            * cfg.motion_fps)
                q_lat_start = q_start // chunk
                q_lat_end = q_end // chunk + 1
                assert q_lat_start < q_lat_end

                pad_small = (method in ("gesture_type", "llm")
                             and (r_end_s - r_start_s) > 0.9)
                win = bounds_to_latent_window(r_start_s, r_end_s, cfg, pad_small)
                if win is None:
                    continue
                r_lat_start, r_lat_end = win
                retr_len = r_lat_end - r_lat_start
                query_mid_lat = ((q_start + q_end) // 2) // chunk

                start, end, kept = place_window(retr_len, query_mid_lat, L,
                                                prev_end)
                if kept <= 0:
                    continue
                if kept < retr_len:
                    r_lat_end = r_lat_start + kept
                prev_end = end

                type2words[b][q_idx] = (q_word, q_type, r_word, r_type)
                retr_startends[b][q_idx] = (r_lat_start, r_lat_end)
                query_startends[b][q_idx] = (start, end)
                names_per_b[b][q_word] = smp_name
                plans.append((b, q_idx, smp_name, (r_lat_start, r_lat_end),
                              (start, end)))
                exemplar_names.append(smp_name)

        # phase 2: ONE batched encode of all exemplars (reference loops them
        # one-by-one on GPU, raggesture.py:556-582).  Exemplars are fetched
        # and encoded once per UNIQUE name (with num_retrieval=1 several
        # queries routinely retrieve the same window), then expanded back to
        # per-plan rows — the splice/inversion row contract stays (Q, ...)
        Q = len(plans)
        lat_np = np.zeros((max(Q, 1), T, cfg.latent_dim), np.float32)
        inv_mask = np.zeros((max(Q, 1), T), np.float32)
        inv_word, inv_audio, inv_spk = [], [], []
        uniq_names = list(dict.fromkeys(exemplar_names))
        fetched = {n: self.dataset[n] for n in uniq_names}
        samples = [fetched[n] for n in exemplar_names]
        if Q > 0:
            usamples = [fetched[n] for n in uniq_names]

            def stack(key):
                return torch.from_numpy(np.stack(
                    [np.asarray(s[key], np.float32) for s in usamples]))

            enc_batch = {k: stack(k) for k in (
                "motion_upper", "motion_lower", "motion_face", "motion_hands",
                "trans", "facial", "contact", "motion_mask")}
            lat, mask = encode_fn(enc_batch)
            row = {n: i for i, n in enumerate(uniq_names)}
            sel = [row[n] for n in exemplar_names]
            lat_np = torch.as_tensor(lat).float().cpu().numpy()[sel]
            inv_mask = torch.as_tensor(mask).float().cpu().numpy()[sel]
            for s in samples:
                inv_word.append(np.asarray(s["word"], np.float32))
                inv_audio.append(np.asarray(s["audio"], np.float32))
                inv_spk.append(int(np.asarray(s["speaker_id"]).reshape(-1)[0]))

        # phase 3: assemble the spliced latent buffers + raw motion buffers
        zero_motion = np.zeros((B, T, cfg.latent_dim), np.float32)
        raw_motion = np.zeros((B, cfg.max_seq_len,
                               samples[0]["motion"].shape[-1] if Q else 1),
                              np.float32)
        raw_trans = np.zeros((B, cfg.max_seq_len, 3), np.float32)
        raw_facial = np.zeros((B, cfg.max_seq_len, 100), np.float32)
        splice_rows = []
        offsets = (0, L + 1, 2 * L + 2, 3 * L + 3)

        for q, (b, q_idx, name, (rs, re_), (qs, qe)) in enumerate(plans):
            ln = qe - qs
            for off in offsets:
                zero_motion[b, off + qs: off + qe] = lat_np[q, off + rs: off + rs + ln]
            smp = samples[q]
            fr_s, fr_e = qs * chunk, qe * chunk
            rfr_s = rs * chunk
            raw_motion[b, fr_s:fr_e] = np.asarray(smp["motion"])[rfr_s: rfr_s + (fr_e - fr_s)]
            raw_trans[b, fr_s:fr_e] = np.asarray(smp["trans"])[rfr_s: rfr_s + (fr_e - fr_s)]
            raw_facial[b, fr_s:fr_e] = np.asarray(smp["facial"])[rfr_s: rfr_s + (fr_e - fr_s)]
            splice_rows.append((b, qs, rs, ln))

        src_mask = (np.abs(zero_motion) != 0).any(-1).astype(np.int32)
        raw_latent_mask = src_mask.copy()
        raw_motion_latents = zero_motion.copy()
        # zero face + lowertrans rows: only upper & hands are inserted
        # (raggesture.py:850-857)
        face_lt = list(range(2 * L + 2, 3 * L + 2)) + list(range(3 * L + 3, T))
        src_mask[:, face_lt] = 0
        raw_motion_latents[:, face_lt, :] = 0.0

        def pad_stack(arrs, fill=0.0):
            if not arrs:
                return np.zeros((0,), np.float32)
            mx = max(a.shape[0] for a in arrs)
            out = np.full((len(arrs), mx) + arrs[0].shape[1:], fill, np.float32)
            for i, a in enumerate(arrs):
                out[i, : a.shape[0]] = a
            return out

        re_dict = {
            "re_mask": src_mask,
            "raw_motion_latents": raw_motion_latents[:, None],  # (B, 1, T, D)
            "raw_motion": raw_motion[:, None],
            "raw_trans": raw_trans[:, None],
            "raw_facial": raw_facial[:, None],
            "raw_sample_names": names_per_b,
            "raw_type2words": type2words,
            "raw_latent_mask": raw_latent_mask,
            "retr_startends": retr_startends,
            "query_startends": query_startends,
            # batched inversion inputs
            "inv_latents": lat_np[: max(Q, 1)],
            "inv_mask": inv_mask[: max(Q, 1)],
            "inv_conds": {
                "word": pad_stack(inv_word) if Q
                else np.zeros((1, 1, cfg.text_latent_dim), np.float32),
                "audio": pad_stack(inv_audio) if Q
                else np.zeros((1, 1, cfg.text_latent_dim), np.float32),
                "speaker_ids": np.asarray(inv_spk, np.int32) if Q
                else np.zeros((1,), np.int32),
            },
            "splice": np.asarray(splice_rows, np.int32).reshape(-1, 4)
            if splice_rows else np.zeros((0, 4), np.int32),
            # per-row exemplar identities, aligned with inv_latents rows —
            # the StagedGenerator's inversion cache keys on these
            "inv_names": list(exemplar_names) if Q else [],
            "num_queries": Q,
        }
        return re_dict


def host_batch_from_records(records: List[Dict]) -> Dict[str, list]:
    """Collate the ragged per-sample fields a RetrievalDatabase call needs
    from raw dataset records (the reference passes these through the
    conditions dict, raggesture.py:986-1010)."""
    return {
        "text": [r.get("raw_word", "") for r in records],
        "text_features": [np.asarray(r["text_feature"], np.float32)
                          for r in records],
        "discourse": [r.get("discourse", []) or [] for r in records],
        "gesture_labels": [r.get("gesture_labels", []) or [] for r in records],
        "text_times": [r.get("text_segments", []) or [] for r in records],
        "prominence": [r.get("prominence", []) or [] for r in records],
        "speaker_ids": [int(np.asarray(r["speaker_id"]).reshape(-1)[0])
                        for r in records],
    }
