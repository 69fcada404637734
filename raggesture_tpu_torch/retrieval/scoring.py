"""Shared retrieval scoring utilities (host-side, deterministic).

The port's own copy of ``raggesture_tpu/retrieval/scoring.py``, after the
reference's mogen/models/transformers/rag/utils.py:
  - map_conns_to_prominence (:171-228): align connective/word lists to
    prosodic-prominence tuples, averaging multi-word connectives
  - text-similarity tie-breaking (:86-132): mean diagonal cosine between the
    query's normalized BERT token features and each candidate's, per score
    tier (the JAX package's batched corpus variant has no caller and is
    left out)
  - word similarity (:231-270): the reference's word2vec/fasttext models are
    commented out upstream, so its effective behavior is ALWAYS the
    fuzzywuzzy ``partial_ratio`` fallback — implemented here directly
    (difflib-based, same definition), so fuzzywuzzy is not needed.
"""

from __future__ import annotations

import copy
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _alnum_space(s: str) -> str:
    return "".join(c for c in str(s) if c.isalnum() or c.isspace())


def partial_ratio(s1: str, s2: str) -> float:
    """fuzzywuzzy.fuzz.partial_ratio semantics: best full-ratio of the
    shorter string against same-length substrings of the longer, in 0..100."""
    if not s1 or not s2:
        return 0.0
    shorter, longer = (s1, s2) if len(s1) <= len(s2) else (s2, s1)
    m = SequenceMatcher(None, shorter, longer, autojunk=False)
    best = 0.0
    for block in m.get_matching_blocks():
        start = max(0, block.b - block.a)
        substr = longer[start : start + len(shorter)]
        r = SequenceMatcher(None, shorter, substr, autojunk=False).ratio()
        best = max(best, r)
        if best == 1.0:
            break
    return round(best * 100)


def word_similarity(word1: str, word2: str) -> float:
    """Word similarity in 0..1 (reference get_word_similarity_score — its
    embedding models are dead code, so this is the partial-ratio path)."""
    return partial_ratio(word1, word2) / 100.0


def map_conns_to_prominence(
    conn_list: Sequence[str], prominence_list: Sequence[Tuple]
) -> Dict[int, Optional[Tuple[str, float]]]:
    """Map each connective to its (normalized text, prominence value).

    prominence_list rows are (word, start, end, prominence).  Multi-word
    connectives accumulate word prominences and are averaged.  Returns
    {conn_idx: (normalized_conn_text, prom) | None}."""
    relevant: Dict[int, list] = {}
    residual = list(copy.deepcopy(conn_list))
    for dp in prominence_list:
        dp_word = _alnum_space(dp[0])
        for si, sc in enumerate(conn_list):
            relevant.setdefault(si, [])
            if residual[si] is None:
                continue
            sc_n = _alnum_space(sc)
            if dp_word == sc_n or dp_word in sc_n.split():
                relevant[si].append((sc_n, float(dp[3])))
                if dp_word == sc_n or dp_word == sc_n.split()[-1]:
                    residual[si] = None
                break
    out: Dict[int, Optional[Tuple[str, float]]] = {}
    for si in range(len(conn_list)):
        dps = relevant.get(si, [])
        if len(dps) > 1:
            sc_n = _alnum_space(conn_list[si])
            assert dps[0][0] == sc_n
            # return the NORMALIZED text like the single-word branch does
            # (relevant[] stores sc_n): downstream consistency asserts in
            # discourse.py compare against _alnum_space-normalized
            # connectives, and a raw multi-word conn with punctuation
            # ('on the other hand,') would crash them
            out[si] = (sc_n, sum(d[1] for d in dps) / len(dps))
        else:
            out[si] = dps[0] if dps else None
    assert len(out) == len(conn_list)
    return out


def text_similarity_scores(
    query_feats: np.ndarray, candidate_feats: Sequence[np.ndarray]
) -> np.ndarray:
    """Mean diagonal cosine between the query token features (Nq, D),
    L2-normalized per token, and each candidate's (Ni, D).

    The reference takes torch.mm(query, cand.T).diagonal().mean() — the
    diagonal of a possibly non-square product, i.e. per-position dot over the
    first min(Nq, Ni) tokens — on RAW features (its normalization is
    commented out, rag/utils.py:103-117).  Here BOTH sides are
    L2-normalized per token (corpus at cache build, query in
    RetrievalDatabase.retrieve): a deliberate deviation making the
    tie-break a true cosine instead of a magnitude-weighted dot."""
    out = np.empty((len(candidate_feats),), np.float32)
    q = np.asarray(query_feats, np.float32)
    for i, c in enumerate(candidate_feats):
        c = np.asarray(c, np.float32)
        n = min(q.shape[0], c.shape[0])
        out[i] = float(np.einsum("nd,nd->n", q[:n], c[:n]).mean()) if n else 0.0
    return out


def sort_by_text_similarity(
    indexes: List, query_feats: np.ndarray, feat_cache: Dict
) -> List:
    """Stable-sort a score tier by descending text similarity
    (reference sort_sidx_by_textsimilarity rag/utils.py:86-132).
    ``feat_cache[idx] = (normalized token feats, speaker_id)``."""
    if not indexes:
        return indexes
    feats = [feat_cache[i][0] for i in indexes]
    sims = text_similarity_scores(query_feats, feats)
    order = sorted(range(len(indexes)), key=lambda k: -sims[k])
    return [indexes[k] for k in order]


def rank_tiers(
    scores: Dict, query_feats: np.ndarray, feat_cache: Dict, top_n: int = 10
) -> List:
    """Sort candidates by score descending, break ties by text similarity,
    stop once top_n collected (reference discourse_retrieval.py:222-248 /
    gesture_type_retrieval.py:117-143). Zero-score candidates are dropped."""
    tiers: Dict[float, list] = {}
    for idx in sorted(scores, key=scores.get, reverse=True):
        s = scores[idx]
        tiers.setdefault(s, [])
        if s > 0:
            tiers[s].append(idx)
    ranked: List = []
    for s in sorted(tiers, reverse=True):
        tier = tiers[s]
        if len(tier) > 1:
            tier = sort_by_text_similarity(tier, query_feats, feat_cache)
        ranked += tier
        if len(ranked) >= top_n:
            break
    return ranked
