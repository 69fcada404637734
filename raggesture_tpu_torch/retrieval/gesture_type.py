"""Semantic gesture-type exemplar retrieval (host-side, deterministic).

The port's own copy of ``raggesture_tpu/retrieval/gesture_type.py``, after
the reference's mogen/models/transformers/rag/gesture_type_retrieval.py:
8-176.  For each non-beat query gesture label
(name in {deictic, iconic, metaphoric}), corpus samples are scored:

    +2  gesture type match
    +2  same speaker
    +5  exact word match among same-type entries, else
    +3 / (1 + 2*max_word_similarity)  (fuzzy word similarity)

Ties re-ranked by BERT-token cosine; top-10 per query label returned with
each sample's best-matching label bounds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .scoring import rank_tiers, word_similarity

TOP_N = 10


def gesture_type_retrieval(
    text: str,
    gesture_labels: Sequence[Dict],
    speaker_id: int,
    db_idx_2_gesture_labels: Dict,
    encoded_text,
    text_feat_cache: Dict,
):
    """Returns (sample_indexes, d_bounds, query_bounds) keyed by the query
    gesture index. gesture_labels rows: {"name", "word", "start", "end"}."""
    gesture_labels = [g for g in gesture_labels if g["name"] != "beat"]

    sample_indexes: Dict[int, List] = {}
    d_bounds: Dict[int, Dict] = {}
    query_bounds: Dict[int, Tuple] = {}
    if len(gesture_labels) == 0:
        return sample_indexes, d_bounds, query_bounds

    q_types = [g["name"] for g in gesture_labels]
    q_words = [g["word"] for g in gesture_labels]
    query_bounds = {
        i: (g["word"].lower(), g["name"], g["start"], g["end"])
        for i, g in enumerate(gesture_labels)
    }

    for q_idx, (q_type, q_word) in enumerate(zip(q_types, q_words)):
        scores: Dict = {}
        relevant_bounds: Dict = {}
        for smp_idx, entry in db_idx_2_gesture_labels.items():
            scores[smp_idx] = 0.0
            smp_spk = entry[0]
            labels = [g for g in entry[1:] if g["name"] != "beat"]
            types = [g["name"] for g in labels]
            words = [g["word"] for g in labels]

            if q_type not in types:
                continue
            scores[smp_idx] += 2.0
            rel_idx = [k for k, t in enumerate(types) if t == q_type]
            rel_words = [words[k] for k in rel_idx]
            if smp_spk == speaker_id:
                scores[smp_idx] += 2.0
            if q_word in rel_words:
                scores[smp_idx] += 5.0
                top_rel = rel_idx[rel_words.index(q_word)]
            else:
                sims = [word_similarity(w, q_word) for w in rel_words]
                k = int(np.argmax(sims))
                top_rel = rel_idx[k]
                scores[smp_idx] += 3.0 / (1.0 + 2.0 * sims[k])
            relevant_bounds[smp_idx] = labels[top_rel]

        ranked = rank_tiers(scores, encoded_text, text_feat_cache, TOP_N)
        sample_indexes[q_idx] = ranked[:TOP_N]
        d_bounds[q_idx] = {}
        for retr_idx in ranked[:TOP_N]:
            g = relevant_bounds[retr_idx]
            d_bounds[q_idx][retr_idx] = (
                g["word"], g["name"],
                round(float(g["start"]), 3), round(float(g["end"]), 3),
            )
        assert len(d_bounds[q_idx]) == len(sample_indexes[q_idx])

    assert len(d_bounds) == len(sample_indexes) == len(query_bounds)
    return sample_indexes, d_bounds, query_bounds
