"""LLM-labeled exemplar retrieval.

The port's own copy of ``raggesture_tpu/retrieval/llm.py``, after the
reference's mogen/models/transformers/rag/llm_retrieval.py:
an LLM (gpt-4o-mini by default) labels up to 2 gesture-eliciting words in the
transcript; the parsed (word, type) labels are aligned to the transcript's
word timings to get query bounds, then corpus samples are scored like
gesture-type retrieval plus a prominence-closeness term:

    +2  type match, +1 same speaker,
    +5  exact word match else +3/(1 + 2*max_word_similarity),
    +   mean over same-type entries of 4/(1 + 2*|Δprominence|)

The OpenAI call is gated: pass ``llm_fn`` (any ``text -> str`` callable)
to inject a client, or set OPENAI_API_KEY in a deployment with network
access.  A deterministic offline fallback
(``heuristic_labeler``) keeps the path exercisable in tests.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .scoring import (
    _alnum_space,
    map_conns_to_prominence,
    rank_tiers,
    word_similarity,
)

TOP_N = 10

GESTURE_TYPE_SYSTEM_PROMPT = """
You are an expert in human gestures. You need to identify words that may elicit semantically meaningful gestures(deictic, iconic, metaphoric) and their types:

Metaphoric Gesture: Represents abstract ideas or concepts physically, creating a vivid mental image.
Iconic Gesture: Mimics the shape or action of the object or concept being described.
Deictic Gesture: Points to or indicates a person, object, or location.

Format your response as a python list of python tuples of (word, type). For example: [('hello', 'beat'), ('world',
'iconic')]
"""


def make_openai_labeler(model: str = "gpt-4o-mini") -> Callable[[str], str]:
    """Build the gpt-4o-mini labeler (requires OPENAI_API_KEY + egress)."""
    from openai import OpenAI  # optional dependency, gated

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise RuntimeError(
            "OPENAI_API_KEY not set — LLM retrieval needs an API key; use "
            "retrieval_method='gesture_type'/'discourse' or pass llm_fn."
        )
    client = OpenAI(api_key=api_key)

    def call(text: str) -> str:
        completion = client.chat.completions.create(
            model=model,
            messages=[
                {"role": "system", "content": GESTURE_TYPE_SYSTEM_PROMPT},
                {"role": "user", "content": (
                    "identify at most 2 important words which are more likely "
                    "to elicit semantically meaningful gestures and what are "
                    f"types of those gestures in following text: \"{text}\"."
                )},
            ],
        )
        return completion.choices[0].message.content

    return call


def heuristic_labeler(text: str) -> str:
    """Zero-egress fallback: deterministic keyword heuristics producing the
    same output format as the LLM (at most 2 (word, type) tuples)."""
    deictic = {"this", "that", "here", "there", "these", "those", "you", "me"}
    iconic = {"big", "small", "round", "long", "short", "open", "close",
              "cut", "throw", "push", "pull", "up", "down"}
    labels: List[Tuple[str, str]] = []
    for w in re.findall(r"[\w']+", text.lower()):
        if len(labels) >= 2:
            break
        if w in deictic:
            labels.append((w, "deictic"))
        elif w in iconic:
            labels.append((w, "iconic"))
    if not labels:
        words = sorted(re.findall(r"[\w']+", text.lower()), key=len)
        if words:
            labels.append((words[-1], "metaphoric"))
    return repr(labels)


_LLM_MATCH = re.compile(
    r"[\"\']*([\w \-\']+\w)[\"\']*\,\s*[\"\']*"
    r"(?P<gesttype>b*eat|m*etaphoric|iconic|deictic)",
    re.MULTILINE,
)


def parse_gesture_labels(llm_output: str) -> List[Dict[str, str]]:
    """Regex-parse (word, type) tuples from LLM text; normalize type spelling
    variants; drop beats and duplicates (reference :131-165)."""
    labels = []
    for m in _LLM_MATCH.finditer(llm_output):
        g = m.group("gesttype")
        if "etaphoric" in g:
            name = "metaphoric"
        elif "eat" in g:
            name = "beat"
        elif "iconic" in g:
            name = "iconic"
        elif "deictic" in g:
            name = "deictic"
        else:
            raise ValueError(f"unknown gesture type {g}")
        labels.append({"word": m.group(1).strip(), "name": name})
    labels = [g for g in labels if g["name"] != "beat"]
    unique = []
    for g in labels:
        if g not in unique:
            unique.append(g)
    return unique


def align_labels_to_times(
    labels: Sequence[Dict], text_times: Sequence
) -> Dict[int, Tuple[str, str, float, float]]:
    """Align labeled words to transcript word timings -> query bounds.
    text_times rows: ((start_s, end_s), word).  Multi-word labels merge to
    (min start, max end) (reference :201-252)."""
    q_types = [g["name"] for g in labels]
    q_words = [_alnum_space(g["word"].lower()) for g in labels]
    bounds: Dict[int, list] = {}
    residual = copy.deepcopy(q_words)
    for t_time in text_times:
        t_word = _alnum_space(str(t_time[1]).lower())
        t_start, t_end = t_time[0][0], t_time[0][1]
        for qi, q_word in enumerate(q_words):
            if residual[qi] is None:
                continue
            if q_word == t_word or t_word in q_word.split():
                bounds.setdefault(qi, []).append(
                    (q_word, q_types[qi], t_start, t_end)
                )
                if q_word == t_word or t_word == q_word.split()[-1]:
                    residual[qi] = None
                break
    merged = {}
    for qi, bs in bounds.items():
        if len(bs) > 1:
            merged[qi] = (bs[0][0], bs[0][1], min(b[2] for b in bs),
                          max(b[3] for b in bs))
        else:
            merged[qi] = bs[0]
    # re-key densely in text order
    return {k: v for k, v in enumerate(merged.values())}


def llm_retrieval(
    text: str,
    text_times: Sequence,
    speaker_id: int,
    prominence: Sequence[Tuple],
    db_idx_2_gesture_labels: Dict,
    db_idx_2_prominence: Dict,
    encoded_text,
    text_feat_cache: Dict,
    llm_fn: Optional[Callable[[str], str]] = None,
):
    """Returns (sample_indexes, d_bounds, query_bounds) keyed by query index.

    ``db_idx_2_prominence`` here is the gesture-word prominence cache
    (idx_2_gestprom in the reference), aligned per gesture label."""
    sample_indexes: Dict[int, List] = {}
    d_bounds: Dict[int, Dict] = {}
    if not text.strip():
        return sample_indexes, d_bounds, {}

    if llm_fn is None:
        # honor the documented recipe: with OPENAI_API_KEY set, the real
        # gpt-4o-mini labeler runs (reference call_gpt_4o_mini); otherwise
        # the deterministic offline heuristic
        import os as _os

        if _os.environ.get("OPENAI_API_KEY"):
            llm_fn = make_openai_labeler()
        else:
            llm_fn = heuristic_labeler
    labels = parse_gesture_labels(llm_fn(text))
    if not labels:
        return sample_indexes, d_bounds, {}

    query_bounds = align_labels_to_times(labels, text_times)
    if not query_bounds:
        return sample_indexes, d_bounds, query_bounds

    q_idxs = sorted(query_bounds.keys())
    q_types = [query_bounds[i][1] for i in q_idxs]
    q_words = [query_bounds[i][0] for i in q_idxs]

    q_prom = map_conns_to_prominence(q_words, prominence)
    q_prom = {
        i: (None if q_prom[i] is None else (q_types[i], *q_prom[i]))
        for i in range(len(q_idxs))
    }

    for q_idx, (q_type, q_word) in enumerate(zip(q_types, q_words)):
        scores: Dict = {}
        relevant_bounds: Dict = {}
        for smp_idx, entry in db_idx_2_gesture_labels.items():
            scores[smp_idx] = 0.0
            smp_spk = entry[0]
            all_labels = entry[1:]
            db_prom_raw = db_idx_2_prominence[smp_idx]
            if len(all_labels) == 0:
                continue
            # filter beats, keeping prominence aligned.  The gestprom cache
            # is int-keyed per label (database.py build/load); a missing
            # index means cache/label misalignment — fail loudly like the
            # reference's len assert (llm_retrieval.py), never silently
            # drop the prominence bonus
            assert len(db_prom_raw) == len(all_labels), (
                f"gestprom cache misaligned for sample {smp_idx}: "
                f"{len(db_prom_raw)} prominence entries vs "
                f"{len(all_labels)} gesture labels")
            labels_f, prom_f = [], []
            for gi, g in enumerate(all_labels):
                if g["name"] == "beat":
                    continue
                labels_f.append(g)
                prom_f.append(db_prom_raw[gi])
            types = [g["name"] for g in labels_f]
            words = [g["word"] for g in labels_f]
            if not types:
                continue
            smp_prom = {}
            for k, c2v in enumerate(prom_f):
                smp_prom[k] = None if c2v is None else (types[k], c2v[0], c2v[1])

            if q_type not in types:
                continue
            scores[smp_idx] += 2.0
            rel_idx = [k for k, t in enumerate(types) if t == q_type]
            rel_words = [words[k] for k in rel_idx]
            if smp_spk == speaker_id:
                scores[smp_idx] += 1.0
            if q_word in rel_words:
                scores[smp_idx] += 5.0
                top_rel = rel_idx[rel_words.index(q_word)]
            else:
                sims = [word_similarity(w, q_word) for w in rel_words]
                k = int(np.argmax(sims))
                top_rel = rel_idx[k]
                scores[smp_idx] += 3.0 / (1.0 + 2.0 * sims[k])

            acc, cnt = 0.0, 0
            diffs = {}
            for k in rel_idx:
                if smp_prom[k] is None or q_prom[q_idx] is None:
                    continue
                smp_type, _, smp_p = smp_prom[k]
                if smp_type != q_prom[q_idx][0]:
                    continue
                diff = abs(smp_p - q_prom[q_idx][-1])
                diffs[k] = diff
                acc += 4.0 / (1.0 + 2.0 * diff)
                cnt += 1
            if cnt > 0:
                scores[smp_idx] += acc / cnt
                best = min(diffs, key=diffs.get)
                if top_rel != best:
                    top_rel = best

            relevant_bounds[smp_idx] = labels_f[top_rel]

        ranked = rank_tiers(scores, encoded_text, text_feat_cache, TOP_N)
        sample_indexes[q_idx] = ranked[:TOP_N]
        d_bounds[q_idx] = {}
        for retr_idx in ranked[:TOP_N]:
            g = relevant_bounds[retr_idx]
            d_bounds[q_idx][retr_idx] = (
                g["word"], g["name"],
                round(float(g["start"]), 3), round(float(g["end"]), 3),
            )

    assert len(d_bounds) == len(sample_indexes) == len(query_bounds)
    return sample_indexes, d_bounds, query_bounds
