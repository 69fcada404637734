"""Whisper-transcript discourse annotation parsing.

The port's own copy of ``raggesture_tpu/datasets/disco.py``, after the
reference's mogen/datasets/utils/disco_utils.py: PDTB-style
relation JSONs carry sentences of word tokens (surface + start/end seconds)
and relations (Connective / Arg1 / Arg2 token lists + Sense).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np


def parse_discourse_tokens(ann_json_path: str) -> Dict[str, np.ndarray]:
    """Token surfaces + timings from a relations JSON (disco_utils.py:4-30)."""
    with open(ann_json_path) as f:
        ann = json.load(f)
    tokens = [t for sent in ann["sentences"] for t in sent["tokens"]]
    text, start, end = [], [], []
    for t in tokens:
        text.append(t["surface"].replace(" ", ""))
        start.append(t["startSec"])
        end.append(t["endSec"])
    return {
        "text": np.asarray(text),
        "start": np.asarray(start, np.float64),
        "end": np.asarray(end, np.float64),
        "duration": np.asarray(end, np.float64) - np.asarray(start, np.float64),
    }


def parse_discourse_relations(ann: dict, start: float, end: float) -> List[dict]:
    """Relations whose connective lies inside [start, end] seconds, with
    relation/connective/arg spans clamped to the window
    (disco_utils.py:32-129)."""
    tokens = [dict(t) for sent in ann["sentences"] for t in sent["tokens"]]
    for t in tokens:
        t["surface"] = t["surface"].replace(" ", "")

    out = []
    for rel in ann["relations"]:
        conn_toks = rel["Connective"]["TokenList"]
        all_toks = conn_toks + rel["Arg1"]["TokenList"] + rel["Arg2"]["TokenList"]
        conn_start = tokens[min(conn_toks)]["startSec"]
        conn_end = tokens[max(conn_toks)]["endSec"]
        if not (conn_start >= start and conn_end <= end):
            continue
        conn = {
            "connective": rel["Connective"]["RawText"],
            "sense": rel["Sense"][0],
            "start": max(tokens[min(all_toks)]["startSec"], start),
            "end": min(tokens[max(all_toks)]["endSec"], end),
            "conn_start": max(conn_start, start),
            "conn_end": min(conn_end, end),
        }
        for arg_name in ("Arg1", "Arg2"):
            tl = rel[arg_name]["TokenList"]
            arg = {}
            if not tl:
                if arg_name == "Arg1":
                    arg = {"start": conn["start"], "end": conn["start"], "text": ""}
                else:
                    anchor = max(conn["end"], conn["Arg1"]["end"]) if isinstance(
                        conn.get("Arg1"), dict) else conn["end"]
                    arg = {"start": anchor, "end": anchor, "text": ""}
            else:
                arg["start"] = max(tokens[tl[0]]["startSec"], start)
                arg["end"] = min(tokens[tl[-1]]["endSec"], end)
                words = [
                    tokens[i]["surface"] for i in tl
                    if tokens[i]["startSec"] >= arg["start"]
                    and tokens[i]["endSec"] <= arg["end"]
                ]
                arg["text"] = " ".join(words)
            conn[arg_name] = arg
        out.append(conn)
    return out


def window_relations(ann: dict, start_sec: float, end_sec: float
                     ) -> List[Tuple]:
    """Relations inside a window as the dataset's 8-tuples, times rebased to
    the window start (beatx_dataset.py:1070-1096):
    (conn_text, sense, arg1_text, arg2_text, rel_start, rel_end,
     conn_start, conn_end)."""
    rels = parse_discourse_relations(ann, start_sec, end_sec)
    out = []
    for c in rels:
        if c["start"] >= start_sec and c["end"] <= end_sec:
            out.append((
                c["connective"], c["sense"], c["Arg1"]["text"], c["Arg2"]["text"],
                c["start"] - start_sec, c["end"] - start_sec,
                c["conn_start"] - start_sec, c["conn_end"] - start_sec,
            ))
    return out


def merge_textsegs(textsegs: List) -> List:
    """Merge word segments sharing identical timings (subword pieces) into
    one word (beatx_dataset.py:1098-1113)."""
    merged = []
    for i, seg in enumerate(textsegs):
        seg = [list(seg[0]), seg[1]]
        if i > 0 and seg[0] == merged[-1][0]:
            merged[-1][1] += seg[1]
        else:
            merged.append(seg)
    return merged


def window_tokens(tokens: Dict[str, np.ndarray], start_sec: float,
                  end_sec: float) -> Tuple[str, List]:
    """Transcript text + per-word [start, end] segments (window-relative)
    for a window (beatx_dataset.py:1024-1068)."""
    segs = [
        [[float(s) - start_sec, float(e) - start_sec], str(w)]
        for w, s, e in zip(tokens["text"], tokens["start"], tokens["end"])
        if s >= start_sec and e <= end_sec
    ]
    merged = merge_textsegs(segs)
    text = " ".join(seg[1] for seg in merged)
    return text, segs
