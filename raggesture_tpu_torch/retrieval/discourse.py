"""Discourse-relation exemplar retrieval (host-side, deterministic).

The port's own copy of ``raggesture_tpu/retrieval/discourse.py``, after the
reference's mogen/models/transformers/rag/discourse_retrieval.py:8-316.  For each query discourse connective, corpus
samples are scored:

    +2  the query's PDTB sense appears in the sample
    +4  exact connective text match (among same-sense entries)
    +3  same speaker
    +   mean over same-sense entries of 4 / (1 + 2*|Δprominence|)

Ties are re-ranked by mean diagonal BERT-token cosine; the top-10 per query
connective are returned along with the bounds (connective, sense, start s,
end s) of each retrieved sample's best-matching relation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .scoring import _alnum_space, map_conns_to_prominence, rank_tiers

TOP_N = 10


def discourse_retrieval(
    text: str,
    discourse: Sequence[Tuple],
    prominence: Sequence[Tuple],
    speaker_id: int,
    db_idx_2_sense: Dict,
    db_idx_2_discbounds: Dict,
    db_idx_2_prominence: Dict,
    encoded_text,
    text_feat_cache: Dict,
):
    """Returns (sample_indexes, d_bounds, query_bounds), each keyed by the
    query discourse index.

    discourse rows are the dataset's 8-tuples
    (conn_text, sense, arg1, arg2, disc_start, disc_end, conn_start, conn_end)
    — see the reference's mogen/datasets/utils/disco_utils.py:32."""
    sample_indexes: Dict[int, List] = {}
    d_bounds: Dict[int, Dict] = {}
    query_bounds: Dict[int, Tuple] = {}
    if len(discourse) == 0:
        return sample_indexes, d_bounds, query_bounds

    disco_senses = [d[1] for d in discourse]
    disco_conns = [d[0] for d in discourse]
    query_bounds = {
        i: (d[0].lower(), d[1], d[6], d[7]) for i, d in enumerate(discourse)
    }

    # (sense, prominence) per query connective
    disco_prom = map_conns_to_prominence(disco_conns, prominence)
    for i, c2v in disco_prom.items():
        if c2v is None:
            continue
        conn_text, prom_val = c2v
        assert conn_text == _alnum_space(disco_conns[i])
        disco_prom[i] = (disco_senses[i], prom_val)

    for disco_idx, (q_sense, q_text) in enumerate(zip(disco_senses, disco_conns)):
        scores: Dict = {}
        relevant_bounds: Dict = {}

        for smp_idx, smp_entry in db_idx_2_sense.items():
            scores[smp_idx] = 0.0
            smp_spk = smp_entry[0]
            smp_disco = smp_entry[1:]  # list of (sense, text)
            if len(smp_disco) == 0:
                continue

            smp_senses = [d[0] for d in smp_disco]
            smp_conns = [d[1] for d in smp_disco]
            db_prom_raw = db_idx_2_prominence[smp_idx]
            assert len(db_prom_raw) == len(smp_senses)
            smp_prom = {}
            for si, c2v in db_prom_raw.items():
                si = int(si)
                if c2v is None:
                    smp_prom[si] = None
                    continue
                conn_text, prom_val = c2v
                assert conn_text == _alnum_space(smp_conns[si])
                smp_prom[si] = (smp_senses[si], prom_val)

            if q_sense not in smp_senses:
                continue
            scores[smp_idx] += 2.0

            rel_idx = [k for k, s in enumerate(smp_senses) if s == q_sense]
            top_rel = rel_idx[0]
            top_rel_chosen = False
            rel_conns = [smp_conns[k] for k in rel_idx]
            if q_text in rel_conns:
                scores[smp_idx] += 4.0
                top_rel = rel_idx[rel_conns.index(q_text)]
                top_rel_chosen = True
            if smp_spk == speaker_id:
                scores[smp_idx] += 3.0

            # prominence-closeness bonus over same-sense entries
            acc, cnt = 0.0, 0
            senidx_2_diff = {}
            for k in rel_idx:
                if smp_prom[k] is None or disco_prom[disco_idx] is None:
                    continue
                smp_sen, smp_p = smp_prom[k]
                assert smp_sen == disco_prom[disco_idx][0]
                diff = abs(smp_p - disco_prom[disco_idx][1])
                senidx_2_diff[k] = diff
                acc += 4.0 / (1.0 + 2.0 * diff)
                cnt += 1
            if cnt > 0:
                scores[smp_idx] += acc / cnt
                best = min(senidx_2_diff, key=senidx_2_diff.get)
                if top_rel != best and not top_rel_chosen:
                    top_rel = best

            relevant_bounds[smp_idx] = db_idx_2_discbounds[smp_idx][top_rel]

        ranked = rank_tiers(scores, encoded_text, text_feat_cache, TOP_N)
        sample_indexes[disco_idx] = ranked[:TOP_N]
        d_bounds[disco_idx] = {}
        for retr_idx in ranked[:TOP_N]:
            b = relevant_bounds[retr_idx]
            # db bounds row: (sense, text, disc_start, disc_end, conn_start, conn_end)
            d_bounds[disco_idx][retr_idx] = (
                b[1], b[0], round(float(b[4]), 3), round(float(b[5]), 3)
            )
        assert len(d_bounds[disco_idx]) == len(sample_indexes[disco_idx])

    assert len(d_bounds) == len(sample_indexes) == len(query_bounds)
    return sample_indexes, d_bounds, query_bounds
