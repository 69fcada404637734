"""Retrieval, the port against the JAX package on the CPU: the corpus, the
three scorers through ``RetrievalDatabase.__call__`` with the batched
exemplar encode, the memo and its corpus fingerprint, the host payloads'
dtypes, and the scoring functions.  The samples are made as
``tests/test_retrieval.py`` makes them; both frameworks hold the port's
random weights (``test_torch_common.port_model_and_jax_tree``) on a small
codec at the 150-frame window.

Tolerances: the re_dict's host fields (names, bounds, splice rows, masks,
the raw motion and the exemplars' condition rows) are equal; the
exemplars' latents come from each framework's float32 codec encode and
agree within 1e-5 (observed ≤ 1.1e-6 on inv_latents and
raw_motion_latents, 0 on inv_mask).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_retrieval import ToyDataset, feat, make_sample
from test_torch_common import port_model_and_jax_tree

TOL = 1e-5
LATENT = 16
HOST_FIELDS = ("re_mask", "raw_motion", "raw_trans", "raw_facial",
               "raw_sample_names", "raw_type2words", "raw_latent_mask",
               "retr_startends", "query_startends", "splice", "inv_names",
               "num_queries")


def _host_batch():
    """Two queries: gesture labels, a discourse relation, word timings and
    prominence, for the three methods."""
    return {
        "text": ["this big house is here", "that one is big"],
        "text_features": [feat(seed=7), feat(n_tokens=3, seed=8)],
        "discourse": [
            [("because", "Contingency.Cause", "a", "b", 1.0, 3.0, 1.5, 2.0)],
            [("because", "Contingency.Cause", "c", "d", 5.0, 7.5, 6.0, 6.4)]],
        "gesture_labels": [
            [{"name": "iconic", "word": "house", "start": 4.0, "end": 4.5},
             {"name": "beat", "word": "is", "start": 5.0, "end": 5.2}],
            [{"name": "iconic", "word": "big", "start": 7.0, "end": 8.5}]],
        "text_times": [
            [((0.2, 0.6), "this"), ((1.0, 1.4), "big"), ((4.0, 4.5), "house")],
            [((0.5, 0.9), "that"), ((2.0, 2.3), "one"), ((7.0, 8.5), "big")]],
        "prominence": [[("house", 4.0, 4.5, 0.7), ("because", 1.5, 2.0, 0.9),
                        ("this", 0.2, 0.6, 1.3)],
                       [("because", 6.0, 6.4, 0.2), ("big", 7.0, 8.5, 1.1)]],
        "speaker_ids": [2, 3],
    }


@pytest.fixture(scope="module")
def setup():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.retrieval.database import (
        RetrievalConfig as JaxRetrievalConfig,
    )
    from raggesture_tpu_torch.retrieval.database import RetrievalConfig
    from raggesture_tpu_torch.tools.visualize import make_encode_fn

    jcfg = tiny_arch_config(frames=150, latent=LATENT)
    model, tree = port_model_and_jax_tree(jcfg, seed=3)
    jmodel = JA.MotionDiffusionModel(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_encode = jax.jit(lambda b: jmodel.apply(
        params, b, rng=None, sample=False, method=jmodel.encode_motion))
    samples = [make_sample(f"f{i}/{j}", seed=i * 31 + j, spk=2 + (i % 2))
               for i in range(3) for j in (0, 15, 20)]
    kw = dict(latent_dim=LATENT, max_seq_len=150, text_latent_dim=24,
              stratification_interval=15)
    return dict(ds=ToyDataset(samples), cfg=RetrievalConfig(**kw),
                jcfg=JaxRetrievalConfig(**kw), encode=make_encode_fn(model),
                jax_encode=jax_encode)


def _corpora(s):
    from raggesture_tpu.retrieval.database import RetrievalCorpus as JaxCorpus
    from raggesture_tpu_torch.retrieval.database import RetrievalCorpus

    return (RetrievalCorpus.build(s["ds"], s["cfg"]),
            JaxCorpus.build(s["ds"], s["jcfg"]))


def _databases(s, corpus, jcorpus, **kw):
    from raggesture_tpu.retrieval.database import (
        RetrievalDatabase as JaxDatabase,
    )
    from raggesture_tpu_torch.retrieval.database import RetrievalDatabase

    return (RetrievalDatabase(corpus, s["cfg"], s["ds"], **kw),
            JaxDatabase(jcorpus, s["jcfg"], s["ds"], **kw))


def _assert_corpora_equal(a, b):
    assert sorted(a.idx_2_text) == sorted(b.idx_2_text)
    for n, (f, spk) in a.idx_2_text.items():
        np.testing.assert_array_equal(f, b.idx_2_text[n][0])
        assert spk == b.idx_2_text[n][1]
    for k in ("idx_2_sense", "idx_2_discbounds", "idx_2_gesture_labels",
              "idx_2_prominence", "idx_2_gestprom"):
        assert getattr(a, k) == getattr(b, k), k


def test_corpus_build_equals_the_jax_packages_and_each_loads_the_other(
        setup, tmp_path):
    from raggesture_tpu.retrieval.database import RetrievalCorpus as JaxCorpus
    from raggesture_tpu_torch.retrieval.database import RetrievalCorpus

    corpus, jcorpus = _corpora(setup)
    assert len(corpus.idx_2_text) == 6          # windows 0 and 15 of 3 clips
    _assert_corpora_equal(corpus, jcorpus)
    corpus.save(str(tmp_path / "port"))
    jcorpus.save(str(tmp_path / "jax"))
    _assert_corpora_equal(RetrievalCorpus.load(str(tmp_path / "jax")),
                          JaxCorpus.load(str(tmp_path / "port")))
    _assert_corpora_equal(RetrievalCorpus.load(str(tmp_path / "port")),
                          jcorpus)


def _assert_re_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in HOST_FIELDS:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    for k in ("word", "audio", "speaker_ids"):
        np.testing.assert_array_equal(got["inv_conds"][k],
                                      np.asarray(want["inv_conds"][k]), k)
    for k in ("inv_latents", "inv_mask", "raw_motion_latents"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("method", ["discourse", "gesture_type", "llm"])
def test_database_call_matches_the_jax_packages(setup, method):
    """Each scorer's retrieval, window placement and batched encode: the
    cold call, then the memoized one."""
    from raggesture_tpu_torch.retrieval.llm import heuristic_labeler

    db, jdb = _databases(setup, *_corpora(setup), llm_fn=heuristic_labeler)
    names = ["q/0", "q/1"]
    for _ in range(2):                      # cold, then from the memo
        got = db(_host_batch(), names, setup["encode"], method=method)
        want = jdb(_host_batch(), names, setup["jax_encode"], method=method)
        assert got["num_queries"] > 0
        _assert_re_dicts_equal(got, want)
    assert db.test_indexes == jdb.test_indexes
    assert db.test_dbounds == jdb.test_dbounds
    assert db.test_qbounds == jdb.test_qbounds


def test_each_package_reads_the_others_memo(setup, tmp_path):
    """A memo saved by one package, loaded by the other: the same re_dict
    as the saving package's, with the scorers never run."""
    from raggesture_tpu_torch.retrieval import database as D

    corpus, jcorpus = _corpora(setup)
    db, jdb = _databases(setup, corpus, jcorpus)
    names = ["q/0", "q/1"]
    want = jdb(_host_batch(), names, setup["jax_encode"])
    db(_host_batch(), names, setup["encode"])
    jdb.save_memo(str(tmp_path / "jax"))
    db.save_memo(str(tmp_path / "port"))
    db2, jdb2 = _databases(setup, corpus, jcorpus)
    db2.load_memo(str(tmp_path / "jax"))
    jdb2.load_memo(str(tmp_path / "port"))
    assert db2.test_indexes == jdb.test_indexes
    assert jdb2.test_indexes == db.test_indexes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(D, "gesture_type_retrieval", None)   # a cold call fails
        _assert_re_dicts_equal(db2(_host_batch(), names, setup["encode"]),
                               want)


def test_memo_of_another_corpus_is_ignored_with_a_warning(setup, tmp_path):
    from raggesture_tpu_torch.retrieval.database import (
        RetrievalCorpus,
        RetrievalDatabase,
    )

    corpus, jcorpus = _corpora(setup)
    _, jdb = _databases(setup, corpus, jcorpus)
    jdb(_host_batch(), ["q/0", "q/1"], setup["jax_encode"])
    jdb.save_memo(str(tmp_path))
    other = RetrievalCorpus()
    other.idx_2_text = dict(list(corpus.idx_2_text.items())[:3])
    db = RetrievalDatabase(other, setup["cfg"], setup["ds"])
    with pytest.warns(UserWarning, match="different corpus"):
        db.load_memo(str(tmp_path))
    assert db.test_indexes == {}


def test_payloads_are_host_arrays_of_the_jax_packages_dtypes(setup):
    """The exemplars' latents and condition rows are float32 (speaker ids
    int32) numpy arrays, as the JAX package keeps them off the TPU; the
    generator moves them onto its device."""
    db, jdb = _databases(setup, *_corpora(setup))
    names = ["q/0", "q/1"]
    got = db(_host_batch(), names, setup["encode"])
    want = jdb(_host_batch(), names, setup["jax_encode"])
    assert got["num_queries"] > 0
    pairs = [(got[k], want[k]) for k in ("inv_latents", "inv_mask")]
    pairs += [(got["inv_conds"][k], want["inv_conds"][k])
              for k in ("word", "audio", "speaker_ids")]
    for a, b in pairs:
        assert isinstance(a, np.ndarray)
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
    assert got["inv_mask"].dtype == np.float32
    assert got["inv_conds"]["speaker_ids"].dtype == np.int32


def _scoring_cases():
    rng = np.random.RandomState(0)
    q = rng.randn(5, 8).astype(np.float32)
    cands = [rng.randn(n, 8).astype(np.float32) for n in (3, 5, 9, 0)]
    cache = {f"c{i}": (c, 2) for i, c in enumerate(cands)}
    scores = {"c0": 2.0, "c1": 2.0, "c2": 1.0, "c3": 0.0}
    conns = ["because", "so that", "on the other hand,"]
    prom = [("because", 1.5, 2.0, 0.9), ("so", 4.0, 4.2, 0.4),
            ("that", 4.2, 4.6, 1.2), ("house", 6.0, 6.5, 0.7),
            ("on", 7.0, 7.1, 0.3), ("the", 7.1, 7.2, 0.1),
            ("other", 7.2, 7.4, 0.5), ("hand", 7.5, 7.8, 0.8)]
    return [
        ("partial_ratio", ("house", "mouse")),
        ("partial_ratio", ("abc", "xxabcxx")),
        ("word_similarity", ("because", "becuase")),
        ("map_conns_to_prominence", (conns, prom)),
        ("text_similarity_scores", (q, cands)),
        ("sort_by_text_similarity", (["c0", "c1", "c2"], q, cache)),
        ("rank_tiers", (scores, q, cache, 2)),
    ]


@pytest.mark.parametrize("case", range(len(_scoring_cases())))
def test_scoring_matches_the_jax_packages(case):
    from raggesture_tpu.retrieval import scoring as jax_scoring
    from raggesture_tpu_torch.retrieval import scoring

    name, args = _scoring_cases()[case]
    got = getattr(scoring, name)(*args)
    want = getattr(jax_scoring, name)(*args)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_retrieve_refuses_an_unknown_method(setup):
    db, _ = _databases(setup, *_corpora(setup))
    with pytest.raises(ValueError, match="unknown retrieval method"):
        db(_host_batch(), ["q/0", "q/1"], setup["encode"], method="other")
    with pytest.raises(NotImplementedError):
        db(_host_batch(), ["q/0", "q/1"], setup["encode"], method="prosody")
