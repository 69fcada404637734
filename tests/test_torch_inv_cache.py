"""The generator's per-exemplar inversion cache and its ``params`` setter,
against the JAX package's ``StagedGenerator`` on the same weights.

* Call by call, both generators are fed the same sequence of exemplar
  names (capacity 3, so that calls evict, overflow and hit the assembled
  stack's memo): the names each call finds cached, the sizes of its
  bucketed inversions, the cache's LRU order and the evicted set are equal,
  and are also asserted as written out here; the assembled stacks agree.
* A cached retrieval-guided clip against the JAX generator's cached clip
  (JAX's draws fed to the port), and against the port's uncached clip.
* ``save_inv_cache``/``load_inv_cache``: a round trip, a fingerprint that
  differs (other weights, another path), a missing file, the capacity.
* The ``params`` setter: caches emptied, and the next clip equals a fresh
  generator's on the new weights and the JAX generator's after its setter.

Three DDIM steps; true-separator query masks (patched into the JAX
package while it traces).  Tolerance 1e-4, absolute and relative, on
valid tokens and decoded parts, as tests/test_torch_guided.py: the JAX
generator runs ``fused=False``, the port its default cached path in
float32 on the CPU.  The port's cached and uncached clips differ only in
the rows the inversion runs on (the misses bucketed on their own, the
first miss repeated, against every exemplar padded with zeros): 1e-4 too.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    parity_query_masks_np,
    port_model_and_jax_tree,
    t32,
)

SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)
TOL = 1e-4
NAMES = "abcdefghij"
CAPACITY = 3
# (names of the call, then what both generators must do: the names found
# cached, the inversions' bucket sizes, the cache afterwards (oldest
# first), the names evicted)
CALLS = [
    ("ab", "", [2], "ab", ""),
    ("ac", "a", [1], "bac", ""),
    ("def", "", [4], "def", "bac"),
    ("ad", "d", [1], "fda", "e"),
    ("fghij", "f", [4], "fghij", "da"),        # Q > capacity: overflow
    ("ab", "", [2], "jab", "fghi"),            # its stack fell out of the memo
    ("ab", "ab", [], "jab", ""),               # the memo's hit: nothing runs
]
BATCH_KEYS = ("word", "audio", "speaker_ids", "motion_mask")


def _parity_masks(mp, JA):
    mp.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in parity_query_masks_np(cfg, b).items()})


def _bucket(q):
    return 1 << max(q - 1, 0).bit_length()


@pytest.fixture(scope="module")
def case():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.models.denoiser import latent_motion_mask

    jcfg = dataclasses.replace(
        tiny_arch_config(), diffusion_train=JA.DiffusionSpec(
            diffusion_steps=1000))
    dc = jcfg.denoiser
    model, params = port_model_and_jax_tree(jcfg, seed=3)
    model_b, params_b = port_model_and_jax_tree(jcfg, seed=7)
    T, D = dc.num_tokens, dc.latent_dim
    rng = np.random.RandomState(2)
    ex = tiny_batch(seed=9, batch=len(NAMES))
    corpus = {n: dict(latent=rng.randn(T, D).astype(np.float32),
                      **{k: np.array(ex[k][i])
                         for k in ("word", "audio", "speaker_ids")})
              for i, n in enumerate(NAMES)}
    inv_mask = np.array(latent_motion_mask(dc, jnp.ones((1, dc.max_seq_len))))
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()
             if k in BATCH_KEYS}
    valid = np.asarray(latent_motion_mask(dc, batch["motion_mask"])) > 0
    return dict(jcfg=jcfg, model=model, params=params, model_b=model_b,
                params_b=params_b, corpus=corpus, inv_mask=inv_mask[0],
                batch=batch, valid=valid)


def _re_dict(case, names):
    c = case["corpus"]
    Q = len(names)
    return {"inv_latents": np.stack([c[n]["latent"] for n in names]),
            "inv_mask": np.repeat(case["inv_mask"][None], Q, axis=0),
            "inv_conds": {k: np.stack([c[n][k] for n in names])
                          for k in ("word", "audio", "speaker_ids")},
            "splice": np.asarray([[0, 0, 0, 2], [1, 1, 0, 1], [1, 0, 1, 1]]
                                 [:Q], np.int32),
            "inv_names": list(names), "num_queries": Q}


def _jax_generator(case, params):
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA

    return JA.StagedGenerator(
        JA.MotionDiffusionModel(case["jcfg"]),
        jax.tree_util.tree_map(jnp.asarray, params), jax_make(*SCHEDULE),
        fused=False)


def _port_generator(model):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    return StagedGenerator(model, make_schedule(*SCHEDULE))


def _query_masks(case):
    return {k: t32(v[0]) for k, v in parity_query_masks_np(
        case["jcfg"].denoiser, 1).items()}


def _port_spy(gen, sizes):
    real = gen._invert_section

    def spy(*args, **inputs):
        sizes.append((args[0] if args else inputs["inv_latents"]).shape[0])
        return real(*args, **inputs)

    gen._invert_section = spy


def _jax_spy(jgen, sizes):
    real = jgen._invert

    def spy(p, inv_lat, *a):
        sizes.append(inv_lat.shape[0])
        return real(p, inv_lat, *a)

    jgen._invert = spy


def _assert_close(got, want, valid, err_msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got[..., valid, :], want[..., valid, :],
                               atol=TOL, rtol=TOL, err_msg=err_msg)


def test_cache_call_by_call_against_jax(case):
    from raggesture_tpu.models import architecture as JA

    gen = _port_generator(case["model"])
    jgen = _jax_generator(case, case["params"])
    gen.inv_cache_capacity = jgen.inv_cache_capacity = CAPACITY
    port_sizes, jax_sizes = [], []
    _port_spy(gen, port_sizes)
    _jax_spy(jgen, jax_sizes)
    qm = _query_masks(case)
    valid = case["inv_mask"] > 0
    with pytest.MonkeyPatch.context() as mp:
        _parity_masks(mp, JA)
        for names, hits, buckets, after, evicted in CALLS:
            names = list(names)
            rd = _re_dict(case, names)
            Qb = _bucket(len(names))
            seen = []
            for g, sizes in ((gen, port_sizes), (jgen, jax_sizes)):
                before = list(g._inv_cache)
                sizes.clear()
                if g is gen:
                    stack = g._cached_inv_stack(rd, names, Qb, qm)
                else:
                    stack = g._cached_inv_stack(
                        g.params, jnp.asarray(rd["inv_latents"]),
                        jnp.asarray(rd["inv_mask"]),
                        {k: jnp.asarray(v) for k, v in rd["inv_conds"].items()},
                        names, Qb)
                now = list(g._inv_cache)
                seen.append(dict(
                    hits="".join(n for n in names if n in before),
                    buckets=list(sizes), after="".join(now),
                    evicted="".join(sorted(set(before) - set(now))),
                    stack=np.asarray(stack)))
            port, ref = seen
            want = dict(hits=hits, buckets=buckets, after=after,
                        evicted="".join(sorted(evicted)))
            for k in want:
                assert port[k] == ref[k] == want[k], (names, k)
            assert port["stack"].shape == (SCHEDULE[3], Qb) + rd[
                "inv_latents"].shape[1:]
            _assert_close(port["stack"], ref["stack"], valid, str(names))


def _jax_draws(key, B, T, D, S):
    r_noise, r_coef, r_loop = jax.random.split(key, 3)
    _, r_bulk = jax.random.split(r_loop)
    return dict(noise=t32(jax.random.normal(r_noise, (B, T, D))),
                coins=torch.from_numpy(np.array(
                    jax.random.bernoulli(r_coef, 0.5, (S,)))),
                bulk=t32(jax.random.normal(r_bulk, (S, B, T, D))))


def _guided_clips(case, gen, jgen, names, key):
    """The port's and (unless ``jgen`` is None) the JAX generator's guided
    clip, same draws."""
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu_torch.models.architecture import InferenceOptions
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    rd = _re_dict(case, names)
    dc = case["jcfg"].denoiser
    d = _jax_draws(key, 2, dc.num_tokens, dc.latent_dim, SCHEDULE[3])
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            case["jcfg"].diffusion_train.diffusion_steps,
                            coins=d["coins"])
    opts = dict(use_inversion=True, insertion_guidance=True)
    got = gen(case["batch"], opts=InferenceOptions(**opts), re_dict=rd,
              noise=d["noise"], coef_table=coef, in_seq_noise=d["bulk"],
              query_masks=_query_masks(case))
    if jgen is None:
        return got, None
    with pytest.MonkeyPatch.context() as mp:
        _parity_masks(mp, JA)
        want = jgen(case["batch"], key, opts=JA.InferenceOptions(**opts),
                    re_dict=rd)
    return got, {k: np.asarray(v) for k, v in want.items()}


def _assert_clip(got, want, valid):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = want[k]
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def cached(case):
    """A port and a JAX generator after one cached guided clip of three
    exemplars, and the clips; the port's on a model of its own (the
    setter's test loads other weights into it)."""
    gen = _port_generator(port_model_and_jax_tree(case["jcfg"], seed=3)[0])
    jgen = _jax_generator(case, case["params"])
    key = jax.random.PRNGKey(3)
    got, want = _guided_clips(case, gen, jgen, "abc", key)
    return dict(gen=gen, jgen=jgen, got=got, want=want, key=key)


def test_cached_guided_clip_matches_jax_and_the_uncached_clip(case, cached):
    gen = cached["gen"]
    assert list(gen._inv_cache) == list("abc")
    assert list(cached["jgen"]._inv_cache) == list("abc")
    _assert_clip(cached["got"], cached["want"], case["valid"])
    # the same clip through the uncached pipeline (no names)
    rd = _re_dict(case, "abc")
    del rd["inv_names"], rd["num_queries"]
    from raggesture_tpu_torch.models.architecture import InferenceOptions
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    dc = case["jcfg"].denoiser
    d = _jax_draws(cached["key"], 2, dc.num_tokens, dc.latent_dim,
                   SCHEDULE[3])
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            case["jcfg"].diffusion_train.diffusion_steps,
                            coins=d["coins"])
    fresh = _port_generator(case["model"])
    sizes = []
    _port_spy(fresh, sizes)
    uncached = fresh(case["batch"], opts=InferenceOptions(
        use_inversion=True, insertion_guidance=True), re_dict=rd,
        noise=d["noise"], coef_table=coef, in_seq_noise=d["bulk"],
        query_masks=_query_masks(case))
    # the uncached route: every exemplar inverted in the pipeline, padded
    assert sizes == [4] and not fresh._inv_cache
    _assert_clip(cached["got"], {k: v.numpy() for k, v in uncached.items()},
                 case["valid"])


def test_save_and_load_round_trip(case, cached, tmp_path):
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    gen = cached["gen"]
    path = str(tmp_path / "inv" / "cache.npz")
    empty = _port_generator(case["model"])
    assert empty.save_inv_cache(path) == 0 and not os.path.exists(path)
    assert gen.save_inv_cache(path) == 3
    assert not os.path.exists(path + ".tmp")

    again = _port_generator(case["model"])
    assert again.load_inv_cache(path) == 3
    assert list(again._inv_cache) == list("abc")
    for n in "abc":
        assert torch.equal(again._inv_cache[n], gen._inv_cache[n])
    again._invert_section = None           # a full hit never inverts
    key = cached["key"]
    got, _ = _guided_clips(case, again, None, "abc", key)
    for k, v in cached["got"].items():
        assert torch.equal(got[k], v), k

    small = _port_generator(case["model"])
    small.inv_cache_capacity = 2
    assert small.load_inv_cache(path) == 2
    assert list(small._inv_cache) == list("bc")
    assert again.load_inv_cache(str(tmp_path / "none.npz")) == 0
    other_weights = _port_generator(case["model_b"])
    other_path = StagedGenerator(case["model"], gen.sched, fused=False)
    for g in (other_weights, other_path):
        assert g.inv_cache_fingerprint() != gen.inv_cache_fingerprint()
        assert g.load_inv_cache(path) == 0 and not g._inv_cache
    assert (_port_generator(case["model"]).inv_cache_fingerprint()
            == gen.inv_cache_fingerprint())


def test_params_setter_against_a_fresh_generator_and_jax(case, cached):
    gen, jgen = cached["gen"], cached["jgen"]
    old_packs, old_fp = gen.packs, gen.inv_cache_fingerprint()
    gen.params = case["model_b"].state_dict()
    assert not gen._inv_cache and not gen._inv_stack_cache
    assert gen.packs is not old_packs
    assert gen.inv_cache_fingerprint() != old_fp
    for k, v in gen.params.items():
        assert torch.equal(v, case["model_b"].state_dict()[k]), k
    jgen.params = jax.tree_util.tree_map(jnp.asarray, case["params_b"])
    key = jax.random.PRNGKey(5)
    got, want = _guided_clips(case, gen, jgen, "abc", key)
    _assert_clip(got, want, case["valid"])
    # a generator built on the new weights gives the same clip, bit for bit
    fresh_model = port_model_and_jax_tree(case["jcfg"], seed=7)[0]
    fresh = _port_generator(fresh_model)
    ref, _ = _guided_clips(case, fresh, None, "abc", key)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    # strict: a missing key raises before anything is loaded or dropped
    packs = gen.packs
    with pytest.raises(KeyError, match="codec"):
        gen.params = {k: v for k, v in case["model"].state_dict().items()
                      if not k.startswith("codec.")}
    assert gen.packs is packs and gen._inv_cache
