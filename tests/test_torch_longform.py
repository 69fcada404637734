"""Long-form synthesis: the port's tool (``raggesture_tpu_torch.tools.
longform_synthesis``) and the generator routes it takes, against the JAX
package on the CPU.

- the tool's host helpers against the JAX tool's (``tools/
  longform_synthesis.py``), exactly;
- ``StagedGenerator(fused=False).__call__`` on the JAX class's staged path,
  now two pipelines: inversion without guidance (with and without the
  long-form handoff) and guidance with the handoff, at Q = 1 and Q = 3
  exemplars (unbucketed on both sides), three DDIM steps, JAX's draws fed
  to the port, true-separator query masks: 1e-4 on valid tokens and on the
  decoded parts, the generator parity tests' tolerance;
- a 2-chunk take of two clips, stitched by the port's ``run_group_waves``
  and ``stitch``, against the same take through the JAX generator and the
  JAX package's ``motion_io`` (1e-4 on the stitched pose, expressions and
  translation);
- the full-clip test cache (``test_cache_mode="full"``) of each package
  read by the other;
- the port's tool end to end on a synthetic BEAT2 directory, with
  ``--clip-batch`` 1 and 2: the JAX tool's files, keys and lengths; and
  nothing of a take (model, generator, tensor) left alive once it returns.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dataset_build import make_raw_beat2
from test_torch_common import (
    jax_tree_from_port,
    parity_query_masks_np,
    port_arch_config,
    port_model_and_jax_tree,
    t32,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CFG = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")
SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)
TOL = 1e-4
FPS = 15


def _full_record(T=300, sr=16000):
    """A full-clip record in the cache's schema (as tests/
    test_longform_chunks.py makes one)."""
    rng = np.random.RandomState(0)
    return {
        "motion": rng.randn(T, 169).astype(np.float32),
        "trans": rng.randn(T, 3).astype(np.float32),
        "facial": rng.randn(T, 100).astype(np.float32),
        "contact": np.ones((T, 4), np.float32),
        "word": rng.randn(T, 768).astype(np.float32),
        "audio": rng.randn(2 * T, 768).astype(np.float32),
        "raw_audio": rng.randn(int(T / FPS * sr)).astype(np.float32) * 0.1,
        "speaker_id": np.asarray([3]),
        "raw_word": "hello world again and again",
        "text_feature": rng.randn(5, 768).astype(np.float32),
        "text_segments": [[[1.0, 2.0], "hello"], [[2.0, 3.0], "world"],
                          [[12.0, 13.0], "later"]],
        "prominence": [("hello", 1.0, 2.0, 0.5)],
        "discourse": [("because", "Reason", "a", "b", 1.0, 2.0, 2.1, 3.0)],
        "gesture_labels": [{"start": 1.0, "end": 2.0, "name": "beat",
                            "word": "hello"}],
        "sample_name": "clip/0",
    }


def _assert_same(a, b, path="out"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)
    else:
        assert a == b, path


def _helper_case(name):
    """(port result, JAX result) of one helper on the same inputs."""
    from raggesture_tpu.datasets.beatx import StubFeatureExtractor as JStub
    from raggesture_tpu_torch.datasets.beatx import StubFeatureExtractor
    from raggesture_tpu_torch.tools import longform_synthesis as P
    from tools import longform_synthesis as J

    if name == "chunk_starts":
        args = [(300, 150, 15), (450, 150, 15), (149, 150, 15), (1, 30, 15),
                (180, 30, 15), (136, 150, 15)]
        return ([P.chunk_starts(*a) for a in args],
                [J.chunk_starts(*a) for a in args])
    if name == "plan_waves":
        args = [([2, 5, 3, 1, 4], 2), ([3, 2], 1), ([4, 4, 1], 3),
                ([1], 4), ([2, 2, 2, 2, 3], 2)]
        return ([P.plan_waves(*a) for a in args],
                [J.plan_waves(*a) for a in args])
    if name == "run_group_waves":
        def trace(mod):
            log = []
            for group, waves in mod.plan_waves([3, 1, 2], 2):
                def run_wave(k, chunks, prev_rows, n_active):
                    log.append(("wave", k, list(chunks), prev_rows, n_active))
                    return ([f"{c}>{k}" for c in chunks], k)

                mod.run_group_waves(
                    group, waves, lambda ci, k: f"c{ci}k{k}", run_wave,
                    lambda ci, k, row, pay: log.append(("chunk", ci, k, row,
                                                        pay)))
            return log
        return trace(P), trace(J)
    rec = _full_record()
    if name == "slice_chunk":
        return ([P.slice_chunk(rec, s, s + 150, FPS) for s in (0, 135, 270)],
                [J.slice_chunk(rec, s, s + 150, FPS) for s in (0, 135, 270)])
    start = {"refeaturize_chunk": 0, "refeaturize_empty_text": 270}[name]
    got = P.refeaturize_chunk(P.slice_chunk(rec, start, start + 150, FPS),
                              StubFeatureExtractor())
    want = J.refeaturize_chunk(J.slice_chunk(rec, start, start + 150, FPS),
                               JStub())
    if start:
        assert got["raw_word"] == ""        # no segment inside the chunk
    return got, want


@pytest.mark.parametrize("name", [
    "chunk_starts", "plan_waves", "run_group_waves", "slice_chunk",
    "refeaturize_chunk", "refeaturize_empty_text"])
def test_tool_helpers_equal_the_jax_tools(name):
    got, want = _helper_case(name)
    _assert_same(got, want)


# ------------------------------------------------------ the staged routes

ROUTES = {
    "guided_prev": dict(use_inversion=True, insertion_guidance=True,
                        use_prev_latent=True),
    "invert": dict(use_inversion=True),
    "invert_prev": dict(use_inversion=True, use_prev_latent=True),
}


def _re_dict(dc, ex, Q, seed):
    from raggesture_tpu.models.denoiser import latent_motion_mask

    rng = np.random.RandomState(seed)
    T, D = dc.num_tokens, dc.latent_dim
    splice = np.asarray([[0, 0, 0, 2], [1, 1, 0, 1], [1, 0, 1, 1]][:Q],
                        np.int32)
    return {
        "inv_latents": rng.randn(Q, T, D).astype(np.float32),
        "inv_mask": np.array(latent_motion_mask(
            dc, jnp.ones((Q, dc.max_seq_len)))),
        "inv_conds": {k: np.array(ex[k])[:Q]
                      for k in ("word", "audio", "speaker_ids")},
        "splice": splice}


def _jax_draws(key, B, T, D, S):
    """JAX's draws of one call, split as its staged path and pipelines
    split the key."""
    r_noise, r_coef, r_loop = jax.random.split(key, 3)
    _, r_bulk = jax.random.split(r_loop)
    return dict(noise=np.array(jax.random.normal(r_noise, (B, T, D))),
                coins=np.array(jax.random.bernoulli(r_coef, 0.5, (S,))),
                bulk=np.array(jax.random.normal(r_bulk, (S, B, T, D))))


@pytest.fixture(scope="module")
def case():
    """Random port weights bridged into a JAX tree, the JAX generator
    (fused=False, the tool's) and its outputs on every route, with the
    true-separator query masks patched in while its programs trace."""
    from raggesture_tpu.datasets.fixtures import tiny_arch_config, tiny_batch
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu.models import architecture as JA

    jcfg = dataclasses.replace(
        tiny_arch_config(),
        diffusion_train=JA.DiffusionSpec(diffusion_steps=1000))
    model, params = port_model_and_jax_tree(jcfg, seed=2)
    dc = jcfg.denoiser
    jmodel = JA.MotionDiffusionModel(jcfg)
    batch = {k: np.array(v) for k, v in tiny_batch(seed=5, batch=2).items()}
    ex = tiny_batch(seed=9, batch=3)
    prev = np.random.RandomState(4).randn(
        2, dc.num_tokens, dc.latent_dim).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "default_query_masks", lambda cfg, b: {
            k: jnp.asarray(v)
            for k, v in parity_query_masks_np(cfg, b).items()})
        jgen = JA.StagedGenerator(
            jmodel, jax.tree_util.tree_map(jnp.asarray, params),
            jax_make(*SCHEDULE))
        assert not jgen.fused and not jgen.bf16_conditions
        for Q in (1, 3):
            for route, opts in ROUTES.items():
                out = jgen(batch, key, opts=JA.InferenceOptions(**opts),
                           re_dict=_re_dict(dc, ex, Q, Q),
                           prev_latent=jnp.asarray(prev))
                want[route, Q] = {k: np.asarray(v) for k, v in out.items()}
    valid = np.asarray(JA.latent_motion_mask(dc, batch["motion_mask"])) > 0
    return dict(jcfg=jcfg, model=model, params=params, jmodel=jmodel,
                jgen=jgen, batch=batch, ex=ex, prev=prev, key=key,
                want=want, valid=valid, JA=JA)


def _port_generator(case, **kw):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    return StagedGenerator(case["model"], make_schedule(*SCHEDULE),
                           fused=False, **kw)


def _port_call(gen, case, batch, key, opts, re_dict, prev):
    """The port's call on JAX's draws of ``key``."""
    from raggesture_tpu_torch.models.architecture import InferenceOptions
    from raggesture_tpu_torch.models.conditioning import scale_func_table

    dc = case["jcfg"].denoiser
    B = np.shape(batch["motion_mask"])[0]
    d = _jax_draws(key, B, dc.num_tokens, dc.latent_dim, SCHEDULE[3])
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            case["jcfg"].diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(d["coins"]))
    qm = {k: t32(v[0]) for k, v in parity_query_masks_np(dc, 1).items()}
    return gen(batch, opts=InferenceOptions(**opts), re_dict=re_dict,
               prev_latent=prev, noise=t32(d["noise"]), coef_table=coef,
               in_seq_noise=t32(d["bulk"]), query_masks=qm)


def _assert_matches(got, want, valid):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape, k
        if k in ("output_latents", "prev_latentout"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_staged_routes_match_the_jax_generator(case, route, Q):
    """Each of the staged path's routes, its exemplars unbucketed (JAX
    inverts the Q rows as they are), against the JAX generator; the route
    ran its pipeline, and the options reached it."""
    gen = _port_generator(case)
    ran = []
    name = "guided_inseq" if "guided" in route else "invert_sample"
    real_run = gen._run
    gen._run = lambda n, fn, inputs, static=(): (
        ran.append((n, inputs["inv_latents"].shape[0])),
        real_run(n, fn, inputs, static))[1]
    dc = case["jcfg"].denoiser
    got = _port_call(gen, case, case["batch"], case["key"], ROUTES[route],
                     _re_dict(dc, case["ex"], Q, Q), t32(case["prev"]))
    assert ran == [(name, Q)]
    _assert_matches(got, case["want"][route, Q], case["valid"])
    others = [r for r in ROUTES if r != route]
    assert all(not np.allclose(got["output_latents"].numpy(),
                               case["want"][r, Q]["output_latents"])
               for r in others)


def _stitch_jax(state, pose, exps, trans, overlap):
    """The JAX tool's stitch (its closure in ``main``) through the JAX
    package's motion_io."""
    from raggesture_tpu.utils.motion_io import (
        crossfade_linear,
        crossfade_pose_aa,
    )

    if state["pose"] is None:
        state["pose"], state["exps"], state["trans"] = pose, exps, trans
        return
    faded = crossfade_pose_aa(state["pose"][-overlap:], pose[:overlap])
    state["pose"] = np.concatenate(
        [state["pose"][:-overlap], faded, pose[overlap:]])
    state["exps"] = np.concatenate(
        [state["exps"][:-overlap],
         crossfade_linear(state["exps"][-overlap:], exps[:overlap]),
         exps[overlap:]])
    state["trans"] = np.concatenate(
        [state["trans"][:-overlap],
         crossfade_linear(state["trans"][-overlap:], trans[:overlap]),
         trans[overlap:]])


def test_stitched_two_chunk_take_matches_jax(case):
    """Two clips of two chunks each as one wave-batched group, retrieval-
    guided with the handoff: the port's run_group_waves + stitch against
    the JAX tool's orchestration through the JAX generator and motion_io,
    every wave on the same draws."""
    from raggesture_tpu.datasets.fixtures import tiny_batch
    from raggesture_tpu.utils.motion_io import (
        reassemble_full_pose as jax_reassemble,
    )
    from raggesture_tpu_torch.tools import longform_synthesis as P
    from raggesture_tpu_torch.utils.motion_io import reassemble_full_pose
    from tools import longform_synthesis as J

    JA = case["JA"]
    dc = case["jcfg"].denoiser
    overlap = dc.frame_chunk_size
    re_dict = _re_dict(dc, case["ex"], 3, 3)
    opts = ROUTES["guided_prev"]
    gen = _port_generator(case)
    chunks = {k: {kk: np.array(v) for kk, v in
                  tiny_batch(seed=20 + k, batch=2).items()} for k in (0, 1)}
    keys = {k: jax.random.fold_in(case["key"], k) for k in (0, 1)}

    def take(mod, run_one, reassemble, stitch):
        st = {ci: {"pose": None, "exps": None, "trans": None}
              for ci in (0, 1)}

        def run_wave(k, chunks_p, prev_rows, n_active):
            prev = None
            if prev_rows is not None:
                prev = (torch.cat(prev_rows) if mod is P
                        else jnp.concatenate(prev_rows))
            out = run_one(k, prev)
            pred = {n: np.asarray(v) for n, v in out.items()
                    if n.startswith("pred_")}
            return out["prev_latentout"], (reassemble(pred), pred)

        def on_chunk(ci, k, row, payload):
            poses, pred = payload
            stitch(st[ci], poses[row], pred["pred_exps"][row],
                   pred["pred_transl"][row], overlap)

        for group, waves in mod.plan_waves([2, 2], 2):
            # each wave's batch is chunks[k], both clips' k-th chunks
            mod.run_group_waves(group, waves, lambda ci, k: (ci, k),
                                run_wave, on_chunk)
        return st

    def port_one(k, prev):
        return _port_call(gen, case, chunks[k], keys[k],
                          dict(opts, use_prev_latent=prev is not None),
                          re_dict, prev)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "default_query_masks", lambda cfg, b: {
            k: jnp.asarray(v)
            for k, v in parity_query_masks_np(cfg, b).items()})

        def jax_one(k, prev):
            return case["jgen"](
                chunks[k], keys[k], opts=JA.InferenceOptions(
                    **dict(opts, use_prev_latent=prev is not None)),
                re_dict=re_dict, prev_latent=prev)

        want = take(J, jax_one, jax_reassemble, _stitch_jax)
    got = take(P, port_one, reassemble_full_pose, P.stitch)
    for ci in (0, 1):
        assert got[ci]["pose"].shape == (2 * dc.max_seq_len - overlap, 165)
        for k in ("pose", "exps", "trans"):
            np.testing.assert_allclose(got[ci][k], want[ci][k], atol=TOL,
                                       rtol=TOL, err_msg=f"clip {ci}: {k}")


# ---------------------------------------------------------- the tool

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A synthetic BEAT2 directory (two train clips, two test clips of 7 and
    4 seconds: 6 and 3 chunks of the tiny config's 2-second window), the
    tiny config's options and a params file of random weights."""
    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.train.checkpoint import save_params

    ws = str(tmp_path_factory.mktemp("longform"))
    root = os.path.join(ws, "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_2_2", "train"),
                          ("2_scott_0_3_3", "test", 7),
                          ("2_scott_0_4_4", "test", 4)], n_sec=12)
    opts = [f"data.{s}.{k}={v}" for s in ("train", "val", "test")
            for k, v in (("data_path", root),
                         ("cache_path", os.path.join(ws, "cache")),
                         ("allow_fake_contacts", True))] + [
        f"model.model.retrieval_cfg.cache_path={ws}/retrieval",
        "model.model.retrieval_cfg.stratification_interval=1",
        f"custom_hooks=[{{'type': 'DatabaseSaveHook', 'save_dir': "
        f"'{ws}/memo'}}]"]
    cfg = Config.fromfile(CFG)
    cfg.merge_option_strings(opts)
    model = create_model(arch_config_from(cfg.model), device="cpu", seed=0,
                         zero_init_std=0.05)
    ckpt = os.path.join(ws, "params.pt")
    save_params(ckpt, model)
    return dict(ws=ws, root=root, opts=opts, ckpt=ckpt)


def test_full_clip_caches_are_read_by_both_packages(workspace, tmp_path):
    """The long-form tool's cache, ``test_cache_mode="full"``: one record a
    clip, equal in both packages, and each package reads the other's."""
    from raggesture_tpu.datasets.beatx import BeatXConfig as JaxCfg
    from raggesture_tpu.datasets.beatx import BeatXDataset as JaxDataset
    from raggesture_tpu.datasets.beatx import ShardCache as JaxCache
    from raggesture_tpu.datasets.build import build_dataset as jax_build
    from raggesture_tpu_torch.datasets.beatx import (
        BeatXConfig,
        BeatXDataset,
        ShardCache,
    )
    from raggesture_tpu_torch.datasets.build import build_dataset

    kw = dict(data_root=workspace["root"], split="test", pose_length=30,
              test_cache_mode="full", allow_fake_contacts=True)
    port = build_dataset(BeatXConfig(cache_dir=str(tmp_path / "port"), **kw))
    jax_ds = jax_build(JaxCfg(cache_dir=str(tmp_path / "jax"), **kw))
    assert port.cache.path.endswith("test_full")
    assert port.names == jax_ds.names and len(port) == 2
    assert [port[i]["motion"].shape[0] for i in range(2)] == [105, 60]
    pairs = [(port, jax_ds),
             (BeatXDataset(ShardCache(jax_ds.cache.path)), jax_ds),
             (JaxDataset(JaxCache(port.cache.path)), port)]
    for a, b in pairs:
        assert a.cache.is_complete
        for i in range(len(b)):
            x, y = a[i], b[i]
            assert sorted(x) == sorted(y)
            for k in x:
                if isinstance(x[k], np.ndarray) and x[k].dtype.kind == "f":
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-6,
                                               err_msg=k)
                else:
                    _assert_same(x[k], y[k], k)


def test_tool_writes_the_jax_tools_files(workspace):
    """The tool twice, one clip a wave and two: the JAX tool's files with
    its keys, each chunk a window and the stitched motion the clip's length
    at 30 fps; retrieval fires on the chunk that holds a gesture label (the
    guided handoff route); both runs stitch the same lengths."""
    from raggesture_tpu.utils.motion_io import save_smplx_npz as jax_save
    from raggesture_tpu_torch.tools import longform_synthesis as P

    ws = workspace["ws"]
    jax_save(os.path.join(ws, "keys.npz"), np.zeros((2, 165)),
             np.zeros((2, 100)), np.zeros((2, 3)))
    keys = sorted(np.load(os.path.join(ws, "keys.npz")).files)
    reports = {}
    for cb in (1, 2):
        waves = []
        reports[cb] = P.main(
            [CFG, workspace["ckpt"], "--out-dir", os.path.join(ws, f"o{cb}"),
             "--device", "cpu", "--retrieval-method", "gesture_type",
             "--use-inversion", "--insertion-guidance", "--guidance-iters",
             "constant", "--clip-batch", str(cb), "--seed", "1",
             "--options"] + workspace["opts"], on_wave=waves.append)
        rep = reports[cb]
        assert [c["chunks"] for c in rep["clips"]] == [6, 3]
        assert len(rep["waves"]) == (9 if cb == 1 else 6)
        assert all(w["rows"] == cb for w in rep["waves"])
        guided = [w for w in waves if w["stats"]["num_queries"] > 0
                  and w["prev_latent"] is not None]
        assert guided and guided[0]["opts"].insertion_guidance
        # the JAX tool's generator: its constructor's default fused=False
        assert not waves[0]["generator"].fused
        for clip in rep["clips"]:
            d = os.path.join(ws, f"o{cb}", clip["name"])
            files = sorted(os.listdir(d))
            assert files == sorted(
                [f"chunk_{k:03d}.npz" for k in range(clip["chunks"])]
                + ["full_gt_motion.npz", "full_pred_motion.npz",
                   "gt_audio.wav"])
            for f in files:
                if not f.endswith(".npz"):
                    continue
                z = np.load(os.path.join(d, f))
                assert sorted(z.files) == keys, f
                n = 2 * (30 if f.startswith("chunk") else clip["frames"])
                assert z["poses"].shape == (n, 165), f
                assert z["expressions"].shape == (n, 100), f
                assert z["trans"].shape == (n, 3), f
                assert int(z["mocap_frame_rate"]) == 30
                assert np.isfinite(z["poses"]).all(), f
    assert reports[1]["clips"] == reports[2]["clips"]
    with pytest.raises(SystemExit, match="incompatible with --clip-batch"):
        P.main([CFG, workspace["ckpt"], "--out-dir", ws, "--device", "cpu",
                "--clip-batch", "2", "--no-refeaturize-chunks"])


def test_tool_leaves_nothing_of_a_take_alive(workspace, tmp_path):
    """Once ``main`` returns and the garbage is collected, no model,
    generator or tensor that the take made is still alive: on the card
    its graphs and their memory pools go with it."""
    import gc

    from raggesture_tpu_torch.models.architecture import (
        MotionDiffusionModel,
        StagedGenerator,
    )
    from raggesture_tpu_torch.tools import longform_synthesis as P

    def live():
        gc.collect()
        return {id(o) for o in gc.get_objects()
                if issubclass(type(o), (MotionDiffusionModel,
                                        StagedGenerator, torch.Tensor))}

    before = live()
    P.main([CFG, workspace["ckpt"], "--out-dir", str(tmp_path), "--device",
            "cpu", "--retrieval-method", "gesture_type", "--use-inversion",
            "--insertion-guidance", "--clip-batch", "2", "--seed", "2",
            "--options"] + workspace["opts"])
    assert live() <= before
