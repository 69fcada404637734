"""The port's serving tool (``raggesture_tpu_torch.tools.visualize``) end to
end on the CPU, against the JAX package's tool path: a synthetic BEAT2
workspace, the tiny config with random weights (the port's, bridged into a
JAX tree), gesture-type retrieval, inversion and insertion guidance, one
batch of two windows.

What is compared:
- the files and their shapes, the JAX tool's schema;
- the ground truth, transcript, semantic scores and the retrieved
  exemplar each sample directory holds, against what the JAX package's
  dataset, database and ``motion_io`` give for the same batch (≤ 1e-5;
  observed ≤ 6e-8);
- ``export_sample`` of the port's uncached clip, computed with the JAX
  generator's draws as tests/test_torch_guided.py feeds them (three DDIM
  steps, true-separator query masks), against the JAX
  ``StagedGenerator(fused=False)`` clip exported through JAX's
  ``motion_io`` (≤ 1e-4, the generator parity tests' tolerance; observed
  1.1e-5 on the poses).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dataset_build import make_raw_beat2
from test_torch_common import jax_tree_from_port, parity_query_masks_np, t32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")
SCHEDULE = ("scaled_linear", 1000, "1,1,1", 3)
TOL_FILES = 1e-5
TOL_CLIP = 1e-4
FILES = ("pred_motion.npz", "gt_motion.npz", "gt_text.txt", "sem_score.npy",
         "gt_audio.wav", "retrieval_0.npz", "retrieval_list.txt")
TOOL_FLAGS = ["--retrieval-method", "gesture_type", "--use-inversion",
              "--insertion-guidance", "--guidance-iters", "constant",
              "--test-batchsize", "2", "--max-batches", "1", "--seed", "0"]


def _options(ws, root, cache):
    return [f"data.{s}.{k}={v}" for s in ("train", "val", "test")
            for k, v in (("data_path", root), ("cache_path", cache),
                         ("allow_fake_contacts", True))] + [
        f"model.model.retrieval_cfg.cache_path={ws}/{os.path.basename(cache)}"
        "_retrieval",
        "model.model.retrieval_cfg.stratification_interval=1",
        f"custom_hooks=[{{'type': 'DatabaseSaveHook', 'save_dir': "
        f"'{ws}/memo'}}]"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The workspace, random weights in a params file, and the tool's first
    run (with --visualize-inversion and --inv-cache), its batch captured."""
    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.tools import visualize
    from raggesture_tpu_torch.train.checkpoint import save_params

    ws = str(tmp_path_factory.mktemp("visualize"))
    root = os.path.join(ws, "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_2_2", "train"),
                          ("2_scott_0_3_3", "test")], n_sec=12)
    opts = _options(ws, root, os.path.join(ws, "cache"))
    cfg = Config.fromfile(CFG)
    cfg.merge_option_strings(opts)
    model = create_model(arch_config_from(cfg.model), device="cpu", seed=0,
                         zero_init_std=0.05)
    ckpt = os.path.join(ws, "params.pt")
    save_params(ckpt, model)
    seen = []
    argv = [CFG, ckpt, "--out-dir", os.path.join(ws, "results"),
            "--device", "cpu", "--inv-cache", os.path.join(ws, "inv.npz")
            ] + TOOL_FLAGS
    report = visualize.main(argv + ["--visualize-inversion", "--options"]
                            + opts, on_batch=seen.append)
    return dict(ws=ws, root=root, cfg=cfg, model=model, argv=argv, opts=opts,
                report=report, info=seen[0])


def test_tool_writes_the_jax_tools_schema(run):
    out = os.path.join(run["ws"], "results")
    names = [n for n, v in zip(run["info"]["batch"]["sample_name"],
                               run["info"]["batch"]["valid_mask"]) if v]
    assert len(names) == 2 and run["info"]["stats"]["num_queries"] > 0
    for name in names:
        files = set(os.listdir(os.path.join(out, name)))
        assert files == set(FILES), name
        d = np.load(os.path.join(out, name, "pred_motion.npz"),
                    allow_pickle=True)
        assert d["poses"].shape == (60, 165)   # 30 frames @15fps -> 60 @30
        assert d["expressions"].shape == (60, 100)
        assert d["trans"].shape == (60, 3) and d["betas"].shape == (300,)
        assert str(d["model"]) == "smplx2020"
        assert int(d["mocap_frame_rate"]) == 30
        assert all(np.isfinite(d[k]).all() for k in ("poses", "trans"))
    check = os.path.join(out, "inversion_check_b0")
    Q = run["info"]["stats"]["num_queries"]
    assert np.load(os.path.join(check, "error_curve.npy")).shape == (10, Q)
    recon = np.load(os.path.join(check, "inv_recon_0.npz"))
    assert recon["poses"].shape == (60, 165)


def test_tool_generator_is_the_uncached_path(run):
    from raggesture_tpu_torch.models.fused_denoiser import UnfusedLayerWeights

    gen = run["info"]["generator"]
    assert not gen.fused and not gen.fused_codec and gen.graphs is None
    assert all(isinstance(w, UnfusedLayerWeights) for w in gen.packs)


def test_second_run_starts_from_the_saved_caches(run):
    from raggesture_tpu_torch.tools import visualize

    report = visualize.main(run["argv"] + ["--options"] + run["opts"])
    first = run["report"]["batches"][0]
    again = report["batches"][0]
    assert report["stages"]["inv_cache_loaded"] == first["num_queries"]
    assert again["num_queries"] == first["num_queries"]
    assert again["inv_cache_hits"] == first["num_queries"]
    assert again["inv_cache_misses"] == 0


@pytest.fixture(scope="module")
def jax_side(run):
    """The JAX package's dataset (its own cache of the same raw files),
    corpus, database and encode for the tool's batch."""
    from raggesture_tpu import builders as JB
    from raggesture_tpu.config import Config as JaxConfig
    from raggesture_tpu.datasets.build import build_dataset
    from raggesture_tpu.models import architecture as JA
    from raggesture_tpu.retrieval.database import (
        RetrievalCorpus,
        RetrievalDatabase,
        host_batch_from_records,
    )

    ws = run["ws"]
    cfg = JaxConfig.fromfile(CFG)
    cfg.merge_option_strings(_options(ws, run["root"],
                                      os.path.join(ws, "jax_cache")))
    test_ds = build_dataset(JB.beatx_config_from(cfg.data.test))
    train_ds = build_dataset(JB.beatx_config_from(cfg.data.train))
    rcfg = JB.retrieval_config_from(cfg.model.model)
    db = RetrievalDatabase(RetrievalCorpus.build(train_ds, rcfg), rcfg,
                           train_ds)
    jmodel = JB.build_architecture(cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    jax_tree_from_port(run["model"]))
    encode = jax.jit(lambda b: jmodel.apply(
        params, b, rng=None, sample=False, method=jmodel.encode_motion))
    names = run["info"]["batch"]["sample_name"]
    records = [test_ds[n] for n in names]
    re_dict = db(host_batch_from_records(records), names, encode,
                 method="gesture_type")
    return dict(cfg=cfg, jmodel=jmodel, params=params, names=names,
                records=records, re_dict=re_dict, JA=JA)


def _jax_export(smp_dir, out, j, rec, re_dict, factor=2):
    """The JAX tool's per-sample export (tools/visualize.py:251-309)
    through the JAX package's motion_io."""
    from raggesture_tpu.utils.motion_io import (
        linear_resample,
        reassemble_full_pose,
        save_smplx_npz,
        upsample_pose_aa,
    )

    os.makedirs(smp_dir, exist_ok=True)
    pred_pose = reassemble_full_pose(out)
    save_smplx_npz(os.path.join(smp_dir, "pred_motion.npz"),
                   upsample_pose_aa(pred_pose[j], factor),
                   linear_resample(np.asarray(out["pred_exps"])[j], factor),
                   linear_resample(np.asarray(out["pred_transl"])[j], factor),
                   fps=30)
    save_smplx_npz(os.path.join(smp_dir, "gt_motion.npz"),
                   upsample_pose_aa(np.asarray(rec["motion"]), factor),
                   linear_resample(np.asarray(rec["facial"]), factor),
                   linear_resample(np.asarray(rec["trans"]), factor),
                   betas=rec.get("beta", [None])[0], fps=30)
    with open(os.path.join(smp_dir, "gt_text.txt"), "w") as f:
        f.write(str(rec.get("raw_word", "")))
    np.save(os.path.join(smp_dir, "sem_score.npy"),
            linear_resample(np.asarray(rec["sem_score"], np.float32), factor))
    rm = np.asarray(re_dict["raw_motion"])[j, 0]
    save_smplx_npz(os.path.join(smp_dir, "retrieval_0.npz"),
                   upsample_pose_aa(rm[:, :165], factor),
                   linear_resample(np.asarray(re_dict["raw_facial"])[j, 0],
                                   factor),
                   linear_resample(np.asarray(re_dict["raw_trans"])[j, 0],
                                   factor), fps=30)
    with open(os.path.join(smp_dir, "retrieval_list.txt"), "w") as f:
        json.dump({
            "names": re_dict["raw_sample_names"][j],
            "type2words": {str(k): list(v) for k, v in
                           re_dict["raw_type2words"][j].items()},
            "query_startends": {str(k): list(v) for k, v in
                                re_dict["query_startends"][j].items()},
        }, f, indent=1)


def _assert_files_equal(got_dir, want_dir, files, tol):
    for name in files:
        a, b = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npz"):
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            assert sorted(x.files) == sorted(y.files), name
            for k in x.files:
                if x[k].dtype.kind == "f":
                    assert x[k].shape == y[k].shape, (name, k)
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=tol,
                                               err_msg=f"{name}:{k}")
                else:
                    assert x[k] == y[k], (name, k)
        elif name.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=0,
                                       atol=tol, err_msg=name)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


def test_tool_files_equal_the_jax_packages(run, jax_side, tmp_path):
    """Every file but the prediction: the JAX dataset's records and its
    database's re_dict for the same batch, through JAX's motion_io."""
    out = os.path.join(run["ws"], "results")
    valid = run["info"]["batch"]["valid_mask"]
    for j, (name, rec) in enumerate(zip(jax_side["names"],
                                        jax_side["records"])):
        if not valid[j]:
            continue
        want = str(tmp_path / name)
        dummy = {k: np.zeros((2, 30, d), np.float32) for k, d in (
            ("pred_upper", 39), ("pred_hands", 90), ("pred_lower", 27),
            ("pred_facepose", 3), ("pred_exps", 100), ("pred_transl", 3))}
        _jax_export(want, dummy, j, rec, jax_side["re_dict"])
        _assert_files_equal(os.path.join(out, name), want,
                            [f for f in FILES if f not in (
                                "pred_motion.npz", "gt_audio.wav")],
                            TOL_FILES)
        with open(os.path.join(out, name, "gt_audio.wav"), "rb") as f:
            assert len(f.read()) > 44             # a RIFF header and samples


def test_export_of_the_uncached_clip_matches_jax(run, jax_side, tmp_path):
    """The port's StagedGenerator(fused=False) clip on the JAX generator's
    draws, written by export_sample, against the JAX tool's generator and
    export on the same batch and retrieval."""
    from raggesture_tpu.diffusion.schedules import make_schedule as jax_make
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        InferenceOptions,
        StagedGenerator,
    )
    from raggesture_tpu_torch.models.conditioning import scale_func_table
    from raggesture_tpu_torch.tools.visualize import export_sample

    JA = jax_side["JA"]
    jmodel = jax_side["jmodel"]
    dc = jmodel.cfg.denoiser
    batch = {k: np.asarray(v) for k, v in run["info"]["batch"].items()
             if k in ("word", "audio", "speaker_ids", "motion_mask")}
    # the plain guided pipeline in both (no exemplar names: no inversion
    # cache), on JAX's re_dict
    re_dict = {k: v for k, v in jax_side["re_dict"].items()
               if k not in ("inv_names", "num_queries")}
    opts = dict(use_inversion=True, insertion_guidance=True)
    key = jax.random.PRNGKey(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "default_query_masks", lambda cfg, b: {
            k: jnp.asarray(v)
            for k, v in parity_query_masks_np(cfg, b).items()})
        jgen = JA.StagedGenerator(jmodel, jax_side["params"],
                                  jax_make(*SCHEDULE))
        assert not jgen.fused                      # the JAX tool's default
        want = {k: np.asarray(v) for k, v in jgen(
            batch, key, opts=JA.InferenceOptions(**opts),
            re_dict=re_dict).items()}
    B, T, D = 2, dc.num_tokens, dc.latent_dim
    r_noise, r_coef, r_loop = jax.random.split(key, 3)
    _, r_bulk = jax.random.split(r_loop)
    gen = StagedGenerator(run["model"], make_schedule(*SCHEDULE), fused=False)
    coef = scale_func_table(gen.sched, gen.model.cfg.scale_func,
                            jmodel.cfg.diffusion_train.diffusion_steps,
                            coins=torch.from_numpy(np.array(
                                jax.random.bernoulli(r_coef, 0.5,
                                                     (SCHEDULE[3],)))))
    qm = {k: t32(v[0]) for k, v in parity_query_masks_np(dc, 1).items()}
    got = gen(batch, opts=InferenceOptions(**opts), re_dict=re_dict,
              noise=t32(jax.random.normal(r_noise, (B, T, D))),
              coef_table=coef, query_masks=qm,
              in_seq_noise=t32(jax.random.normal(
                  r_bulk, (SCHEDULE[3], B, T, D))))
    got = {k: v.numpy() for k, v in got.items()}
    for j, rec in enumerate(jax_side["records"]):
        export_sample(str(tmp_path / "port" / str(j)), got, j, rec,
                      jax_side["re_dict"])
        _jax_export(str(tmp_path / "jax" / str(j)), want, j, rec,
                    jax_side["re_dict"])
        _assert_files_equal(str(tmp_path / "port" / str(j)),
                            str(tmp_path / "jax" / str(j)),
                            ["pred_motion.npz"], TOL_CLIP)
