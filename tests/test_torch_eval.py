"""Evaluation in the port against the JAX package on the CPU: SMPL-X FK
(``models/smplx.py``), foot contacts in the window cache, the FGD embedder
and its weights, the metrics, the evaluator and the three tools.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- FK joints and vertices: float32 on both sides, summed in other orders,
  within 1e-5 (observed ≤ 2.9e-6 on rigs of metre-sized joints).
- Foot contacts: ``velocity < 0.01``; the two packages may differ only
  where a velocity lies within float32 rounding (1e-6) of the threshold.
  Such frames are counted; no other difference is allowed.
- FGD latents and decode: within 1e-5 (observed ~1e-7 and ~1e-6).
- Metrics: the same numpy code on the same inputs, bitwise equal.
- The evaluator with the same host callables on both sides: only the 6d
  conversion differs (float32 rounding), every key within 1e-6 relative.
- The tools end to end, each package with its own FK and FGD: the
  continuous keys within 1e-4 relative; ``align`` and ``srgr`` count beats
  and hits and are held equal to the same relative tolerance, which a
  single flipped beat or hit would exceed.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_evaluator import _write_result_dir
from test_torch_common import REPO

FIX = os.path.join(REPO, "tests", "fixtures")
TOL_FK = 1e-5
TOL_FGD = 1e-5
CONTACT_THRESHOLD = 0.01
# a velocity this close to the threshold may fall either side of it
CONTACT_ROUNDING = 1e-6


# ------------------------------------------------------------------ rigs


def _rig_pair(**kw):
    """The same synthetic rig in both packages (the port's ``expr_dirs``
    flag set as the JAX package's ``num_expr != 5`` sentinel sets it)."""
    from raggesture_tpu.models import smplx as JS
    from raggesture_tpu_torch.models import smplx as PS

    parents = kw.pop("parents", None)
    jm = JS.synthetic_model(**kw)
    pm = PS.synthetic_model(**kw, expr_dirs=kw.get("num_expr", 5) != 5,
                            device="cpu")
    if parents is not None:
        jm = dataclasses.replace(jm, parents=jnp.asarray(parents, jnp.int32))
        pm = dataclasses.replace(pm, parents=torch.as_tensor(
            np.asarray(parents), dtype=torch.long))
    return jm, pm


@pytest.fixture(scope="module")
def tree_rig():
    """55 joints on the SMPL-X tree, two vertices a joint, the release's
    300 betas and 100 expressions, random pose and expression blend
    shapes: the level-wise chain meets the real tree."""
    from raggesture_tpu_torch.models.eval_fgd import default_smplx_parents

    return _rig_pair(num_joints=55, verts_per_joint=2, num_betas=300,
                     num_expr=100, posedirs=True,
                     parents=default_smplx_parents())


def _arrays(model):
    return {f.name: np.asarray(getattr(model, f.name))
            for f in dataclasses.fields(model)}


def write_release_npz(path, model, posedirs_3d=False):
    """A rig in the SMPLX_NEUTRAL_2020.npz layout: betas and expressions
    concatenated in ``shapedirs``, ``posedirs`` (P, V*3) or (V, 3, P),
    ``kintree_table`` (2, J), faces ``f``."""
    from raggesture_tpu_torch.models.smplx import synthetic_faces

    a = _arrays(model)
    V = a["v_template"].shape[0]
    J = a["j_regressor"].shape[0]
    posedirs = a["posedirs"]
    if posedirs_3d:
        posedirs = posedirs.T.reshape(V, 3, -1)
    np.savez(path, v_template=a["v_template"],
             shapedirs=np.concatenate([a["shapedirs"], a["exprdirs"]], -1),
             posedirs=posedirs, J_regressor=a["j_regressor"],
             weights=a["lbs_weights"],
             kintree_table=np.stack([a["parents"], np.arange(J)]),
             f=synthetic_faces(J, V // J))
    return path


@pytest.fixture(scope="module")
def asset(tree_rig, tmp_path_factory):
    return write_release_npz(
        str(tmp_path_factory.mktemp("smplx") / "SMPLX_NEUTRAL_2020.npz"),
        tree_rig[1])


def _lbs_inputs(model, B=6, seed=0, scale=0.5):
    r = np.random.RandomState(seed)
    J = model.num_joints
    pose = (r.randn(B, J * 3) * scale).astype(np.float32)
    pose[0] = 0.0                 # the rest pose: every joint's small-angle branch
    pose[1, : 3 * (J // 2)] = 0.0  # half the joints exactly zero
    pose[2, 3:6] = 1e-7           # below the branch's angle 1e-6
    return {
        "betas": r.randn(B, model.shapedirs.shape[-1]).astype(np.float32),
        "pose_aa": pose,
        "expression": r.randn(B, model.exprdirs.shape[-1]).astype(np.float32),
        "transl": r.randn(B, 3).astype(np.float32)}


# ------------------------------------------------------------------ FK


@pytest.mark.parametrize("case", ["chain", "chain_blendshapes", "tree"])
def test_lbs_matches_jax(case, tree_rig):
    from raggesture_tpu.models import smplx as JS
    from raggesture_tpu_torch.models import smplx as PS

    if case == "tree":
        jm, pm = tree_rig
    else:
        extra = (dict(posedirs=True, num_expr=7) if case == "chain_blendshapes"
                 else {})
        jm, pm = _rig_pair(num_joints=6, **extra)
    x = _lbs_inputs(pm)
    jj, jv = jax.jit(lambda **k: JS.lbs(jm, **k))(
        **{k: jnp.asarray(v) for k, v in x.items()})
    pj, pv = PS.lbs(pm, **{k: torch.from_numpy(v) for k, v in x.items()})
    for a, b in ((jj, pj), (jv, pv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL_FK)
    if case == "chain_blendshapes":
        assert np.abs(_arrays(pm)["exprdirs"]).max() > 0
    # the rest pose gives the rest joints, translated
    rest = (pm.j_regressor @ (pm.v_template + torch.einsum(
        "vdk,k->vd", pm.shapedirs, torch.from_numpy(x["betas"][0]))
        + torch.einsum("vdk,k->vd", pm.exprdirs,
                       torch.from_numpy(x["expression"][0]))))
    np.testing.assert_allclose(pj[0].numpy(), (rest + torch.from_numpy(
        x["transl"][0])).numpy(), rtol=0, atol=TOL_FK)


def test_level_chain_equals_the_sequential_chain(tree_rig):
    """The chain by depth level against a joint-by-joint composition."""
    from raggesture_tpu_torch.models import smplx as PS
    from raggesture_tpu_torch.ops.rotations import axis_angle_to_matrix

    _, pm = tree_rig
    roots, levels = pm.levels
    assert roots.tolist() == [0] and len(levels) == 10   # 11 levels
    x = _lbs_inputs(pm, seed=1)
    B, J = x["pose_aa"].shape[0], pm.num_joints
    rot = axis_angle_to_matrix(torch.from_numpy(x["pose_aa"]).reshape(B, J, 3))
    rest = torch.randn(B, J, 3, generator=torch.Generator().manual_seed(0))
    joints, rel = PS._rigid_transform_chain(pm, rot, rest)
    parents = pm.parents.tolist()
    world = []
    for j in range(J):
        local = torch.zeros(B, 4, 4)
        local[:, :3, :3] = rot[:, j]
        local[:, :3, 3] = rest[:, j] - (rest[:, parents[j]] if j else 0.0)
        local[:, 3, 3] = 1.0
        world.append(local if j == 0 else world[parents[j]] @ local)
    world = torch.stack(world, 1)
    np.testing.assert_allclose(joints.numpy(), world[..., :3, 3].numpy(),
                               rtol=0, atol=1e-6)


def test_rotations_match_jax():
    from raggesture_tpu.ops import rotations as JR
    from raggesture_tpu_torch.ops import rotations as PR

    r = np.random.RandomState(3)
    aa = (r.randn(64, 3) * 1.5).astype(np.float32)
    aa[:8] = 0.0
    aa[8:16] *= 1e-7
    q = PR.axis_angle_to_quaternion(torch.from_numpy(aa))
    np.testing.assert_allclose(
        q.numpy(), np.asarray(JR.axis_angle_to_quaternion(aa)), atol=1e-6)
    np.testing.assert_allclose(
        PR.axis_angle_to_matrix(torch.from_numpy(aa)).numpy(),
        np.asarray(JR.axis_angle_to_matrix(aa)), atol=1e-6)
    assert torch.equal(PR.axis_angle_to_matrix(torch.zeros(2, 3)),
                       torch.eye(3).expand(2, 3, 3))


@pytest.mark.parametrize("num_expr", [5, 7])
def test_synthetic_model_flag_gives_the_jax_arrays(num_expr):
    """The explicit ``expr_dirs`` flag set as JAX's ``num_expr != 5``
    sentinel sets it gives JAX's arrays; the flag, unlike the sentinel,
    also gives random expression directions at num_expr = 5."""
    from raggesture_tpu_torch.models import smplx as PS

    jm, pm = _rig_pair(num_expr=num_expr, posedirs=True)
    ja, pa = _arrays(jm), _arrays(pm)
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    flagged = PS.synthetic_model(num_expr=5, expr_dirs=True, posedirs=True,
                                 device="cpu")
    assert flagged.exprdirs.abs().max() > 0


@pytest.mark.parametrize("posedirs_3d", [False, True])
def test_load_smplx_reads_the_release_layout(tree_rig, tmp_path, posedirs_3d):
    from raggesture_tpu.models.smplx import load_smplx as jax_load
    from raggesture_tpu_torch.models.smplx import load_smplx

    from raggesture_tpu.models import smplx as JS
    from raggesture_tpu_torch.models import smplx as PS

    path = write_release_npz(str(tmp_path / "m.npz"), tree_rig[1],
                             posedirs_3d)
    np.testing.assert_array_equal(PS.load_smplx_faces(path),
                                  JS.load_smplx_faces(path))
    np.testing.assert_array_equal(PS.synthetic_faces(5, 4),
                                  JS.synthetic_faces(5, 4))
    ja, pa = _arrays(jax_load(path)), _arrays(load_smplx(path, device="cpu"))
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
        np.testing.assert_array_equal(pa[k], _arrays(tree_rig[1])[k],
                                      err_msg=k)


# ------------------------------------------------------------ foot contacts


def _slow_motion(n, seed, step=0.004):
    """Poses and translation that drift slowly, so that the feet's
    per-frame speeds straddle the contact threshold."""
    r = np.random.RandomState(seed)
    pose = np.cumsum(r.randn(n, 165) * step, axis=0).astype(np.float32)
    trans = np.cumsum(r.randn(n, 3) * step, axis=0).astype(np.float32)
    return pose, trans


def _assert_contacts_agree(port, jax_c, vel):
    """Equal, except frames whose velocity lies within float32 rounding of
    the threshold; returns how many such frames differ."""
    port, jax_c = np.asarray(port), np.asarray(jax_c)
    diff = port != jax_c
    near = np.abs(vel - CONTACT_THRESHOLD) < CONTACT_ROUNDING
    assert not (diff & ~near).any(), np.argwhere(diff & ~near)[:5]
    return int(diff.sum())


def _foot_speeds(model, betas, pose, trans):
    from raggesture_tpu_torch.models.smplx import lbs

    n = len(pose)
    joints, _ = lbs(model, torch.from_numpy(betas).expand(n, -1),
                    torch.from_numpy(pose), transl=torch.from_numpy(trans),
                    return_verts=False)
    fj = joints[:, (7, 8, 10, 11)].numpy()
    vel = np.zeros((n, 4), np.float32)
    vel[:-1] = np.linalg.norm(fj[1:] - fj[:-1], axis=-1)
    return vel


def test_foot_contacts_match_jax(tree_rig):
    from raggesture_tpu.models import smplx as JS
    from raggesture_tpu_torch.models import smplx as PS

    jm, pm = tree_rig
    pose, trans = _slow_motion(96, seed=0)
    betas = np.zeros((1, 300), np.float32)
    jc = jax.jit(lambda b, p, t: JS.foot_contacts(jm, b, p, t))(
        jnp.broadcast_to(betas, (96, 300)), pose, trans)
    pc = PS.foot_contacts(pm, torch.from_numpy(betas).expand(96, 300),
                          torch.from_numpy(pose), torch.from_numpy(trans))
    vel = _foot_speeds(pm, betas[0], pose, trans)
    assert 0.1 < pc.mean() < 0.9          # both kinds of bit occur
    _assert_contacts_agree(pc, jc, vel)
    assert pc[-1].all()                   # the last frame is a contact


def test_featurize_clip_contacts_match_jax(tree_rig):
    from raggesture_tpu.datasets import beatx as JB
    from raggesture_tpu_torch.datasets import beatx as PB

    jm, pm = tree_rig
    pose, trans = _slow_motion(240, seed=1, step=0.001)
    r = np.random.RandomState(2)
    raw = {"poses30": pose, "trans30": trans,
           "betas": (r.randn(300) * 0.1).astype(np.float32),
           "expressions30": (r.randn(240, 100) * 0.1).astype(np.float32),
           "audio": np.zeros(16000 * 8, np.float32)}
    kw = dict(pose_length=30, stride=15)
    port = PB.featurize_clip("2_scott_0_1_1", raw, PB.BeatXConfig(**kw),
                             PB.StubFeatureExtractor(), smplx_model=pm)
    jax_r = JB.featurize_clip("2_scott_0_1_1", raw, JB.BeatXConfig(**kw),
                              JB.StubFeatureExtractor(), smplx_model=jm)
    assert len(port) == len(jax_r) > 1
    vel = _foot_speeds(pm, raw["betas"][None], pose[::2], trans[::2])
    flips = 0
    for i, (a, b) in enumerate(zip(port, jax_r)):
        s = 15 * i
        flips += _assert_contacts_agree(a["contact"], b["contact"],
                                        vel[s: s + 30])
        np.testing.assert_array_equal(a["motion"][:, :165], b["motion"][:, :165])
        np.testing.assert_array_equal(a["motion"][:, 165:], a["contact"])
    bits = np.concatenate([a["contact"] for a in port])
    assert 0.1 < bits.mean() < 0.9
    assert flips <= 2


def test_build_cache_with_an_smplx_asset(asset, tmp_path):
    """The port's cache build loads ``smplx_asset`` onto the device it is
    given (it used to raise) and its contacts equal the JAX package's."""
    from raggesture_tpu.datasets.beatx import BeatXConfig as JaxCfg
    from raggesture_tpu.datasets.build import build_cache as jax_build
    from raggesture_tpu_torch.datasets.beatx import BeatXConfig
    from raggesture_tpu_torch.datasets.build import build_cache
    from test_dataset_build import make_raw_beat2

    root = str(tmp_path / "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_2_2", "train")], n_sec=4)
    kw = dict(data_root=root, split="train", pose_length=30, stride=30,
              smplx_asset=asset)
    port = build_cache(BeatXConfig(cache_dir=str(tmp_path / "port"), **kw),
                       device="cpu")
    jc = jax_build(JaxCfg(cache_dir=str(tmp_path / "jax"), **kw))
    assert len(port) == len(jc) == 4
    for i in range(len(port)):
        a, b = port.read(i)["contact"], jc.read(i)["contact"]
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cache(BeatXConfig(cache_dir=str(tmp_path / "p2"), **kw))


# ------------------------------------------------------------------ FGD


@pytest.fixture(scope="module")
def fgd_state():
    """A state dict on the reference checkpoint's 56 keys and shapes
    (``golden_keys_fgd.json``), its masks and pool matrices the
    reference's (``golden_fgd_topology.npz``), weights from a seed (small,
    so that tanh stays off saturation)."""
    golden = json.load(open(os.path.join(FIX, "golden_keys_fgd.json")))
    topo = np.load(os.path.join(FIX, "golden_fgd_topology.npz"))
    rng = np.random.RandomState(9)
    return {k: (topo[k].astype(np.float32) if k in topo.files
                else (rng.randn(*shape) * 0.05).astype(np.float32))
            for k, shape in golden.items()}


@pytest.fixture(scope="module")
def fgd_pair(fgd_state):
    """The JAX embedder with its convert_fgd params, and the port's filled
    from the same JAX tree by load_jax_params."""
    from raggesture_tpu.models.eval_fgd import FGDConfig, FGDEmbedder
    from raggesture_tpu.utils.convert_torch import convert_fgd
    from raggesture_tpu_torch.models import eval_fgd as PF
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params

    tree = convert_fgd(fgd_state)
    jm = FGDEmbedder(FGDConfig())
    pm = PF.FGDEmbedder(PF.FGDConfig())
    load_jax_params(pm, {k: v for k, v in tree["params"].items()
                         if not k.startswith("fc_")})
    return jm, tree, pm


def test_fgd_topology_equals_the_reference():
    from raggesture_tpu_torch.models.eval_fgd import (
        FGDConfig,
        FGDEmbedder,
        default_smplx_parents,
        encoder_topology,
    )

    gold = np.load(os.path.join(FIX, "golden_fgd_topology.npz"))
    stages = encoder_topology(FGDConfig(), default_smplx_parents())
    for i, st in enumerate(stages):
        base = f"encoder.layers.{i}.0"
        np.testing.assert_array_equal(st["res_mask"],
                                      gold[f"{base}.residual.0.mask"])
        np.testing.assert_array_equal(st["short_mask"],
                                      gold[f"{base}.shortcut.mask"])
        assert st["do_pool"] == (f"{base}.common.0.weight" in gold.files)
        if st["do_pool"]:
            np.testing.assert_array_equal(st["pool_w"],
                                          gold[f"{base}.common.0.weight"])
    assert FGDEmbedder().encoder.out_dim == 240


@pytest.mark.parametrize("variational", [False, True])
def test_convert_fgd_fills_every_parameter(fgd_state, fgd_pair, variational):
    """convert_fgd fills the port's embedder as the JAX package's
    convert_fgd + load_jax_params do (masks baked in; fc_mu / fc_logvar
    only into a variational embedder)."""
    from raggesture_tpu_torch.models import eval_fgd as PF
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params
    from raggesture_tpu_torch.utils.convert_torch import convert_fgd

    _, tree, _ = fgd_pair
    cfg = PF.FGDConfig(variational=variational)
    got, want = PF.FGDEmbedder(cfg), PF.FGDEmbedder(cfg)
    convert_fgd(fgd_state, got)
    params = tree["params"] if variational else {
        k: v for k, v in tree["params"].items() if not k.startswith("fc_")}
    load_jax_params(want, params)
    for (k, a), (_, b) in zip(got.state_dict().items(),
                              want.state_dict().items()):
        assert torch.equal(a, b), k
    assert ("fc_mu.weight" in dict(got.named_parameters())) == variational


@pytest.mark.parametrize("fault", ["extra_key", "other_mask", "no_layers"])
def test_convert_fgd_refuses_a_state_that_does_not_fit(fgd_state, fault):
    from raggesture_tpu_torch.models import eval_fgd as PF
    from raggesture_tpu_torch.utils.convert_torch import convert_fgd

    state = dict(fgd_state)
    if fault == "extra_key":
        state["decoder.main.99.weight"] = np.zeros((1, 1, 3), np.float32)
        state["decoder.main.99.bias"] = np.zeros(1, np.float32)
        state["encoder.stray"] = np.zeros(1, np.float32)
    elif fault == "other_mask":
        key = "encoder.layers.1.0.shortcut.mask"
        state[key] = np.ones_like(state[key])
    else:
        state = {k: v for k, v in state.items()
                 if not k.startswith("encoder.")}
    with pytest.raises((KeyError, ValueError)):
        convert_fgd(state, PF.FGDEmbedder())


def test_fgd_map2latent_and_decode_match_jax(fgd_pair):
    jm, tree, pm = fgd_pair
    x = np.random.RandomState(4).randn(2, 64, 330).astype(np.float32)
    out = jax.jit(lambda p, x: jm.apply(p, x))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got["poses_feat"].shape == (2, 4, 240)
    for key in ("poses_feat", "rec_pose"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(out[key]),
                                   rtol=0, atol=TOL_FGD, err_msg=key)


def test_variational_embedder_draws_from_the_given_generator(fgd_state):
    from raggesture_tpu_torch.models import eval_fgd as PF
    from raggesture_tpu_torch.utils.convert_torch import convert_fgd

    pm = PF.FGDEmbedder(PF.FGDConfig(variational=True))
    convert_fgd(fgd_state, pm)
    x = torch.randn(1, 32, 330, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = pm.map2latent(x, torch.Generator().manual_seed(1))
        b = pm.map2latent(x, torch.Generator().manual_seed(1))
        c = pm.map2latent(x, torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="generator"):
            pm.map2latent(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------------------------ metrics


def test_metrics_bitwise_equal_the_jax_packages():
    from raggesture_tpu.eval import metrics as JM
    from raggesture_tpu_torch.eval import metrics as PM

    r = np.random.RandomState(5)
    wave = (r.randn(16000 * 3) * 0.3).astype(np.float32)
    a = np.cumsum(r.randn(90, 165) * 0.05, axis=0)
    b = a + r.randn(90, 165) * 0.01
    sem = r.rand(90)
    mean_vel = np.abs(r.randn(55)) + 0.5
    mask = (r.rand(90, 55) > 0.5).astype(np.float32)
    for fn in ("onset_strength", "detect_onsets"):
        np.testing.assert_array_equal(getattr(PM, fn)(wave, 16000),
                                      getattr(JM, fn)(wave, 16000))
    results = []
    for M in (JM, PM):
        l1 = M.L1div()
        l1.run(a)
        l1.run(b)
        srgr = M.SRGR()
        srgr.run(a, b, sem)
        align = M.BeatAlignment(mean_velocity=mean_vel)
        beats = align.motion_beats(a, 30, t_start=10, t_end=80)
        mp = M.MPJPE()
        mp.compute_error(a.reshape(90, 55, 3), b.reshape(90, 55, 3), mask)
        results.append([
            l1.avg(), srgr.avg(), [x.tolist() for x in beats],
            align.calculate_align(M.detect_onsets(wave), beats, 30),
            M.frechet_distance(a[:, :8], b[:, :8]),
            M.calc_diversity(a[:10]), M.calculate_avg_distance(list(a[:6])),
            mp.get_average_error()])
    assert results[0] == results[1]
    assert PM.detect_onsets is __import__(
        "raggesture_tpu_torch.datasets.beatx", fromlist=["x"]).detect_onsets


# ------------------------------------------------------------ evaluator


SUMMARY_KEYS = ("fgd", "align", "l1div", "l1div_gt", "mpjpe_retrieval",
                "srgr", "diversity", "face_l2", "face_lvd")


def _write_results(root, names, seed0):
    """Result directories as tests/test_evaluator.py makes them (64 frames,
    retrieval_0.npz, gt_audio.wav), with a sem_score.npy each."""
    for i, name in enumerate(names):
        d = os.path.join(root, name)
        _write_result_dir(d, seed=seed0 + i)
        np.save(os.path.join(d, "sem_score.npy"),
                np.random.RandomState(seed0 + 50 + i).rand(64, 1)
                .astype(np.float32))
    return root


@pytest.fixture(scope="module")
def eval_inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval")
    root = _write_results(str(base / "res_rep0"),
                          ["clip_a/0", "clip_b/0", "clip_c/0"], seed0=0)
    _write_results(str(base / "res_rep1"), ["clip_a/0", "clip_c/0"],
                   seed0=20)
    avg_vel = str(base / "avg_vel.npy")
    np.save(avg_vel, (np.abs(np.random.RandomState(8).randn(55)) + 0.5)
            .astype(np.float32))
    return {"root": root, "prefix": str(base / "res"), "avg_vel": avg_vel}


def test_evaluator_logic_matches_jax(eval_inputs, tree_rig, fgd_pair):
    """Both packages' Evaluator and multimodality with the same host
    callables for FK and FGD (the port's, on the CPU): only the
    evaluator's own code differs."""
    from raggesture_tpu.eval import evaluator as JE
    from raggesture_tpu_torch.eval import evaluator as PE
    from raggesture_tpu_torch.tools.evaluate import (
        build_face_fk_fn,
        build_fgd_fn,
        build_fk_fn,
    )

    pm = tree_rig[1]
    fns = dict(fk_fn=build_fk_fn("", model=pm),
               face_fk_fn=build_face_fk_fn("", model=pm),
               fgd_embed_fn=build_fgd_fn("", device="cpu",
                                         model=fgd_pair[2]))
    kw = dict(eval_n=64, compute_srgr=True,
              avg_vel_path=eval_inputs["avg_vel"])
    want = JE.Evaluator(JE.EvalConfig(**kw), **fns).evaluate(
        eval_inputs["root"])
    ev = PE.Evaluator(PE.EvalConfig(**kw), device="cpu", **fns)
    got = ev.evaluate(eval_inputs["root"])
    assert sorted(got) == sorted(want) == sorted(SUMMARY_KEYS)
    for k in SUMMARY_KEYS:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
    assert all(v > 0 for v in ev.seconds.values()), ev.seconds
    roots = [eval_inputs["prefix"] + f"_rep{i}" for i in range(2)]
    mm = PE.multimodality(roots, eval_n=64, fk_fn=fns["fk_fn"])
    assert mm > 0 and mm == pytest.approx(
        JE.multimodality(roots, eval_n=64, fk_fn=fns["fk_fn"]), rel=1e-6)


def test_evaluator_lets_an_fk_fault_through(eval_inputs, tree_rig):
    """A TypeError raised inside FK reaches the caller: the JAX Evaluator
    retries such a call without betas (``_fk_joints``'s ``except
    TypeError``) and so evaluates with zero betas; the port's always passes
    them."""
    from raggesture_tpu.eval import evaluator as JE
    from raggesture_tpu_torch.eval import evaluator as PE
    from raggesture_tpu_torch.tools.evaluate import build_fk_fn

    fk = build_fk_fn("", model=tree_rig[1])

    def faulty_fk(pose, trans, exps, betas=None):
        if betas is not None:
            raise TypeError("a fault inside FK")
        return fk(pose, trans, exps)

    cfg = dict(eval_n=64, compute_fgd=False, compute_mpjpe=False)
    assert "l1div" in JE.Evaluator(JE.EvalConfig(**cfg), fk_fn=faulty_fk
                                   ).evaluate(eval_inputs["root"])
    with pytest.raises(TypeError, match="inside FK"):
        PE.Evaluator(PE.EvalConfig(**cfg), fk_fn=faulty_fk,
                     device="cpu").evaluate(eval_inputs["root"])


def _jax_tool(monkeypatch, name, argv):
    import importlib

    mod = importlib.import_module(f"tools.{name}")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def _jax_summary(root, asset, avg_vel, fgd_path=None):
    """What tools/evaluate.py's main (with ``fgd_path``, --srgr) or
    tools/evaluate_divonly.py's (without) computes before it prints: its
    build_*_fn functions and the JAX package's Evaluator, as a dict of
    floats."""
    from raggesture_tpu.eval.evaluator import EvalConfig, Evaluator
    from raggesture_tpu.models.smplx import load_smplx
    from tools.evaluate import build_face_fk_fn, build_fgd_fn, build_fk_fn

    m = load_smplx(asset)
    if fgd_path is None:
        ev = Evaluator(EvalConfig(eval_n=64, compute_fgd=False,
                                  avg_vel_path=avg_vel, compute_mpjpe=False),
                       fk_fn=build_fk_fn(asset, model=m))
    else:
        ev = Evaluator(EvalConfig(eval_n=64, compute_srgr=True,
                                  avg_vel_path=avg_vel),
                       fgd_embed_fn=build_fgd_fn(fgd_path),
                       fk_fn=build_fk_fn(asset, model=m),
                       face_fk_fn=build_face_fk_fn(asset, model=m))
    return {k: float(v) for k, v in ev.evaluate(root).items()}


def test_tools_end_to_end_match_the_jax_tools(eval_inputs, asset, fgd_state,
                                              tmp_path, monkeypatch, capsys):
    """The three tools with --device cpu against the JAX tools on copies of
    the same result directories, each package with its own FK and FGD: the
    same files and keys, the continuous keys within 1e-4 relative (align
    and srgr too: no beat or hit flips on this fixture).

    The JAX tools cannot write their JSON when FK runs: under NumPy 2 the
    diversity and the retrieval MPJPE of float32 joints are np.float32,
    which json refuses.  Their summaries are taken from their build_*_fn
    functions and the JAX Evaluator, as their mains compute them; the
    port's tools write Python floats."""
    import shutil

    from raggesture_tpu.train.checkpoint import save_params
    from raggesture_tpu.utils.convert_torch import convert_fgd
    from raggesture_tpu_torch.tools import evaluate, evaluate_divonly
    from raggesture_tpu_torch.tools import evaluate_mm

    # the reference checkpoint for the port; its conversion (orbax) for JAX
    ref_bin = str(tmp_path / "AESKConv_240_100.bin")
    torch.save({"model_state": {k: torch.from_numpy(v)
                                for k, v in fgd_state.items()},
                "epoch": 100}, ref_bin)
    jax_fgd = str(tmp_path / "fgd_jax")
    save_params(jax_fgd, convert_fgd(fgd_state))
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path / who)
        shutil.copytree(eval_inputs["root"], roots[who])
    common = ["--eval-n", "64", "--smplx", asset, "--avg-vel",
              eval_inputs["avg_vel"]]
    report = evaluate.main([roots["port"], "--srgr", "--fgd-weights",
                            ref_bin, "--device", "cpu"] + common)
    div = evaluate_divonly.main([roots["port"], "--device", "cpu"] + common)
    for tool, argv, name, fgd in (
            ("evaluate", ["--srgr", "--fgd-weights", jax_fgd],
             "metrics.json", jax_fgd),
            ("evaluate_divonly", [], "metrics_divonly.json", None)):
        with pytest.raises(TypeError, match="float32"):
            _jax_tool(monkeypatch, tool, [roots["jax"]] + argv + common)
        with open(os.path.join(roots["jax"], name), "w") as f:
            json.dump(_jax_summary(roots["jax"], asset,
                                   eval_inputs["avg_vel"], fgd), f)
    for name, keys in (("metrics.json", SUMMARY_KEYS),
                       ("metrics_divonly.json",
                        ("align", "l1div", "l1div_gt", "diversity",
                         "face_l2", "face_lvd"))):
        want = json.load(open(os.path.join(roots["jax"], name)))
        got = json.load(open(os.path.join(roots["port"], name)))
        assert sorted(got) == sorted(want) == sorted(keys), name
        for k in keys:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=0), (name, k)
    assert report["summary"] == json.load(
        open(os.path.join(roots["port"], "metrics.json")))
    for r in (report, div):
        s = r["seconds"]
        assert s["host_metrics_s"] > 0 and s["fk_s"] > 0
    assert report["seconds"]["fgd_s"] > 0 and div["seconds"]["fgd_s"] == 0

    mm_argv = [eval_inputs["prefix"], "--reps", "2", "--eval-n", "64",
               "--smplx", asset]
    capsys.readouterr()
    _jax_tool(monkeypatch, "evaluate_mm", mm_argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mm = evaluate_mm.main(mm_argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) == ["multimodality"]
    assert got["multimodality"] == mm["multimodality"] == pytest.approx(
        want["multimodality"], rel=1e-4, abs=0)


def test_entry_points_need_a_card_unless_told(eval_inputs, monkeypatch):
    from raggesture_tpu_torch.eval.evaluator import Evaluator
    from raggesture_tpu_torch.models.smplx import synthetic_model
    from raggesture_tpu_torch.tools import evaluate, evaluate_divonly
    from raggesture_tpu_torch.tools import evaluate_mm

    proc = subprocess.run(
        [sys.executable, "-m", "raggesture_tpu_torch.tools.evaluate",
         eval_inputs["root"]], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
        timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, arg in ((evaluate.main, eval_inputs["root"]),
                      (evaluate_divonly.main, eval_inputs["root"]),
                      (evaluate_mm.main, eval_inputs["prefix"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([arg])
    for make in (Evaluator, synthetic_model,
                 lambda: evaluate.build_fgd_fn("unused")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
