"""The port's rendering (``utils/visualization.py``) against the JAX
package's on ``tests/test_visualization.py``'s inputs, and the serving
tool's ``--render`` end to end on the CPU.

Tolerances: vertices and joints within 1e-5 (float32 FK on both sides),
the framing within 1e-6, the floor exact; frames equal to JAX's on at
least 99.9 % of pixels (the rasterizers share their arithmetic, float64
screen space, but the float32 camera transform and shading may round an
edge pixel or a shade step apart), and bitwise equal between two runs.
~23 s on one worker.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from test_dataset_build import make_raw_beat2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs/raggesture_beatx/tiny_smoke.py")
PIXELS = 0.999


def _same_pixels(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).all(axis=-1).mean())


def _npz(path, T=8, dim=165, seed=0):
    from raggesture_tpu.utils.motion_io import save_smplx_npz

    rng = np.random.RandomState(seed)
    save_smplx_npz(path, rng.randn(T, dim).astype(np.float32) * 0.1,
                   rng.randn(T, 100).astype(np.float32),
                   rng.randn(T, 3).astype(np.float32) * 0.01)
    return path


@pytest.fixture(scope="module")
def rigs():
    from raggesture_tpu.models.smplx import synthetic_model as jax_model

    from raggesture_tpu_torch.models.smplx import synthetic_model

    return jax_model(), synthetic_model(device="cpu")


def test_helpers_match_jax(tmp_path, rigs):
    from raggesture_tpu.utils import visualization as J

    from raggesture_tpu_torch.utils import visualization as P

    poses = np.zeros((10, 165))
    poses[3:7] = 1.0
    assert P.active_frame_range(poses) == J.active_frame_range(poses)
    np.testing.assert_array_equal(P.active_frame_mask(poses),
                                  J.active_frame_mask(poses))
    assert P._SMPLX_PARENTS == J._SMPLX_PARENTS
    for y, length in ((0.5, 4.0), (-0.3, 12.0)):
        for a, b in zip(P.checkerboard_floor(y, length),
                        J.checkerboard_floor(y, length)):
            np.testing.assert_array_equal(a, b)
    verts = np.random.RandomState(0).randn(5, 20, 3).astype(np.float32)
    mask = np.array([False, True, True, True, False])
    (pp, pf), (jp, jf) = (P.compute_auto_framing(verts, mask),
                          J.compute_auto_framing(verts, mask))
    np.testing.assert_allclose(pp, jp, atol=1e-6)
    assert abs(pf - jf) <= 1e-6
    # the skeleton's surrogate FK and SMPL-X FK
    gt = _npz(str(tmp_path / "gt.npz"))
    np.testing.assert_allclose(P.joints_from_npz(gt), J.joints_from_npz(gt),
                               atol=1e-5)


def test_vertices_joints_and_anchor_match_jax(tmp_path, rigs):
    from raggesture_tpu.utils import visualization as J
    from raggesture_tpu.utils.motion_io import save_smplx_npz

    from raggesture_tpu_torch.utils import visualization as P

    jm, pm = rigs
    T, nj = 6, 4
    poses = np.zeros((T, nj * 3), np.float32)
    poses[1:] = np.random.RandomState(1).randn(T - 1, nj * 3) * 0.2
    trans = np.tile(np.array([[0.1, 0.2, 0.3]], np.float32), (T, 1))
    p = str(tmp_path / "m.npz")
    save_smplx_npz(p, poses, np.zeros((T, 5), np.float32), trans)
    got = P.vertices_from_npz(p, pm, batch=4)
    np.testing.assert_allclose(got, J.vertices_from_npz(p, jm, batch=4),
                               atol=1e-5)
    np.testing.assert_allclose(got[0], pm.v_template.numpy() + trans[0],
                               atol=1e-5)
    np.testing.assert_allclose(P.joints_from_npz(p, pm),
                               J.joints_from_npz(p, jm), atol=1e-5)
    np.testing.assert_allclose(P.smplx_active_anchor(p, pm),
                               J.smplx_active_anchor(p, jm), atol=1e-5)


def test_rasterizer_matches_jax_and_repeats(rigs):
    from raggesture_tpu.models.smplx import synthetic_faces
    from raggesture_tpu.utils import visualization as J

    from raggesture_tpu_torch.utils import visualization as P

    # the z-test: two stacked triangles, the near one wins; background kept
    cam = np.eye(4, dtype=np.float32)
    verts = np.array([[-1, -1, -2.0], [1, -1, -2.0], [0, 1, -2.0],
                      [-1, -1, -4.0], [1, -1, -4.0], [0, 1, -4.0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    img = P.rasterize_mesh(verts, faces, colors, cam, 64, 64,
                           bg=(10, 10, 10), device="cpu")
    assert img[32, 32, 0] > img[32, 32, 1] and tuple(img[0, 0]) == (10,) * 3
    np.testing.assert_array_equal(
        img, J.rasterize_mesh(verts, faces, colors, cam, 64, 64,
                              bg=(10, 10, 10)))
    # coincident triangles: at equal depth the later one wins, as JAX's
    # stable far-to-near paint
    tie = P.rasterize_mesh(np.concatenate([verts[:3], verts[:3]]),
                           faces, colors, cam, 32, 32, device="cpu")
    np.testing.assert_array_equal(
        tie, J.rasterize_mesh(np.concatenate([verts[:3], verts[:3]]), faces,
                              colors, cam, 32, 32))
    assert tie[16, 16, 1] > tie[16, 16, 0]
    # mesh frames over the floor, an inactive frame floor only
    jm, _ = rigs
    T = 3
    seq = np.tile(np.asarray(jm.v_template)[None], (T, 1, 1))
    seq[2] += 0.05
    active = np.array([True, False, True])
    cam, floor_y = J.compute_auto_framing(seq, active)
    want = J.software_mesh_frames(seq, synthetic_faces(), active, cam,
                                  floor_y, width=96, height=128)
    got = P.software_mesh_frames(seq, synthetic_faces(), active, cam,
                                 floor_y, width=96, height=128, device="cpu")
    again = P.mesh_frames(torch.from_numpy(seq), synthetic_faces(), active,
                          cam, floor_y, width=96, height=128)
    for g, w, a in zip(got, want, again):
        assert _same_pixels(g, w) >= PIXELS
        np.testing.assert_array_equal(g, a)
    assert not np.array_equal(got[0], got[1])


def test_mesh_side_by_side_matches_jax(tmp_path, rigs):
    from raggesture_tpu.models.smplx import synthetic_faces
    from raggesture_tpu.utils import visualization as J

    from raggesture_tpu_torch.utils import visualization as P

    jm, pm = rigs
    paths = [_npz(str(tmp_path / f"{n}.npz"), T=4, dim=12, seed=s)
             for s, n in enumerate(("gt", "pred"))]
    colors = [P.GT_COLOR, P.PRED_COLOR]
    got = P.mesh_side_by_side_frames(paths, colors, pm, synthetic_faces(),
                                     panel_width=64, panel_height=96)
    want = J._mesh_side_by_side(paths, colors, jm, synthetic_faces(), 600,
                                64, 96)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == (96, 128, 3)
        assert _same_pixels(g, w) >= PIXELS


def test_pyrender_fallback_and_call_contract(monkeypatch):
    """The JAX module's mocked pyrender contract
    (tests/test_visualization.py:148,176) on the port's module: a failing
    EGL context falls back with a warning; the scene assembly."""
    from raggesture_tpu_torch.utils import visualization as V

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_visualization as TV

    monkeypatch.setattr(V, "HAS_PYRENDER", True)
    monkeypatch.setattr(V, "_pyrender_mesh_frames",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("EGL device query failed")))
    verts = np.zeros((2, 4, 3), np.float32)
    verts[:, 1, 0] = verts[:, 2, 1] = verts[:, 3, 2] = 0.5
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    cam, floor_y = V.compute_auto_framing(verts, np.ones(2, bool))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        frames = V.mesh_frames(verts, faces, np.ones(2, bool), cam,
                               floor_y=floor_y, width=64, height=64,
                               device="cpu")
    assert len(frames) == 2 and frames[0].shape == (64, 64, 3)
    assert any("falling back" in str(w.message) for w in rec)
    monkeypatch.undo()
    # the JAX test's scene-assembly contract, run against the port module
    monkeypatch.setattr(TV, "V", V, raising=False)
    import raggesture_tpu.utils as jax_utils

    monkeypatch.setattr(jax_utils, "visualization", V)
    monkeypatch.setitem(sys.modules, "raggesture_tpu.utils.visualization", V)
    TV.test_pyrender_branch_call_contract(monkeypatch)


def test_writer_and_skeleton_name_what_is_missing(tmp_path, monkeypatch):
    from raggesture_tpu_torch.utils import visualization as V

    frames = [np.zeros((8, 8, 3), np.uint8)] * 2
    monkeypatch.setattr(V, "HAS_FFMPEG", False)
    out = V.write_video(frames, str(tmp_path / "v.mp4"), fps=5)
    assert out.endswith(".gif") and os.path.exists(out)
    monkeypatch.setattr(V, "_has_pil", lambda: False)
    with pytest.raises(RuntimeError, match="ffmpeg.*PIL"):
        V.write_video(frames, str(tmp_path / "w.mp4"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        V.skeleton_frames([np.zeros((2, 55, 3), np.float32)], ["x"])


@pytest.fixture
def one_thread():
    """One intra-op thread for the CPU rasterizer: with the test run's
    workers sharing the cores, its scatter passes took ~300 s on eight
    threads a worker against ~18 s on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_serving_tool_renders_gifs_end_to_end(tmp_path, one_thread):
    """``--render --smplx-asset`` on the CPU: the tool writes, for its one
    sample, the GT/prediction GIF and the prediction/retrieval GIF (no
    ffmpeg here), two 320 × 480 mesh panels wide."""
    from PIL import Image

    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.models.smplx import (synthetic_faces,
                                                   synthetic_model)
    from raggesture_tpu_torch.tools import visualize
    from raggesture_tpu_torch.train.checkpoint import save_params
    from test_torch_visualize import _options

    ws = str(tmp_path)
    root = os.path.join(ws, "beat2")
    make_raw_beat2(root, [("2_scott_0_1_1", "train"),
                          ("2_scott_0_3_3", "test")], n_sec=8)
    rig = synthetic_model(num_joints=55, verts_per_joint=4, device="cpu")
    asset = os.path.join(ws, "SMPLX_NEUTRAL_2020.npz")
    n = lambda t: t.numpy()
    np.savez(asset, v_template=n(rig.v_template),
             shapedirs=np.concatenate([n(rig.shapedirs), n(rig.exprdirs)], -1),
             posedirs=n(rig.posedirs), J_regressor=n(rig.j_regressor),
             weights=n(rig.lbs_weights),
             kintree_table=np.stack([n(rig.parents), np.arange(55)]),
             f=synthetic_faces(55, 4))
    opts = _options(ws, root, os.path.join(ws, "cache"))
    cfg = Config.fromfile(CFG)
    cfg.merge_option_strings(opts)
    ckpt = os.path.join(ws, "params.pt")
    save_params(ckpt, create_model(arch_config_from(cfg.model), device="cpu",
                                   seed=0, zero_init_std=0.05))
    report = visualize.main(
        [CFG, ckpt, "--out-dir", os.path.join(ws, "results"), "--device",
         "cpu", "--retrieval-method", "gesture_type", "--test-batchsize",
         "1", "--max-batches", "1", "--render", "--smplx-asset", asset,
         "--options"] + opts)
    videos = report["batches"][0]["videos"]
    assert report["batches"][0]["render_ms"] > 0
    assert any(v.endswith("pred_vs_retrieval.gif") for v in videos)
    for v in videos:
        assert v.endswith(".gif")
        with Image.open(v) as gif:
            assert gif.size == (2 * 320, 480) and gif.n_frames > 1
