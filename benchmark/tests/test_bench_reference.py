"""The plain reference against the port's plain path at a tiny size on the
CPU: the denoiser's forward, the DDIM loop with the scale function's
mixing, the decode and the rotations; and the benchmark's weights loading
strictly into the port's model."""

from __future__ import annotations

import pytest
import torch

from benchmark.reference import model as R
from benchmark.reference.params import make_weights, param_shapes
from benchmark.systems import build

from bench_tiny import flagship, tiny_config

CPU = torch.device("cpu")
KEYS = ("xf_text", "xf_audio", "xf_spk")


@pytest.fixture(scope="module")
def tiny():
    c = tiny_config()
    return c, build.model(c, 5, CPU), make_weights(c, 5, CPU)


def _inputs(c, n=3, seed=0):
    dc, cc = c["denoiser"], c["conditions"]
    g = torch.Generator().manual_seed(seed)
    T = 4 * (dc["max_seq_len"] // dc["frame_chunk_size"]) + 3
    return {"x": torch.randn(n, T, dc["latent_dim"], generator=g),
            "word": torch.randn(n, cc["text_frames"], dc["text_latent_dim"],
                                generator=g),
            "audio": torch.randn(n, cc["audio_frames"],
                                 dc["audio_latent_dim"], generator=g),
            "speaker": torch.arange(n) % dc["num_speakers"],
            "frames": torch.ones(n, dc["max_seq_len"])}


def test_flagship_parameters_are_the_ports():
    from raggesture_tpu_torch.models.architecture import MotionDiffusionModel

    c = flagship()
    with torch.device("meta"):
        m = MotionDiffusionModel(build.arch_config(c))
    want = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert dict(param_shapes(c)) == want
    assert sum(torch.Size(s).numel() for s in want.values()) == 313_875_881


def test_weights_repeat_from_the_seed(tiny):
    c, _, W = tiny
    again = make_weights(c, 5, CPU)
    assert all(torch.equal(W[k], again[k]) for k in W)
    assert not torch.equal(W["denoiser.out.weight"],
                           make_weights(c, 6, CPU)["denoiser.out.weight"])


@pytest.mark.parametrize("quirk", [True, False])
def test_denoiser_forward_matches_the_ports(tiny, quirk):
    c, m, W = tiny
    dc = c["denoiser"]
    i = _inputs(c)
    n, T = i["x"].shape[:2]
    tm = R.token_mask(dc, i["frames"])
    qm = R.query_masks(dc, n, CPU)
    if not quirk:
        L = dc["max_seq_len"] // dc["frame_chunk_size"]
        qm = torch.ones(n, T)
        qm[:, [L, 2 * L + 1, 3 * L + 2]] = 0.0
    t = torch.tensor([999, 400, 3])
    cm = torch.tensor([1.0, 0.0, 1.0])
    with torch.no_grad():
        conds = m.denoiser.encode_conditions(i["word"], i["audio"],
                                             i["speaker"])
        want = m.denoiser(i["x"], t, tm, conds, {k: qm for k in KEYS},
                          cm.reshape(n, 1, 1))
    got = R.denoise(W, dc, i["x"], t, tm, i["word"], i["audio"],
                    i["speaker"], cm, qm)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_ddim_loop_matches_the_ports_plain_loop(tiny):
    from raggesture_tpu_torch.diffusion.sampling import ddim_sample_loop
    from raggesture_tpu_torch.models.conditioning import (
        make_mixed_model_fn,
        scale_func_table,
    )

    c, m, W = tiny
    dc = c["denoiser"]
    i = _inputs(c)
    n = i["x"].shape[0]
    sched = m.cfg.diffusion_test.schedule()
    tm = R.token_mask(dc, i["frames"])
    qm = R.query_masks(dc, n, CPU)
    den = m.denoiser
    with torch.no_grad():
        conds = den.encode_conditions(i["word"], i["audio"], i["speaker"])
        fn = make_mixed_model_fn(
            lambda x, t, mk, cc, q, cm: den(x, t, mk, cc, q, cm), conds, tm,
            {k: qm for k in KEYS},
            scale_func_table(sched, m.cfg.scale_func, 1000,
                             generator=torch.Generator().manual_seed(1)),
            torch.ones(tm.shape[1]))
        want = ddim_sample_loop(fn, sched, i["x"])
    got = R.ddim_sample(W, c, i["x"], i["word"], i["audio"], i["speaker"],
                        i["frames"])
    assert (got - want).norm() <= 1e-4 * want.norm()


def test_decode_matches_the_ports(tiny):
    c, m, W = tiny
    z = _inputs(c)["x"]
    with torch.no_grad():
        want = m.codec.decode(z)
    got = R.decode(W, c["codec"], z)
    for k in ("upper", "hands", "facepose", "lower"):
        mats = R.axis_angle_to_matrix(want[k])
        assert (mats - got[k]).abs().max() <= 1e-4, k
    for k in ("transl", "exps", "contact"):
        assert torch.allclose(got[k], want[k], atol=1e-5), k


def test_rotations_compare_by_the_rotation_they_mean():
    from raggesture_tpu_torch.ops.rotations import d6_feature_to_aa

    g = torch.Generator().manual_seed(3)
    six = torch.randn(4, 7, 5 * 6, generator=g)
    mats = R.d6_to_matrix(six)
    assert (R.axis_angle_to_matrix(d6_feature_to_aa(six)) - mats).abs().max() < 1e-4
    # the same rotation from an axis-angle of the other sign near pi
    axis = torch.nn.functional.normalize(torch.randn(3, generator=g), dim=0)
    a, b = axis * (torch.pi - 1e-4), -axis * (torch.pi - 1e-4)
    assert (R.axis_angle_to_matrix(a) - R.axis_angle_to_matrix(b)).abs().max() < 1e-3
