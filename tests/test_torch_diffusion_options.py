"""The diffusion options of the port against the JAX package's, on the CPU:
every beta schedule (with and without the zero-terminal-SNR rescale),
every respacing string, ``p_mean_variance`` for every mean and variance
type with ``clip_denoised``, ``denoised_fn`` and classifier-free guidance,
the DDPM loop with ``pre_seq`` and ``transl_req`` and the DDIM loop with
``pre_seq`` on JAX's draws, ``clip_denoised`` in the inversion loop, the
variational bound function by function and ``calc_bpd_loop``, and
``make_cfg_model_fn``.

The model functions are small closed forms, the same in both frameworks.
JAX's draws are made from its key as its loops split it and handed to the
port as the loops' draw arguments.

Tolerances: the schedule tables are float64 on the host on both sides,
handed over as float32: 1e-6 relative.  The statistics and the loops are
float32 on both sides: 1e-5 relative and absolute (a step divides by
sqrt(1/abar - 1), which amplifies float32 rounding by up to ~30 at the
smallest t).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import t32

TOL = 1e-5
SCHEDULES = ("linear", "cosine", "scaled_linear")
RESPACINGS = ("ddim50", "ddim10", "fast27", "leading", "trailing",
              "15,15,8,6,6", "10,40", None)
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev",
          "alphas_cumprod_next", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
          "posterior_variance", "posterior_log_variance_clipped",
          "posterior_mean_coef1", "posterior_mean_coef2",
          "fixed_large_variance", "fixed_large_log_variance")


def _tables_equal(got, want):
    for name in TABLES:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == np.float32, name
        # a rescaled schedule's last row is inf / 0 on both sides
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(got.timestep_map.numpy(),
                                  np.asarray(want.timestep_map))
    assert got.num_timesteps == want.num_timesteps
    assert got.original_num_steps == want.original_num_steps


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("rescale", (False, True))
@pytest.mark.parametrize("name", SCHEDULES)
def test_beta_schedule_and_its_tables_match_jax(name, rescale):
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    for steps in (1000, 100):
        np.testing.assert_array_equal(P.get_named_beta_schedule(name, steps),
                                      J.get_named_beta_schedule(name, steps))
        _tables_equal(P.make_schedule(name, steps,
                                      rescale_betas_zero_snr=rescale),
                      J.make_schedule(name, steps,
                                      rescale_betas_zero_snr=rescale))
    betas = P.get_named_beta_schedule(name, 1000)
    np.testing.assert_array_equal(P.rescale_zero_terminal_snr(betas),
                                  J.rescale_zero_terminal_snr(betas))
    assert P.rescale_zero_terminal_snr(betas)[-1] == 1.0


def test_betas_for_alpha_bar_clips_at_max_beta():
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    def bar(t):
        return 1.0 - t
    for max_beta in (0.999, 0.5):
        got = P.betas_for_alpha_bar(20, bar, max_beta)
        np.testing.assert_array_equal(got, J.betas_for_alpha_bar(20, bar,
                                                                 max_beta))
        assert got.max() == max_beta
    with pytest.raises(NotImplementedError):
        P.get_named_beta_schedule("sigmoid", 10)


@pytest.mark.parametrize("respace", RESPACINGS)
def test_respacing_matches_jax(respace):
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    n = 50 if respace in ("leading", "trailing", "15,15,8,6,6") else None
    if respace is not None:
        assert (P.space_timesteps(1000, respace, n)
                == J.space_timesteps(1000, respace, n))
    for name in ("cosine", "linear"):
        _tables_equal(P.make_schedule(name, 1000, respace, n),
                      J.make_schedule(name, 1000, respace, n))
    _tables_equal(P.make_schedule("scaled_linear", 1000, respace, n, True),
                  J.make_schedule("scaled_linear", 1000, respace, n, True))


def test_respacing_of_a_sequence_and_at_other_lengths_matches_jax():
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    for steps, respace, n in ((1000, [3, 7, 10], 20), (100, "ddim3", None),
                              (100, "trailing", 7), (100, "leading", 7),
                              (37, "4,4,4", None), (1000, "fast27", None)):
        assert (P.space_timesteps(steps, respace, n)
                == J.space_timesteps(steps, respace, n)), respace
        _tables_equal(P.make_schedule("cosine", steps, respace, n),
                      J.make_schedule("cosine", steps, respace, n))


@pytest.mark.parametrize("args,error", [
    ((1000, "ddim999"), ValueError),       # no integer stride gives 999
    ((10, "6,6"), ValueError),             # a section of 5 steps into 6
    ((1000, "leading"), AssertionError),   # no num_inference_timesteps
    ((1000, "trailing"), AssertionError),
    ((1000, "10,10", 30), AssertionError),  # sections sum to 20, not 30
])
def test_respacing_raises_where_jax_raises(args, error):
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    with pytest.raises(error):
        J.space_timesteps(*args)
    with pytest.raises(error):
        P.space_timesteps(*args)


# --------------------------------------------------------- p_mean_variance

MEANS = ("start_x", "epsilon", "v_pred", "previous_x")
VARS = ("fixed_large", "fixed_small", "learned", "learned_range")


def _schedules():
    from raggesture_tpu.diffusion import schedules as J
    from raggesture_tpu_torch.diffusion import schedules as P

    args = ("cosine", 1000, "ddim10")
    return P.make_schedule(*args), J.make_schedule(*args)


def _inputs(seed, B=4, C=6, D=5, out_rows=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, D).astype(np.float32)
    out = (1.5 * rng.randn(out_rows or B, C, D)).astype(np.float32)
    t = np.asarray([0, 3, 7, 9, 5, 1][:B], np.int64)
    return x, out, t


def _pmv_both(psched, jsched, x, out, t, mean, var, **kw):
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu_torch.diffusion import gaussian as PG

    pfn = kw.pop("pfn", None)
    jfn = kw.pop("jfn", None)
    got = PG.p_mean_variance(psched, t32(out), t32(x), torch.from_numpy(t),
                             PG.MeanType(mean), PG.VarType(var),
                             denoised_fn=pfn, **kw)
    want = JG.p_mean_variance(jsched, jnp.asarray(out), jnp.asarray(x),
                              jnp.asarray(t, jnp.int32), JG.MeanType(mean),
                              JG.VarType(var), denoised_fn=jfn, **kw)
    return got, want


def _stats_equal(got, want, what):
    for name in ("mean", "variance", "log_variance", "pred_xstart", "eps"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, (what, name)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("mean", MEANS)
def test_p_mean_variance_matches_jax(mean, var):
    """Every mean x variance type, plain, with clip_denoised, with a
    denoised_fn, and with both (the learned variances take a model output
    of twice x's axis 1: prediction, then variance values)."""
    psched, jsched = _schedules()
    learned = var.startswith("learned")
    x, out, t = _inputs(1)
    if learned:
        out = np.concatenate([out, np.tanh(out[:, ::-1])], axis=1)
    for kw in ({}, {"clip_denoised": True},
               {"pfn": lambda a: 0.5 * torch.tanh(a) + 0.2,
                "jfn": lambda a: 0.5 * jnp.tanh(a) + 0.2},
               {"clip_denoised": True, "pfn": lambda a: 3.0 * a,
                "jfn": lambda a: 3.0 * a}):
        got, want = _pmv_both(psched, jsched, x, out, t, mean, var,
                              **dict(kw))
        _stats_equal(got, want, f"{mean}/{var}/{sorted(kw)}")


def test_v_pred_leaves_its_x0_unprocessed_and_others_clip():
    psched, jsched = _schedules()
    x, out, t = _inputs(2)
    out = 40.0 * out    # x0 predictions far outside [-1, 1]
    for mean in MEANS:
        got, want = _pmv_both(psched, jsched, x, out, t, mean, "fixed_large",
                              clip_denoised=True)
        _stats_equal(got, want, mean)
        beyond = got.pred_xstart.abs().max().item() > 1.0
        assert beyond == (mean == "v_pred"), mean


def test_learned_variance_splits_the_token_axis_as_jax_does():
    """A model output of x's shape (the motion latents' case) splits along
    axis 1 into the whole prediction and an empty variance, in both."""
    psched, jsched = _schedules()
    x, out, t = _inputs(3)
    for var in ("learned", "learned_range"):
        got, want = _pmv_both(psched, jsched, x, out, t, "start_x", var)
        assert tuple(got.variance.shape) == (4, 0, 5)
        _stats_equal(got, want, var)


@pytest.mark.parametrize("mean", ("start_x", "epsilon"))
@pytest.mark.parametrize("var", ("fixed_large", "fixed_small"))
def test_cfg_statistics_match_jax(mean, var):
    """Guidance: 2B rows of model output, unconditioned first, B rows of x,
    every statistic B rows; with clip_denoised and a denoised_fn too."""
    psched, jsched = _schedules()
    x, out, t = _inputs(4, out_rows=8)
    for kw in ({}, {"clip_denoised": True, "pfn": lambda a: 0.7 * a,
                    "jfn": lambda a: 0.7 * a}):
        got, want = _pmv_both(psched, jsched, x, out, t, mean, var,
                              cfg_scale=2.5, **dict(kw))
        assert tuple(got.mean.shape) == x.shape
        _stats_equal(got, want, f"cfg {mean}/{var}/{sorted(kw)}")


@pytest.mark.parametrize("mean,var", [
    ("start_x", "learned"), ("epsilon", "learned_range"),
    ("previous_x", "fixed_large"), ("v_pred", "fixed_small")])
def test_cfg_raises_where_jax_raises(mean, var):
    psched, jsched = _schedules()
    x, out, t = _inputs(5, out_rows=8)
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu_torch.diffusion import gaussian as PG

    with pytest.raises(NotImplementedError):
        JG.p_mean_variance(jsched, jnp.asarray(out), jnp.asarray(x),
                           jnp.asarray(t, jnp.int32), JG.MeanType(mean),
                           JG.VarType(var), cfg_scale=1.5)
    with pytest.raises(NotImplementedError):
        PG.p_mean_variance(psched, t32(out), t32(x), torch.from_numpy(t),
                           PG.MeanType(mean), PG.VarType(var),
                           cfg_scale=1.5)


def test_conversions_match_jax():
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu_torch.diffusion import gaussian as PG

    psched, jsched = _schedules()
    x, out, t = _inputs(6)
    t = np.maximum(t, 1)
    for fn in ("predict_xstart_from_eps", "predict_eps_from_xstart",
               "predict_xstart_from_v", "predict_eps_from_v",
               "predict_xstart_from_xprev"):
        got = getattr(PG, fn)(psched, t32(x), torch.from_numpy(t), t32(out))
        want = getattr(JG, fn)(jsched, jnp.asarray(x),
                               jnp.asarray(t, jnp.int32), jnp.asarray(out))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=fn)


# ------------------------------------------------------------------ loops

W = np.random.RandomState(7).randn(5, 5).astype(np.float32) / 3


def _model_fns(rows=1):
    """The same model function in both frameworks: tanh(x W) scaled by
    the original timestep (``rows`` 2: the guidance contract's 2B rows,
    the unconditioned half damped)."""
    Wp, Wj = t32(W), jnp.asarray(W)

    def pfn(x, t_orig, i):
        y = torch.tanh(x @ Wp) * (1.0 + t_orig.float() / 1000.0)[:, None,
                                                                  None]
        return y if rows == 1 else torch.cat([0.5 * y, y])

    def jfn(x, t_orig, i):
        y = jnp.tanh(x @ Wj) * (1.0 + t_orig / 1000.0)[:, None, None]
        return y if rows == 1 else jnp.concatenate([0.5 * y, y])

    return pfn, jfn


def _ddpm_draws(key, S, B, T, D, L, K):
    """JAX's ddpm_sample_loop draws: per step (S-1 first) ``r, r_noise,
    r_pre, r_tr = split(r, 4)``, the step noise, the prefix noise, and
    ``fold_in(r_tr, k)`` for pinned row k; indexed by spaced step."""
    step = np.zeros((S, B, T, D), np.float32)
    pre = np.zeros((S, B, L, D), np.float32)
    tr = np.zeros((S, K, 2), np.float32)
    r = key
    for i in range(S - 1, -1, -1):
        r, r_n, r_p, r_t = jax.random.split(r, 4)
        step[i] = jax.random.normal(r_n, (B, T, D))
        pre[i] = jax.random.normal(r_p, (B, L, D))
        for k in range(K):
            tr[i, k] = jax.random.normal(jax.random.fold_in(r_t, k), (2,))
    return step, pre, tr


@pytest.mark.parametrize("case", ("start_x_large", "epsilon_small_clip",
                                  "start_x_large_cfg"))
def test_ddpm_loop_with_pre_seq_and_transl_req_matches_jax(case):
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.diffusion import sampling as JS
    from raggesture_tpu_torch.diffusion import gaussian as PG
    from raggesture_tpu_torch.diffusion import sampling as PS

    from raggesture_tpu.diffusion.schedules import make_schedule as jmake
    from raggesture_tpu_torch.diffusion.schedules import make_schedule as pmake

    args = ("linear", 100, "ddim3")
    psched, jsched = pmake(*args), jmake(*args)
    S, B, T, D, L = psched.num_timesteps, 2, 6, 5, 2
    mean, var, extra = {
        "start_x_large": ("start_x", "fixed_large", {}),
        "epsilon_small_clip": ("epsilon", "fixed_small",
                               {"clip_denoised": True}),
        "start_x_large_cfg": ("start_x", "fixed_large",
                                     {"cfg_scale": 2.0}),
    }[case]
    pfn, jfn = _model_fns(2 if "cfg_scale" in extra else 1)
    rng = np.random.RandomState(8)
    noise = rng.randn(B, T, D).astype(np.float32)
    pre_seq = rng.randn(B, L, D).astype(np.float32)
    transl = np.asarray([[3, 0.25, -0.5], [1, 1.5, 0.75]], np.float32)
    key = jax.random.PRNGKey(11)
    want = JS.ddpm_sample_loop(
        jfn, jsched, jnp.asarray(noise), key, mean_type=JG.MeanType(mean),
        var_type=JG.VarType(var), pre_seq=jnp.asarray(pre_seq),
        transl_req=transl, **extra)
    step, pre, tr = _ddpm_draws(key, S, B, T, D, L, len(transl))
    got = PS.ddpm_sample_loop(
        pfn, psched, t32(noise), mean_type=PG.MeanType(mean),
        var_type=PG.VarType(var), pre_seq=t32(pre_seq),
        transl_req=torch.from_numpy(transl), step_noise=t32(step),
        pre_seq_noise=t32(pre), transl_noise=t32(tr), **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the same from a generator: the draws in the documented order
    g = torch.Generator().manual_seed(0)
    a = PS.ddpm_sample_loop(pfn, psched, t32(noise), pre_seq=t32(pre_seq),
                            transl_req=transl, generator=g,
                            mean_type=PG.MeanType(mean),
                            var_type=PG.VarType(var), **extra)
    g = torch.Generator().manual_seed(0)
    drawn = [torch.randn(s, generator=g) for s in
             ((S, B, T, D), (S, B, L, D), (S, len(transl), 2))]
    b = PS.ddpm_sample_loop(pfn, psched, t32(noise), pre_seq=t32(pre_seq),
                            transl_req=transl, step_noise=drawn[0],
                            pre_seq_noise=drawn[1], transl_noise=drawn[2],
                            mean_type=PG.MeanType(mean),
                            var_type=PG.VarType(var), **extra)
    assert torch.equal(a, b)


def test_ddpm_pinning_overwrites_the_two_first_positions_at_each_step():
    """The last step (t = 0) pins q_sample(v) at abar_0 ~ 1 and adds no
    noise; the model here is the identity on x0, so the pinned values come
    out within the q_sample noise of abar_0."""
    from raggesture_tpu_torch.diffusion import sampling as PS
    from raggesture_tpu_torch.diffusion.schedules import make_schedule

    sched = make_schedule("linear", 100, "ddim3")
    transl = np.asarray([[2, 0.3, -0.7]], np.float32)
    seen = []

    def fn(x, t_orig, i):
        seen.append(x[:, 0:2, 2].clone())
        return x

    PS.ddpm_sample_loop(fn, sched, torch.zeros(2, 6, 5),
                        transl_req=transl,
                        generator=torch.Generator().manual_seed(0))
    last = seen[-1]
    np.testing.assert_allclose(last.numpy(), [[0.3, -0.7]] * 2, atol=0.05)
    assert torch.equal(last[0], last[1])


@pytest.mark.parametrize("mean,var,in_seq", [
    ("epsilon", "fixed_small", False), ("v_pred", "learned_range", True),
    ("start_x", "fixed_large", True)])
def test_ddim_loop_with_pre_seq_matches_jax(mean, var, in_seq):
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.diffusion import sampling as JS
    from raggesture_tpu.diffusion.schedules import make_schedule as jmake
    from raggesture_tpu_torch.diffusion import gaussian as PG
    from raggesture_tpu_torch.diffusion import sampling as PS
    from raggesture_tpu_torch.diffusion.schedules import make_schedule as pmake

    # linear betas: cosine's last step (abar ~2e-9) makes V_PRED's x0
    # sqrt(1/abar) ~ 2e4 times its float32 rounding, in either framework
    args = ("linear", 1000, "trailing", 3)
    psched, jsched = pmake(*args), jmake(*args)
    S, B, T, D, L = psched.num_timesteps, 2, 6, 5, 2   # trailing: 4 steps
    pfn, jfn = _model_fns()
    rng = np.random.RandomState(9)
    noise = rng.randn(B, T, D).astype(np.float32)
    pre_seq = rng.randn(B, L, D).astype(np.float32)
    seq = np.zeros((B, T, D), np.float32)
    seq[:, 4] = rng.randn(B, D)
    key = jax.random.PRNGKey(12)
    kw = dict(clip_denoised=True) if mean == "epsilon" else {}
    want = JS.ddim_sample_loop(
        jfn, jsched, jnp.asarray(noise), key, mean_type=JG.MeanType(mean),
        var_type=JG.VarType(var), pre_seq=jnp.asarray(pre_seq),
        in_seq=jnp.asarray(seq) if in_seq else None, **kw)
    # JAX: with in_seq, rng, r_bulk = split(rng) first; then per step
    # r, r_pre, r_noise = split(r, 3)
    r = key
    bulk = None
    if in_seq:
        r, r_bulk = jax.random.split(r)
        bulk = t32(jax.random.normal(r_bulk, (S, B, T, D)))
    pre = np.zeros((S, B, L, D), np.float32)
    for i in range(S - 1, -1, -1):
        r, r_p, _ = jax.random.split(r, 3)
        pre[i] = jax.random.normal(r_p, (B, L, D))
    got = PS.ddim_sample_loop(
        pfn, psched, t32(noise), mean_type=PG.MeanType(mean),
        var_type=PG.VarType(var), pre_seq=t32(pre_seq),
        pre_seq_noise=t32(pre), in_seq=t32(seq) if in_seq else None,
        in_seq_noise=bulk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_reverse_and_guided_loops_take_clip_denoised_as_jax():
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.diffusion import sampling as JS
    from raggesture_tpu_torch.diffusion import gaussian as PG
    from raggesture_tpu_torch.diffusion import sampling as PS

    psched, jsched = _schedules()
    pfn, jfn = _model_fns()
    x0 = 2.0 * np.random.RandomState(10).randn(2, 6, 5).astype(np.float32)
    kw = dict(clip_denoised=True)
    want = JS.ddim_reverse_sample_loop(
        jfn, jsched, jnp.asarray(x0), mean_type=JG.MeanType.EPSILON,
        var_type=JG.VarType.FIXED_SMALL, **kw)
    got = PS.ddim_reverse_sample_loop(
        pfn, psched, t32(x0), mean_type=PG.MeanType.EPSILON,
        var_type=PG.VarType.FIXED_SMALL, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the guided loop: its bulk draw from split(rng) as JAX's
    S = psched.num_timesteps
    key = jax.random.PRNGKey(13)
    inv = np.array(want)
    inv[:, :, 3:] = 0.0
    jw = JS.ddim_guided_sample_loop(
        jfn, jsched, jnp.asarray(x0), key, inverted_latents=jnp.asarray(inv),
        guidance_iters=np.zeros(S, np.int32), mean_type=JG.MeanType.EPSILON,
        var_type=JG.VarType.FIXED_SMALL, **kw)
    _, r_bulk = jax.random.split(key)
    bulk = t32(jax.random.normal(r_bulk, (S,) + x0.shape))
    pg = PS.ddim_guided_sample_loop(
        pfn, psched, t32(x0), inverted_latents=t32(inv), guidance_iters=None,
        in_seq_noise=bulk, mean_type=PG.MeanType.EPSILON,
        var_type=PG.VarType.FIXED_SMALL, **kw)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jw), rtol=TOL,
                               atol=TOL)
    unclipped = PS.ddim_guided_sample_loop(
        pfn, psched, t32(x0), inverted_latents=t32(inv), guidance_iters=None,
        in_seq_noise=bulk, mean_type=PG.MeanType.EPSILON,
        var_type=PG.VarType.FIXED_SMALL)
    assert not torch.allclose(pg, unclipped)


def test_cfg_model_fn_orders_uncond_first_as_jax():
    from raggesture_tpu.models.conditioning import make_cfg_model_fn as jmake
    from raggesture_tpu_torch.models.conditioning import (
        make_cfg_model_fn as pmake,
    )

    rng = np.random.RandomState(11)
    B, T, D = 2, 6, 5
    conds = {"c": rng.randn(B, 3, D).astype(np.float32)}
    mask = np.ones((B, T), np.float32)
    qm = {"c": rng.rand(B, T).astype(np.float32)}
    x = rng.randn(B, T, D).astype(np.float32)
    t = np.asarray([7, 300])

    def papply(x2, t2, m2, c2, q2, cm):
        return (x2 * cm + c2["c"].mean(1, keepdim=True) * (1 - cm)
                + q2["c"][..., None] * t2[:, None, None] / 100 + m2[..., None])

    def japply(x2, t2, m2, c2, q2, cm):
        return (x2 * cm + c2["c"].mean(1, keepdims=True) * (1 - cm)
                + q2["c"][..., None] * t2[:, None, None] / 100 + m2[..., None])

    got = pmake(papply, {k: t32(v) for k, v in conds.items()}, t32(mask),
                {k: t32(v) for k, v in qm.items()})(t32(x),
                                                    torch.from_numpy(t), 0)
    want = jmake(japply, {k: jnp.asarray(v) for k, v in conds.items()},
                 jnp.asarray(mask), {k: jnp.asarray(v) for k, v in
                                     qm.items()})(jnp.asarray(x),
                                                  jnp.asarray(t), 0)
    assert tuple(got.shape) == (2 * B, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the unconditioned rows first: they read the conditions' mean
    assert not np.allclose(got[:B].numpy(), got[B:].numpy())
    np.testing.assert_allclose(got[B:].numpy(), np.asarray(want)[B:])


def test_jax_guidance_through_a_b_row_model_fn_mixes_other_samples():
    """The reference fault the port refuses (architecture._no_guidance):
    JAX's ``generate`` and ``StagedGenerator`` build the scale function's
    (or the conditioned) model function, which returns B rows, and pass
    ``classifier_free_guidance_scale`` on to ``p_mean_variance``, whose
    guidance takes 2B rows, unconditioned first.  At B = 2 it takes sample
    0's row as the unconditioned and sample 1's as the conditioned half of
    BOTH samples; at B = 1 it raises."""
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.models.conditioning import make_mixed_model_fn

    _, jsched = _schedules()
    rng = np.random.RandomState(12)
    B, T, D = 2, 6, 5
    x = jnp.asarray(rng.randn(B, T, D).astype(np.float32))
    coef = jnp.asarray(rng.rand(10, 4).astype(np.float32))

    def apply(x2, t2, m2, c2, q2, cm):
        return jnp.tanh(x2) * (1 + cm) + c2["c"].mean(1, keepdims=True)

    fn = make_mixed_model_fn(apply, {"c": jnp.asarray(
        rng.randn(B, 3, D).astype(np.float32))}, jnp.ones((B, T)), None,
        coef, jnp.ones((T,)))
    t = jnp.asarray([4, 4], jnp.int32)
    out = fn(x, t, 4)
    assert out.shape == (B, T, D)                  # B rows, not 2B
    got = JG.p_mean_variance(jsched, out, x, t, cfg_scale=2.0)
    assert got.pred_xstart.shape == (B, T, D)      # no error at B = 2 ...
    # ... and each sample's guided eps mixes rows 0 and 1 of the batch
    eps0 = JG.predict_eps_from_xstart(jsched, x, t, out[:1])
    eps1 = JG.predict_eps_from_xstart(jsched, x, t, out[1:])
    np.testing.assert_allclose(np.asarray(got.eps),
                               np.asarray(eps0 + 2.0 * (eps1 - eps0)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        JG.p_mean_variance(jsched, out[:1], x[:1], t[:1], cfg_scale=2.0)


# -------------------------------------------------------------------- VLB

def test_vlb_functions_match_jax():
    from raggesture_tpu.diffusion import vlb as J
    from raggesture_tpu_torch.diffusion import vlb as P

    rng = np.random.RandomState(13)
    a, b, c, d = (rng.randn(3, 4, 5).astype(np.float32) for _ in range(4))
    x = np.clip(rng.randn(3, 4, 5), -1.2, 1.2).astype(np.float32)
    x[0, 0, :3] = [-1.0, 1.0, 0.9995]       # the edge bins
    cases = [
        ("normal_kl", (a, b, c, d), {}),
        ("normal_kl", (a, b, 0.0, 0.0), {}),
        ("approx_standard_normal_cdf", (3 * a,), {}),
        # means near x, scales ~ 1/50: the bins' probabilities stay above
        # float32's resolution of a CDF near 1 (in the far tails each
        # framework's tanh rounds cdf_plus - cdf_min to its own noise)
        ("discretized_gaussian_log_likelihood", (x,),
         {"means": x + 0.02 * b, "log_scales": -4.0 + 0.3 * c}),
    ]
    for fn, args, kw in cases:
        got = getattr(P, fn)(*[t32(v) if isinstance(v, np.ndarray) else v
                               for v in args],
                             **{k: t32(v) for k, v in kw.items()})
        want = getattr(J, fn)(*[jnp.asarray(v) for v in args],
                              **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=fn)


@pytest.mark.parametrize("mean,var", [("start_x", "fixed_large"),
                                      ("epsilon", "fixed_small"),
                                      ("v_pred", "learned_range")])
def test_vb_terms_and_prior_bpd_match_jax(mean, var):
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.diffusion import vlb as J
    from raggesture_tpu_torch.diffusion import gaussian as PG
    from raggesture_tpu_torch.diffusion import vlb as P

    psched, jsched = _schedules()
    x0, out, t = _inputs(14)
    x0 = np.clip(x0, -1, 1)
    xt, _, _ = _inputs(15)
    if var.startswith("learned"):
        out = np.concatenate([out, np.tanh(out)], axis=1)
    for clip in (True, False):
        got = P.vb_terms_bpd(t32(out), psched, t32(x0), t32(xt),
                             torch.from_numpy(t), mean_type=PG.MeanType(mean),
                             var_type=PG.VarType(var), clip_denoised=clip)
        want = J.vb_terms_bpd(jnp.asarray(out), jsched, jnp.asarray(x0),
                              jnp.asarray(xt), jnp.asarray(t, jnp.int32),
                              mean_type=JG.MeanType(mean),
                              var_type=JG.VarType(var), clip_denoised=clip)
        for k in ("output", "pred_xstart"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(P.prior_bpd(psched, t32(x0)).numpy(),
                               np.asarray(J.prior_bpd(jsched,
                                                      jnp.asarray(x0))),
                               rtol=TOL, atol=1e-7)


def test_calc_bpd_loop_matches_jax_over_a_respaced_schedule():
    from raggesture_tpu.diffusion import gaussian as JG
    from raggesture_tpu.diffusion import vlb as J
    from raggesture_tpu.diffusion.schedules import make_schedule as jmake
    from raggesture_tpu_torch.diffusion import gaussian as PG
    from raggesture_tpu_torch.diffusion import vlb as P
    from raggesture_tpu_torch.diffusion.schedules import make_schedule as pmake

    args = ("cosine", 1000, "ddim4")
    psched, jsched = pmake(*args), jmake(*args)
    S = psched.num_timesteps
    pfn, jfn = _model_fns()
    x0 = np.tanh(np.random.RandomState(16).randn(3, 6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    want = J.calc_bpd_loop(jfn, jsched, jnp.asarray(x0), key,
                           mean_type=JG.MeanType.EPSILON,
                           var_type=JG.VarType.FIXED_SMALL)
    noise = np.zeros((S,) + x0.shape, np.float32)
    r = key
    for i in range(S - 1, -1, -1):
        r, r_n = jax.random.split(r)
        noise[i] = jax.random.normal(r_n, x0.shape)
    got = P.calc_bpd_loop(pfn, psched, t32(x0), noise=t32(noise),
                          mean_type=PG.MeanType.EPSILON,
                          var_type=PG.VarType.FIXED_SMALL)
    assert sorted(got) == sorted(want) == ["mse", "prior_bpd", "total_bpd",
                                           "vb", "xstart_mse"]
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    a = P.calc_bpd_loop(pfn, psched, t32(x0),
                        generator=torch.Generator().manual_seed(3))
    b = P.calc_bpd_loop(pfn, psched, t32(x0), noise=torch.randn(
        (S,) + x0.shape, generator=torch.Generator().manual_seed(3)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        P.calc_bpd_loop(pfn, psched, t32(x0))
