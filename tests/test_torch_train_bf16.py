"""bf16 mixed precision in the training step (``bf16_compute``), the port
against the JAX package on the CPU: one step's loss and gradients, a
2-step multi-step's logs and parameters, the dtypes the forward sees and
those the master parameters and Adam keep, and kernel K3's plain path on
bf16 inputs against JAX's ``cond_contexts`` (forward and vjp).

The JAX draws are made as its ``training_loss`` makes them under
``bf16_compute`` (the encode's eps, the noise and the condition mask in
bf16) and handed to the port.  Both frameworks round the same values to
bf16, but each bf16 product and sum rounds its own way (summation order,
where a float32 result is rounded), so the tolerances are bf16's:
  * the loss and the gradient norm: rtol 5e-3 (about one bf16 ulp; the
    observed loss difference is 1.3e-4);
  * each gradient tensor: its largest difference within 5e-2 of its
    largest element (bf16 keeps 8 bits: a product of rounded operands
    is good to ~4e-3 of its size, and the backward chains a few; observed
    at most 1.7e-2, median 6e-3);
  * the parameters after the steps: Adam moves an element by about lr
    per step whatever its gradient, so the bound is 2 lr per step; the
    mean difference is held to lr / 10;
  * K3 on bf16 inputs: the contexts rtol 2e-5 / atol 2e-6 of scale
    (both frameworks upcast to float32 and run float32 from there, as
    tests/test_torch_cond_ctx.py holds them), the gradients, which come
    back rounded to bf16, to 1e-2 of scale (one bf16 rounding).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import numpy_tree, parity_query_masks_np, t32
from test_torch_train import PARTS, _jax_leaf, _jax_params, _port_batch
from test_torch_train_runtime import _tiny

BF = jnp.bfloat16
LR = 1e-3


def _bf(a):
    """A JAX bf16 array as a torch bf16 tensor (its values exactly)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bf16_draws(rng, jcfg, B=2):
    """The draws of JAX's training_loss(rng) under bf16_compute."""
    r_enc, r_t, r_noise, r_cond, _ = jax.random.split(rng, 5)
    c = jcfg.codec
    shape = (B, c.num_frames // c.frame_chunk_size, c.latent_dim)
    eps = {p: _bf(jax.random.normal(jax.random.fold_in(r_enc, i), shape, BF))
           for i, p in enumerate(PARTS)}
    t = jax.random.randint(r_t, (B,), 0, jcfg.diffusion_train.diffusion_steps)
    noise = jax.random.normal(
        r_noise, (B, jcfg.denoiser.num_tokens, jcfg.denoiser.latent_dim), BF)
    cond = (jax.random.randint(r_cond, (B, 1, 1), 0, 100) % 10 > 0)
    return dict(enc_eps=eps, t=torch.from_numpy(np.array(t)).long(),
                noise=_bf(noise), cond_mask=_bf(cond.astype(BF)))


def _masks(monkeypatch, jcfg, B=2):
    from raggesture_tpu.models import architecture as JA

    masks = parity_query_masks_np(jcfg.denoiser, B)
    monkeypatch.setattr(JA, "default_query_masks", lambda cfg, b: {
        k: jnp.asarray(v) for k, v in masks.items()})
    return {k: t32(v) for k, v in masks.items()}


def _port_state(params, jcfg):
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.train.loop import OptimConfig, create_train_state
    from raggesture_tpu_torch.utils.convert_jax import load_jax_params
    from test_torch_common import port_arch_config

    model = create_model(port_arch_config(jcfg), device="cpu")
    load_jax_params(model, params)
    return create_train_state(model, OptimConfig(lr=LR, total_steps=50,
                                                 bf16_compute=True))


def _zero_exact(name):
    from test_torch_train import _zero_exact_gradient

    return _zero_exact_gradient(name)


def test_bf16_step_loss_and_gradients_match_jax(monkeypatch):
    """One ``bf16_compute`` step: the logs, every denoiser gradient (but
    those zero in exact arithmetic, which are bf16 noise on both sides)."""
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.train.loop import make_train_step

    jcfg, jmodel, params, batch = _tiny()
    qm = _masks(monkeypatch, jcfg)
    sched = jcfg.diffusion_train.schedule()
    rng = jax.random.PRNGKey(9)

    jbatch = JL._cast_floats({k: jnp.asarray(v) for k, v in batch.items()},
                             BF)

    def jloss(p):
        loss, logs = JL.training_loss(
            jmodel, JL._cast_floats(p, BF), sched, jbatch,
            jax.random.fold_in(rng, 0), fused_ctx=True)
        return loss.astype(jnp.float32), logs

    (jl, jlogs), jg = jax.value_and_grad(jloss, has_aux=True)(
        _jax_params(params))
    jg = numpy_tree(jg)["params"]["denoiser"]
    state = _port_state(params, jcfg)
    step = make_train_step(state.model.cfg.diffusion_train.schedule(),
                           bf16_compute=True)
    logs = step(state, _port_batch(batch), query_masks=qm,
                **_bf16_draws(jax.random.fold_in(rng, 0), jcfg))
    np.testing.assert_allclose(logs["recon_loss"].item(), float(jl),
                               rtol=5e-3)
    jnorm = np.sqrt(sum((np.asarray(v, np.float64) ** 2).sum()
                        for v in jax.tree_util.tree_leaves(jg)))
    np.testing.assert_allclose(logs["grad_norm"].item(), jnorm, rtol=5e-3)
    g_scale = max(np.abs(v).max() for v in jax.tree_util.tree_leaves(jg))
    for name, p in state.model.denoiser.named_parameters():
        want = _jax_leaf(jg, name)
        diff = np.abs(p.grad.numpy() - want).max()
        if _zero_exact(name) or not np.abs(want).max():
            # zero in exact arithmetic: bf16 noise on both sides, held to
            # 1e-3 of the step's largest gradient
            assert diff <= 1e-3 * g_scale, (name, diff)
        else:
            assert diff <= 5e-2 * np.abs(want).max(), (name, diff)


def test_bf16_multi_step_matches_jax(monkeypatch):
    """``make_multi_train_step(bf16_compute=True)`` over a stack of two
    batches against JAX's scan: the stacked logs and every denoiser
    parameter after the two steps; the codec bitwise unchanged."""
    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.train.loop import make_multi_train_step

    jcfg, jmodel, params, batch = _tiny()
    qm = _masks(monkeypatch, jcfg)
    k = 2
    other = {n: np.flip(v, axis=0).copy() for n, v in batch.items()}
    stacked = {n: np.stack([batch[n], other[n]]) for n in batch}
    jstate, tx = JL.create_train_state(
        jmodel, _jax_params(params), JL.OptimConfig(lr=LR, total_steps=50))
    multi = JL.make_multi_train_step(
        jmodel, tx, jcfg.diffusion_train.schedule(), bf16_compute=True,
        fused_ctx=True)
    rng = jax.random.PRNGKey(5)
    jstate, jlogs = jax.jit(multi)(jstate, stacked, rng)
    state = _port_state(params, jcfg)
    codec0 = {n: v.clone() for n, v in state.model.codec.state_dict().items()}
    draws = [_bf16_draws(jax.random.fold_in(rng, s), jcfg) for s in range(k)]
    sdraws = {n: (torch.stack([d[n] for d in draws]) if n != "enc_eps" else
                  {p: torch.stack([d[n][p] for d in draws]) for p in PARTS})
              for n in draws[0]}
    logs = make_multi_train_step(state.model.cfg.diffusion_train.schedule(),
                                 bf16_compute=True)(
        state, _port_batch(stacked),
        query_masks={n: v.expand(k, *v.shape) for n, v in qm.items()},
        **sdraws)
    for n in ("recon_loss", "mse_unweighted", "grad_norm"):
        np.testing.assert_allclose(logs[n].numpy(), np.asarray(jlogs[n]),
                                   rtol=5e-3, err_msg=n)
    assert state.step == k
    den = numpy_tree(jstate.params)["params"]["denoiser"]
    for name, p in state.model.denoiser.named_parameters():
        diff = np.abs(p.detach().numpy() - _jax_leaf(den, name))
        assert diff.max() <= 2 * LR * k, (name, diff.max())
        assert diff.mean() <= LR / 10, (name, diff.mean())
    for n, v in state.model.codec.state_dict().items():
        assert torch.equal(v, codec0[n]), n


def test_bf16_forward_sees_bf16_and_the_state_stays_float32():
    """Hooks on the frozen encode's and the condition encoders' Linears see
    bf16 weights, inputs and outputs, the trunk's a float32 product of a
    bf16-rounded weight; after the step every parameter, its gradient and
    Adam's moments are float32."""
    from raggesture_tpu_torch.train.loop import make_train_step

    jcfg, _, params, batch = _tiny()
    state = _port_state(params, jcfg)
    model = state.model
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            w = mod.weight
            seen[name] = (w.dtype, args[0].dtype, out.dtype,
                          torch.equal(w, w.to(torch.bfloat16).to(w.dtype)))
        return fn

    den = model.denoiser
    mods = {"codec": next(m for m in model.codec.modules()
                          if isinstance(m, torch.nn.Linear)),
            "text": den.text_pre_proj,
            "trunk": den.block(0).ffn.linear1}
    handles = [m.register_forward_hook(hook(n)) for n, m in mods.items()]
    step = make_train_step(model.cfg.diffusion_train.schedule(),
                           bf16_compute=True)
    step(state, _port_batch(batch), torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen["codec"] == (bf16, bf16, bf16, True), seen
    assert seen["text"] == (bf16, bf16, bf16, True), seen
    # the trunk starts from the float32 x_t: jnp promotes a bf16 weight to
    # a float32 product, here the float32 value of the bf16 weight
    assert seen["trunk"] == (f32, f32, f32, True), seen
    for name, p in model.named_parameters():
        assert p.dtype == f32, name
        assert p.grad is None or p.grad.dtype == f32, name
    moments = [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0]
    assert moments and all(v.dtype == f32 for v in moments)


def _jax_k3(xf, cm, params, num_heads, w):
    from raggesture_tpu.ops.pallas.cond_ctx_kernel import cond_contexts

    def f(xf, *prm):
        return cond_contexts(xf, jnp.asarray(cm), *prm, num_heads=num_heads,
                             use_kernel=False)

    ins = (jnp.asarray(xf, BF),) + tuple(
        jnp.asarray(p, BF) for p in params)
    ctx, vjp = jax.vjp(f, *ins)
    return ctx, vjp(jnp.asarray(w))


def test_k3_plain_on_bf16_inputs_matches_jax():
    """K3's plain path with bf16 xf and parameters against JAX's
    cond_contexts with the same bf16 inputs: float32 contexts, and dxf,
    d ln_g, d ln_b, dwk, dbk, dwv, dbv back in bf16."""
    from raggesture_tpu_torch.ops.cond_ctx import cond_contexts
    from test_torch_cond_ctx import _head_blocks, _inputs, _to_groups

    H, D = 4, 64
    xf, cm, params = _inputs(3, D=D)
    rng = np.random.RandomState(4)
    w_h = rng.randn(xf.shape[0], params[2].shape[0], H, D // H,
                    D // H).astype(np.float32)
    G, S = 1, D      # JAX's grouping at D 64: one dense group
    ctx_j, grads_j = _jax_k3(xf, cm, params, H, _to_groups(w_h, G, S))
    ins = [t32(a).to(torch.bfloat16).requires_grad_() for a in (xf,) + params]
    ctx = cond_contexts(ins[0], t32(cm), *ins[1:], num_heads=H)
    assert ctx.dtype == torch.float32
    want = _head_blocks(np.asarray(ctx_j), H)
    scale = np.abs(want).max()
    np.testing.assert_allclose(ctx.detach().numpy(), want, rtol=2e-5,
                               atol=2e-6 * scale)
    grads = torch.autograd.grad((ctx * t32(w_h)).sum(), ins)
    g_scale = max(np.abs(np.asarray(g, np.float32)).max() for g in grads_j)
    for name, g, gj in zip(("xf", "ln_g", "ln_b", "wk", "bk", "wv", "bv"),
                           grads, grads_j):
        assert g.dtype == torch.bfloat16 and gj.dtype == BF, name
        gj = np.asarray(gj, np.float32)
        diff = np.abs(g.float().numpy() - gj).max()
        # bk's gradient is zero in exact arithmetic (a per-column shift of
        # the time softmax's logits): float32 noise on both sides
        scale = g_scale if name == "bk" else np.abs(gj).max()
        assert diff <= 1e-2 * scale, (name, diff)


@pytest.mark.parametrize("field,value", [("bf16_conditions", True),
                                         ("fused_ctx", False)])
def test_unported_options_raise(field, value):
    """Both options, once refused, are ported and build: fused_ctx=False
    (the per-layer forward: test_torch_train_fused_ctx.py) and
    bf16_conditions=True (the condition features shipped as bf16, held to
    JAX in test_torch_wire.py); bf16_conditions None or False runs."""
    from raggesture_tpu_torch.train.loop import OptimConfig

    assert getattr(OptimConfig(**{field: value}), field) is value
    OptimConfig(bf16_conditions=False)
    OptimConfig(bf16_conditions=None, fused_ctx=True)
