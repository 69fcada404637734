"""The training forward without fused contexts (``fused_ctx=False``: the
denoiser's per-layer forward, the only one that takes dropout), dropout
from explicit draws, and ``build_optimizers``: the port against its
``fused_ctx=True`` path and against the JAX package, on the same weights
and draws (``test_torch_train.py``'s helpers: JAX's tiny model, its draws
handed to the port, true-separator query masks on both sides).

Tolerances: losses 1e-5 relative; gradients 1e-5 of each tensor's largest
element, and those zero in exact arithmetic (``_zero_exact_gradient``)
1e-5 of the largest gradient of the model, as they hold only rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import numpy_tree, port_arch_config, t32
from test_torch_train import (
    _jax_draws,
    _jax_leaf,
    _jax_params,
    _parity_masks,
    _port_batch,
    _port_model,
    _tiny,
    _zero_exact_gradient,
)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.denoiser.named_parameters()}


def _port_loss_and_grads(model, batch, qm, draws, **kw):
    from raggesture_tpu_torch.models.architecture import training_loss

    model.zero_grad(set_to_none=True)
    loss, logs = training_loss(model, model.cfg.diffusion_train.schedule(),
                               batch, query_masks=qm, return_per_sample=True,
                               **draws, **kw)
    loss.backward()
    return loss.item(), logs, _grads(model)


def _assert_grads(got, want):
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        d = float(np.abs(np.asarray(got[n]) - w).max())
        own = scale if _zero_exact_gradient(n) else float(np.abs(w).max())
        assert d <= 1e-5 * own, (n, d, own)


@pytest.fixture(scope="module")
def jax_flax_path():
    """JAX's training_loss(fused_ctx=False) on the tiny model: the loss, the
    logs and the denoiser's gradients (numpy, in the port's layout), at
    rng 1 (one condition dropped)."""
    from raggesture_tpu.models import architecture as JA

    jcfg, jmodel, params, batch = _tiny()
    rng = jax.random.PRNGKey(1)

    def loss_fn(p):
        return JA.training_loss(jmodel, p, jcfg.diffusion_train.schedule(),
                                batch, rng, return_per_sample=True,
                                fused_ctx=False)

    with pytest.MonkeyPatch.context() as mp:
        masks = _parity_masks(mp, jcfg, 2)
        (v, logs), g = jax.value_and_grad(loss_fn, has_aux=True)(
            _jax_params(params))
    g_den = numpy_tree(g)["params"]["denoiser"]
    model = _port_model(jcfg, params)
    grads = {n: _jax_leaf(g_den, n)
             for n, _ in model.denoiser.named_parameters()}
    return float(v), numpy_tree(logs), grads, _jax_draws(rng, jcfg, 2), masks


def test_per_layer_forward_matches_jax_at_dropout_zero(jax_flax_path,
                                                       monkeypatch):
    """``fused_ctx=False`` against JAX's flax per-layer forward: the loss,
    the logs and every denoiser gradient."""
    v_j, logs_j, g_j, draws, _ = jax_flax_path
    jcfg, _, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    model = _port_model(jcfg, params)
    loss, logs, grads = _port_loss_and_grads(model, _port_batch(batch), qm,
                                             draws, fused_ctx=False)
    np.testing.assert_allclose(loss, v_j, rtol=1e-5)
    for k in ("mse_unweighted", "per_sample_loss"):
        np.testing.assert_allclose(logs[k].detach().numpy(), logs_j[k],
                                   rtol=1e-5, err_msg=k)
    _assert_grads({n: g.numpy() for n, g in grads.items()}, g_j)


def test_per_layer_forward_equals_the_fused_context_path(monkeypatch):
    """At dropout 0 the two training forwards of the port are one function:
    ``fused_ctx=False`` against ``fused_ctx=True`` (the contexts from the
    plain version of K3 on the CPU)."""
    jcfg, _, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    draws = _jax_draws(jax.random.PRNGKey(9), jcfg, 2)
    model = _port_model(jcfg, params)
    pb = _port_batch(batch)
    a = _port_loss_and_grads(model, pb, qm, draws, fused_ctx=False)
    b = _port_loss_and_grads(model, pb, qm, draws, fused_ctx=True)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
    _assert_grads({n: g.numpy() for n, g in a[2].items()},
                  {n: g.numpy() for n, g in b[2].items()})


def test_train_and_val_steps_take_the_per_layer_forward(jax_flax_path,
                                                        monkeypatch):
    """``make_train_step(fused_ctx=False)`` and ``make_val_step``: one step's
    logs against JAX's loss at its draws, the update made; the validation
    logs the same loss without an update."""
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
        make_val_step,
    )

    v_j, _, _, draws, _ = jax_flax_path
    jcfg, _, params, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    model = _port_model(jcfg, params)
    state = create_train_state(model, OptimConfig(lr=1e-3, total_steps=10,
                                                  fused_ctx=False))
    sched = model.cfg.diffusion_train.schedule()
    val = make_val_step(sched, fused_ctx=False)(state, _port_batch(batch),
                                                query_masks=qm, **draws)
    np.testing.assert_allclose(val["recon_loss"].item(), v_j, rtol=1e-5)
    w0 = model.denoiser.out.weight.detach().clone()
    logs = make_train_step(sched, fused_ctx=False)(
        state, _port_batch(batch), query_masks=qm, **draws)
    np.testing.assert_allclose(logs["recon_loss"].item(), v_j, rtol=1e-5)
    assert state.step == 1 and not torch.equal(w0, model.denoiser.out.weight)


# ------------------------------------------------------------ dropout

def test_dropout_draws_keep_share_scale_and_repeat():
    """Rate 0.1: the share kept within 1 % of 0.9, what is kept scaled by
    1 / 0.9 and the rest zero, the same masks from the same generator
    state, other masks from another; rate 0 returns its input."""
    from raggesture_tpu_torch.models.layers import DropoutDraws

    x = torch.rand(64, 43, 128) + 0.5     # no element is zero

    def run(seed):
        return DropoutDraws(torch.Generator().manual_seed(seed))(x, 0.1)

    y = run(3)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.9, rtol=0, atol=0)
    assert torch.equal(run(3), y) and not torch.equal(run(4), y)
    assert DropoutDraws(torch.Generator())(x, 0.0) is x


def test_dropout_rows_are_the_global_batchs():
    """``rows=(start, global)``: a rank's masks are rows of the masks one
    process draws for the global batch."""
    from raggesture_tpu_torch.models.layers import DropoutDraws

    x = torch.rand(6, 5, 7) + 0.5
    whole = DropoutDraws(torch.Generator().manual_seed(1))(x, 0.3)
    part = DropoutDraws(torch.Generator().manual_seed(1), rows=(2, 6))(
        x[2:4], 0.3)
    assert torch.equal(part, whole[2:4])


def _dropout_model(rate, ca_rate=-1.0):
    jcfg, _, params, _ = _tiny()
    model = _port_model(jcfg, params)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=rate, ca_dropout=ca_rate))
    for blk in (model.denoiser.block(i) for i in range(cfg.denoiser.num_layers)):
        blk.sa_block.proj_out.dropout = rate
        blk.ffn.dropout = blk.ffn.proj_out.dropout = rate
        for key in ("xf_text", "xf_audio", "xf_spk"):
            getattr(blk, f"ca_{key}").proj_out.dropout = (
                rate if ca_rate < 0 else ca_rate)
    return model


def test_the_denoisers_dropout_sites_and_rates():
    """A denoiser built with dropout 0.1 and cross-attention dropout 0.2
    drops where the JAX layers do: each stylization block (0.2 in the cross
    attentions) and the FFN's hidden layer."""
    from raggesture_tpu_torch.models.denoiser import GestureDenoiser

    jcfg = _tiny()[0]
    dc = dataclasses.replace(port_arch_config(jcfg).denoiser, dropout=0.1,
                             ca_dropout=0.2)
    den = GestureDenoiser(dc)
    blk = den.block(0)
    assert blk.sa_block.proj_out.dropout == 0.1
    assert blk.ffn.dropout == blk.ffn.proj_out.dropout == 0.1
    assert blk.ca_xf_audio.proj_out.dropout == 0.2


def test_training_with_dropout_draws_its_masks_from_the_generator(
        monkeypatch):
    """``fused_ctx=False`` with dropout 0.1: the same generator state gives
    the same loss and gradients, another generator other ones, and both
    differ from the deterministic loss at the same draws (every other draw
    is given, so the generator draws the masks alone); ``fused_ctx=True``
    refuses dropout."""
    from raggesture_tpu_torch.models.architecture import training_loss

    jcfg, _, _, batch = _tiny()
    qm = _parity_masks(monkeypatch, jcfg, 2)
    draws = _jax_draws(jax.random.PRNGKey(9), jcfg, 2)
    model = _dropout_model(0.1)
    pb = _port_batch(batch)

    def run(seed, **kw):
        return _port_loss_and_grads(
            model, pb, qm, draws, fused_ctx=False,
            generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(0), run(0), run(1)
    assert a[0] == b[0] and all(torch.equal(a[2][n], b[2][n]) for n in a[2])
    assert a[0] != c[0]
    det = _port_loss_and_grads(_port_model(jcfg, _tiny()[2]), pb, qm, draws,
                               fused_ctx=False)
    assert a[0] != det[0]
    with pytest.raises(ValueError, match="dropout"):
        training_loss(model, model.cfg.diffusion_train.schedule(), pb,
                      query_masks=qm, fused_ctx=True, **draws)


# ----------------------------------------------------- build_optimizers

class _Three(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.denoiser = torch.nn.Linear(4, 3)
        self.codec = torch.nn.Linear(3, 2)
        self.other = torch.nn.Linear(2, 2)


def test_build_optimizers_matches_jax_and_freezes_the_rest():
    """A two-submodule map (denoiser: clipped Adam; codec: AdamW) against
    optax's multi_transform after 3 updates of the same gradients; the
    unmapped submodule does not move (the counterpart of
    ``test_runtime.py::test_build_optimizers_per_submodule``)."""
    import optax

    from raggesture_tpu.train import loop as JL
    from raggesture_tpu_torch.train.loop import OptimConfig, build_optimizers

    from test_torch_common import jax_tree_from_port

    torch.manual_seed(0)
    model = _Three()
    tree = jax_tree_from_port(model)
    cfgs = {"denoiser": dict(lr=1e-2, total_steps=10, grad_clip=0.5),
            "codec": dict(lr=1e-3, total_steps=10, weight_decay=0.1)}
    opt = build_optimizers({k: OptimConfig(**v) for k, v in cfgs.items()},
                           model)
    # copies: the tree's arrays share the torch parameters' memory
    jp = jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), tree)
    tx = JL.build_optimizers({k: JL.OptimConfig(**v)
                              for k, v in cfgs.items()}, jp)
    js = tx.init(jp)
    other0 = model.other.weight.detach().clone()
    rng = np.random.RandomState(0)
    for _ in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norms = opt.step()
        jg = jax_tree_from_port(_with_values(model, grads))
        up, js = tx.update(jax.tree_util.tree_map(jnp.asarray, jg), js, jp)
        jp = optax.apply_updates(jp, up)
    assert set(norms) == {"denoiser", "codec"} and opt.frozen == ["other"]
    assert opt.count == 3
    # within 1e-6, 1e-4 of three updates of lr 1e-2: the frameworks round
    # the clip and Adam's bias corrections apart (1.8e-7 measured)
    want = numpy_tree(jp)["params"]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _jax_leaf(want, n),
                                   rtol=0, atol=1e-6, err_msg=n)
    assert torch.equal(model.other.weight, other0)
    with pytest.raises(KeyError, match="no top-level submodule"):
        build_optimizers({"nope": OptimConfig()}, model)


def _with_values(model, values):
    """A copy of ``model`` holding ``values`` (by parameter name)."""
    import copy

    m = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(t32(values[n]))
    return m
