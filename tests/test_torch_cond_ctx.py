"""K3: the port's ``cond_contexts`` (on the CPU: its plain forward and
analytic backward) against the JAX package's, on the same numpy inputs.

JAX returns (B, L, G, S, S) contexts, block-diagonal inside S-lane groups;
the port returns the diagonal blocks per head, (B, L, H, Dh, Dh).  The
tests cut JAX's output into head blocks and check that the rest is zero.
Tolerances are the JAX package's own for its kernels against its
reference (tests/test_cond_ctx.py): values rtol 2e-5 / atol 2e-6,
gradients rtol 5e-4 / atol 2e-4.  JAX's value atol held its kernel against
its reference inside one framework; across the two the float32 sums run in
other orders, so here the value atol is 2e-6 of the largest |context|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import t32

NAMES = ("xf", "ln_g", "ln_b", "wk", "bk", "wv", "bv")


def _inputs(seed, B=2, N=13, D=64, L=3):
    """JAX's test inputs (tests/test_cond_ctx.py), with the projection
    weights at 2.4 / sqrt(D): 0.3 at D 64 as there, and logits of the same
    spread at D 256 (at 0.3 their std is ~5 there, and the sharp softmax
    amplifies float32 summation-order noise past the tolerances)."""
    rng = np.random.RandomState(seed)
    s, sw = 0.3, 2.4 / np.sqrt(D)

    def rn(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    xf = rn(B, N, D, scale=s)
    cm = np.asarray([1.0, 0.0, 1.0][:B], np.float32).reshape(B, 1, 1)
    params = (1.0 + rn(L, D, scale=0.1), rn(L, D, scale=0.1),
              rn(L, D, D, scale=sw), rn(L, D, scale=0.1),
              rn(L, D, D, scale=sw), rn(L, D, scale=0.1))
    return xf, cm, params


def _head_blocks(ctx_g, num_heads):
    """(B, L, G, S, S) -> the (B, L, H, Dh, Dh) diagonal head blocks;
    asserts every other entry is zero."""
    B, L, G, S, _ = ctx_g.shape
    Dh = G * S // num_heads
    hpg = S // Dh
    blocks = ctx_g.reshape(B, L, G, hpg, Dh, hpg, Dh)
    diag = np.stack([blocks[:, :, :, i, :, i, :] for i in range(hpg)], 3)
    off = blocks.copy()
    for i in range(hpg):
        off[:, :, :, i, :, i, :] = 0.0
    assert not off.any()
    return diag.reshape(B, L, num_heads, Dh, Dh)


def _to_groups(w_h, G, S):
    """Per-head (B, L, H, Dh, Dh) -> grouped (B, L, G, S, S) with zeros off
    the head blocks."""
    B, L, H, Dh, _ = w_h.shape
    hpg = S // Dh
    out = np.zeros((B, L, G, hpg, Dh, hpg, Dh), np.float32)
    wb = w_h.reshape(B, L, G, hpg, Dh, Dh)
    for i in range(hpg):
        out[:, :, :, i, :, i, :] = wb[:, :, :, i]
    return out.reshape(B, L, G, S, S)


def _port(xf, cm, params, num_heads, w=None):
    """The port's contexts, and with a cotangent ``w`` the gradients of
    sum(ctx * w) (w=None: sum(ctx ** 2))."""
    from raggesture_tpu_torch.ops.cond_ctx import cond_contexts

    ins = [t32(a).requires_grad_() for a in (xf,) + params]
    ctx = cond_contexts(ins[0], t32(cm), *ins[1:], num_heads=num_heads)
    loss = (ctx ** 2).sum() if w is None else (ctx * t32(w)).sum()
    grads = torch.autograd.grad(loss, ins)
    return (ctx.detach().numpy(), loss.item(),
            [g.numpy() for g in grads])


def _jax(xf, cm, params, num_heads, use_kernel, w=None):
    from raggesture_tpu.ops.pallas.cond_ctx_kernel import cond_contexts

    def loss(*args):
        ctx = cond_contexts(args[0], jnp.asarray(cm), *args[1:],
                            num_heads=num_heads, use_kernel=use_kernel,
                            interpret=True)
        return (jnp.sum(ctx ** 2) if w is None else jnp.sum(ctx * w)), ctx

    (val, ctx), grads = jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True)(
            *(jnp.asarray(a) for a in (xf,) + params))
    return np.asarray(ctx), float(val), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("D, heads, use_kernel", [
    (64, 8, True),     # JAX's Pallas kernels in interpret mode, one group
    (256, 8, False),   # JAX's reference, two 128-lane groups
])
def test_cond_contexts_match_jax(D, heads, use_kernel):
    from raggesture_tpu.ops.pallas.cond_ctx_kernel import group_shape

    xf, cm, params = _inputs(0, D=D)
    G, S = group_shape(D, heads)
    L = params[0].shape[0]
    w_h = np.random.RandomState(1).randn(
        2, L, heads, D // heads, D // heads).astype(np.float32)
    ctx_j, v_j, g_j = _jax(xf, cm, params, heads, use_kernel,
                           w=_to_groups(w_h, G, S))
    ctx_p, v_p, g_p = _port(xf, cm, params, heads, w=w_h)
    want = _head_blocks(ctx_j, heads)
    np.testing.assert_allclose(ctx_p, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
    for name, a, b in zip(NAMES, g_p, g_j):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=2e-4,
                                   err_msg=f"grad of {name}")


def test_cond_contexts_with_every_condition_dropped_match_jax():
    """cm = 0: every logit sits near -1e6, values stay the value bias and
    the gradients follow the reference (JAX's test: xf's gradient within
    rtol 5e-4 / atol 1e-6)."""
    xf, _, params = _inputs(3)
    cm = np.zeros((2, 1, 1), np.float32)
    ctx_j, v_j, g_j = _jax(xf, cm, params, 8, True)
    ctx_p, v_p, g_p = _port(xf, cm, params, 8)
    want = _head_blocks(ctx_j, 8)
    np.testing.assert_allclose(ctx_p, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
    np.testing.assert_allclose(g_p[0], g_j[0], rtol=5e-4, atol=1e-6)
    for name, a, b in zip(NAMES[1:], g_p[1:], g_j[1:]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=2e-4,
                                   err_msg=f"grad of {name}")


def test_plain_analytic_backward_passes_gradcheck():
    """The analytic backward against finite differences in float64, with a
    dropped element and padding rows (N 5 -> 8)."""
    from raggesture_tpu_torch.ops.cond_ctx import cond_contexts

    g = torch.Generator().manual_seed(0)
    B, N, D, L, H = 2, 5, 16, 2, 4

    def rn(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g,
                                dtype=torch.float64)).requires_grad_()

    cm = torch.tensor([1.0, 0.0], dtype=torch.float64).reshape(B, 1, 1)
    args = (rn(B, N, D), rn(L, D, s=0.1) + 1.0, rn(L, D, s=0.1),
            rn(L, D, D, s=0.3), rn(L, D, s=0.1), rn(L, D, D, s=0.3),
            rn(L, D, s=0.1))
    args = tuple(a.detach().requires_grad_() for a in args)
    assert torch.autograd.gradcheck(
        lambda xf, *p: cond_contexts(xf, cm, *p, num_heads=H), args)


def test_cond_contexts_off_the_cpu_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernels, which take CUDA
    tensors only (here: a meta tensor, refused before any launch)."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts,
        cond_ctx_forward,
    )

    xf, cm, params = _inputs(0, D=128)
    before = cond_ctx_forward.launches
    with pytest.raises(ValueError, match="CUDA"):
        cond_contexts(t32(xf).to("meta"), t32(cm).to("meta"),
                      *(t32(p).to("meta") for p in params), num_heads=4)
    assert cond_ctx_forward.launches == before
