"""Where the codec attention takes kernel K2: the port's ``mha_supported``
and ``TorchMHA``'s routing, against the JAX package's ``TorchMHA`` on the
same numpy weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.mark.parametrize("Tq, Tk, D, H, want", [
    (160, 160, 512, 32, True),    # upper, hands, face decoders: Dh 16
    (160, 160, 512, 64, True),    # lowertrans decoder: Dh 8
    (50, 300, 256, 4, True),      # Dh 64, 163 KB of keys and values
    (16, 16, 48, 4, False),       # Dh 12
    (8, 1500, 256, 16, False),    # Dh 16: 240 KB of keys and values
    (8, 1452, 256, 16, True),     # Dh 16: the longest that fits, 227 KB
    (8, 1453, 256, 16, False),
    (8, 8, 100, 3, False),        # D not a multiple of the heads
    (0, 8, 64, 4, False),         # no query
])
def test_mha_supported_states_the_kernels_limits(Tq, Tk, D, H, want):
    from raggesture_tpu_torch.ops.mha import mha_supported

    assert mha_supported(Tq, Tk, D, H) is want


def _jax_and_port_mha(D, H, seed):
    from raggesture_tpu.models.vae import TorchMHA as JaxMHA
    from raggesture_tpu_torch.models.vae import TorchMHA

    rng = np.random.default_rng(seed)
    jmod = JaxMHA(D, H)
    x = jnp.zeros((1, 4, D), jnp.float32)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        / np.sqrt(a.shape[0]), jmod.init(jax.random.PRNGKey(0), x, x, x))
    mod = TorchMHA(D, H)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            p = params["params"][name]
            getattr(mod, name).weight.copy_(torch.from_numpy(p["kernel"].T))
            getattr(mod, name).bias.copy_(torch.from_numpy(p["bias"]))
    return jmod, params, mod, rng


@pytest.mark.parametrize("Tq, Tk, D, H, kernel", [
    (24, 24, 64, 4, True),        # Dh 16: kernel K2
    (16, 16, 48, 4, False),       # Dh 12: the plain einsum
    (4, 1500, 64, 4, False),      # Dh 16, 1500 keys: the plain einsum
])
def test_torch_mha_routes_as_the_jax_package(monkeypatch, Tq, Tk, D, H,
                                             kernel):
    from raggesture_tpu_torch.models import vae

    calls = []
    real = vae.fused_softmax_mha

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(vae, "fused_softmax_mha", spy)
    jmod, params, mod, rng = _jax_and_port_mha(D, H, seed=Tq + Tk)
    q = rng.standard_normal((2, Tq, D)).astype(np.float32)
    kv = rng.standard_normal((2, Tk, D)).astype(np.float32)
    want = np.asarray(jmod.apply(params, q, kv, kv))
    with torch.no_grad():
        got = mod(torch.from_numpy(q), torch.from_numpy(kv),
                  torch.from_numpy(kv)).numpy()
    assert len(calls) == int(kernel)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_masked_torch_mha_never_takes_the_kernel(monkeypatch):
    from raggesture_tpu_torch.models import vae

    monkeypatch.setattr(vae, "fused_softmax_mha", None)   # any call raises
    jmod, params, mod, rng = _jax_and_port_mha(64, 4, seed=3)
    q = rng.standard_normal((2, 10, 64)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[1, 6:] = False
    want = np.asarray(jmod.apply(params, q, q, q, jnp.asarray(mask)))
    with torch.no_grad():
        got = mod(*(torch.from_numpy(q),) * 3,
                  key_padding_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
