"""The port's ops against the JAX package on the same numpy inputs.

Kernel K1 (``fused_decoder_layer``) and kernel K2 (``fused_softmax_mha``)
are compared here through their plain PyTorch versions, which is what their
wrappers run on a CPU tensor; the JAX side runs its Pallas kernels in
interpret mode, as the JAX package's own tests do.  The kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (
    jax_denoiser_setup,
    parity_query_masks_np,
    port_denoiser,
    t32,
)

COND_KEYS = ("xf_text", "xf_audio", "xf_spk")


# ---------------------------------------------------------------- rotations

def test_d6_feature_to_aa_matches_jax_including_angles_near_pi():
    from raggesture_tpu.ops.rotations import aa_feature_to_6d
    from raggesture_tpu.ops.rotations import d6_feature_to_aa as jax_d6
    from raggesture_tpu_torch.ops.rotations import d6_feature_to_aa

    rng = np.random.RandomState(0)
    n = 256
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = np.concatenate([
        rng.uniform(0.0, np.pi, n // 4),            # anywhere
        np.pi - rng.uniform(0.0, 1e-3, n // 4),     # just below pi
        np.full(n // 8, np.pi),                     # exactly pi
        rng.uniform(0.0, 1e-7, n // 8),             # the small-angle branch
        rng.uniform(np.pi, 2 * np.pi, n // 4),      # past pi: axis flips
    ])
    aa = (axis * angle[:, None]).astype(np.float32).reshape(8, n // 8 * 3)
    d6 = np.asarray(aa_feature_to_6d(jnp.asarray(aa)))
    # plus raw, unnormalised network outputs, as the codec decode produces
    raw = rng.randn(4, 5, 13 * 6).astype(np.float32)
    for x in (d6, raw):
        want = np.asarray(jax_d6(jnp.asarray(x)))
        got = d6_feature_to_aa(t32(x)).numpy()
        assert got.shape == want.shape
        # float32 both sides, the same branch choices; near pi the axis is
        # a quotient of two small numbers, which bounds the agreement
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# ------------------------------------------------- kernel K1, plain version

def _rows(a, Tp):
    B, T = a.shape[:2]
    pad = np.zeros((B, Tp - T) + a.shape[2:], np.float32)
    return np.concatenate([a.astype(np.float32), pad], 1).reshape(
        B * Tp, *a.shape[2:])


def _per_head_blocks(ctx, heads):
    """Dense block-diagonal (B, 3, D, D) contexts -> (B, 3, H, Dh, Dh);
    asserts that every block off the diagonal is exactly zero."""
    B, n, D, _ = ctx.shape
    Dh = D // heads
    c = ctx.reshape(B, n, heads, Dh, heads, Dh)
    blocks = np.stack([c[:, :, h, :, h, :] for h in range(heads)], axis=2)
    off = c.copy()
    for h in range(heads):
        off[:, :, h, :, h, :] = 0.0
    assert not off.any(), "the JAX contexts are not block-diagonal"
    return blocks


def _k1_case(B, bf16, dead_partner=False):
    """One DecoderLayer through the JAX layer kernel (interpret mode) and
    through the port's plain version, on the same weights and inputs."""
    from raggesture_tpu.models.fused_denoiser import precompute_cross_contexts
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_decoder_layer as jax_layer,
    )
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        pack_decoder_layer as jax_pack,
    )
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        pack_decoder_layer,
    )

    cfg, den, params, inp = jax_denoiser_setup(B=B)
    T, D, H, Hc = cfg.num_tokens, cfg.latent_dim, cfg.num_heads, cfg.ca_heads
    Tp = -(-T // 8) * 8
    mask = inp["mask"].copy()
    if dead_partner:
        mask[1] = 0.0
    conds = den.apply(params, inp["word"], inp["audio"], inp["spk"],
                      method=den.encode_conditions)
    # conditioned and unconditioned sequences, as sampling pairs them
    cm = np.asarray([1.0, 0.0] * (B // 2), np.float32).reshape(B, 1, 1)
    ctx = precompute_cross_contexts(params["params"], cfg, conds,
                                    jnp.asarray(cm))
    ctx3 = np.stack([np.asarray(ctx[(0, k)]) for k in COND_KEYS], axis=1)
    qm = parity_query_masks_np(cfg, B)
    rng = np.random.RandomState(7)
    x = _rows(inp["x"], Tp)
    m = _rows(mask[..., None], Tp)
    qm3 = _rows(np.stack([qm[k] for k in COND_KEYS], -1), Tp)
    scale5 = (0.1 * rng.randn(5, D)).astype(np.float32)
    shift5 = (0.1 * rng.randn(5, D)).astype(np.float32)

    want = np.asarray(jax_layer(
        x, m, qm3, scale5, shift5, ctx3,
        jax_pack(params["params"]["block_0"], bf16=bf16),
        num_heads=H, ca_heads=Hc, batch=B, interpret=True))

    dtype = torch.bfloat16 if bf16 else torch.float32
    layer = port_denoiser(cfg, params).block_0
    got = fused_decoder_layer(
        t32(x), t32(m), t32(qm3), t32(scale5), t32(shift5),
        t32(_per_head_blocks(ctx3, Hc)).to(dtype),
        pack_decoder_layer(layer, dtype), H, Hc, B).numpy()
    return got, want, m[:, 0] > 0


@pytest.mark.parametrize("B, bf16, atol", [
    # float32 packs: the same arithmetic, summed in other orders
    (2, False, 1e-5),
    # bf16 packs: both round the same operands to bf16, but the TPU kernel
    # also rounds the feature-softmax numerators inside its denominator
    # (a matrix product) and sums in another order, so an operand near a
    # rounding boundary can land one bf16 step (2^-8 relative) apart
    (2, True, 2e-2),
    # four sequences: the TPU kernel's grid over pairs, rows merged here
    (4, False, 1e-5),
])
def test_decoder_layer_plain_version_matches_the_tpu_kernel(B, bf16, atol):
    got, want, valid = _k1_case(B, bf16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=atol)


def test_decoder_layer_with_a_fully_masked_partner_stays_finite():
    """A fully padded sequence beside a valid one: the time softmax takes
    its max per sequence, so neither goes 0/0."""
    got, want, valid = _k1_case(2, False, dead_partner=True)
    assert valid[:valid.size // 2].any() and not valid[valid.size // 2:].any()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)


# ------------------------------------------------- kernel K2, plain version

@pytest.mark.parametrize("B, T, D, H", [
    (1, 160, 512, 32),   # a codec decoder layer: 10 latents + 150 queries
    (2, 16, 32, 4),      # tiny
])
def test_softmax_mha_plain_version_matches_the_tpu_kernel(B, T, D, H):
    from raggesture_tpu.ops.pallas.mha_kernel import (
        fused_softmax_mha as jax_mha,
    )
    from raggesture_tpu_torch.ops.mha import fused_softmax_mha

    rng = np.random.RandomState(B * T + H)
    q, k, v = (rng.randn(B, T, D).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(D // H)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              H, float(scale), True))
    got = fused_softmax_mha(t32(q), t32(k), t32(v), H, float(scale)).numpy()
    assert got.shape == (B, T, D)
    # float32 throughout, summed in other orders
    np.testing.assert_allclose(got, want, atol=1e-5)
