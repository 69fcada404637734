"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips without a card.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with the card and no JAX (the conftest there is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py
"""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda

# max |kernel - plain| over valid rows.  Both versions round the same
# activations to bf16 before each product but sum in other orders, so an
# operand near a rounding boundary can land one bf16 step (2^-8 relative)
# apart; a few such flips move an O(1) layer output by ~1e-3.
TOL_K1 = 2e-2
# float32 throughout, summed in other orders
TOL_K2 = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer_case(dev, B, D, H, F, frames=150, dead_partner=False):
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DecoderLayer,
        DenoiserConfig,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        cross_context,
        layer_kernel_mask_rows,
        padded_tokens,
    )
    from raggesture_tpu_torch.ops.decoder_layer import pack_decoder_layer

    cfg = DenoiserConfig(latent_dim=D, time_embed_dim=2 * D, num_heads=H,
                         ff_size=F, max_seq_len=frames)
    g = torch.Generator(device=dev).manual_seed(B * D + H)
    with torch.device(dev):
        layer = DecoderLayer(cfg)
    init_weights(layer, g, zero_init_std=0.02)
    T, Tp = cfg.num_tokens, padded_tokens(cfg.num_tokens)
    frame_mask = torch.ones(B, frames, device=dev)
    if dead_partner:
        frame_mask[1] = 0.0
    qm = torch.ones(B, T, device=dev)
    qm[:, list(cfg.sep_indices)] = 0.0
    m_rows, qm_rows = layer_kernel_mask_rows(
        latent_motion_mask(cfg, frame_mask), {k: qm for k in COND_KEYS})
    x = torch.nn.functional.pad(
        torch.randn(B, T, D, generator=g, device=dev),
        (0, 0, 0, Tp - T)).reshape(B * Tp, D)
    cm = torch.tensor([1.0, 0.0] * (B // 2), device=dev).reshape(B, 1, 1)
    ctx3 = torch.stack([
        cross_context(getattr(layer, f"ca_{k}"),
                      torch.randn(B, n, D, generator=g, device=dev), cm,
                      cfg.ca_heads)
        for k, n in zip(COND_KEYS, (20, 33, 1))], 1).to(torch.bfloat16)
    scale5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    shift5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    args = (x, m_rows, qm_rows, scale5, shift5, ctx3.contiguous(),
            pack_decoder_layer(layer, torch.bfloat16), H, cfg.ca_heads, B)
    return args, m_rows[:, 0] > 0


@pytest.mark.parametrize("B, D, H, F", [
    (2, 512, 16, 1024),   # sampling: two halves of one clip, shipped widths
    (4, 512, 16, 1024),   # two clips
    (2, 64, 2, 128),      # narrow: one GEMM column tile per 32 columns
])
def test_decoder_layer_kernel_matches_plain_version(dev, B, D, H, F):
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
    )

    args, valid = _layer_case(dev, B, D, H, F)
    before = fused_decoder_layer.launches
    out = fused_decoder_layer(*args)
    assert fused_decoder_layer.launches == before + 1
    ref = fused_decoder_layer_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out[valid]).all()
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_K1, err


def test_decoder_layer_kernel_with_a_fully_masked_partner(dev):
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
    )

    args, valid = _layer_case(dev, 2, 512, 16, 1024, dead_partner=True)
    out = fused_decoder_layer(*args)
    ref = fused_decoder_layer_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref)[valid].abs().max().item() <= TOL_K1


def test_decoder_layer_kernel_refuses_float32_packs(dev):
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer

    args, _ = _layer_case(dev, 2, 64, 2, 128)
    packed = dict(args[6], mats=args[6]["mats"].float())
    with pytest.raises(ValueError, match="mats"):
        fused_decoder_layer(*args[:6], packed, *args[7:])


@pytest.mark.parametrize("B, Tq, Tk, D, H", [
    (1, 160, 160, 512, 32),   # upper, hands, face decoders
    (1, 160, 160, 512, 64),   # lowertrans decoder
    (3, 70, 45, 128, 4),      # ragged query tiles, Dh 32
    (2, 33, 17, 256, 4),      # Dh 64
])
def test_softmax_mha_kernel_matches_plain_version(dev, B, Tq, Tk, D, H):
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )

    g = torch.Generator(device=dev).manual_seed(Tq * H)
    q = torch.randn(B, Tq, D, generator=g, device=dev)
    k, v = (torch.randn(B, Tk, D, generator=g, device=dev) for _ in range(2))
    scale = 1.0 / math.sqrt(D // H)
    before = fused_softmax_mha.launches
    out = fused_softmax_mha(q, k, v, H, scale)
    assert fused_softmax_mha.launches == before + 1
    ref = softmax_mha_reference(q, k, v, H, scale)
    torch.cuda.synchronize()
    assert out.shape == (B, Tq, D)
    assert (out - ref).abs().max().item() <= TOL_K2


def test_softmax_mha_kernel_refuses_what_it_does_not_take(dev):
    from raggesture_tpu_torch.ops.mha import fused_softmax_mha

    q = torch.randn(1, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head width"):
        fused_softmax_mha(q, q, q, 4, 1.0)             # Dh 12
    with pytest.raises(ValueError, match="float32"):
        fused_softmax_mha(q.half(), q.half(), q.half(), 6, 1.0)
