"""The weight layout kernel K1 streams (``ops.decoder_layer.kernel_tiles``):
each unit's column tile contiguous, stage after stage, its 16-byte chunks
swizzled as the kernel's ldmatrix reads them.  The offsets and the swizzle
here are the ones ``csrc/decoder_layer.cu`` computes (``tile_offset``,
``mma_chunk``); the test holds the packed tiles to the pack's matrices."""

import numpy as np
import pytest
import torch


def _unswizzle(tile: torch.Tensor, nt: int) -> torch.Tensor:
    """(K, nt) tile as stored -> the logical (K, nt) columns."""
    K = tile.shape[0]
    chunks = tile.reshape(K, nt // 8, 8)
    out = torch.empty_like(chunks)
    for k in range(K):
        f = (k >> 2) & 1 if nt == 16 else (k >> 1) & 3
        for c in range(nt // 8):
            out[k, c] = chunks[k, c ^ f]
    return out.reshape(K, nt)


@pytest.mark.parametrize("D, F", [(64, 128), (128, 256)])
def test_kernel_tiles_hold_each_units_columns(D, F):
    from raggesture_tpu_torch.ops.decoder_layer import kernel_tiles

    rng = np.random.default_rng(D + F)
    mats = torch.from_numpy(rng.standard_normal((14, D, D), np.float32))
    w1 = torch.from_numpy(rng.standard_normal((D, F), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((F, D), np.float32))
    tiles = kernel_tiles(mats, w1, w2)
    assert tiles.shape == (14 * D * D + 2 * D * F,)
    DD, DF, heads = D * D, D * F, D // 32

    def qkv(h):
        return torch.cat([mats[j][:, 32 * h:32 * h + 32] for j in range(3)],
                         dim=1)

    mix = mats[10:13].reshape(3 * D, D)
    # (stage offset, K, nt, the tile's columns of the logical matrix)
    units = [(h * D * 96, D, 96, qkv(h)) for h in range(heads)]
    units += [(3 * DD + t * D * 32, D, 32, mats[3][:, 32 * t:32 * t + 32])
              for t in range(D // 32)]
    for i in range(3):
        units += [(4 * DD + (i * heads + t) * D * 32, D, 32,
                   mats[4 + 2 * i][:, 32 * t:32 * t + 32])
                  for t in range(heads)]
        units += [(7 * DD + (i * (D // 32) + t) * D * 32, D, 32,
                   mats[5 + 2 * i][:, 32 * t:32 * t + 32])
                  for t in range(D // 32)]
    units += [(10 * DD + t * 3 * D * 16, 3 * D, 16,
               mix[:, 16 * t:16 * t + 16]) for t in range(D // 16)]
    units += [(13 * DD + t * D * 32, D, 32, w1[:, 32 * t:32 * t + 32])
              for t in range(F // 32)]
    units += [(13 * DD + DF + t * F * 16, F, 16, w2[:, 16 * t:16 * t + 16])
              for t in range(D // 16)]
    units += [(13 * DD + 2 * DF + t * D * 32, D, 32,
               mats[13][:, 32 * t:32 * t + 32]) for t in range(D // 32)]
    assert sum(K * nt for _, K, nt, _ in units) == tiles.numel()
    for off, K, nt, want in units:
        got = _unswizzle(tiles[off:off + K * nt].reshape(K, nt), nt)
        assert torch.equal(got, want), (off, K, nt)


def test_pack_decoder_layer_carries_the_tiles_in_the_packs_dtype():
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        DecoderLayer,
        DenoiserConfig,
    )
    from raggesture_tpu_torch.ops.decoder_layer import (
        kernel_tiles,
        pack_decoder_layer,
    )

    cfg = DenoiserConfig(latent_dim=64, time_embed_dim=128, num_heads=2,
                         ff_size=128)
    layer = DecoderLayer(cfg)
    init_weights(layer, torch.Generator().manual_seed(0), zero_init_std=0.02)
    packed = pack_decoder_layer(layer, torch.bfloat16)
    assert packed["tiles"].dtype == torch.bfloat16
    assert torch.equal(packed["tiles"], kernel_tiles(
        packed["mats"], packed["w1"], packed["w2"]))


@pytest.mark.parametrize("dtype, F, tiled", [
    (torch.bfloat16, 128, True),
    (torch.float32, 128, False),   # the kernel takes bf16 packs only
    (torch.bfloat16, 96, False),   # F not a multiple of 64
])
def test_pack_decoder_layer_builds_tiles_only_for_the_kernel(dtype, F,
                                                             tiled):
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        DecoderLayer,
        DenoiserConfig,
    )
    from raggesture_tpu_torch.ops.decoder_layer import (
        kernel_widths,
        pack_decoder_layer,
    )

    cfg = DenoiserConfig(latent_dim=64, time_embed_dim=128, num_heads=2,
                         ff_size=F)
    layer = DecoderLayer(cfg)
    init_weights(layer, torch.Generator().manual_seed(0), zero_init_std=0.02)
    packed = pack_decoder_layer(layer, dtype)
    assert ("tiles" in packed) == tiled
    assert kernel_widths(64, F) == (F % 64 == 0)
