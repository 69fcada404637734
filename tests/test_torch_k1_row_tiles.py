"""Kernel K1's row-tile design on the CPU: which calls take it
(``ops.decoder_layer.uses_row_tiles``, a function of the call's shapes
alone) and the weight layout it streams (``gmma_tiles``): each unit's
column tile contiguous, its K in chunks of 64, a chunk the tile's columns
as rows of 64 contraction elements with the 128-byte swizzle.  The offsets
and the swizzle here are the ones ``csrc/decoder_layer.cu`` computes
(``rt_weights``, ``rt_load``, ``kmajor_desc``); the test holds the packed
tiles to the pack's matrices."""

import numpy as np
import pytest
import torch


def _unswizzle(tile: torch.Tensor, K: int, nt: int) -> torch.Tensor:
    """A tile as stored, (K / 64, nt, 64) -> the logical (K, nt) columns."""
    chunks = tile.reshape(K // 64, nt, 8, 8)
    out = torch.empty_like(chunks)
    for n in range(nt):
        for c in range(8):
            out[:, n, c] = chunks[:, n, c ^ (n & 7)]
    return out.reshape(K // 64, nt, 64).permute(0, 2, 1).reshape(K, nt)


@pytest.mark.parametrize("D, F", [(128, 256), (256, 512)])
def test_gmma_tiles_hold_each_units_columns(D, F):
    from raggesture_tpu_torch.ops.decoder_layer import gmma_tiles

    rng = np.random.default_rng(D + F)
    mats = torch.from_numpy(rng.standard_normal((14, D, D), np.float32))
    w1 = torch.from_numpy(rng.standard_normal((D, F), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((F, D), np.float32))
    tiles = gmma_tiles(mats, w1, w2)
    assert tiles.shape == (14 * D * D + 2 * D * F,)
    DD, DF, heads, per = D * D, D * F, D // 32, D // 64

    def qkv(h):
        return torch.cat([mats[j][:, 32 * h:32 * h + 32] for j in range(3)],
                         dim=1)

    def cols(w, nt, t):
        return w[:, nt * t:nt * t + nt]

    mix = mats[10:13].reshape(3 * D, D)
    # (stage base, tile index, K, nt, the tile's columns of the logical
    # matrix): rt_weights' base + tile * K * nt
    units = [(0, h, D, 96, qkv(h)) for h in range(heads)]
    units += [(3 * DD, t, D, 64, cols(mats[3], 64, t)) for t in range(per)]
    units += [(4 * DD, i * per + t, D, 64, cols(mats[4 + 2 * i], 64, t))
              for i in range(3) for t in range(per)]
    units += [(7 * DD, i * per + t, D, 64, cols(mats[5 + 2 * i], 64, t))
              for i in range(3) for t in range(per)]
    units += [(10 * DD, t, 3 * D, 64, cols(mix, 64, t)) for t in range(per)]
    units += [(13 * DD, t, D, 128, cols(w1, 128, t))
              for t in range(F // 128)]
    units += [(13 * DD + DF, t, F, 64, cols(w2, 64, t)) for t in range(per)]
    units += [(13 * DD + 2 * DF, t, D, 64, cols(mats[13], 64, t))
              for t in range(per)]
    assert sum(K * nt for _, _, K, nt, _ in units) == tiles.numel()
    for base, t, K, nt, want in units:
        off = base + t * K * nt
        got = _unswizzle(tiles[off:off + K * nt], K, nt)
        assert torch.equal(got, want), (base, t, K, nt)


def test_gmma_tiles_chunks_are_swizzled_rows_of_128_bytes():
    """Row n of a chunk holds its 16-byte pieces at c ^ (n & 7): the
    first row in order, the next rotated, as wgmma's 128-byte swizzle
    reads them."""
    from raggesture_tpu_torch.ops.decoder_layer import gmma_tiles

    D, F = 128, 256
    mats = torch.zeros(14, D, D)
    mats[3] = torch.arange(D * D, dtype=torch.float32).reshape(D, D)
    tiles = gmma_tiles(mats, torch.zeros(D, F), torch.zeros(F, D))
    chunk = tiles[3 * D * D:3 * D * D + 64 * 64].reshape(64, 8, 8)
    for n in range(16):
        for c in range(8):
            k = 8 * (c ^ (n & 7))
            assert torch.equal(chunk[n, c], mats[3][k:k + 8, n]), (n, c)


@pytest.mark.parametrize("batch, Tp, D, F, row_tiles", [
    (2, 48, 512, 1024, False),      # one clip: the per-sequence design
    (64, 48, 512, 1024, True),      # a serving batch of 32 clips
    (128, 48, 512, 1024, True),
    (64, 16, 512, 1024, True),      # 12 sequences a row tile
    (64, 8, 512, 1024, False),      # 24 a row tile: past the contexts' room
    (64, 48, 64, 128, False),       # narrow: too few column tiles
    (64, 48, 320, 1024, False),     # D not a multiple of 128
    (64, 48, 512, 960, False),      # F not a multiple of 128
])
def test_row_tile_design_is_a_function_of_the_calls_shapes(batch, Tp, D, F,
                                                           row_tiles):
    from raggesture_tpu_torch.ops.decoder_layer import uses_row_tiles

    assert uses_row_tiles(batch, Tp, D, F) == row_tiles


def test_row_tile_design_starts_at_the_measured_crossover():
    from raggesture_tpu_torch.ops.decoder_layer import (
        ROW_TILE_MIN_SEQUENCES,
        uses_row_tiles,
    )

    n = ROW_TILE_MIN_SEQUENCES
    assert 2 < n <= 64          # one clip below it, a 32-clip batch above
    assert not uses_row_tiles(n - 1, 48, 512, 1024)
    assert all(uses_row_tiles(b, 48, 512, 1024) for b in range(n, 4 * n))


@pytest.mark.parametrize("dtype, D, F, gmma", [
    (torch.bfloat16, 256, 512, True),
    (torch.float32, 256, 512, False),    # the kernel takes bf16 packs only
    (torch.bfloat16, 64, 128, False),    # narrow: the per-sequence design
    (torch.bfloat16, 256, 320, False),   # F not a multiple of 128
])
def test_pack_decoder_layer_builds_gmma_tiles_only_for_the_design(dtype, D,
                                                                  F, gmma):
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        DecoderLayer,
        DenoiserConfig,
    )
    from raggesture_tpu_torch.ops.decoder_layer import (
        gmma_tiles,
        kernel_widths,
        pack_decoder_layer,
        row_tile_widths,
    )

    cfg = DenoiserConfig(latent_dim=D, time_embed_dim=2 * D,
                         num_heads=D // 32, ff_size=F)
    layer = DecoderLayer(cfg)
    init_weights(layer, torch.Generator().manual_seed(0), zero_init_std=0.02)
    packed = pack_decoder_layer(layer, dtype)
    assert ("gmma_tiles" in packed) == gmma
    assert row_tile_widths(D, F) == (D >= 256 and F % 128 == 0)
    # the per-sequence design's tiles stay beside them
    assert ("tiles" in packed) == (dtype == torch.bfloat16
                                   and kernel_widths(D, F))
    if gmma:
        assert packed["gmma_tiles"].dtype == torch.bfloat16
        assert torch.equal(packed["gmma_tiles"], gmma_tiles(
            packed["mats"], packed["w1"], packed["w2"]))


def _row_tile_plan(B, Tp, D, H, F):
    """The row-tile design's units as ``csrc/decoder_layer.cu`` deals them
    (``rg_decoder_layer``, ``rt_stage_units``, ``rt_decode``): row tiles
    of the 192 // Tp whole sequences that fit, units of each stage its
    column tiles times the row tiles, the row tile fastest; each unit as
    (stage, column tile, first sequence, sequences)."""
    G = 192 // Tp
    nrt = -(-B // G)
    tiles = [H, D // 64, 3 * (D // 64), 3 * (D // 64), D // 64, F // 128,
             D // 64, D // 64]
    plan = []
    for stage, n in enumerate(tiles):
        for u in range(n * nrt):
            rt, tile = u % nrt, u // nrt
            plan.append((stage, tile, rt * G, min(G, B - rt * G)))
    return plan


@pytest.mark.parametrize("B, Tp", [(8, 48), (64, 48), (66, 48), (130, 48),
                                   (64, 16), (66, 40), (10, 24)])
def test_row_tile_units_cover_each_sequence_once(B, Tp):
    D, H, F = 512, 16, 1024
    plan = _row_tile_plan(B, Tp, D, H, F)
    tiles = [H, D // 64, 3 * (D // 64), 3 * (D // 64), D // 64, F // 128,
             D // 64, D // 64]
    for stage, n in enumerate(tiles):
        seen = {}
        for st, tile, s0, seqs in plan:
            if st != stage:
                continue
            # whole sequences, at most 192 rows and 12 sequences (the
            # contexts' room in shared memory)
            assert 0 < seqs * Tp <= 192 and seqs <= 12
            for s in range(s0, s0 + seqs):
                seen[(tile, s)] = seen.get((tile, s), 0) + 1
        assert seen == {(t, s): 1 for t in range(n) for s in range(B)}


def test_row_tile_units_at_a_serving_batch():
    """64 sequences of 48 tokens: 16 row tiles of 4 sequences; 128 to 384
    units a stage, one to three for each of an H100's 132 SMs."""
    plan = _row_tile_plan(64, 48, 512, 16, 1024)
    per_stage = [sum(1 for u in plan if u[0] == s) for s in range(8)]
    assert per_stage == [256, 128, 384, 384, 128, 128, 128, 128]
    assert {u[3] for u in plan} == {4}
