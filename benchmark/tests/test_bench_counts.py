"""The FLOP and byte counts against hand counts at the flagship's widths."""

from __future__ import annotations

import pytest

from benchmark.counts import clip, k1, k2, shapes
from benchmark.harness import peaks

from bench_tiny import flagship


@pytest.fixture(scope="module")
def cfg():
    return flagship()


def test_layer_weights_are_14_d2_plus_2_d_f(cfg):
    s = shapes.denoiser(cfg)
    assert s["T"] == 43 and s["Dh"] == 32 and s["Dhc"] == 32
    assert shapes.layer_weights(s) == 14 * 512 ** 2 + 2 * 512 * 1024 == 4718592


def test_k1_call_at_one_and_thirty_two_clips(cfg):
    # one clip: 2 sequences (conditioned, dropped) of 43 tokens
    f, b = k1.call(cfg, 2)
    rows = 86
    attn = 2 * (2 * 2 * 43 * 512 * 32 + 3 * 2 * 43 * 512 * 32)
    assert f == 2 * rows * 4718592 + attn
    assert b == (2 * 4718592 + 4 * (31 * 512 + 1024) + 8 * rows * 512
                 + 16 * rows + 40 * 512 + 2 * 2 * 3 * 16 * 32 * 32)
    # bytes-bound at batch 1: 3.0 us, PR 6's 0.00302 ms
    assert peaks.bound_s(f, b, peaks.BF16_FLOPS) == pytest.approx(
        3.0076e-6, rel=1e-3)
    f32, b32 = k1.call(cfg, 64)
    assert f32 / 1e9 == pytest.approx(26.42, rel=1e-3)    # 2 x 64 x 43 x 4.72 M
    # operations-bound at 32 clips: 26.7 us
    assert peaks.bound_s(f32, b32, peaks.BF16_FLOPS) == pytest.approx(
        f32 / 989e12)


def test_k2_decode_attentions(cfg):
    calls = k2.decode(cfg, 3)
    assert len(calls) == 4 * 9                  # 4 parts, 8 layers -> 9
    f, b = calls[0]
    assert f == 4 * 3 * 160 * 160 * 512
    assert b == 4 * 3 * 4 * 160 * 512


def test_clip_flops_by_part(cfg):
    s = shapes.denoiser(cfg)
    # the trunk of one forward, one sequence: embedding and head, then
    # 8 layers of weight products and linear attentions
    per_layer = 2 * 43 * 4718592 + 2 * 2 * 43 * 512 * 32 + 3 * 2 * 43 * 512 * 32
    assert clip.trunk(s) == 4 * 43 * 512 * 512 + 8 * per_layer
    proj = 2 * 512 * (150 * 768 + 499 * 768)
    ctx = sum(4 * n * 512 * 512 + 2 * n * 512 * 32 for n in (150, 499, 1))
    assert clip.conditions(s) == proj + 2 * 8 * ctx
    assert clip.adaln(s) == 2 * (512 * 2048 + 2048 * 2048) + 8 * 5 * 2 * 2048 * 1024
    total = clip.clip(cfg)
    assert total == (clip.conditions(s) + 50 * (clip.adaln(s) + 2 * clip.trunk(s))
                     + clip.decode(cfg))
    assert 0.3e12 < total < 0.5e12
