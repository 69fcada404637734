"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, and the tools and evaluation (FK, the FGD embedder) on the card
against the CPU.  Every test here is marked ``cuda`` and skips without a
card.

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


def _case(B, D, H, F, frames=150, dead=False, id=None):
    return pytest.param(B, D, H, F, frames, dead,
                        id=id or f"{B}-{D}-{H}-{F}")


# Calls of at least ops.decoder_layer.ROW_TILE_MIN_SEQUENCES sequences at
# widths the row-tile design takes run it; the others the per-sequence
# design.
@pytest.mark.parametrize("B, D, H, F, frames, dead", [
    _case(2, 512, 16, 1024),   # sampling: two halves of one clip, shipped
                               # widths
    _case(4, 512, 16, 1024),   # two clips
    _case(2, 64, 2, 128),      # narrow: two column tiles, most blocks idle
    _case(16, 512, 16, 1024),  # batch 8
    _case(64, 512, 16, 1024),  # batch 32, a serving batch
    _case(128, 512, 16, 1024), # batch 64
    # the row-tile design from the crossover (ROW_TILE_MIN_SEQUENCES, 6;
    # 4 above is the most sequences below it) and just past it
    _case(6, 512, 16, 1024),
    _case(8, 512, 16, 1024),
    _case(66, 512, 16, 1024),  # the last row tile ragged: 2 of 4 sequences
    _case(130, 512, 16, 1024),
    _case(64, 512, 16, 1024, frames=45, id="64-512-16-1024-Tp16"),
    _case(64, 512, 16, 1024, frames=120, id="64-512-16-1024-Tp40"),
    _case(66, 512, 16, 1024, frames=120, id="66-512-16-1024-Tp40"),
    _case(64, 512, 16, 1024, dead=True, id="64-512-16-1024-dead"),
])
def test_decoder_layer_kernel_matches_plain_version(dev, B, D, H, F, frames,
                                                    dead):
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
        uses_row_tiles,
    )

    args, valid = _layer_case(dev, B, D, H, F, frames=frames,
                              dead_partner=dead)
    before = fused_decoder_layer.launches
    row_tiles = fused_decoder_layer.row_tile_launches
    out = fused_decoder_layer(*args)
    assert fused_decoder_layer.launches == before + 1
    assert (fused_decoder_layer.row_tile_launches - row_tiles
            == uses_row_tiles(B, args[0].shape[0] // B, D, F))
    again = fused_decoder_layer(*args)
    ref = fused_decoder_layer_reference(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out[valid]).all()
    assert torch.equal(out, again)
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_K1, err


def test_decoder_layer_kernel_replays_in_a_cuda_graph(dev):
    """One call captured in a CUDA graph (after an eager warm-up call, as a
    captured sampling loop would be) replays to the eager call's bits."""
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer

    args, _ = _layer_case(dev, 2, 512, 16, 1024)
    eager = fused_decoder_layer(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_decoder_layer(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_decoder_layer(*args)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_decoder_layer_kernel_row_tiles_replay_in_a_cuda_graph(dev):
    """The row-tile design at 64 sequences, captured after an eager
    warm-up call, replays to the eager call's bits."""
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer

    args, _ = _layer_case(dev, 64, 512, 16, 1024)
    eager = fused_decoder_layer(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_decoder_layer(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fused_decoder_layer.row_tile_launches
    with torch.cuda.graph(graph):
        captured = fused_decoder_layer(*args)
    assert fused_decoder_layer.row_tile_launches == before + 1
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_decoder_layer_kernel_design_follows_the_batch(dev):
    """Two sequences (one clip) leave the row-tile counter where it was:
    the per-sequence design serves them; 64 (a 32-clip batch) move it."""
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer

    before = fused_decoder_layer.row_tile_launches
    fused_decoder_layer(*_layer_case(dev, 2, 512, 16, 1024)[0])
    assert fused_decoder_layer.row_tile_launches == before
    fused_decoder_layer(*_layer_case(dev, 64, 512, 16, 1024)[0])
    torch.cuda.synchronize()
    assert fused_decoder_layer.row_tile_launches == before + 1


def test_decoder_layer_kernel_trace_marks_run_in_order(dev):
    """The kernel's optional %globaltimer trace (for measuring its phases):
    a traced call gives the untraced call's bits, and each block's marks run
    forward: entry, weight copies started, the grid barriers, its end; each
    traced unit's start, product start, product end and end in between."""
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        trace_slots,
    )

    args, _ = _layer_case(dev, 2, 512, 16, 1024)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tr = torch.zeros(sms, trace_slots(), dtype=torch.int64, device=dev)
    out = fused_decoder_layer(*args, trace=tr)
    assert torch.equal(out, fused_decoder_layer(*args))
    units, marks = 8, 4                    # traced units, marks of each
    bar0 = 2 + units * marks
    rows = [r for r in tr.cpu().tolist() if r[0]]
    assert len(rows) == sms               # 480 units: a block on every SM
    for r in rows:
        bars = r[bar0:-3]
        assert len(bars) == 12
        timeline = [r[0], r[1], *bars, r[-1]]
        assert timeline == sorted(timeline), timeline
        assert r[-2] > r[-3]              # the SM clock at entry and end
        for j in range(units):
            mk = r[2 + marks * j:2 + marks * (j + 1)]
            if mk[0]:
                assert r[1] <= mk[0] <= mk[1] <= mk[2] <= mk[3] <= r[-1], mk


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


def test_decoder_layer_kernel_refuses_other_head_widths(dev):
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer

    args, _ = _layer_case(dev, 2, 64, 4, 128)      # heads of 16 columns
    with pytest.raises(ValueError, match="head width 32"):
        fused_decoder_layer(*args)


@pytest.mark.parametrize("B, Tq, Tk, D, H", [
    (1, 160, 160, 512, 32),   # upper, hands, face decoders
    (1, 160, 160, 512, 64),   # lowertrans decoder
    (3, 70, 45, 128, 4),      # ragged query tiles, Dh 32
    (2, 33, 17, 256, 4),      # Dh 64
    (2, 37, 161, 512, 32),    # neither a multiple of a block's 32 query
                              # rows nor of a team's 8 lanes x 4 keys
    (1, 50, 300, 256, 4),     # 163 KB of keys and values at Dh 64, past
                              # the 48 KB a launch gets without asking
    (2, 5, 3, 64, 8),         # fewer keys than a team has lanes, Dh 8
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
    again = fused_softmax_mha(q, k, v, H, scale)
    ref = softmax_mha_reference(q, k, v, H, scale)
    torch.cuda.synchronize()
    assert out.shape == (B, Tq, D)
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= TOL_K2


@pytest.mark.parametrize("Tq, Tk, D, H", [
    (16, 16, 48, 4),      # Dh 12: no kernel for that head width
    (8, 1500, 256, 16),   # Dh 16: the keys and values exceed 227 KB
])
def test_codec_attention_routes_unsupported_shapes_to_the_plain_path(
        dev, Tq, Tk, D, H):
    from raggesture_tpu_torch.models.vae import TorchMHA
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )

    g = torch.Generator(device=dev).manual_seed(Tk)
    with torch.device(dev):
        mod = TorchMHA(D, H)
    q = torch.randn(2, Tq, D, generator=g, device=dev)
    kv = torch.randn(2, Tk, D, generator=g, device=dev)
    before = fused_softmax_mha.launches
    with torch.no_grad():
        out = mod(q, kv, kv)
        ref = mod.out_proj(softmax_mha_reference(
            mod.q_proj(q), mod.k_proj(kv), mod.v_proj(kv), H,
            1.0 / math.sqrt(D // H)))
    torch.cuda.synchronize()
    assert fused_softmax_mha.launches == before
    assert out.shape == (2, Tq, D)
    assert (out - ref).abs().max().item() <= TOL_K2


def test_softmax_mha_kernel_refuses_what_it_does_not_take(dev):
    from raggesture_tpu_torch.ops.mha import fused_softmax_mha

    q = torch.randn(1, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head width"):
        fused_softmax_mha(q, q, q, 4, 1.0)             # Dh 12
    with pytest.raises(ValueError, match="float32"):
        fused_softmax_mha(q.half(), q.half(), q.half(), 6, 1.0)


# K3, cond_contexts.  Both sides round the same operands to bf16 before each
# product and sum in float32 in other orders; an operand near a bf16
# rounding boundary can land one step (2^-8 relative) apart, which moves a
# context or a gradient by ~1e-4 of its largest element.  Tolerance: max
# |kernel - plain| over max |plain|, per tensor; the key side's gradients
# against the larger of the key and value scales: the time softmax is
# invariant to a per-column shift, so dbk is zero in exact arithmetic, and
# so is dwk for a one-token stream (its softmax weight is exactly 1); both
# sides then return rounding noise.
TOL_K3 = 2e-3
K3_NAMES = ("dxf", "dg", "db", "dwk", "dbk", "dwv", "dbv")


def _k3_errors(got, want, names, scale_of=None):
    scale = {n: b.abs().max()
             for n, b in zip(names, want if scale_of is None else scale_of)}
    for k_side, v_side in (("dwk", "dwv"), ("dbk", "dbv")):
        scale[k_side] = max(scale[k_side], scale[v_side])
    return {n: ((a - b).abs().max() / scale[n]).item()
            for n, a, b in zip(names, got, want)}


def _k3_case(dev, B, N, D, H, L, seed=0, cm_value=None, pad_to=None):
    """Padded inputs of one condition stream, bf16 weights, a condition
    mask with dropped elements (every element ``cm_value`` if given), and
    a random context cotangent.  ``pad_to``: rows per sequence past
    pad_rows' multiple of 8 (more padding rows, validity 0)."""
    from raggesture_tpu_torch.ops.cond_ctx import pad_rows

    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, device=dev)

    xf = rn(B, N, D)
    cm = torch.ones(B, 1, 1, device=dev)
    cm[1::3] = 0.0
    if cm_value is not None:
        cm[:] = cm_value
    xf_p, cm3, nv = pad_rows(xf, cm)
    if pad_to is not None:
        more = (0, 0, 0, pad_to - xf_p.shape[1])
        xf_p = torch.nn.functional.pad(xf_p, more)
        nv = torch.nn.functional.pad(nv, more)
    params = (1.0 + rn(L, D, s=0.1), rn(L, D, s=0.1),
              rn(L, D, D, s=D ** -0.5).to(torch.bfloat16), rn(L, D, s=0.1),
              rn(L, D, D, s=D ** -0.5).to(torch.bfloat16), rn(L, D, s=0.1))
    dctx = rn(B, L, H, D // H, D // H)
    return xf_p, cm3, nv, params, dctx


def _k3_kernels(case, H):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    xf, cm, nv, (g, b, wk, bk, wv, bv), dctx = case
    out, saved = cond_ctx_forward(xf, cm, nv, g, b, wk, bk, wv, bv, H)
    dxf, dg, db, inter = cond_ctx_backward_a(xf, cm, nv, g, b, wk, bk, wv,
                                             bv, out, saved, dctx, H)
    return (out, dxf, dg, db) + cond_ctx_backward_b(xf, cm, g, b, saved,
                                                    inter)


def _k3_plain(case, H):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_reference,
        cond_ctx_reference,
    )

    xf, cm, nv, params, dctx = case
    params = tuple(p.float() for p in params)
    bf16 = torch.bfloat16
    return (cond_ctx_reference(xf, cm, nv, *params, H, bf16),) + \
        cond_ctx_backward_reference(xf, cm, nv, *params, dctx, H, bf16)


@pytest.mark.parametrize("B, N, D, H, L", [
    (5, 37, 256, 8, 3),       # mid size: ragged row tiles, two column tiles
    (3, 70, 256, 16, 2),      # head width 16
    (3, 9, 128, 16, 2),       # head width 8
    (6, 1, 128, 4, 2),        # a speaker-like stream: 1 row of 8
    (16, 150, 512, 16, 8),    # text stream at the training widths
    (128, 499, 512, 16, 8),   # audio stream at the training shape
])
def test_cond_ctx_kernels_match_plain_versions(dev, B, N, D, H, L):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    case = _k3_case(dev, B, N, D, H, L)
    before = (cond_ctx_forward.launches, cond_ctx_backward_a.launches,
              cond_ctx_backward_b.launches)
    got = _k3_kernels(case, H)
    assert (cond_ctx_forward.launches, cond_ctx_backward_a.launches,
            cond_ctx_backward_b.launches) == tuple(n + 1 for n in before)
    want = _k3_plain(case, H)
    torch.cuda.synchronize()
    for name, a, b in zip(("ctx",) + K3_NAMES, got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
    errors = _k3_errors(got, want, ("ctx",) + K3_NAMES)
    assert max(errors.values()) <= TOL_K3, errors


def test_cond_ctx_kernels_are_deterministic(dev):
    case = _k3_case(dev, 32, 150, 512, 16, 8, seed=3)
    first = _k3_kernels(case, 16)
    second = _k3_kernels(case, 16)
    for name, a, b in zip(("ctx",) + K3_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B, N, D, H, L, cm_value", [
    (3, 37, 256, 8, 2, None),      # B*Np = 120: no whole split-K chunk
    (128, 1, 512, 16, 8, None),    # Np 8 at batch 128: 16 sequences a tile
    (5, 37, 256, 8, 2, 0.0),       # every condition dropped
    (4, 21, 128, 16, 2, None),     # D 128 with head width 8
])
def test_cond_ctx_backward_kernels_at_the_edges(dev, B, N, D, H, L,
                                               cm_value):
    """Against the plain versions at TOL_K3, finite, bitwise repeatable,
    one count a call on each wrapper (the kernel instances a call:
    test_cond_ctx_backward_kernel_instances, at the end of this file).
    With every condition dropped each value row is the bias, so the
    gradients through the keys (dxf, dg, db, dwk, dbk) and dwv (its
    operand xn cm is zero) vanish in exact arithmetic and both sides return
    rounding noise: they are held against the scales of the same inputs
    with the conditions kept."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    case = _k3_case(dev, B, N, D, H, L, cm_value=cm_value)
    got = _k3_kernels(case, H)
    again = _k3_kernels(case, H)
    want = _k3_plain(case, H)
    torch.cuda.synchronize()
    names = ("ctx",) + K3_NAMES
    for name, a, b, c in zip(names, got, want, again):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, c), name
    scale_of = None
    if cm_value == 0.0:
        xf, cm, nv, params, dctx = case
        scale_of = _k3_plain((xf, torch.ones_like(cm), nv, params, dctx), H)
    errors = _k3_errors(got, want, names, scale_of)
    assert max(errors.values()) <= TOL_K3, errors

    # one count a call on each wrapper
    xf, cm, nv, (g, b, wk, bk, wv, bv), dctx = case
    out, saved = cond_ctx_forward(xf, cm, nv, g, b, wk, bk, wv, bv, H)
    counts = (cond_ctx_backward_a.launches, cond_ctx_backward_b.launches)
    inter = cond_ctx_backward_a(xf, cm, nv, g, b, wk, bk, wv, bv, out, saved,
                                dctx, H)[3]
    cond_ctx_backward_b(xf, cm, g, b, saved, inter)
    assert (cond_ctx_backward_a.launches,
            cond_ctx_backward_b.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("B, N, D, H, L, cm_value, pad_to", [
    (5, 37, 256, 8, 2, None, None),   # Np 40: tile 1 starts inside seq 3
    (2, 100, 256, 16, 2, None, 152),  # Np 152, rows 100..151 padding: the
                                      # segments in tiles 1 and 2 are
                                      # padding rows only
    (128, 1, 512, 16, 8, None, None),  # speaker: Np 8, every seq whole
    (5, 37, 256, 8, 2, 0.0, None),    # every condition dropped
    (4, 21, 128, 16, 2, None, None),  # head width 8, Np 24
    (3, 13, 128, 8, 2, None, None),   # B * Np = 48 < 128: one ragged tile
])
def test_cond_ctx_forward_kernels_at_the_edges(dev, B, N, D, H, L, cm_value,
                                               pad_to):
    """The forward (ln_rows, ctx_fwd_kv, ctx_fwd_merge) against the plain
    version at TOL_K3, and the backward wrappers on its column max and sum
    and its xn likewise; finite, bitwise repeatable, and a forward captured
    in a CUDA graph replays to the eager call's bits.  Gradients of the
    all-dropped case against the scales with the conditions kept, as in
    test_cond_ctx_backward_kernels_at_the_edges."""
    from raggesture_tpu_torch.ops.cond_ctx import cond_ctx_forward

    case = _k3_case(dev, B, N, D, H, L, cm_value=cm_value, pad_to=pad_to)
    got = _k3_kernels(case, H)
    again = _k3_kernels(case, H)
    want = _k3_plain(case, H)
    torch.cuda.synchronize()
    names = ("ctx",) + K3_NAMES
    for name, a, b, c in zip(names, got, want, again):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, c), name
    scale_of = None
    if cm_value == 0.0:
        xf, cm, nv, params, dctx = case
        scale_of = _k3_plain((xf, torch.ones_like(cm), nv, params, dctx), H)
        scale_of = (want[0],) + scale_of[1:]
    errors = _k3_errors(got, want, names, scale_of)
    assert max(errors.values()) <= TOL_K3, errors

    xf, cm, nv, prm, _ = case
    assert _replays_bit_equal(
        lambda: cond_ctx_forward(xf, cm, nv, *prm, H)[0])


def test_cond_ctx_backward_a_reads_the_forward_rows(dev):
    """Backward A takes xn from the forward's saved tensors and launches no
    row pass of its own: with xn scaled by 2 its gradients move (the
    products read the tensor handed over), and with the forward's own xn
    they match the plain versions at TOL_K3."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_forward,
    )

    case = _k3_case(dev, 5, 37, 256, 8, 2)
    xf, cm, nv, prm, dctx = case
    out, saved = cond_ctx_forward(xf, cm, nv, *prm, 8)
    assert saved[4].shape == (2, 5, 40, 256)
    assert saved[4].dtype == torch.bfloat16
    dxf = cond_ctx_backward_a(xf, cm, nv, *prm, out, saved, dctx, 8)[0]
    doubled = saved[:4] + (saved[4] * 2,)
    dxf2 = cond_ctx_backward_a(xf, cm, nv, *prm, out, doubled, dctx, 8)[0]
    want = _k3_plain(case, 8)
    torch.cuda.synchronize()
    assert not torch.equal(dxf, dxf2)
    err = ((dxf - want[1]).abs().max() / want[1].abs().max()).item()
    assert err <= TOL_K3, err


def test_cond_contexts_on_the_card_runs_the_kernels(dev):
    """The wrapper on CUDA tensors: the three kernels through autograd,
    and gradients that match the plain versions'."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts,
        cond_contexts_plain,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    D, H, L = 256, 8, 2
    xf = torch.randn(4, 21, D, generator=g, device=dev, requires_grad=True)
    cm = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev).reshape(4, 1, 1)
    params = [torch.randn(L, D, generator=g, device=dev) * 0.1 + 1.0,
              torch.randn(L, D, generator=g, device=dev) * 0.1,
              torch.randn(L, D, D, generator=g, device=dev) * D ** -0.5,
              torch.randn(L, D, generator=g, device=dev) * 0.1,
              torch.randn(L, D, D, generator=g, device=dev) * D ** -0.5,
              torch.randn(L, D, generator=g, device=dev) * 0.1]
    for p in params:
        p.requires_grad_(True)
    w = torch.randn(4, L, H, D // H, D // H, generator=g, device=dev)
    f0, b0 = cond_ctx_forward.launches, cond_ctx_backward_b.launches
    out = cond_contexts(xf, cm, *params, num_heads=H)
    got = torch.autograd.grad((out * w).sum(), [xf] + params)
    assert (cond_ctx_forward.launches, cond_ctx_backward_b.launches) == (
        f0 + 1, b0 + 1)
    ref = cond_contexts_plain(xf, cm, *params, num_heads=H,
                              operand_dtype=torch.bfloat16)
    want = torch.autograd.grad((ref * w).sum(), [xf] + params)
    torch.cuda.synchronize()
    errors = _k3_errors((out,) + got, (ref,) + want, ("ctx",) + K3_NAMES)
    assert max(errors.values()) <= TOL_K3, errors


# K4, K5, K7, K8: the split path's kernels.  float32 throughout; the plain
# versions run float32 cuBLAS products (no TF32) that sum in other orders
# (the kernels multiply in 3xTF32, float32-accurate).
TOL_SPLIT = 1e-4
SPLIT_KERNELS = ("self_attention", "cross_attention_cached",
                 "cross_block_cached", "ffn")


def _split_case(dev, B, D, H, F, frames=150, dead_partner=False):
    """One DecoderLayer's weights, float32 inputs of the split blocks at
    B sequences of 43 tokens (150 frames), one extra masked token, the
    true-separator query masks, and contexts with the conditions dropped in
    every other sequence."""
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DenoiserConfig,
        GestureDenoiser,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        cross_context,
        split_mask_rows,
        stack_layer_contexts,
    )

    cfg = DenoiserConfig(latent_dim=D, time_embed_dim=2 * D, num_heads=H,
                         ff_size=F, max_seq_len=frames, num_layers=1)
    g = torch.Generator(device=dev).manual_seed(B * D + H + F)
    with torch.device(dev):
        den = GestureDenoiser(cfg)
    init_weights(den, g, zero_init_std=0.02)
    layer = den.block_0
    T = cfg.num_tokens
    frame_mask = torch.ones(B, frames, device=dev)
    if dead_partner:
        frame_mask[1] = 0.0
    tmask = latent_motion_mask(cfg, frame_mask)
    tmask[0, 5] = 0.0
    qm = torch.ones(B, T, device=dev)
    qm[:, list(cfg.sep_indices)] = 0.0
    src, qm3 = split_mask_rows(tmask, {k: qm for k in COND_KEYS})
    cm = (torch.arange(B, device=dev) % 2 == 0).float().reshape(B, 1, 1)
    ctx = {(0, k): cross_context(getattr(layer, f"ca_{k}"),
                                 torch.randn(B, n, D, generator=g, device=dev),
                                 cm, cfg.ca_heads)
           for k, n in zip(COND_KEYS, (20, 33, 1))}
    case = dict(den=den, H=H, x=torch.randn(B, T, D, generator=g,
                                                device=dev),
                src=src, qm3=qm3,
                ctx3=stack_layer_contexts(cfg, ctx, torch.float32)[0],
                scale=0.1 * torch.randn(B, 5, D, generator=g, device=dev),
                shift=0.1 * torch.randn(B, 5, D, generator=g, device=dev))
    valid = (src[..., 0] > 0) & (qm3 > 0).all(-1)
    return case, valid


def _split_call(kernel, case, plain=False):
    """(the wrapper that counts launches, its output) for one split kernel
    on ``case``; ``plain`` runs the kernel's plain version instead."""
    from raggesture_tpu_torch.models.fused_denoiser import pack_split_layers
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import ffn as FF
    from raggesture_tpu_torch.ops import self_attention as SA

    c = case
    if "packs" not in c:
        c["packs"] = pack_split_layers(c["den"])[0]
    w, H, x = c["packs"], c["H"], c["x"]
    sc, sh = c["scale"], c["shift"]
    if kernel == "self_attention":
        module = SA
        fn = SA.fused_self_attention
        args = (x, c["src"], sc[:, 0], sh[:, 0], w.sa, H)
    elif kernel == "cross_attention_cached":
        # the audio stream, through column views as the split path passes
        module = CA
        fn = CA.fused_cross_attention_cached
        args = (x, c["ctx3"][:, 1], c["qm3"][..., 1:2], sc[:, 2], sh[:, 2],
                w.cross_block.cas[1], H)
    elif kernel == "cross_block_cached":
        module = CA
        fn = CA.fused_cross_block_cached
        args = (x, c["ctx3"], c["qm3"], sc[:, 1:4], sh[:, 1:4],
                w.cross_block, H)
    else:
        module = FF
        fn = FF.fused_ffn
        args = (x, sc[:, 4], sh[:, 4], w.ffn)
    if plain:
        return fn, getattr(module, f"{fn.__name__}_reference")(*args)
    return fn, fn(*args)


@pytest.mark.parametrize("kernel", SPLIT_KERNELS)
@pytest.mark.parametrize("B, D, H, F", [
    (2, 512, 16, 1024),   # sampling: two halves of one clip, shipped widths
    (2, 64, 2, 128),      # narrow: two GEMM column tiles, head width 32
    (3, 128, 16, 256),    # head width 8, an odd number of sequences
    (2, 256, 4, 512),     # head width 64
])
def test_split_kernel_matches_plain_version(dev, kernel, B, D, H, F):
    case, valid = _split_case(dev, B, D, H, F)
    fn, _ = _split_call(kernel, case, plain=True)
    before = fn.launches
    _, out = _split_call(kernel, case)
    assert fn.launches == before + 1
    _, ref = _split_call(kernel, case, plain=True)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == case["x"].shape
    assert torch.isfinite(out[valid]).all()
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_SPLIT, err


def test_self_attention_kernel_with_a_fully_masked_partner(dev):
    case, valid = _split_case(dev, 2, 512, 16, 1024, dead_partner=True)
    _, out = _split_call("self_attention", case)
    _, ref = _split_call("self_attention", case, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert not valid[1].any()
    assert (out - ref)[valid].abs().max().item() <= TOL_SPLIT


def test_split_kernels_are_deterministic(dev):
    case, _ = _split_case(dev, 2, 512, 16, 1024)
    for kernel in SPLIT_KERNELS:
        _, first = _split_call(kernel, case)
        _, second = _split_call(kernel, case)
        assert torch.equal(first, second), kernel


def test_split_kernels_refuse_what_they_do_not_take(dev):
    from raggesture_tpu_torch.models.fused_denoiser import pack_split_layers
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_block_cached,
    )
    from raggesture_tpu_torch.ops.ffn import fused_ffn
    from raggesture_tpu_torch.ops.self_attention import fused_self_attention

    case, _ = _split_case(dev, 2, 64, 2, 128)
    w = pack_split_layers(case["den"])[0]
    x, src = case["x"], case["src"]
    sc, sh = case["scale"][:, 0], case["shift"][:, 0]
    with pytest.raises(ValueError, match="float32"):
        fused_self_attention(x.double(), src, sc, sh, w.sa, 2)
    with pytest.raises(ValueError, match="shape"):
        fused_self_attention(x, src, sc[:, :32], sh, w.sa, 2)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ffn(strided, sc, sh, w.ffn)
    with pytest.raises(ValueError, match="head width"):
        fused_self_attention(x, src, sc, sh, w.sa, 16)          # Dh 4
    with pytest.raises(ValueError, match="query_mask3"):
        fused_cross_block_cached(x, case["ctx3"], case["qm3"][:, :, :2],
                                 case["scale"][:, 1:4],
                                 case["shift"][:, 1:4], w.cross_block, 2)
    # a pack of bfloat16 weights: refused at its first launch
    bf16 = pack_split_layers(case["den"].to(torch.bfloat16))[0]
    with pytest.raises(ValueError, match="FFNWeights.w1"):
        fused_ffn(x, sc, sh, bf16.ffn)


@pytest.mark.parametrize("shared_adaln", [False, True])
@pytest.mark.parametrize("kernel", ["self_attention", "ffn"])
@pytest.mark.parametrize("D, H, F", [
    (512, 16, 1024),   # head width 32, the shipped widths
    (128, 16, 96),     # head width 8: four heads a column tile; F != 2D
    (256, 4, 1056),    # head width 64; F > 1024: two ffn_down stages
    (256, 2, 512),     # head width 128: 128-column q, k, v tiles
])
def test_block_kernels_match_plain_version_across_sequences(
        dev, kernel, D, H, F, shared_adaln):
    """K5 and K8 at three sequences of 43 tokens, so that 16-row tiles
    straddle both sequence boundaries, with per-sequence or batch-shared
    (stride 0) adaLN rows."""
    case, valid = _split_case(dev, 3, D, H, F)
    if shared_adaln:   # one row for the batch: batch stride 0, as sampling
        for k in ("scale", "shift"):
            case[k] = case[k][:1].expand_as(case[k])
    fn, out = _split_call(kernel, case)
    _, ref = _split_call(kernel, case, plain=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_SPLIT, err
    assert torch.equal(out, _split_call(kernel, case)[1])


def _self_attention_case(dev, B, T, D, H):
    """One EfficientSelfAttention's weights and float32 inputs of K5: B
    sequences of T tokens, one masked token, per-sequence adaLN rows."""
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import EfficientSelfAttention
    from raggesture_tpu_torch.ops.self_attention import pack_self_attention

    g = torch.Generator(device=dev).manual_seed(T + D + H)
    with torch.device(dev):
        block = EfficientSelfAttention(D, H, 2 * D)
    init_weights(block, g, zero_init_std=0.02)
    mask = torch.ones(B, T, 1, device=dev)
    mask[0, 5] = 0.0
    return (torch.randn(B, T, D, generator=g, device=dev), mask,
            0.1 * torch.randn(B, D, generator=g, device=dev),
            0.1 * torch.randn(B, D, generator=g, device=dev),
            pack_self_attention(block), H)


@pytest.mark.parametrize("D, H, t_max", [(512, 16, 568), (256, 4, 274)])
def test_self_attention_kernel_at_the_longest_sequence_it_takes(dev, D, H,
                                                                t_max):
    """The largest T whose head fits a context block's 227 KB (head widths
    32 and 64) against the plain version; one token more raises."""
    from raggesture_tpu_torch.ops.self_attention import (
        fused_self_attention,
        fused_self_attention_reference,
    )

    args = _self_attention_case(dev, 2, t_max, D, H)
    before = fused_self_attention.launches
    out = fused_self_attention(*args)
    assert fused_self_attention.launches == before + 1
    ref = fused_self_attention_reference(*args)
    torch.cuda.synchronize()
    valid = args[1][..., 0] > 0
    assert torch.isfinite(out).all()
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_SPLIT, err
    longer = _self_attention_case(dev, 2, t_max + 1, D, H)
    with pytest.raises(ValueError, match="shared memory"):
        fused_self_attention(*longer)
    assert fused_self_attention.launches == before + 1


def test_split_denoiser_call_matches_plain_path(dev):
    """Two layers at a narrow width through fused_denoise_ctx's split
    path, every option set: kernels against plain versions, and K8's
    launches."""
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        create_model,
    )
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DenoiserConfig,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        adaln_table,
        fused_denoise_ctx,
        pack_split_layers,
        precompute_cross_contexts,
        split_mask_rows,
        stack_layer_contexts,
    )
    from raggesture_tpu_torch.ops.ffn import fused_ffn

    dc = DenoiserConfig(latent_dim=128, time_embed_dim=256, num_layers=2,
                        num_heads=4, ff_size=256)
    model = create_model(ArchitectureConfig(denoiser=dc), device=dev,
                         zero_init_std=0.02)
    den = model.denoiser
    g = torch.Generator(device=dev).manual_seed(4)
    B, T = 2, dc.num_tokens
    conds = den.encode_conditions(
        torch.randn(B, 30, dc.text_latent_dim, generator=g, device=dev),
        torch.randn(B, 50, dc.audio_latent_dim, generator=g, device=dev),
        torch.tensor([1, 1], device=dev))
    cm = torch.tensor([1.0, 0.0], device=dev).reshape(B, 1, 1)
    ctx3s = stack_layer_contexts(
        dc, precompute_cross_contexts(den, conds, cm), torch.float32)
    qm = torch.ones(B, T, device=dev)
    qm[:, list(dc.sep_indices)] = 0.0
    tmask = latent_motion_mask(dc, torch.ones(B, dc.max_seq_len, device=dev))
    src, qm3 = split_mask_rows(tmask, {k: qm for k in COND_KEYS})
    scale, shift = adaln_table(den, torch.tensor([700], device=dev))
    x = torch.randn(B, T, dc.latent_dim, generator=g, device=dev)
    valid = tmask > 0
    packs = pack_split_layers(den)
    for merged in (False, True):
        for ffn_k in (False, True):
            call = (den, x, scale[0], shift[0], packs, ctx3s, src, qm3)
            opts = dict(layer_kernel=False, merged_ca=merged,
                        ffn_pallas=ffn_k)
            before = fused_ffn.launches
            got = fused_denoise_ctx(*call, **opts)
            assert fused_ffn.launches == before + (2 if ffn_k else 0)
            want = fused_denoise_ctx(*call, **opts, split_fns=SPLIT_PLAIN)
            torch.cuda.synchronize()
            err = (got - want)[valid].abs().max().item()
            assert err <= TOL_SPLIT, (merged, ffn_k, err)


# K6: the uncached cross attention.  float32 throughout, like its plain
# version; the k and v products run over the N condition rows of each call.
def _k6_case(dev, B, D, H, N, seed=0):
    """One EfficientCrossAttention's weights and float32 inputs: B
    sequences of 43 tokens, true-separator query masks, N condition rows,
    the conditions dropped in every other sequence."""
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        DenoiserConfig,
        EfficientCrossAttention,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        pack_cross_attention_kv,
    )

    cfg = DenoiserConfig()
    T = cfg.num_tokens
    g = torch.Generator(device=dev).manual_seed(seed + B * D + H + N)
    with torch.device(dev):
        block = EfficientCrossAttention(D, H, 2 * D)
    init_weights(block, g, zero_init_std=0.02)
    qm = torch.ones(B, T, 1, device=dev)
    qm[:, list(cfg.sep_indices)] = 0.0
    cm = (torch.arange(B, device=dev) % 2 == 0).float().reshape(B, 1, 1)
    args = (torch.randn(B, T, D, generator=g, device=dev),
            torch.randn(B, N, D, generator=g, device=dev), qm, cm,
            0.1 * torch.randn(B, D, generator=g, device=dev),
            0.1 * torch.randn(B, D, generator=g, device=dev),
            pack_cross_attention_kv(block), H)
    return args, qm[..., 0] > 0


@pytest.mark.parametrize("B, D, H, N", [
    (2, 512, 16, 150),    # the text stream at the shipped widths
    (2, 512, 16, 499),    # audio: eight 64-row tiles, the last ragged
    (2, 512, 16, 1),      # speaker: one row, one 8-row tile
    (4, 512, 16, 499),    # the inversion's batch of exemplars
    (3, 128, 16, 13),     # head width 8, an odd number of sequences
    (2, 256, 4, 70),      # head width 64: 32-row tiles, >48 KB of stages
    (2, 512, 16, 63),     # one 64-row tile, one row short of full
    (2, 512, 16, 64),     # one full tile
    (2, 512, 16, 65),     # a full tile and a one-row tile
    (2, 512, 16, 128),    # two full tiles
    (2, 128, 16, 40),     # head width 8: one 256-row tile
    (2, 256, 16, 150),    # head width 16: 128-row tiles
])
def test_cross_attention_kernel_matches_plain_version(dev, B, D, H, N):
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_attention,
        fused_cross_attention_reference,
    )

    args, valid = _k6_case(dev, B, D, H, N)
    before = fused_cross_attention.launches
    out = fused_cross_attention(*args)
    assert fused_cross_attention.launches == before + 1
    again = fused_cross_attention(*args)
    ref = fused_cross_attention_reference(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == args[0].shape
    # a dropped sequence's keys sit at -1e6: its context is ~bv, finite
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_SPLIT, err


def test_cross_attention_kernel_refuses_what_it_does_not_take(dev):
    from raggesture_tpu_torch.models.denoiser import EfficientCrossAttention
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_attention,
        pack_cross_attention_kv,
    )

    args, _ = _k6_case(dev, 2, 64, 2, 9)
    x, xf, qm, cm, sc, sh, w, H = args
    before = fused_cross_attention.launches
    with pytest.raises(ValueError, match="xf.*CUDA"):
        fused_cross_attention(x, xf.cpu(), qm, cm, sc, sh, w, H)
    with pytest.raises(ValueError, match="cond_mask.*CUDA"):
        fused_cross_attention(x, xf, qm, cm.cpu(), sc, sh, w, H)
    with pytest.raises(ValueError, match="float32"):
        fused_cross_attention(x, xf.double(), qm, cm, sc, sh, w, H)
    with pytest.raises(ValueError, match="shape"):
        fused_cross_attention(x, xf[:1], qm, cm, sc, sh, w, H)
    with pytest.raises(ValueError, match="condition row"):
        fused_cross_attention(x, xf[:, :0], qm, cm, sc, sh, w, H)
    # a pack of bfloat16 weights, or of CPU weights: refused at its first
    # launch
    with torch.device(dev):
        block = EfficientCrossAttention(64, 2, 128)
    bf16 = pack_cross_attention_kv(block.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CrossAttentionKVWeights.ln_g"):
        fused_cross_attention(x, xf, qm, cm, sc, sh, bf16, H)
    cpu = pack_cross_attention_kv(block.float().cpu())
    with pytest.raises(ValueError, match="CrossAttentionKVWeights"):
        fused_cross_attention(x, xf, qm, cm, sc, sh, cpu, H)
    assert fused_cross_attention.launches == before


def _unfused_model(dev):
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        create_model,
    )
    from raggesture_tpu_torch.models.codec import CodecConfig
    from raggesture_tpu_torch.models.denoiser import DenoiserConfig

    # the codec decoders' fixed 32 and 64 heads take the full width
    dc = DenoiserConfig(num_layers=2, ff_size=256)
    codec = CodecConfig(num_layers=1, ff_size=256)
    return create_model(ArchitectureConfig(denoiser=dc, codec=codec),
                        device=dev, zero_init_std=0.02)


def test_unfused_denoiser_call_matches_plain_and_cached_paths(dev):
    """Two layers at a narrow width: fused_denoise with the kernels against
    its plain versions (per-sample timesteps), and at a shared timestep
    against the cached split path, which computes the same function."""
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        adaln_table,
        fused_denoise,
        fused_denoise_ctx,
        pack_split_layers,
        pack_unfused_layers,
        precompute_cross_contexts,
        split_mask_rows,
        stack_adaln_weights,
        stack_layer_contexts,
    )
    from raggesture_tpu_torch.ops.cross_attention import fused_cross_attention
    from raggesture_tpu_torch.ops.self_attention import fused_self_attention

    den = _unfused_model(dev).denoiser
    dc = den.cfg
    g = torch.Generator(device=dev).manual_seed(5)
    B, T = 2, dc.num_tokens
    conds = den.encode_conditions(
        torch.randn(B, 30, dc.text_latent_dim, generator=g, device=dev),
        torch.randn(B, 50, dc.audio_latent_dim, generator=g, device=dev),
        torch.tensor([1, 2], device=dev))
    cm = torch.tensor([1.0, 0.0], device=dev).reshape(B, 1, 1)
    qm = torch.ones(B, T, device=dev)
    qm[:, list(dc.sep_indices)] = 0.0
    qms = {k: qm for k in COND_KEYS}
    tmask = latent_motion_mask(dc, torch.ones(B, dc.max_seq_len, device=dev))
    tmask[1, 3] = 0.0
    x = torch.randn(B, T, dc.latent_dim, generator=g, device=dev)
    valid = (tmask > 0) & (qm > 0)
    packs, adaln = pack_unfused_layers(den), stack_adaln_weights(den)
    t = torch.tensor([880, 12], device=dev)
    before = (fused_self_attention.launches, fused_cross_attention.launches)
    got = fused_denoise(den, x, t, tmask, conds, qms, cm, packs, adaln)
    assert (fused_self_attention.launches - before[0],
            fused_cross_attention.launches - before[1]) == (2, 6)
    want = fused_denoise(den, x, t, tmask, conds, qms, cm, packs, adaln,
                         fns=SPLIT_PLAIN)
    torch.cuda.synchronize()
    assert (got - want)[valid].abs().max().item() <= TOL_SPLIT

    t = torch.tensor([700, 700], device=dev)
    uncached = fused_denoise(den, x, t, tmask, conds, qms, cm, packs, adaln)
    scale, shift = adaln_table(den, t[:1])
    src, qm3 = split_mask_rows(tmask, qms)
    cached = fused_denoise_ctx(
        den, x, scale[0], shift[0], pack_split_layers(den),
        stack_layer_contexts(dc, precompute_cross_contexts(den, conds, cm),
                             torch.float32), src, qm3, layer_kernel=False)
    torch.cuda.synchronize()
    assert (uncached - cached)[valid].abs().max().item() <= TOL_SPLIT


def test_unfused_generator_runs_the_kernels(dev):
    """StagedGenerator(fused=False) at a narrow width, three steps: a plain
    clip and a retrieval-guided clip (inversion of three exemplars, bucketed
    to four, insertion guidance) count their K5 and K6 launches, and the
    same seed gives the same clip."""
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import (
        InferenceOptions,
        StagedGenerator,
    )
    from raggesture_tpu_torch.ops.cross_attention import fused_cross_attention
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer
    from raggesture_tpu_torch.ops.self_attention import fused_self_attention

    model = _unfused_model(dev)
    dc = model.cfg.denoiser
    # eager (graphs off): a captured pipeline launches from Python only
    # at its capture
    gen = StagedGenerator(model, make_schedule("scaled_linear", 1000,
                                               "1,1,1", 3), fused=False,
                          graphs=False)
    g = torch.Generator(device=dev).manual_seed(6)
    T, D, Q = dc.num_tokens, dc.latent_dim, 3
    batch = {"word": torch.randn(1, 40, dc.text_latent_dim, generator=g,
                                 device=dev),
             "audio": torch.randn(1, 60, dc.audio_latent_dim, generator=g,
                                  device=dev),
             "speaker_ids": torch.tensor([2], device=dev),
             "motion_mask": torch.ones(1, dc.max_seq_len, device=dev)}
    re_dict = {"inv_latents": torch.randn(Q, T, D, generator=g, device=dev),
               "inv_mask": torch.ones(Q, T, device=dev),
               "inv_conds": {"word": batch["word"].expand(Q, -1, -1),
                             "audio": batch["audio"].expand(Q, -1, -1),
                             "speaker_ids": torch.tensor([0, 1, 2],
                                                         device=dev)},
               "splice": [[0, 0, 0, 3], [0, 2, 1, 4], [0, 5, 0, 2]]}
    counted = (fused_self_attention, fused_cross_attention,
               fused_decoder_layer)
    L = dc.num_layers
    for opts, calls in ((InferenceOptions(), 3),
                        (InferenceOptions(use_inversion=True,
                                          insertion_guidance=True), 6)):
        clips = []
        for _ in range(2):
            before = [fn.launches for fn in counted]
            clips.append(gen(batch, torch.Generator(device=dev).manual_seed(0),
                             opts, re_dict)["output_latents"])
            assert [fn.launches - b for fn, b in zip(counted, before)] == [
                calls * L, 3 * calls * L, 0]
        torch.cuda.synchronize()
        assert torch.isfinite(clips[0]).all()
        assert torch.equal(clips[0], clips[1])


# The query side of K4, K7 and K6 (cross_query, cross_output and K7's
# cross_mix): 16-row tiles that straddle sequences at T = 43, each row's
# context, query mask and adaLN rows picked by its sequence.
def _device_kernels(fn, calls=4):
    """Names of the device operations of ``calls`` calls of ``fn``
    (torch.profiler; windows retaken until two agree on their count, since
    a window now and then records only part of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in p.events()
                 if ev.device_type == DeviceType.CUDA]
        if names and any(len(names) == len(w) for w in windows):
            return names
        windows.append(names)
    return max(windows, key=len)


def _replays_bit_equal(fn):
    """fn() eagerly and from a CUDA graph of one call: the same bits."""
    eager = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(captured, eager)


@pytest.mark.parametrize("shared_adaln", [False, True])
@pytest.mark.parametrize("kernel", ["cross_attention_cached",
                                    "cross_block_cached"])
@pytest.mark.parametrize("D, H", [
    (512, 16),   # head width 32, the shipped widths
    (128, 16),   # head width 8: four heads a 32-column tile
    (256, 4),    # head width 64: 64-column tiles
    (256, 2),    # head width 128: 128-column tiles, three-stage ring
])
def test_cross_query_side_matches_plain_version_across_sequences(
        dev, kernel, D, H, shared_adaln):
    case, valid = _split_case(dev, 3, D, H, 2 * D)
    if shared_adaln:   # one row for the batch: batch stride 0, as sampling
        for k in ("scale", "shift"):
            case[k] = case[k][:1].expand_as(case[k])
    # one more masked query row, in the tile that straddles sequences 0|1
    case["qm3"][1, 2] = 0.0
    valid = valid & (case["qm3"] > 0).all(-1)
    fn, out = _split_call(kernel, case)
    _, ref = _split_call(kernel, case, plain=True)
    torch.cuda.synchronize()
    # every row finite, the masked ones too: a NaN would reach every row
    # of the next layer through its value mask
    assert torch.isfinite(out).all()
    err = (out - ref)[valid].abs().max().item()
    assert err <= TOL_SPLIT, err
    assert torch.equal(out, _split_call(kernel, case)[1])


@pytest.mark.parametrize("kernel, kernels", [
    ("cross_attention_cached", 2), ("cross_block_cached", 3)])
def test_cross_query_side_launches_and_replays_in_a_cuda_graph(
        dev, kernel, kernels):
    case, _ = _split_case(dev, 2, 512, 16, 1024)
    case["scale"] = case["scale"][:1].expand_as(case["scale"])
    case["shift"] = case["shift"][:1].expand_as(case["shift"])
    names = _device_kernels(lambda: _split_call(kernel, case))
    assert len(names) == 4 * kernels, names
    assert all("cross_" in n for n in names), names
    assert _replays_bit_equal(lambda: _split_call(kernel, case)[1])


@pytest.mark.parametrize("N, kernels", [(150, 5), (499, 5), (1, 4)])
def test_cross_attention_kernel_launches_and_replays_in_a_cuda_graph(
        dev, N, kernels):
    from raggesture_tpu_torch.ops.cross_attention import fused_cross_attention

    args, _ = _k6_case(dev, 2, 512, 16, N)
    names = _device_kernels(lambda: fused_cross_attention(*args))
    assert len(names) == 4 * kernels, names
    assert _replays_bit_equal(lambda: fused_cross_attention(*args))


# K5 and K8: three launches each, the last two programmatic dependent
# launches, and the names of their kernels (csrc/split_layer.cu).
BLOCK_KERNELS = {"self_attention": ("self_qkv", "self_context",
                                    "cross_output"),
                 "ffn": ("ffn_up", "ffn_down", "cross_output")}


@pytest.mark.parametrize("kernel", sorted(BLOCK_KERNELS))
def test_block_kernels_launch_three_kernels_and_replay_in_a_cuda_graph(
        dev, kernel):
    case, _ = _split_case(dev, 2, 512, 16, 1024)
    case["scale"] = case["scale"][:1].expand_as(case["scale"])
    case["shift"] = case["shift"][:1].expand_as(case["shift"])
    names = _device_kernels(lambda: _split_call(kernel, case))
    assert len(names) == 4 * 3, names
    # four calls: each of the three kernels four times, and nothing else
    assert {k: sum(k in n for n in names) for k in BLOCK_KERNELS[kernel]} \
        == dict.fromkeys(BLOCK_KERNELS[kernel], 4), names
    assert _replays_bit_equal(lambda: _split_call(kernel, case)[1])


# Kernel instances a wrapper call launches: backward A the key/value and dx
# products, the LayerNorm backward and the affine sums (the forward's row
# pass wrote its xn); backward B the split-K product and the sums of its
# chunks and bias partials.  Last in the file: a long run of profiler
# windows in one process now and then drops device records from the
# windows after it.
K3_BACKWARD_KERNELS = {"bwd_a": 4, "bwd_b": 2}
K3_FORWARD_KERNELS = ("ln_rows", "ctx_fwd_kv", "ctx_fwd_merge")


@pytest.mark.parametrize("B, N, D, H, L", [
    (3, 37, 256, 8, 2), (128, 1, 512, 16, 8), (4, 21, 128, 16, 2)])
def test_cond_ctx_backward_kernel_instances(dev, B, N, D, H, L):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    xf, cm, nv, (g, b, wk, bk, wv, bv), dctx = _k3_case(dev, B, N, D, H, L)
    out, saved = cond_ctx_forward(xf, cm, nv, g, b, wk, bk, wv, bv, H)
    inter = cond_ctx_backward_a(xf, cm, nv, g, b, wk, bk, wv, bv, out, saved,
                                dctx, H)[3]
    names_a = _device_kernels(lambda: cond_ctx_backward_a(
        xf, cm, nv, g, b, wk, bk, wv, bv, out, saved, dctx, H))
    names_b = _device_kernels(
        lambda: cond_ctx_backward_b(xf, cm, g, b, saved, inter))
    assert len(names_a) == 4 * K3_BACKWARD_KERNELS["bwd_a"], names_a
    assert len(names_b) == 4 * K3_BACKWARD_KERNELS["bwd_b"], names_b
    assert not any("ln_rows" in n for n in names_a), names_a


@pytest.mark.parametrize("B, N, D, H, L, kernels", [
    (3, 37, 256, 8, 2, 2),     # B * Np = 120: every sequence in tile 0
    (5, 37, 256, 8, 2, 3),     # seq 3 spans tiles 0 and 1: the merge runs
    (128, 1, 512, 16, 8, 2),   # the speaker's Np 8: 16 whole seqs a tile
    (16, 150, 512, 16, 8, 3),  # text: every sequence spans two tiles
])
def test_cond_ctx_forward_kernel_instances(dev, B, N, D, H, L, kernels):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_forward,
        forward_records,
    )

    xf, cm, nv, (g, b, wk, bk, wv, bv), _ = _k3_case(dev, B, N, D, H, L)
    assert forward_records(B, xf.shape[1], D, L, D // H).merge == (
        kernels == 3)
    names = _device_kernels(
        lambda: cond_ctx_forward(xf, cm, nv, g, b, wk, bk, wv, bv, H))
    assert len(names) == 4 * kernels, names
    assert {k: sum(k in n for n in names) for k in K3_FORWARD_KERNELS} == {
        k: 4 if i < kernels else 0
        for i, k in enumerate(K3_FORWARD_KERNELS)}, names


# one bf16 ulp of the largest dxf element on top of TOL_K3: the bf16
# entry points write dxf in bf16, held against the plain dxf rounded to
# bf16 (chip_smoke.py TOL_K3_BF16_DXF)
TOL_K3_BF16_DXF = 6e-3


@pytest.mark.parametrize("B, N, D, H, L, cm_value", [
    (5, 37, 256, 8, 2, None),      # ragged Np 40: sequences straddle tiles
    (6, 1, 128, 4, 2, None),       # a one-row stream: Np 8, every seq whole
    (128, 1, 512, 16, 8, None),    # the speaker at the training shape
    (5, 37, 256, 8, 2, 0.0),       # every condition dropped
    (16, 150, 512, 16, 8, None),   # text stream at the training widths
])
def test_cond_ctx_bf16_entries_match_plain_versions(dev, B, N, D, H, L,
                                                    cm_value):
    """K3's bf16 entry points (bf16 xf, bf16 dxf) against the plain
    versions on xf's values in float32 with dxf rounded to bf16: TOL_K3,
    dxf TOL_K3_BF16_DXF; finite, bitwise repeatable, one count a call on
    each wrapper, the same kernel instances as the float32 entries.  The
    all-dropped case against the scales with the conditions kept, as in
    test_cond_ctx_backward_kernels_at_the_edges."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
        forward_records,
    )

    xf, cm, nv, params, dctx = _k3_case(dev, B, N, D, H, L,
                                        cm_value=cm_value)
    case = (xf.to(torch.bfloat16), cm, nv, params, dctx)
    before = [f.launches for f in (cond_ctx_forward, cond_ctx_backward_a,
                                   cond_ctx_backward_b)]
    got = _k3_kernels(case, H)
    assert [f.launches - b for f, b in zip(
        (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b),
        before)] == [1, 1, 1]
    again = _k3_kernels(case, H)
    plain_case = (case[0].float(),) + case[1:]
    want = list(_k3_plain(plain_case, H))
    want[1] = want[1].to(torch.bfloat16).float()
    torch.cuda.synchronize()
    names = ("ctx",) + K3_NAMES
    assert got[1].dtype == torch.bfloat16
    for name, a, b, c in zip(names, got, want, again):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, c), name
    scale_of = None
    if cm_value == 0.0:
        scale_of = _k3_plain((plain_case[0], torch.ones_like(cm)) +
                             plain_case[2:], H)
        scale_of = (want[0],) + scale_of[1:]
    errors = _k3_errors([a.float() for a in got], want, names, scale_of)
    assert errors.pop("dxf") <= TOL_K3_BF16_DXF, errors
    assert max(errors.values()) <= TOL_K3, errors
    # the float32 entries' instances a call (8, and the merge where a
    # sequence spans row tiles), counted, not named: the profiler may
    # elide a long templated kernel name.  Here, beside the float32
    # entries' instance tests: late in a long process the profiler drops
    # device records
    names = _device_kernels(lambda: _k3_kernels(case, H), calls=2)
    merge = forward_records(B, xf.shape[1], D, L, D // H).merge
    assert len(names) == 2 * (8 + int(merge)), names


# The generator's pipelines as CUDA graphs (utils/cuda_graph.py): two
# layers at the shipped width, a one-layer codec, three steps.
GRAPH_PIPELINES = {
    # name: (generator options, the route of __call__)
    "plain": ({}, "sample"),
    "inseq": ({}, "outpaint"),
    "guided": ({}, "guided"),
    "guided_cached": ({}, "cached"),
    "plain_split": (dict(layer_kernel=False), "sample"),
    "plain_merged_ca": (dict(merged_ca=True), "sample"),
    "plain_unfused": (dict(fused=False), "sample"),
    # the staged path's routes (the long-form tool's generator)
    "invert_sample": (dict(fused=False), "invert"),
    "invert_sample_prev": (dict(fused=False), "invert_prev"),
    "guided_inseq": (dict(fused=False), "guided_prev"),
}


def _graph_case(dev):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule

    model = _unfused_model(dev)
    dc = model.cfg.denoiser
    g = torch.Generator(device=dev).manual_seed(6)
    T, D, Q = dc.num_tokens, dc.latent_dim, 3
    batch = {"word": torch.randn(1, 40, dc.text_latent_dim, generator=g,
                                 device=dev),
             "audio": torch.randn(1, 60, dc.audio_latent_dim, generator=g,
                                  device=dev),
             "speaker_ids": torch.tensor([2], device=dev),
             "motion_mask": torch.ones(1, dc.max_seq_len, device=dev)}
    rml = torch.zeros(1, T, D, device=dev)
    rml[:, [0, 1, 12]] = torch.randn(1, 3, D, generator=g, device=dev)
    re_dict = {"inv_latents": torch.randn(Q, T, D, generator=g, device=dev),
               "inv_mask": torch.ones(Q, T, device=dev),
               "inv_conds": {"word": batch["word"].expand(Q, -1, -1),
                             "audio": batch["audio"].expand(Q, -1, -1),
                             "speaker_ids": torch.tensor([0, 1, 2],
                                                         device=dev)},
               "splice": [[0, 0, 0, 3], [0, 2, 1, 4], [0, 5, 0, 2]],
               "raw_motion_latents": rml}
    return model, make_schedule("scaled_linear", 1000, "1,1,1", 3), batch, \
        re_dict


def _graph_run(gen, batch, re_dict, route, seed=0):
    from raggesture_tpu_torch.models.architecture import InferenceOptions

    g = torch.Generator(device=gen.device).manual_seed(seed)
    if route == "sample":
        return gen.sample(batch, generator=g)
    if route == "outpaint":
        return gen(batch, g, InferenceOptions(outpaint=True), re_dict)
    rd = dict(re_dict)
    if route == "cached":
        rd.update(inv_names=["e0", "e1", "e2"], num_queries=3)
    if route in ("invert", "invert_prev", "guided_prev"):
        # a previous chunk's latents, from its own seed
        dc = gen.model.cfg.denoiser
        prev = torch.randn(1, dc.num_tokens, dc.latent_dim, device=gen.device,
                           generator=torch.Generator(
                               device=gen.device).manual_seed(seed + 7))
        return gen(batch, g, InferenceOptions(
            use_inversion=True, insertion_guidance=route == "guided_prev",
            use_prev_latent=route != "invert"), rd, prev_latent=prev)
    return gen(batch, g, InferenceOptions(use_inversion=True,
                                          insertion_guidance=True), rd)


def _same_clip(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", sorted(GRAPH_PIPELINES))
def test_pipeline_replays_bitwise_equal_to_eager(dev, name):
    """Each pipeline captured at its first call: the first call and later
    replays equal the same pipeline run eagerly (graphs off), bit for bit;
    a replay launches nothing from Python; a held result survives the next
    replay; the allocated memory stays flat over ten replays."""
    from raggesture_tpu_torch.models.architecture import StagedGenerator
    from raggesture_tpu_torch.ops.cross_attention import fused_cross_attention
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer
    from raggesture_tpu_torch.ops.mha import fused_softmax_mha
    from raggesture_tpu_torch.ops.self_attention import fused_self_attention

    counted = (fused_decoder_layer, fused_softmax_mha, fused_self_attention,
               fused_cross_attention)
    opts, route = GRAPH_PIPELINES[name]
    model, sched, batch, re_dict = _graph_case(dev)
    eager = StagedGenerator(model, sched, graphs=False, **opts)
    graphed = StagedGenerator(model, sched, **opts)
    assert graphed.graphs is not None and eager.graphs is None
    want = _graph_run(eager, batch, re_dict, route)
    first = _graph_run(graphed, batch, re_dict, route)
    captures = 2 if route == "cached" else 1      # + the misses' inversion
    assert graphed.graphs.captures == captures == len(graphed.graphs)
    launches = [fn.launches for fn in counted]
    held = _graph_run(graphed, batch, re_dict, route)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == launches
    assert graphed.graphs.captures == captures
    assert _same_clip(first, want) and _same_clip(held, want)
    kept = {k: v.clone() for k, v in held.items()}
    other = _graph_run(graphed, batch, re_dict, route, seed=1)
    torch.cuda.synchronize()
    assert not torch.equal(other["output_latents"], held["output_latents"])
    assert _same_clip(held, kept)
    del other
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    for _ in range(10):
        del held
        held = _graph_run(graphed, batch, re_dict, route)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before
    assert _same_clip(held, want)


def test_params_setter_recaptures(dev):
    """After the setter the graphs are gone; the next call captures anew
    and equals a fresh eager generator on the new weights."""
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    model, sched, batch, re_dict = _graph_case(dev)
    gen = StagedGenerator(model, sched)
    _graph_run(gen, batch, re_dict, "cached")
    assert len(gen.graphs) == 2 and gen._inv_cache
    new = _unfused_model(dev)
    with torch.no_grad():
        for p in new.parameters():
            p.mul_(1.1)
    gen.params = new.state_dict()
    assert len(gen.graphs) == 0 and not gen._inv_cache
    for route, captures in (("sample", 3), ("cached", 5)):
        got = _graph_run(gen, batch, re_dict, route)
        assert gen.graphs.captures == captures
        want = _graph_run(StagedGenerator(new, sched, graphs=False), batch,
                          re_dict, route)
        assert _same_clip(got, want), route


def test_stacked_decode_attention_on_the_kernel(dev):
    """K2 on the stacked decode's (3·B, T, 512) operands, made by reshape
    from the batched projections: within TOL_K2 of its plain version."""
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    B, T, D = 2, 160, 512
    x = torch.randn(3, B * T, D, generator=g, device=dev)
    w = torch.randn(3, 3, D, D, generator=g, device=dev) / math.sqrt(D)
    q, k, v = (torch.bmm(x, w[i]).reshape(3 * B, T, D) for i in range(3))
    before = fused_softmax_mha.launches
    got = fused_softmax_mha(q, k, v, 32, 0.25)
    assert fused_softmax_mha.launches == before + 1
    want = softmax_mha_reference(q, k, v, 32, 0.25)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= TOL_K2


def test_serving_tool_on_the_card(dev):
    """The serving tool (``raggesture_tpu_torch.tools.visualize``) at the
    narrow tiny config, twice on a synthetic BEAT2 workspace: chip_smoke.py's
    phase 15 with its checks.  Each batch retrieves exemplars and launches
    no K1, and K5 and K6 where it captures a graph; the first batch's
    re_dict equals the same retrieval on the CPU (latents within 1e-4); its
    guided batch's denoiser calls, decode and whole-batch latents on the
    kernels are within 1e-3 of the plain versions under true-separator
    query masks; the second run takes every exemplar from the saved
    inversion cache."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    # the tiny config's cross attentions keep the base's 16 heads, 2 columns
    # each, which K6 does not take (8 to 64): 4 heads of 8 here.  Its codec
    # decoders' 16 heads of 2 columns take the plain attention, as
    # ops.mha.mha_supported routes them: no K2
    r = chip_smoke.serve_phase(torch, dev, config=os.path.join(
        repo, "configs/raggesture_beatx/tiny_smoke.py"), n_sec=10,
        config_options=["model.model.ca_block_cfg.num_heads=4"])
    assert all(b["num_queries"] > 0 for run in r["runs"]
               for b in run["batches"])
    calls = r["guided_calls_vs_plain_max_abs_err"]
    assert max(calls["true_sep"]["kernels"].values()) <= 1e-3
    assert calls["decode"]["kernels"] <= 1e-3
    whole = r["guided_batch_vs_plain_max_abs_diff"]
    assert whole["true_sep"]["kernels"]["output_latents"] <= 1e-3
    assert max(r["retrieval_vs_cpu_max_abs_err"].values()) <= 1e-4


def test_longform_tool_on_the_card(dev, tmp_path):
    """The long-form tool (``raggesture_tpu_torch.tools.longform_synthesis``)
    at the narrow tiny config on a synthetic BEAT2 workspace of 10-second
    clips: chip_smoke.py's phase 15 with its checks.  Both runs (one clip a
    wave, two) stitch every clip to its length at 30 fps, finite; every
    wave after a clip's first takes the guided handoff pipeline; a held
    prev_latentout survives every later replay; the staged pipelines'
    replays equal their eager runs bit for bit and launch nothing from
    Python; a 2-chunk handoff take on the kernels is within 1e-3 of the
    plain versions under true-separator query masks."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    # K6 takes 8 to 64 columns a head: the tiny config's cross attentions
    # at 4 heads of 8 (see test_serving_tool_on_the_card)
    r = chip_smoke.longform_phase(
        torch, dev, str(tmp_path), config=os.path.join(
            repo, "configs/raggesture_beatx/tiny_smoke.py"), n_sec=10,
        config_options=["model.model.ca_block_cfg.num_heads=4"])
    for run in r["runs"].values():
        assert [c["stitched_frames"] for c in run["clips"]] == [150, 150]
        assert run["graph_captures"] >= 2
    assert all(p["replay_equals_eager"] for p in r["pipelines"].values())
    assert all(e["latents"] <= 1e-3 and e["finite"]
               for e in r["take_vs_plain_max_abs_diff"]["true_sep"])


def test_training_tool_on_the_card(dev, tmp_path):
    """The training tool (``raggesture_tpu_torch.tools.train``) at the tiny
    config widened to 128 (K3 takes widths in multiples of 128), batch 4:
    chip_smoke.py's phase 17 with its checks.  The live bf16 run, and the
    latent cache streamed and banked, whose losses are equal bitwise, and
    the banked run resumed to a third epoch; K3's launches 3 a step (and 3
    a validation batch for the forward), every value finite, every
    parameter on the card."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    r = chip_smoke.train_tool_phase(
        torch, dev, str(tmp_path), config=os.path.join(
            repo, "configs/raggesture_beatx/tiny_smoke.py"), batch=4,
        config_options=["model.model.latent_dim=128",
                        "model.model.vae_cfg.latent_dim=128",
                        "model.model.retrieval_cfg.latent_dim=128",
                        "model.model.ca_block_cfg.num_heads=4"])
    runs = r["runs"]
    assert runs["b_cached"]["losses"] == runs["c_cached_bank"]["losses"]
    assert runs["c_cached_bank"]["bank"]["hits"] > 0
    assert runs["a_live_bf16"]["val_batches"] > 0
    assert runs["d_resumed"]["checkpoints"][-1] == "epoch_2.pt"


def test_cached_train_step_gradients_on_the_kernels(dev):
    """A training step on a batch of cached latents (no encode): K3's three
    kernels launch three times each, and the denoiser's gradients with the
    kernels are within 1e-2 of those with K3's plain versions (the
    training phase's tolerance; tensors whose gradient is zero in exact
    arithmetic left out)."""
    import functools
    import os
    import sys

    from raggesture_tpu_torch.models.architecture import training_loss
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts_plain,
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from chip_smoke import train_batch, zero_exact_gradient

    model = _unfused_model(dev)
    dc = model.cfg.denoiser
    B = 8
    batch, rt = train_batch(torch, dc, B, dev)
    with torch.no_grad():
        mu, logvar = model.encode_motion_dist(batch)
    cached = {k: batch[k] for k in ("motion_mask", "word", "audio",
                                    "speaker_ids")}
    cached.update(latent_mu=mu, latent_logvar=logvar)
    cond_mask = torch.ones(B, 1, 1, device=dev)
    cond_mask[::3] = 0.0
    draws = {"enc_eps": rt(*mu.shape), "noise": rt(*mu.shape),
             "t": torch.randint(0, 1000, (B,), device=dev,
                                generator=rt.generator),
             "cond_mask": cond_mask}
    model.codec.requires_grad_(False)
    fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)

    def grads(**kw):
        model.denoiser.zero_grad(set_to_none=True)
        loss, _ = training_loss(model, model.cfg.diffusion_train.schedule(
            device=dev), cached, **draws, **kw)
        loss.backward()
        return {k: p.grad.clone()
                for k, p in model.denoiser.named_parameters()}

    before = [fn.launches for fn in fns]
    got = grads()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [3, 3, 3]
    want = grads(ctx_fn=functools.partial(cond_contexts_plain,
                                          operand_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    err = max(((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
              for k in got if not zero_exact_gradient(k))
    assert err <= 1e-2


def test_bf16_train_step_gradients_on_the_kernels(dev):
    """A bf16_compute training step (live bf16 encode, K3's bf16 entry
    points): three launches of each K3 wrapper, the denoiser's gradients
    with the kernels within 2e-2 of those with K3's plain versions
    (chip_smoke.py TOL_TRAIN_GRAD_BF16; tensors whose gradient is zero in
    exact arithmetic left out), and the parameters float32."""
    import functools
    import os
    import sys

    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts_plain,
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.train.loop import bf16_loss

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from chip_smoke import train_batch, zero_exact_gradient

    model = _unfused_model(dev)
    dc = model.cfg.denoiser
    B = 8
    batch, rt = train_batch(torch, dc, B, dev)
    bf16 = torch.bfloat16
    cond_mask = torch.ones(B, 1, 1, device=dev, dtype=bf16)
    cond_mask[::3] = 0.0
    n_chunks = dc.max_seq_len // model.cfg.codec.frame_chunk_size
    draws = {"enc_eps": {p: rt(B, n_chunks, model.cfg.codec.latent_dim).to(
                 bf16) for p in ("upper", "hands", "face", "lowertrans")},
             "noise": rt(B, dc.num_tokens, dc.latent_dim).to(bf16),
             "t": torch.randint(0, 1000, (B,), device=dev,
                                generator=rt.generator),
             "cond_mask": cond_mask}
    model.codec.requires_grad_(False)
    sched = model.cfg.diffusion_train.schedule(device=dev)
    fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)

    def grads(**kw):
        model.denoiser.zero_grad(set_to_none=True)
        loss, _ = bf16_loss(model, sched, batch, None, {}, **draws, **kw)
        loss.backward()
        return {k: p.grad.clone()
                for k, p in model.denoiser.named_parameters()}

    before = [fn.launches for fn in fns]
    got = grads()
    assert [fn.launches - b for fn, b in zip(fns, before)] == [3, 3, 3]
    want = grads(ctx_fn=functools.partial(cond_contexts_plain,
                                          operand_dtype=bf16))
    torch.cuda.synchronize()
    err = max(((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
              for k in got if not zero_exact_gradient(k))
    assert err <= 2e-2
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.denoiser.parameters())


def test_sample_bank_gathers_on_the_card(dev):
    """DeviceSampleBank on the card: staged rows equal what device_batch
    ships, bitwise, through evictions below the unique ids of the batches
    in flight."""
    import numpy as np

    from raggesture_tpu_torch.train.cond_bank import DeviceSampleBank
    from raggesture_tpu_torch.train.runner import device_batch

    rng = np.random.RandomState(0)
    rows = {"word": rng.randn(10, 12, 16).astype(np.float32),
            "audio": rng.randn(10, 30, 16).astype(np.float32),
            "motion_mask": np.ones((10, 30), np.float32),
            "latent_mu": rng.randn(10, 43, 32).astype(np.float32),
            "latent_logvar": rng.randn(10, 43, 32).astype(np.float32),
            "speaker_ids": rng.randint(0, 25, 10)}
    bank = DeviceSampleBank(5, dev)
    evicted = []
    for ids in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 2, 3], [8, 9, 9, 4]):
        batch = {k: v[ids] for k, v in rows.items()}
        before = set(bank.resident())
        got = bank.stage(batch, np.asarray(ids))
        evicted.append(before - set(bank.resident()))
        want = device_batch(batch, dev)
        assert got.keys() == {k for k, v in want.items()
                              if isinstance(v, torch.Tensor)}
        for k, v in got.items():
            assert v.device.type == "cuda" and torch.equal(v, want[k]), k
    assert evicted == [set(), {0, 1, 2}, {4, 5, 6}, {0, 1, 7}]


# ---------------------------------------------------------------- evaluation


@pytest.fixture
def dev_tf32():
    """The card with TF32 allowed in cuBLAS and cuDNN (cuDNN's default;
    stricter than the matmul default): FK and the FGD embedder must scope
    float32 products themselves.  The flags are restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_fk_on_the_card_matches_the_cpu_under_tf32_flags(dev_tf32, tmp_path):
    """FK to joints and to face vertices of the release-shaped stand-in
    (10,475 vertices) on the card against the CPU within 1e-5 of the
    largest magnitude, with TF32 allowed outside the calls."""
    import numpy as np

    from raggesture_tpu_torch.models.smplx import load_smplx
    from raggesture_tpu_torch.tools.evaluate import (
        build_face_fk_fn,
        build_fk_fn,
    )

    path = str(tmp_path / "SMPLX_NEUTRAL_2020.npz")
    _chip_smoke().write_smplx_standin(path, seed=1)
    rng = np.random.RandomState(0)
    T = 120
    pose = (rng.randn(T, 165) * 0.3).astype(np.float32)
    pose[:4] = 0.0
    exps = rng.randn(T, 100).astype(np.float32)
    trans = (rng.randn(T, 3) * 0.1).astype(np.float32)
    betas = rng.randn(300).astype(np.float32)
    out = {}
    for side, d in (("card", dev_tf32), ("cpu", "cpu")):
        m = load_smplx(path, device=d)
        out[side] = (build_fk_fn("", model=m)(pose, trans, exps, betas),
                     build_face_fk_fn("", model=m)(pose, exps, betas))
    for card, cpu in zip(out["card"], out["cpu"]):
        assert np.abs(card - cpu).max() <= 1e-5 * np.abs(cpu).max()
    assert torch.backends.cuda.matmul.allow_tf32


def test_fgd_map2latent_on_the_card_matches_the_cpu_under_tf32_flags(
        dev_tf32, tmp_path):
    """The embedder's latents from the reference-shaped stand-in
    checkpoint on the card against the CPU within 1e-5 of their scale,
    with TF32 allowed outside the call."""
    import numpy as np

    from raggesture_tpu_torch.tools.evaluate import build_fgd_fn

    path = str(tmp_path / "AESKConv_240_100.bin")
    _chip_smoke().write_fgd_standin(path, seed=1)
    x = np.random.RandomState(2).randn(3, 96, 330).astype(np.float32)
    card = build_fgd_fn(path, device=dev_tf32)(x)
    cpu = build_fgd_fn(path, device="cpu")(x)
    assert card.shape == (3, 6, 240)
    assert np.abs(card - cpu).max() <= 1e-5 * np.abs(cpu).max()
    assert torch.backends.cudnn.allow_tf32


def test_evaluator_on_the_card_matches_the_cpu(dev_tf32, tmp_path):
    """The Evaluator with the tools' FK, face FK and FGD on the card
    against the same on the CPU over a small result tree: the continuous
    keys within 1e-4 relative, every key finite."""
    import math
    import os

    import numpy as np
    from scipy.io import wavfile

    from raggesture_tpu_torch.eval.evaluator import EvalConfig, Evaluator
    from raggesture_tpu_torch.models.smplx import load_smplx
    from raggesture_tpu_torch.tools import evaluate as tool
    from raggesture_tpu_torch.utils.motion_io import save_smplx_npz

    cs = _chip_smoke()
    asset, ckpt = str(tmp_path / "smplx.npz"), str(tmp_path / "fgd.bin")
    cs.write_smplx_standin(asset, seed=2)
    cs.write_fgd_standin(ckpt, seed=2)
    rng = np.random.RandomState(3)
    T = 96
    for i in range(3):
        d = str(tmp_path / "results" / f"clip_{i}" / "0")
        for name in ("pred_motion", "gt_motion", "retrieval_0"):
            poses = rng.randn(T, 165).astype(np.float32) * 0.2
            if name == "retrieval_0":
                poses[:20] = poses[60:] = 0.0
            save_smplx_npz(os.path.join(d, name + ".npz"), poses,
                           rng.randn(T, 100).astype(np.float32),
                           rng.randn(T, 3).astype(np.float32) * 0.01,
                           betas=rng.randn(300) * 0.1)
        wavfile.write(os.path.join(d, "gt_audio.wav"), 16000,
                      (rng.randn(T * 533) * 3000).astype(np.int16))
        np.save(os.path.join(d, "sem_score.npy"), rng.rand(T, 1))
    cfg = EvalConfig(eval_n=T, compute_srgr=True)
    summary = {}
    for side, d in (("card", dev_tf32), ("cpu", "cpu")):
        m = load_smplx(asset, device=d)
        ev = Evaluator(cfg, fgd_embed_fn=tool.build_fgd_fn(ckpt, device=d),
                       fk_fn=tool.build_fk_fn("", model=m),
                       face_fk_fn=tool.build_face_fk_fn("", model=m),
                       device=d)
        summary[side] = ev.evaluate(str(tmp_path / "results"))
    card, cpu = summary["card"], summary["cpu"]
    assert sorted(card) == sorted(cs.EVAL_KEYS)
    assert all(math.isfinite(v) for v in card.values())
    for k in cs.EVAL_CONTINUOUS:
        assert card[k] == pytest.approx(cpu[k], rel=1e-4), k


def test_evaluation_phase_on_the_card(dev, tmp_path):
    """chip_smoke.py's phase evaluate at the narrow tiny config, on the
    result directories of its phase serve: the three tools, the card
    against the CPU, the contacts in featurize_clip, with the phase's
    gates."""
    import os

    cs = _chip_smoke()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = os.path.join(repo, "configs/raggesture_beatx/tiny_smoke.py")
    opts = ["model.model.ca_block_cfg.num_heads=4"]
    ws = str(tmp_path)
    cs.serve_phase(torch, dev, config=config, n_sec=10,
                   config_options=opts, ws=ws)
    r = cs.evaluate_phase(torch, dev, ws, config=config,
                          config_options=opts)
    assert r["result_dirs"] > 1 and r["runs"]["mm"]["multimodality"] > 0
    assert r["profiled_dir"]["device_ops"] > 0


# ------------------------------------------ the training runtime's remainder

@pytest.mark.parametrize("heads", [32, 64])
def test_k2_under_autograd_gives_the_plain_gradients(dev, heads):
    """K2 under autograd (``ops/mha.py::SoftmaxMHA``) at a decoder's shapes
    (batch 8 of 160 tokens, D 512; 32 heads of 16, 64 of 8): one launch,
    the output within TOL_K2 of the plain version, and the gradients the
    plain version's bitwise (the backward recomputes it on the saved
    inputs)."""
    from raggesture_tpu_torch.ops.mha import (
        SoftmaxMHA,
        fused_softmax_mha,
        softmax_mha_reference,
    )

    g = torch.Generator(device=dev).manual_seed(heads)
    q, k, v = (torch.randn(8, 160, 512, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    up = torch.randn(8, 160, 512, generator=g, device=dev)
    scale = 1.0 / math.sqrt(512 // heads)
    launches, backs = fused_softmax_mha.launches, SoftmaxMHA.backwards
    out = fused_softmax_mha(q, k, v, heads, scale)
    got = torch.autograd.grad(out, (q, k, v), up)
    assert fused_softmax_mha.launches == launches + 1
    assert SoftmaxMHA.backwards == backs + 1
    ref = softmax_mha_reference(q, k, v, heads, scale)
    want = torch.autograd.grad(ref, (q, k, v), up)
    assert (out - ref).abs().max().item() <= TOL_K2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _tiny_port_config():
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        DiffusionSpec,
    )
    from raggesture_tpu_torch.models.codec import CodecConfig
    from raggesture_tpu_torch.models.denoiser import DenoiserConfig

    return ArchitectureConfig(
        denoiser=DenoiserConfig(latent_dim=32, time_embed_dim=64,
                                num_layers=2, num_heads=4, ff_size=64,
                                text_latent_dim=24, audio_latent_dim=24,
                                max_seq_len=30),
        codec=CodecConfig(latent_dim=32, num_frames=30, num_layers=2,
                          num_heads=2, lowertrans_num_heads=2, ff_size=64),
        diffusion_train=DiffusionSpec(diffusion_steps=100),
        diffusion_test=DiffusionSpec(diffusion_steps=100))


def test_per_layer_training_step_on_the_card_matches_the_cpu(dev):
    """``training_loss(fused_ctx=False)`` (the denoiser's plain per-layer
    forward, no kernel) on the card against the same call on the CPU, on
    the same weights and draws, true-separator query masks: the loss
    within 1e-5 relative, the gradients within 1e-4 of the largest; then
    one ``make_train_step(fused_ctx=False)`` step updates the model on the
    card."""
    cs = _chip_smoke()

    from raggesture_tpu_torch.models.architecture import (
        create_model,
        training_loss,
    )
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )

    cfg = _tiny_port_config()
    dc = cfg.denoiser
    cpu = create_model(cfg, device="cpu", seed=3, zero_init_std=0.05)
    card = create_model(cfg, device=dev, seed=3, zero_init_std=0.05)
    card.load_state_dict(cpu.state_dict())
    batch, rt = cs.train_batch(torch, dc, 4, torch.device("cpu"))
    batch["word"] = batch["word"][..., :24].contiguous()
    batch["audio"] = batch["audio"][:, :8, :24].contiguous()
    qm = torch.ones(4, dc.num_tokens)
    qm[:, list(dc.sep_indices)] = 0.0
    draws = {"t": torch.tensor([3, 40, 77, 99]), "noise": rt(4, 11, 32),
             "cond_mask": torch.tensor([1.0, 0.0, 1.0, 1.0]).reshape(4, 1, 1),
             "enc_eps": {p: rt(4, 2, 32) for p in ("upper", "hands", "face",
                                                    "lowertrans")}}

    def run(model, to):
        model.zero_grad(set_to_none=True)
        mv = (lambda x: {k: mv(v) for k, v in x.items()}
              if isinstance(x, dict) else x.to(to))
        loss, _ = training_loss(model, cfg.diffusion_train.schedule(
            device=to), mv(batch), query_masks={k: qm.to(to) for k in (
                "xf_text", "xf_audio", "xf_spk")}, fused_ctx=False,
            **mv(draws))
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in
                             model.denoiser.named_parameters()}

    loss_c, grads_c = run(cpu, torch.device("cpu"))
    loss_d, grads_d = run(card, dev)
    assert loss_d == pytest.approx(loss_c, rel=1e-5)
    scale = max(g.abs().max().item() for g in grads_c.values())
    assert max((grads_d[n] - g).abs().max().item()
               for n, g in grads_c.items()) <= 1e-4 * scale
    state = create_train_state(card, OptimConfig(fused_ctx=False))
    w0 = card.denoiser.out.weight.detach().clone()
    logs = make_train_step(cfg.diffusion_train.schedule(device=dev),
                           fused_ctx=False)(
        state, {k: v.to(dev) for k, v in batch.items()},
        torch.Generator(device=dev).manual_seed(0))
    assert math.isfinite(logs["recon_loss"].item()) and state.step == 1
    assert not torch.equal(w0, card.denoiser.out.weight)


def test_all_reduce_grads_at_nccl_world_size_one(dev):
    """``parallel/mesh.py`` over NCCL at world size 1: one flat all-reduce
    of the gradients (the identity), the loss collectives and gathers the
    identity, ``replicate_tree`` equal; the group left at the end."""
    import socket

    from raggesture_tpu_torch.parallel import mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    got = mesh.init_distributed(f"tcp://localhost:{port}", 1, 0,
                                device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        assert got.type == "cuda" and mesh.in_group()
        assert not mesh.spans_processes()
        lin = torch.nn.Linear(64, 32, device=got)
        lin(torch.randn(8, 64, device=got)).square().sum().backward()
        before = [p.grad.clone() for p in lin.parameters()]
        calls = mesh.all_reduce_grads_.calls
        assert mesh.all_reduce_grads_(list(lin.parameters())) == 64 * 32 + 32
        assert mesh.all_reduce_grads_.calls == calls + 1
        assert all(torch.equal(a, p.grad)
                   for a, p in zip(before, lin.parameters()))
        x = torch.arange(6.0, device=got)
        assert torch.equal(mesh.all_reduce_sum(x), x)
        assert torch.equal(mesh.all_gather_rows(x[None]), x[None])
        assert mesh.replicate_tree(lin)
        assert mesh.local_shard(8) == mesh.Shard(0, 8)
    finally:
        mesh.shutdown()
    assert not mesh.in_group()


def test_train_vae_phase_on_the_card(dev, tmp_path):
    """chip_smoke.py's phase train_vae at the tiny config with its VAEs
    widened to 128 (the decoders' 16 heads then of 8, which K2 takes),
    batch 32: K2 under autograd in the tool's steps, its gradients against
    the plain attention, the two files grafted and decoded."""
    import os

    cs = _chip_smoke()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = cs.train_vae_phase(
        torch, dev, str(tmp_path), batch=32, config=os.path.join(
            repo, "configs/raggesture_beatx/tiny_smoke.py"),
        config_options=["model.model.vae_cfg.latent_dim=128"])
    assert r["grafted"] == ["upper", "lowertrans"]
    for part in r["parts"].values():
        assert part["k2_launches_per_step"] == 3
        assert part["k2_autograd_grads_bitwise"]


def test_ddp_phase_on_the_card(dev, tmp_path):
    """chip_smoke.py's phase ddp at the tiny config widened to 128 (K3 takes
    widths in multiples of 128): the tool over NCCL at world size 1, then
    two gloo ranks on this card against one process at global batch 8,
    with the phase's gates."""
    import os

    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config

    cs = _chip_smoke()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = os.path.join(repo, "configs/raggesture_beatx/tiny_smoke.py")
    opts = ["model.model.latent_dim=128",
            "model.model.vae_cfg.latent_dim=128",
            "model.model.retrieval_cfg.latent_dim=128",
            "model.model.ca_block_cfg.num_heads=4"]
    cfg = Config.fromfile(config)
    cfg.merge_option_strings(opts)
    r = cs.ddp_phase(torch, dev, str(tmp_path), config=config, batch=8,
                     tool_batch=4, config_options=opts,
                     arch=arch_config_from(cfg.model))
    assert r["nccl_tool"]["steps"] > 0
    assert [x["backend"] for x in r["gloo_two_ranks"]] == ["gloo", "gloo"]
    assert all(x["k3_launches_first_step"]["cond_ctx_forward"] == 3
               for x in r["gloo_two_ranks"])


def test_options_phase_on_the_card(dev):
    """chip_smoke.py's phase options at the shipped width with two decoder
    layers and a one-layer codec, training batch 8: spec A, spec B and the
    condition encoders on K1 and K2, eager and replayed; the uncached clip
    on K5 and K6 against the plain versions; DDPM generate; the CFG DDPM
    loop and the bound against the CPU; the training step's K3 launches and
    gradients, with the phase's gates."""
    from raggesture_tpu_torch.models.architecture import ArchitectureConfig
    from raggesture_tpu_torch.models.codec import CodecConfig
    from raggesture_tpu_torch.models.denoiser import DenoiserConfig

    cs = _chip_smoke()
    arch = ArchitectureConfig(denoiser=DenoiserConfig(num_layers=2,
                                                      ff_size=256),
                              codec=CodecConfig(num_layers=1, ff_size=256))
    r = cs.options_phase(torch, dev, arch=arch, train_rows=8)
    assert sorted(r["clips"]) == ["encoders", "spec_a", "spec_a fused=False",
                                  "spec_b"]
    assert r["clips"]["spec_a"]["launches"] == {
        "fused_decoder_layer": 100, "fused_softmax_mha": 2}
    # trailing over 1000 steps at 50 keeps 51 (the grammar appends step 0)
    assert r["clips"]["spec_b"]["launches"]["fused_decoder_layer"] == 102
    assert r["clips"]["spec_a fused=False"]["launches"] == {
        "fused_self_attention": 100, "fused_cross_attention": 300,
        "fused_softmax_mha": 4}
    assert r["train"]["k3_launches_per_step"] == {
        "cond_ctx_forward": 3, "cond_ctx_backward_a": 3,
        "cond_ctx_backward_b": 3}
    assert max(r["card_vs_cpu_rel_err"].values()) <= cs.TOL_OPTIONS_CPU


# ------------------------------------------------------------- the release

# a narrow config at the release's depth (the conversion tool, as the JAX
# tool, reads 8 denoiser and 8 codec layers): D 256, 8 heads of 32 (K1's
# head width), F 512
RELEASE_NARROW = ["model.model.latent_dim=256", "model.model.time_embed_dim=1024",
                  "model.model.sa_block_cfg.num_heads=8",
                  "model.model.ca_block_cfg.num_heads=8",
                  "model.model.ffn_cfg.ffn_dim=512",
                  "model.model.vae_cfg.latent_dim=256",
                  "model.model.vae_cfg.ff_size=512",
                  "model.model.retrieval_cfg.latent_dim=256"]


def test_release_phase_on_the_card(dev, tmp_path):
    """chip_smoke.py's phase release at a narrow 8-layer config and
    2-layer featurizers, on a workspace of 10-second clips: the stand-in
    release converted (the whole model's file the seeded model's bitwise),
    a window cache featurized on the card (features within TOL_FEATURES of
    the CPU's), the converted model served, its clips' launches, its calls
    on K1, K5/K6 and K2 against the plain paths, the traced device time,
    the served samples' videos through --render, the mesh frames on the
    card against the CPU's, with the phase's gates."""
    import os

    cs = _chip_smoke()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = cs.release_phase(torch, dev, str(tmp_path), config=os.path.join(
        repo, cs.SERVE_CONFIG), n_sec=10, config_options=RELEASE_NARROW,
        hf_layers=2)
    assert not r["convert"]["golden_names_and_shapes"]
    assert len(r["convert"]["files"]) == 6
    assert r["featurize"]["windows"] > 0
    assert max(r["featurize"]["card_vs_cpu_rel_err"].values()) <= \
        cs.TOL_FEATURES
    steps = 50
    assert r["serve"]["clips_launches"]["fused=False"][
        "fused_self_attention"] == 8 * steps
    assert r["serve"]["clips_launches"]["fused=True"][
        "fused_decoder_layer"] == 8 * steps
    assert min(p["pixels_equal_to_cpu"]
               for p in r["render"]["pixels"].values()) >= cs.RENDER_PIXELS
    assert r["render"]["writer"] is None or (
        len(r["render"]["videos"]) >= 2 and r["render"]["video_frames"] > 0)


def test_profile_helpers_read_what_the_event_tree_holds(dev):
    """``utils/profiling.py``'s helpers read a profile's raw records; on a
    window of a few thousand kernels and a copy they give the device
    operations, per-kernel times and busy time of torch's own event tree
    (``key_averages`` and ``events``) over the same window.  (Late in a
    long process the profiler may drop some of a window's records: both
    readings then see the same fewer.)"""
    from torch.autograd import DeviceType

    from raggesture_tpu_torch.utils import profiling as P

    x = torch.randn(256, 256, device=dev)
    with P.profiled(torch) as prof:
        y = x
        for _ in range(1000):
            y = torch.nn.functional.gelu(y * 1.0001 + 0.5)
        y.cpu()
        torch.cuda.synchronize()

    def kept(ev):
        return (ev.device_type == DeviceType.CUDA
                and "spin_kernel" not in P.kernel_name(ev.key))

    want, n = {}, 0
    for ev in prof.key_averages():
        if kept(ev):
            name = P.kernel_name(ev.key)
            want[name] = want.get(name, 0.0) + ev.self_device_time_total / 1e3
            n += ev.count
    busy, end = 0.0, -math.inf
    for a, b in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events() if kept(ev)):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel, n_ops = P.device_time_by_kernel(prof)
    assert n_ops == n == sum(P.instances_by_kernel(prof).values()) > 0
    assert by_kernel == pytest.approx(want, rel=1e-9, abs=1e-9)
    assert P.device_busy_ms(prof) == pytest.approx(busy / 1e3, rel=1e-9)



def test_spans_are_no_device_work_in_a_cpu_and_cuda_window(dev):
    """Under the port's own CPU and CUDA window (``profiled``, which
    ``chip_smoke.py`` measures with) an annotated training step and a
    replayed generator call record their spans, and no record that
    ``device_records`` keeps bears a span's name: the ranges torch copies
    onto the device's timeline are not counted as device work, so a
    profiled step's device ms and busy share keep their meaning."""
    from raggesture_tpu_torch.models.architecture import (
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )
    from raggesture_tpu_torch.utils import profiling as P

    cs = _chip_smoke()
    cfg = _tiny_port_config()
    model = create_model(cfg, device=dev, seed=3, zero_init_std=0.05)
    batch, _ = cs.train_batch(torch, cfg.denoiser, 4, torch.device("cpu"))
    batch["word"] = batch["word"][..., :24].contiguous()
    batch["audio"] = batch["audio"][:, :8, :24].contiguous()
    batch = {k: v.to(dev) for k, v in batch.items()}
    state = create_train_state(model, OptimConfig(fused_ctx=False))
    step = make_train_step(cfg.diffusion_train.schedule(device=dev),
                           fused_ctx=False)
    tg = torch.Generator(device=dev).manual_seed(0)
    gmodel, sched, gbatch, re_dict = _graph_case(dev)
    gen = StagedGenerator(gmodel, sched)
    for _ in range(2):              # the graph captured, then replayed
        step(state, batch, tg)
        _graph_run(gen, gbatch, re_dict, "sample")
    torch.cuda.synchronize()
    first = len(P.recorded_spans())
    with P.profiled(torch) as prof:
        step(state, batch, tg)
        _graph_run(gen, gbatch, re_dict, "sample")
        torch.cuda.synchronize()
    names = {s[0] for s in P.recorded_spans()[first:]}
    assert names == {"train.step", "train.forward", "train.encode",
                     "train.backward", "train.optimizer", "gen.sample",
                     "gen.prepare", "gen.pipeline"}
    recs = P.device_records(prof)
    assert len(recs) > 10
    assert not {n for n, _, _ in recs} & names
