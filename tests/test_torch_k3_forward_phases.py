"""The arithmetic of K3's forward kernels (``cond_contexts`` forward,
``raggesture_tpu_torch/ops/csrc/cond_ctx.cu``), emulated in PyTorch on the
CPU, where the kernels themselves cannot run:

  ln_rows        each row's mean and rstd, then xn_l = LN_l(xf) for every
                 layer, rounded once to the operand dtype;
  ctx_fwd_kv     per tile of 128 flat rows (tiles straddle sequences) and
                 128 columns (whole heads): [k | v] = xn_l [wk_l | wv_l],
                 the bias and masks, v = (cm acc + bv) nv, then the tile's
                 rows sequence segment by segment: the column max m_t, e =
                 exp(k - m_t), s_t = sum e and the per-head C_t = e^T v
                 (3xTF32 in the kernel, float32-accurate; here in the
                 compute dtype).  A sequence whole in the tile gets C_t /
                 s_t, colmax m_t and colsum s_t; a segment of a longer one
                 writes the record (m_t, s_t, C_t) to slot b + t;
  ctx_fwd_merge  per sequence that spans tiles, its records in tile order:
                 M = max m_t, S = sum s_t e^(m_t - M), ctx = sum e^(m_t - M)
                 C_t / S.

The emulation is held against the plain version in float64 (the same bf16
roundings in the same places, so only the order of float64 sums differs:
1e-9 of the scale) and against the JAX package's ``cond_contexts`` (its
Pallas kernels in interpret mode at D 64, its reference at D 256) in
float32 without operand rounding, with the tolerances of
tests/test_torch_cond_ctx.py.  Its column max and sum feed the backward
kernels' emulation (tests/test_torch_k3_phases.py), which must still match
the plain backward.  The plan tests check ``cond_ctx.forward_records``:
every row lies in exactly one segment, the record slots are distinct and
are the ones the emulation writes, the workspaces have the shapes the
wrapper allocates, and the merge runs exactly when a sequence spans tiles.

pad_rows pads a sequence by fewer than 8 rows and sequence starts and tile
edges are multiples of 8 rows, so its padding never makes a segment by
itself: the padding-only segments here come from validity masks with more
padding rows (Np 152 with 100 valid rows).
"""

import numpy as np
import pytest
import torch

from test_torch_common import t32
from test_torch_k3_phases import (
    NAMES,
    NEG_MASK,
    TOL_F64,
    _case,
    _emulate,
    _forward_stats,
    _plain,
    _scales,
)
from test_torch_cond_ctx import _head_blocks

TILE = 128


def _rnd(a, od):
    return a if od is None else a.to(od).to(a.dtype)


def _fcase(B, N, D, H, L, drop, pad_to=None):
    """tests/test_torch_k3_phases.py's inputs; ``pad_to`` pads each
    sequence further with rows of validity 0."""
    xf, cm, nv, params, dctx = _case(B, N, D, H, L, drop)
    if pad_to is not None:
        more = (0, 0, 0, pad_to - xf.shape[1])
        xf = torch.nn.functional.pad(xf, more)
        nv = torch.nn.functional.pad(nv, more)
    return xf, cm, nv, params, dctx


def _segments(B, Np):
    """The kernel's walk of every row tile: (tile, sequence, first row,
    end row) of each segment, in order."""
    R = B * Np
    out = []
    for t in range(-(-R // TILE)):
        row0 = t * TILE
        rows = min(TILE, R - row0)
        ns = 0
        while ns < rows:
            b = (row0 + ns) // Np
            ne = min(rows, (b + 1) * Np - row0)
            out.append((t, b, row0 + ns, row0 + ne))
            ns = ne
    return out


def _emulate_forward(xf, cm, nv, params, H, od):
    """The forward kernels' arithmetic, tile by tile: the contexts, the
    saved tensors (mean, rstd, colmax, colsum, xn) and {"xn", "records",
    "written", "merges"}.  Column tiles of min(128, D) (the kernels take D
    a multiple of 128; each column's arithmetic is its own)."""
    from raggesture_tpu_torch.ops.cond_ctx import _centre, forward_records

    g, b, wk, bk, wv, bv = params
    B, Np, D = xf.shape
    L = wk.shape[0]
    Dh = D // H
    R = B * Np
    COLS = min(TILE, D)
    plan = forward_records(B, Np, D, L, Dh)
    dt = xf.dtype
    # ln_rows
    mean = xf.mean(-1)
    c, rstd = _centre(xf)
    cf = c.reshape(R, D)
    xn = torch.stack([_rnd(cf * g[l] + b[l], od) for l in range(L)])
    nvr = nv.reshape(R)
    cmb = cm.reshape(B)
    nan = float("nan")
    out = torch.full((B, L, H, Dh, Dh), nan, dtype=dt)
    colmax = torch.full((B, L, D), nan, dtype=dt)
    colsum = torch.full((B, L, D), nan, dtype=dt)
    rec = torch.full((plan.slots, L, D // COLS, 2 * COLS + COLS * Dh), nan,
                     dtype=dt)
    written = []
    # ctx_fwd_kv
    for t, bb, r0, r1 in _segments(B, Np):
        row0 = t * TILE
        whole = bb * Np >= row0 and (bb + 1) * Np <= row0 + TILE
        assert whole == plan.whole[bb]
        rs = slice(r0, r1)
        n = r1 - r0
        nvv, cmv = nvr[rs, None], cmb[bb]
        for l in range(L):
            for ct in range(D // COLS):
                cols = slice(ct * COLS, (ct + 1) * COLS)
                k = xn[l, rs] @ _rnd(wk[l][:, cols], od) + bk[l, cols]
                k = k + (1.0 - cmv) * NEG_MASK
                k = k + (1.0 - nvv) * NEG_MASK
                v = (cmv * (xn[l, rs] @ _rnd(wv[l][:, cols], od))
                     + bv[l, cols]) * nvv
                m = k.amax(0)
                e = torch.exp(k - m)
                s = e.sum(0)
                C = torch.einsum("nhd,nhe->hde", e.reshape(n, -1, Dh),
                                 v.reshape(n, -1, Dh))
                h0 = ct * COLS // Dh
                if whole:
                    out[bb, l, h0:h0 + COLS // Dh] = \
                        C / s.reshape(-1, Dh)[..., None]
                    colmax[bb, l, cols] = m
                    colsum[bb, l, cols] = s
                else:
                    rec[bb + t, l, ct] = torch.cat([m, s, C.reshape(-1)])
                    written.append((bb + t, l, ct))
    # ctx_fwd_merge
    merges = 0
    for bb in range(B):
        if plan.whole[bb]:
            continue
        merges += 1
        tiles = range(plan.first[bb], plan.last[bb] + 1)
        for l in range(L):
            for ct in range(D // COLS):
                recs = [rec[bb + t, l, ct] for t in tiles]
                M = torch.stack([r[:COLS] for r in recs]).amax(0)
                S = torch.zeros(COLS, dtype=dt)
                acc = torch.zeros(COLS, Dh, dtype=dt)
                for r in recs:
                    w = torch.exp(r[:COLS] - M)
                    S = S + r[COLS:2 * COLS] * w
                    acc = acc + w[:, None] * r[2 * COLS:].reshape(COLS, Dh)
                h0 = ct * COLS // Dh
                cols = slice(ct * COLS, (ct + 1) * COLS)
                out[bb, l, h0:h0 + COLS // Dh] = \
                    (acc / S[:, None]).reshape(-1, Dh, Dh)
                colmax[bb, l, cols] = M
                colsum[bb, l, cols] = S
    saved = (mean, rstd[..., 0], colmax, colsum, xn.reshape(L, B, Np, D))
    work = {"xn": saved[4], "records": rec, "written": written,
            "merges": merges}
    return out, saved, work


def _err(a, w):
    return ((a - w).abs().max() / w.abs().max()).item()


CASES = [
    # B, N, D, H, L, dropped, rows padded to
    (5, 37, 256, 8, 2, "some", None),   # Dh 32, Np 40: tile 1 starts
                                        # inside sequence 3
    (2, 100, 256, 16, 2, "some", 152),  # Dh 16, Np 152 of 100 valid rows:
                                        # tiles 1 and 2 begin with
                                        # padding-only segments
    (2, 150, 128, 4, 1, "some", None),  # the text stream's Np 152
    (32, 1, 128, 4, 2, "some", None),   # speaker: Np 8 at B 32, 16
                                        # whole sequences a tile, no merge
    (4, 13, 128, 8, 2, "all", None),    # every condition dropped,
                                        # B * Np = 64 < 128
    (3, 9, 128, 16, 2, "some", None),   # Dh 8, Np 16, B * Np = 48
    (3, 70, 256, 16, 2, "some", None),  # Np 72, two column tiles
]


@pytest.mark.parametrize("B, N, D, H, L, drop, pad_to", CASES)
@pytest.mark.parametrize("od", [torch.bfloat16, None])
def test_forward_phases_match_plain_version_in_float64(B, N, D, H, L, drop,
                                                       pad_to, od):
    from raggesture_tpu_torch.ops.cond_ctx import _centre, cond_ctx_reference

    xf, cm, nv, params, _ = _fcase(B, N, D, H, L, drop, pad_to)
    got, saved, _ = _emulate_forward(xf, cm, nv, params, H, od)
    want = cond_ctx_reference(xf, cm, nv, *params, H, od)
    assert torch.isfinite(got).all()
    assert _err(got, want) <= TOL_F64
    _, cmax, csum = _forward_stats(xf, cm, nv, params, H, od)
    assert _err(saved[2], cmax) <= TOL_F64
    assert _err(saved[3], csum) <= TOL_F64
    c, r = _centre(xf)
    assert _err(saved[1], r[..., 0]) <= TOL_F64
    assert _err((xf - saved[0][..., None]) * saved[1][..., None], c) \
        <= TOL_F64


def test_padding_only_segments_get_zero_weight():
    """Np 152 with 100 valid rows: sequence 0's segment in tile 1 (rows
    128..151) and sequence 1's in tile 2 (its rows 104..151) hold padding
    rows only: m_t about -1e6, s_t >= 1, C_t = 0, and merged with weight
    exactly 0 into finite contexts."""
    from raggesture_tpu_torch.ops.cond_ctx import forward_records

    xf, cm, nv, params, _ = _fcase(2, 100, 256, 16, 2, "none", 152)
    got, saved, work = _emulate_forward(xf, cm, nv, params, 16, None)
    plan = forward_records(2, 152, 256, 2, 16)
    rec = work["records"]
    for b, t in ((0, 1), (1, 2)):
        m, s, C = (rec[b + t, :, :, :128], rec[b + t, :, :, 128:256],
                   rec[b + t, :, :, 256:])
        assert (m < -0.9e6).all() and (s >= 1.0).all()
        assert (C == 0).all()
        M = saved[2][b].reshape(2, 2, 128)     # the merged column max
        assert (M > -1e3).all()
        assert (torch.exp(m - M) == 0).all()
    assert plan.first == (0, 1) and plan.last == (1, 2)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("D, H, B, N, drop, use_kernel", [
    (64, 8, 5, 37, "some", True),    # Dh 8, JAX's Pallas kernel
                                     # (interpret); seq 3 spans tiles
    (64, 2, 3, 70, "all", True),     # Dh 32, every condition dropped
    (64, 4, 2, 150, "some", True),   # Dh 16, the text stream's Np 152
    (256, 16, 3, 70, "some", False),  # Dh 16, JAX's reference, two groups
])
def test_forward_phases_match_jax(D, H, B, N, drop, use_kernel):
    from raggesture_tpu.ops.pallas.cond_ctx_kernel import cond_contexts
    from raggesture_tpu_torch.ops.cond_ctx import pad_rows
    import jax.numpy as jnp

    # tests/test_torch_cond_ctx.py's scales: xf 0.3, weights 2.4 / sqrt(D)
    rng = np.random.RandomState(D + H + B)
    sw = 2.4 / np.sqrt(D)
    xf = (0.3 * rng.randn(B, N, D)).astype(np.float32)
    params = tuple(a.astype(np.float32) for a in (
        1.0 + 0.1 * rng.randn(2, D), 0.1 * rng.randn(2, D),
        sw * rng.randn(2, D, D), 0.1 * rng.randn(2, D),
        sw * rng.randn(2, D, D), 0.1 * rng.randn(2, D)))
    cm = np.ones((B, 1, 1), np.float32)
    cm[1::3] = 0.0
    if drop == "all":
        cm[:] = 0.0
    ctx_j = np.asarray(cond_contexts(
        jnp.asarray(xf), jnp.asarray(cm), *(jnp.asarray(p) for p in params),
        num_heads=H, use_kernel=use_kernel, interpret=True))
    want = _head_blocks(ctx_j, H)
    xf_p, cm3, nv = pad_rows(t32(xf), t32(cm))
    got, _, _ = _emulate_forward(xf_p, cm3, nv, tuple(t32(p) for p in params),
                                 H, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("B, N, D, H, L, drop, pad_to",
                         [CASES[i] for i in (0, 1, 3, 4)])
@pytest.mark.parametrize("od", [torch.bfloat16, None])
def test_backward_on_the_emulated_forward_matches_plain_versions(
        B, N, D, H, L, drop, pad_to, od):
    """The forward's column max and sum (merged from records where a
    sequence spans tiles) and contexts feed the backward kernels'
    emulation, which must match the plain backward as with the plain
    version's statistics (scales as in tests/test_torch_k3_phases.py)."""
    xf, cm, nv, params, dctx = _fcase(B, N, D, H, L, drop, pad_to)
    ctx, saved, _ = _emulate_forward(xf, cm, nv, params, H, od)
    got, _ = _emulate(xf, cm, nv, params, dctx, H, od,
                      stats=(ctx, saved[2], saved[3]))
    want = _plain(xf, cm, nv, params, dctx, H, od)
    scale = _scales(want if drop != "all" else
                    _plain(xf, torch.ones_like(cm), nv, params, dctx, H, od))
    errors = {n: ((a - w).abs().max() / scale[n]).item()
              for n, a, w in zip(NAMES, got, want)}
    assert max(errors.values()) <= TOL_F64, errors


# ------------------------------------------------------------------ plans

SHAPES = [(128, 504), (128, 152), (128, 8), (5, 40), (3, 40), (3, 16),
          (1, 8), (7, 200), (2, 152), (9, 128), (4, 136)]


@pytest.mark.parametrize("B, Np", SHAPES)
def test_every_row_lies_in_exactly_one_segment(B, Np):
    from raggesture_tpu_torch.ops.cond_ctx import forward_records

    plan = forward_records(B, Np, 512, 8, 32)
    owner = torch.full((B * Np,), -1)
    for t, b, r0, r1 in _segments(B, Np):
        assert r0 % 8 == 0 and r1 % 8 == 0 and r1 > r0
        assert b * Np <= r0 and r1 <= (b + 1) * Np      # one sequence
        assert t * TILE <= r0 and r1 <= (t + 1) * TILE   # one tile
        assert plan.first[b] <= t <= plan.last[b]
        assert (owner[r0:r1] == -1).all()
        owner[r0:r1] = b
    assert (owner == torch.arange(B * Np) // Np).all()


@pytest.mark.parametrize("B, Np", SHAPES)
def test_record_slots_are_distinct_and_inside_the_workspace(B, Np):
    from raggesture_tpu_torch.ops.cond_ctx import forward_records, row_tiles

    plan = forward_records(B, Np, 512, 8, 32)
    slots = [b + t for b in range(B) if not plan.whole[b]
             for t in range(plan.first[b], plan.last[b] + 1)]
    assert len(set(slots)) == len(slots)
    assert all(0 <= s < plan.slots for s in slots)
    assert plan.slots == (B + row_tiles(B, Np) - 1 if slots else 0)
    assert plan.shape == (plan.slots, 8, 4, 2 * 128 + 128 * 32)


@pytest.mark.parametrize("B, N, D, H, L, drop, pad_to",
                         [c for c in CASES if c[2] % 128 == 0])
def test_workspaces_match_the_wrapper_and_the_written_slots(B, N, D, H, L,
                                                            drop, pad_to):
    from raggesture_tpu_torch.ops.cond_ctx import (
        forward_records,
        forward_workspaces,
    )

    xf, cm, nv, params, _ = _fcase(B, N, D, H, L, drop, pad_to)
    _, _, work = _emulate_forward(xf, cm, nv, params, H, torch.bfloat16)
    Np = xf.shape[1]
    spec = forward_workspaces(B, Np, D, L, D // H)
    assert set(spec) == {"xn", "records"}
    for name, (shape, _) in spec.items():
        assert tuple(work[name].shape) == shape, name
    plan = forward_records(B, Np, D, L, D // H)
    want = {(b + t, l, ct) for b in range(B) if not plan.whole[b]
            for t in range(plan.first[b], plan.last[b] + 1)
            for l in range(L) for ct in range(D // 128)}
    assert len(work["written"]) == len(want) == len(set(work["written"]))
    assert set(work["written"]) == want
    rec = work["records"]
    unwritten = torch.ones(rec.shape[:3], dtype=torch.bool)
    for key in want:
        unwritten[key] = False
    assert torch.isnan(rec[unwritten]).all()   # nothing else is touched


@pytest.mark.parametrize("B, Np, merge", [
    (128, 8, False), (9, 16, False), (5, 64, False), (3, 128, False),
    (3, 40, False),        # B * Np = 120: one tile
    (4, 40, True),         # sequence 3 spans tiles 0 and 1
    (1, 136, True), (128, 504, True), (128, 152, True)])
def test_merge_runs_exactly_when_a_sequence_spans_tiles(B, Np, merge):
    from raggesture_tpu_torch.ops.cond_ctx import forward_records

    plan = forward_records(B, Np, 128, 1, 32)
    assert plan.merge == merge == (not all(plan.whole))
    assert (plan.slots > 0) == merge
    if B * Np <= 512:
        xf, cm, nv, params, _ = _fcase(B, Np - 3, 128, 4, 1, "some")
        _, _, work = _emulate_forward(xf, cm, nv, params, 4, None)
        assert work["merges"] == sum(not w for w in plan.whole)
