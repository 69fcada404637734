"""The arithmetic of K3's backward kernels (``cond_contexts`` backward A and
B, ``raggesture_tpu_torch/ops/csrc/cond_ctx.cu``), emulated in PyTorch on
the CPU, where the kernels themselves cannot run:

  ln_rows     (the forward's launch, its rows handed to backward A) xn_l =
              LN_l(xf) for every layer, rounded once to the operand dtype;
  ctx_bwd_kv  per tile of 128 flat rows (tiles straddle sequences: each row
              looks up its own sequence's column max, sum, cm and dctx) and
              128 columns (whole heads): [k | v] = xn_l [wk_l | wv_l], the
              bias and masks, v = (cm acc + bv) nv, and the softmax vjp
              through sum_n ksm dksm = sum_e ctx dctx (the forward's
              contexts, no pass over the rows; the kernel runs these
              per-head products in 3xTF32, float32-accurate, emulated here
              in the compute dtype); dk and cm dv rounded to the operand
              dtype, per-tile column sums of dk and dv;
  ctx_bwd_dx  per (row tile, 128 columns): dc = sum_l ln_g[l] (dk_l wk_l^T
              + (cm dv_l) wv_l^T) accumulated layer by layer, per-tile
              partials of d ln_g and d ln_b; then the LayerNorm backward;
  ctx_bwd_w   [dwk | dwv] = xn^T [dk | cm dv] over the chunks of the
              split-K plan, the chunks' partials and the tiles' bias
              partials summed in the kernels' order.

The emulation is held against the plain versions in float64 (the same
roundings to bf16 in the same places, so only the order of float64 sums
differs: 1e-9 of each output's scale) and against the JAX package's
``cond_contexts`` (its Pallas kernels in interpret mode, or its reference)
in float32 without operand rounding, with the tolerances of
tests/test_torch_cond_ctx.py.  The plan tests check that every row lies in
exactly one chunk, that tiles hold whole heads, and that the emulation's
workspaces have the shapes the wrappers allocate.  The forward's own
kernels are emulated in tests/test_torch_k3_forward_phases.py, which feeds
its column max and sum into ``_emulate`` here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import t32

NEG_MASK = -1e6
SMS = 132                     # SMs of an H100 SXM: the split-K plan's target
TOL_F64 = 1e-9
NAMES = ("dxf", "dg", "db", "dwk", "dbk", "dwv", "dbv")


def _rnd(a, od):
    return a if od is None else a.to(od).to(a.dtype)


def _case(B, N, D, H, L, drop, seed=0, dtype=torch.float64):
    """Padded inputs of one stream (numpy draws), the stacked parameters
    and a context cotangent; ``drop``: "none", "some" or "all" sequences
    with cm = 0."""
    from raggesture_tpu_torch.ops.cond_ctx import pad_rows

    rng = np.random.RandomState(seed + B * N + D + H)

    def rn(*shape, s=1.0):
        return torch.tensor(s * rng.randn(*shape), dtype=dtype)

    cm = torch.ones(B, 1, 1, dtype=dtype)
    if drop == "some":
        cm[1::3] = 0.0
    elif drop == "all":
        cm[:] = 0.0
    xf, cm3, nv = pad_rows(rn(B, N, D), cm)
    params = (1.0 + rn(L, D, s=0.1), rn(L, D, s=0.1),
              rn(L, D, D, s=D ** -0.5), rn(L, D, s=0.1),
              rn(L, D, D, s=D ** -0.5), rn(L, D, s=0.1))
    dctx = rn(B, L, H, D // H, D // H)
    return xf, cm3, nv, params, dctx


def _forward_stats(xf, cm, nv, params, H, od):
    """What the forward kernel saves for the backward: the contexts and
    the column max and sum of the time softmax (B, L, D)."""
    from raggesture_tpu_torch.ops.cond_ctx import _centre, cond_ctx_reference

    g, b, wk, bk, wv, bv = params
    c, _ = _centre(xf)
    cmax, csum = [], []
    for l in range(wk.shape[0]):
        xn = c * g[l] + b[l]
        k = _rnd(xn, od) @ _rnd(wk[l], od) + bk[l]
        k = k + (1.0 - cm) * NEG_MASK + (1.0 - nv) * NEG_MASK
        m = k.amax(dim=1)
        cmax.append(m)
        csum.append(torch.exp(k - m[:, None]).sum(dim=1))
    ctx = cond_ctx_reference(xf, cm, nv, *params, H, od)
    return ctx, torch.stack(cmax, 1), torch.stack(csum, 1)


def _emulate(xf, cm, nv, params, dctx, H, od, sms=SMS, stats=None):
    """The backward kernels' arithmetic, tile by tile: (dxf, dg, db, dwk,
    dbk, dwv, dbv) and the workspaces {name: tensor}.  ``stats``: the
    forward's (contexts, column max, column sum), by default the plain
    version's."""
    from raggesture_tpu_torch.ops.cond_ctx import (
        _centre,
        row_tiles,
        split_chunks,
        weight_splits,
    )

    g, b, wk, bk, wv, bv = params
    B, Np, D = xf.shape
    L = wk.shape[0]
    Dh = D // H
    R = B * Np
    T, COLS, CH = 128, 128, 64
    ctx, colmax, colsum = (_forward_stats(xf, cm, nv, params, H, od)
                           if stats is None else stats)
    c, r = _centre(xf)
    cf = c.reshape(R, D)
    seq = torch.arange(R) // Np                # each flat row's sequence
    cmr = cm.reshape(B)[seq]
    nvr = nv.reshape(R)
    # ln_rows (the forward's)
    xn = torch.stack([_rnd(cf * g[l] + b[l], od) for l in range(L)])
    # ctx_bwd_kv
    tiles = row_tiles(B, Np)
    dk = torch.zeros(L, R, D, dtype=xf.dtype)
    dvc = torch.zeros(L, R, D, dtype=xf.dtype)
    dbkv_part = torch.zeros(tiles, 2, L, D, dtype=xf.dtype)
    for l in range(L):
        for t in range(tiles):
            rows = slice(t * T, min(R, (t + 1) * T))
            bb, cmb, nvv = seq[rows], cmr[rows, None], nvr[rows, None]
            for n0 in range(0, D, COLS):
                cols = slice(n0, n0 + COLS)
                k = xn[l, rows] @ _rnd(wk[l][:, cols], od) + bk[l, cols]
                k = k + (1.0 - cmb) * NEG_MASK
                k = k + (1.0 - nvv) * NEG_MASK
                ksm = (torch.exp(k - colmax[bb, l, cols])
                       / colsum[bb, l, cols])
                v = (cmb * (xn[l, rows] @ _rnd(wv[l][:, cols], od))
                     + bv[l, cols]) * nvv
                n = ksm.shape[0]
                h0 = n0 // Dh
                dc_h = dctx[bb, l, h0:h0 + COLS // Dh]   # (n, heads, Dh, Dh)
                ctx_h = ctx[bb, l, h0:h0 + COLS // Dh]
                ksm_h = ksm.reshape(n, -1, Dh)
                v_h = v.reshape(n, -1, Dh)
                dksm = torch.einsum("nhe,nhde->nhd", v_h, dc_h)
                rterm = (ctx_h * dc_h).sum(-1)       # sum_e ctx[d, e] dctx
                dkt = (ksm_h * (dksm - rterm)).reshape(n, COLS)
                dvt = torch.einsum("nhd,nhde->nhe", ksm_h,
                                   dc_h).reshape(n, COLS) * nvv
                dk[l, rows, cols] = _rnd(dkt, od)
                dvc[l, rows, cols] = _rnd(cmb * dvt, od)
                dbkv_part[t, 0, l, cols] = dkt.sum(0)
                dbkv_part[t, 1, l, cols] = dvt.sum(0)
    # ctx_bwd_dx, then the LayerNorm backward
    dgb_part = torch.zeros(tiles, L, 2, D, dtype=xf.dtype)
    dc = torch.zeros(R, D, dtype=xf.dtype)
    for t in range(tiles):
        rows = slice(t * T, min(R, (t + 1) * T))
        for n0 in range(0, D, COLS):
            cols = slice(n0, n0 + COLS)
            acc = torch.zeros(rows.stop - rows.start, COLS, dtype=xf.dtype)
            for l in range(L):
                dxn = (dk[l, rows] @ _rnd(wk[l][cols, :], od).t()
                       + dvc[l, rows] @ _rnd(wv[l][cols, :], od).t())
                acc = acc + g[l, cols] * dxn
                dgb_part[t, l, 0, cols] = (dxn * cf[rows, cols]).sum(0)
                dgb_part[t, l, 1, cols] = dxn.sum(0)
            dc[rows, cols] = acc
    dc = dc.reshape(B, Np, D)
    dxf = r * (dc - dc.mean(-1, keepdim=True)
               - c * (dc * c).mean(-1, keepdim=True))
    dgb = torch.zeros(L, 2, D, dtype=xf.dtype)
    for t in range(tiles):
        dgb = dgb + dgb_part[t]
    # ctx_bwd_w: the split-K chunks, then the sums in order
    splits = weight_splits(B, Np, D, L, sms)
    stages = -(-R // CH)
    xkv = torch.cat([dk, dvc], dim=2)            # (L, R, 2D)
    ws = torch.zeros(splits, L, D, 2 * D, dtype=xf.dtype)
    for s, (k0, k1) in enumerate(split_chunks(stages, splits)):
        rows = slice(k0 * CH, min(R, k1 * CH))
        for l in range(L):
            ws[s, l] = xn[l, rows].t() @ xkv[l, rows]
    dw = torch.zeros(L, D, 2 * D, dtype=xf.dtype)
    for s in range(splits):
        dw = dw + ws[s]
    dbkv = torch.zeros(2, L, D, dtype=xf.dtype)
    for t in range(tiles):
        dbkv = dbkv + dbkv_part[t]
    grads = (dxf, dgb[:, 0], dgb[:, 1], dw[..., :D], dbkv[0], dw[..., D:],
             dbkv[1])
    work = {"dk": dk.reshape(L, B, Np, D),
            "dv": dvc.reshape(L, B, Np, D), "dbkv_part": dbkv_part,
            "dgb_part": dgb_part, "dc": dc, "ws": ws}
    return grads, work


def _scales(want):
    """Each output's scale; the key side's gradients against the larger of
    the key and value scales (dbk is zero in exact arithmetic: the time
    softmax is shift-invariant per column)."""
    scale = {n: w.abs().max().item() for n, w in zip(NAMES, want)}
    for k_side, v_side in (("dwk", "dwv"), ("dbk", "dbv")):
        scale[k_side] = max(scale[k_side], scale[v_side])
    return scale


def _plain(xf, cm, nv, params, dctx, H, od):
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_bwd_a_reference,
        cond_ctx_bwd_b_reference,
    )

    args = (xf, cm, nv) + params + (dctx, H, od)
    return cond_ctx_bwd_a_reference(*args) + cond_ctx_bwd_b_reference(*args)


CASES = [
    # B, N, D, H, L, dropped
    (5, 37, 256, 8, 2, "some"),   # Dh 32, Np 40: tile 1 starts inside seq 3
    (3, 70, 256, 16, 2, "some"),  # Dh 16, two column tiles
    (3, 9, 128, 16, 2, "some"),   # Dh 8, Np 16 (ragged)
    (40, 1, 128, 4, 2, "some"),   # speaker: one row of 8 per sequence
    (4, 13, 128, 8, 2, "all"),    # every condition dropped
]


@pytest.mark.parametrize("B, N, D, H, L, drop", CASES)
@pytest.mark.parametrize("od", [torch.bfloat16, None])
def test_backward_phases_match_plain_versions_in_float64(B, N, D, H, L, drop,
                                                         od):
    """With every condition dropped each value row is the bias, so dksm is
    the same on every row and every gradient through the keys (dxf, dg,
    db, dwk, dbk), and dwv (its operand xn cm is zero), vanish in exact
    arithmetic: both sides return rounding noise, held against the scales
    of the same inputs with the conditions kept."""
    xf, cm, nv, params, dctx = _case(B, N, D, H, L, drop)
    got, _ = _emulate(xf, cm, nv, params, dctx, H, od)
    want = _plain(xf, cm, nv, params, dctx, H, od)
    scale = _scales(want if drop != "all" else
                    _plain(xf, torch.ones_like(cm), nv, params, dctx, H, od))
    errors = {n: ((a - w).abs().max() / scale[n]).item()
              for n, a, w in zip(NAMES, got, want)}
    assert max(errors.values()) <= TOL_F64, errors


def test_one_row_tile_straddles_many_sequences():
    """The speaker's 8-row sequences: a 128-row tile holds 16 of them, and
    each row takes its own sequence's dctx, column stats and cm: mixing up
    two sequences' cotangents is caught."""
    xf, cm, nv, params, dctx = _case(32, 1, 128, 4, 2, "some")
    got, _ = _emulate(xf, cm, nv, params, dctx, 4, None)
    swapped = dctx.clone()
    swapped[[0, 1]] = dctx[[1, 0]]
    other, _ = _emulate(xf, cm, nv, params, swapped, 4, None)
    assert (got[0] - other[0]).abs().max() > 1e-3 * got[0].abs().max()


# ---------------------------------------------------------------- vs JAX

def _jax_grads(xf, cm, params, H, w_h, use_kernel):
    """JAX's gradients of sum(ctx * w) (its grouped layout), float32."""
    from raggesture_tpu.ops.pallas.cond_ctx_kernel import (
        cond_contexts,
        group_shape,
    )

    B, L = w_h.shape[:2]
    D = xf.shape[-1]
    G, S = group_shape(D, H)
    Dh = D // H
    hpg = S // Dh
    w_g = np.zeros((B, L, G, hpg, Dh, hpg, Dh), np.float32)
    wb = w_h.reshape(B, L, G, hpg, Dh, Dh)
    for i in range(hpg):
        w_g[:, :, :, i, :, i, :] = wb[:, :, :, i]
    w_g = w_g.reshape(B, L, G, S, S)

    def loss(*a):
        ctx = cond_contexts(a[0], jnp.asarray(cm), *a[1:], num_heads=H,
                            use_kernel=use_kernel, interpret=True)
        return jnp.sum(ctx * w_g)

    grads = jax.grad(loss, argnums=tuple(range(7)))(
        *(jnp.asarray(a) for a in (xf,) + params))
    return [np.asarray(gr) for gr in grads]


@pytest.mark.parametrize("D, H, drop, use_kernel", [
    (128, 4, "some", True),    # Dh 32, JAX's Pallas kernels (interpret)
    (128, 8, "all", True),     # Dh 16, every condition dropped
    (256, 32, "some", False),  # Dh 8, two column tiles, JAX's reference
])
def test_backward_phases_match_jax(D, H, drop, use_kernel):
    from raggesture_tpu_torch.ops.cond_ctx import pad_rows

    B, N, L = 3, 13, 2
    rng = np.random.RandomState(7 + D + H)
    xf = (0.3 * rng.randn(B, N, D)).astype(np.float32)
    cm = np.asarray([1.0, 0.0, 1.0], np.float32).reshape(B, 1, 1)
    if drop == "all":
        cm[:] = 0.0
    sw = 2.4 / np.sqrt(D)
    params = tuple(a.astype(np.float32) for a in (
        1.0 + 0.1 * rng.randn(L, D), 0.1 * rng.randn(L, D),
        sw * rng.randn(L, D, D), 0.1 * rng.randn(L, D),
        sw * rng.randn(L, D, D), 0.1 * rng.randn(L, D)))
    w_h = rng.randn(B, L, H, D // H, D // H).astype(np.float32)
    xf_p, cm3, nv = pad_rows(t32(xf), t32(cm))
    got, _ = _emulate(xf_p, cm3, nv, tuple(t32(p) for p in params),
                      t32(w_h), H, None)
    want = _jax_grads(xf, cm, params, H, w_h, use_kernel)
    # JAX's gradient order: xf, ln_g, ln_b, wk, bk, wv, bv
    mine = (got[0][:, :N], got[1], got[2], got[3], got[4], got[5], got[6])
    for name, a, b in zip(("xf", "ln_g", "ln_b", "wk", "bk", "wv", "bv"),
                          mine, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-4, atol=2e-4,
                                   err_msg=f"grad of {name}")


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("B, Np, D, L", [
    (128, 504, 512, 8), (128, 152, 512, 8), (128, 8, 512, 8),
    (5, 40, 256, 3), (3, 16, 128, 2), (1, 8, 1024, 1), (7, 200, 384, 5)])
def test_split_plan_covers_every_row_once(B, Np, D, L):
    from raggesture_tpu_torch.ops.cond_ctx import (
        CHUNK_ROWS,
        W_TILE,
        split_chunks,
        weight_splits,
    )

    R = B * Np
    stages = -(-R // CHUNK_ROWS)
    splits = weight_splits(B, Np, D, L, SMS)
    blocks = (D // W_TILE[0]) * (2 * D // W_TILE[1]) * L
    assert 1 <= splits <= stages
    assert blocks * splits <= max(SMS, blocks)
    if blocks < SMS and splits < stages:        # the grid fills the card
        assert blocks * (splits + 1) > SMS
    owner = torch.full((R,), -1)
    for s, (k0, k1) in enumerate(split_chunks(stages, splits)):
        assert k1 > k0                          # no empty chunk
        rows = slice(k0 * CHUNK_ROWS, min(R, k1 * CHUNK_ROWS))
        assert (owner[rows] == -1).all()
        owner[rows] = s
    assert (owner >= 0).all()
    assert (owner.diff() >= 0).all()            # chunks in row order


@pytest.mark.parametrize("Dh", [8, 16, 32])
def test_column_tiles_hold_whole_heads(Dh):
    from raggesture_tpu_torch.ops.cond_ctx import _COLS, _DH_SUPPORTED, W_TILE

    assert Dh in _DH_SUPPORTED
    for width in (_COLS,) + W_TILE:
        assert width % Dh == 0


@pytest.mark.parametrize("B, N, D, H, L, drop", CASES[:4])
def test_workspaces_match_the_wrappers(B, N, D, H, L, drop):
    from raggesture_tpu_torch.ops.cond_ctx import (
        backward_workspaces,
        weight_splits,
    )

    xf, cm, nv, params, dctx = _case(B, N, D, H, L, drop)
    _, work = _emulate(xf, cm, nv, params, dctx, H, torch.bfloat16)
    Np = xf.shape[1]
    spec = backward_workspaces(B, Np, D, L,
                               weight_splits(B, Np, D, L, SMS))
    assert set(spec) == set(work)
    for name, (shape, _) in spec.items():
        assert tuple(work[name].shape) == shape, name
