"""The arithmetic of the cached cross attentions' query-side kernels (K4
``fused_cross_attention_cached``, K7 ``fused_cross_block_cached``, and the
query side of K6), emulated in PyTorch on the CPU, where the kernels
themselves cannot run:

  phase 1  per 16-row tile (tiles straddle sequences: T = 43), column tile
           of max(32, Dh) columns and condition z: LayerNorm, q, the
           per-head feature softmax, y = softmax(q) ctx[b] with b = row // T,
           the query-mask term, and per row the tile's (mean, M2) of y;
  phase 2  each row's statistics merged by Chan's formula, the stylization
           and the output product with the residual;
  phase 3  (K7) ca_mix summed over the three conditions in order.

The emulation is held against the plain versions (what the kernels are held
against on the card) and against the JAX package's Pallas kernels in
interpret mode, at head widths 8, 16, 32 and 64, with per-sequence and
batch-shared (stride 0) adaLN rows and masked query rows.  A masked row's
y is -1e6 + O(1): a merge of raw sums of y and y^2 cancels there, which the
last test shows.

Tolerances: float32 on every side, summed in other orders; 1e-5 on valid
rows, as tests/test_torch_split.py holds one block.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from test_torch_common import t32

TOL_BLOCK = 1e-5
B, T, D = 3, 43, 128          # 129 rows: tiles straddle sequences 0|1, 1|2
SEPARATORS = (10, 21, 32)     # true separators of 43 tokens: query mask 0
NEG_MASK = -1e6
LN_EPS = 1e-5
TILE_ROWS = 16                # rows of a query-side block (split_layer.cu)


def _weights(rng, nz):
    """``nz`` cross attentions' query-side tensors, numpy float32, nn.Linear
    (out, in) layout, and a ca_mix (D, 3D)."""
    def n(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)

    cas = [dict(ln_g=1.0 + n(D, s=0.1), ln_b=n(D, s=0.1),
                wq=n(D, D, s=D ** -0.5), bq=n(D, s=0.1),
                sn_g=1.0 + n(D, s=0.1), sn_b=n(D, s=0.1),
                wo=n(D, D, s=D ** -0.5), bo=n(D, s=0.1))
           for _ in range(nz)]
    return cas, n(D, 3 * D, s=(3 * D) ** -0.5), n(D, s=0.1)


def _case(heads, nz, shared_adaln, seed=0):
    rng = np.random.RandomState(seed + 10 * heads + nz)
    Dh = D // heads
    cas, wmix, bmix = _weights(rng, nz)
    qm = np.ones((B, T, nz), np.float32)
    qm[:, list(SEPARATORS)] = 0.0
    sc = (0.1 * rng.randn(B, nz, D)).astype(np.float32)
    sh = (0.1 * rng.randn(B, nz, D)).astype(np.float32)
    if shared_adaln:
        sc, sh = sc[:1].repeat(B, 0), sh[:1].repeat(B, 0)
    return dict(
        heads=heads, cas=cas, wmix=wmix, bmix=bmix, qm=qm, sc=sc, sh=sh,
        shared=shared_adaln,
        x=rng.randn(B, T, D).astype(np.float32),
        ctx=(0.5 * rng.randn(B, nz, heads, Dh, Dh)).astype(np.float32))


def _adaln(c, i):
    """The (B, D) adaLN rows of condition i as the wrappers get them: a
    stride-0 expand of one row where the batch shares it."""
    sc, sh = t32(c["sc"][:, i]), t32(c["sh"][:, i])
    if c["shared"]:
        sc, sh = sc[:1].expand(B, D), sh[:1].expand(B, D)
    return sc, sh


def _pack(ca):
    from raggesture_tpu_torch.ops.cross_attention import CrossAttentionWeights

    return CrossAttentionWeights(*[t32(ca[k]) for k in
                                   CrossAttentionWeights.names])


# ------------------------------------------------------ the emulation

def _phase1(x, ctx, qm, cas, heads, raw=False):
    """y (nz, R, D) and the per-(row, column tile) partials (nz, R, P, 2):
    (mean, M2) of y over the tile's columns, or with ``raw`` the sums of y
    and y^2.  x (R, D); ctx (B, nz, H, Dh, Dh); qm (R, nz)."""
    from raggesture_tpu_torch.ops.cross_attention import query_tile_cols

    R = x.shape[0]
    Dh = D // heads
    NC = query_tile_cols(Dh)
    hpt = NC // Dh
    nz = len(cas)
    y = torch.empty(nz, R, D)
    part = torch.empty(nz, R, D // NC, 2)
    for z, w in enumerate(cas):
        for r0 in range(0, R, TILE_ROWS):
            rows = slice(r0, min(r0 + TILE_ROWS, R))
            xr = x[rows]
            n = xr.shape[0]
            mu = xr.mean(-1, keepdim=True)
            var = ((xr - mu) ** 2).mean(-1, keepdim=True)
            xn = (xr - mu) * torch.rsqrt(var + LN_EPS) * w.ln_g + w.ln_b
            seq = torch.arange(rows.start, rows.stop) // T
            for ct in range(D // NC):
                cols = slice(ct * NC, (ct + 1) * NC)
                q = (xn @ w.wq[cols].T + w.bq[cols]).reshape(n, hpt, Dh)
                e = torch.exp(q - q.amax(-1, keepdim=True))
                p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
                c = ctx[seq, z, ct * hpt:(ct + 1) * hpt]   # per row's sequence
                yt = (torch.einsum("nhd,nhde->nhe", p, c).reshape(n, NC)
                      + (1.0 - qm[rows, z:z + 1]) * NEG_MASK)
                y[z, rows, cols] = yt
                if raw:
                    part[z, rows, ct] = torch.stack(
                        [yt.sum(-1), (yt * yt).sum(-1)], -1)
                else:
                    m = yt.mean(-1)
                    part[z, rows, ct] = torch.stack(
                        [m, ((yt - m[:, None]) ** 2).sum(-1)], -1)
    return y, part


def _merge(part, raw=False):
    """Each row's mean and variance over D from its P partials: Chan's
    formula for groups of equal size n = D / P, or the raw sums."""
    P = part.shape[-2]
    if raw:
        mean = part[..., 0].sum(-1) / D
        return mean, part[..., 1].sum(-1) / D - mean * mean
    mean = part[..., 0].sum(-1) / P
    m2 = (part[..., 1].sum(-1)
          + (D // P) * ((part[..., 0] - mean[..., None]) ** 2).sum(-1))
    return mean, m2 / D


def _phase2(x, y, mean, var, sc, sh, cas):
    """o (nz, R, D): x + hn Wo^T + bo, hn the stylization input from the
    merged statistics; sc, sh (R, nz, D), each row's sequence's rows."""
    rstd = torch.rsqrt(var + LN_EPS)
    o = []
    for z, w in enumerate(cas):
        h = ((y[z] - mean[z, :, None]) * rstd[z, :, None] * w.sn_g + w.sn_b)
        hn = Fn.silu(h * (1.0 + sc[:, z]) + sh[:, z])
        o.append(x + (hn @ w.wo.T + w.bo))
    return torch.stack(o)


def _emulate(c, raw=False):
    """The phases on case ``c``: o (nz, B, T, D), and with three conditions
    also ca_mix's output (B, T, D)."""
    heads = c["heads"]
    cas = [_pack(ca) for ca in c["cas"]]
    nz = len(cas)
    x = t32(c["x"]).reshape(B * T, D)
    y, part = _phase1(x, t32(c["ctx"]), t32(c["qm"]).reshape(B * T, nz),
                      cas, heads, raw)
    mean, var = _merge(part, raw)
    seq = torch.arange(B * T) // T
    adaln = [_adaln(c, i) for i in range(nz)]
    sc = torch.stack([a[0] for a in adaln], 1)[seq]
    sh = torch.stack([a[1] for a in adaln], 1)[seq]
    o = _phase2(x, y, mean, var, sc, sh, cas)
    if nz == 1:
        return o.reshape(1, B, T, D), None
    wmix = t32(c["wmix"])
    mix = o[0] @ wmix[:, :D].T
    for z in (1, 2):
        mix = mix + o[z] @ wmix[:, z * D:(z + 1) * D].T
    return o.reshape(nz, B, T, D), (mix + t32(c["bmix"])).reshape(B, T, D)


def _dense(ctx):
    """Per-head (..., H, Dh, Dh) contexts -> the TPU kernels' dense
    block-diagonal (..., D, D)."""
    H, Dh = ctx.shape[-3], ctx.shape[-1]
    out = np.zeros(ctx.shape[:-3] + (D, D), np.float32)
    for h in range(H):
        out[..., h * Dh:(h + 1) * Dh, h * Dh:(h + 1) * Dh] = ctx[..., h, :, :]
    return out


def _jax_params(ca):
    return {"norm": {"scale": ca["ln_g"], "bias": ca["ln_b"]},
            "query": {"kernel": ca["wq"].T, "bias": ca["bq"]},
            "proj_out": {"norm": {"scale": ca["sn_g"], "bias": ca["sn_b"]},
                         "out_proj": {"kernel": ca["wo"].T,
                                      "bias": ca["bo"]}}}


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("shared_adaln", [False, True])
@pytest.mark.parametrize("heads", [16, 8, 4, 2])     # Dh 8, 16, 32, 64
def test_k4_phases_match_the_plain_version_and_the_tpu_kernel(heads,
                                                              shared_adaln):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_cross_attention_cached as jax_k4,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        fused_cross_attention_cached_reference,
    )

    c = _case(heads, 1, shared_adaln)
    got = _emulate(c)[0][0].numpy()
    sc, sh = _adaln(c, 0)
    plain = fused_cross_attention_cached_reference(
        t32(c["x"]), t32(c["ctx"][:, 0]), t32(c["qm"]), sc, sh,
        _pack(c["cas"][0]), heads).numpy()
    want = np.asarray(jax_k4(c["x"], _dense(c["ctx"][:, 0]), c["qm"],
                             c["sc"][:, 0], c["sh"][:, 0],
                             _jax_params(c["cas"][0]), num_heads=heads,
                             interpret=True))
    valid = c["qm"][..., 0] > 0
    assert (~valid).sum() == B * len(SEPARATORS)
    # every row finite, the masked ones too: the next layer's value mask
    # multiplies them by 0, and NaN * 0 would reach every row
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], plain[valid], atol=TOL_BLOCK)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)


@pytest.mark.parametrize("heads", [16, 8, 4, 2])
def test_k7_phases_match_the_plain_version_and_the_tpu_kernel(heads):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_cross_block_cached as jax_k7,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        CrossBlockWeights,
        fused_cross_block_cached_reference,
    )

    c = _case(heads, 3, shared_adaln=heads == 4)
    o, got = _emulate(c)
    got = got.numpy()
    w = CrossBlockWeights([_pack(ca) for ca in c["cas"]], t32(c["wmix"]),
                          t32(c["bmix"]))
    sc = torch.stack([_adaln(c, i)[0] for i in range(3)], 1)
    sh = torch.stack([_adaln(c, i)[1] for i in range(3)], 1)
    plain = fused_cross_block_cached_reference(
        t32(c["x"]), t32(c["ctx"]), t32(c["qm"]), sc, sh, w, heads).numpy()
    want = np.asarray(jax_k7(
        c["x"], _dense(c["ctx"]), c["qm"], c["sc"], c["sh"],
        tuple(_jax_params(ca) for ca in c["cas"]),
        {"kernel": c["wmix"].T, "bias": c["bmix"]}, num_heads=heads,
        interpret=True))
    valid = (c["qm"] > 0).all(-1)
    assert torch.isfinite(o).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], plain[valid], atol=TOL_BLOCK)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)


def test_raw_sums_of_y_and_y_squared_break_on_a_masked_row():
    """At a masked row (y = -1e6 + O(1)) the raw merge's variance, the mean
    of y^2 less the squared mean, is cancellation noise (float32 steps of
    65536 at 1e12): negative (NaN rstd), zero or huge, where the variance
    of the same float32 y is ~0.01; Chan's merge of per-tile (mean, M2)
    stays within half of it."""
    c = _case(4, 1, shared_adaln=False)
    cas = [_pack(c["cas"][0])]
    x = t32(c["x"]).reshape(B * T, D)
    ctx, qm = t32(c["ctx"]), t32(c["qm"]).reshape(B * T, 1)
    y, chan_part = _phase1(x, ctx, qm, cas, 4)
    raw_part = _phase1(x, ctx, qm, cas, 4, raw=True)[1]
    chan_var = _merge(chan_part)[1][0]
    raw_var = _merge(raw_part, raw=True)[1][0]
    for row in (b * T + s for b in range(B) for s in SEPARATORS):
        exact = y[0, row].double().var(unbiased=False).item()
        assert 0.0 < exact < 1.0
        assert abs(chan_var[row].item() - exact) < 0.5 * exact, row
        assert not abs(raw_var[row].item() - exact) < 0.5 * exact, row
    # the whole emulated block: finite with Chan's merge; with the raw
    # sums the masked rows go non-finite or far off
    good = _emulate(c)[0][0]
    bad = _emulate(c, raw=True)[0][0]
    masked = t32(c["qm"])[..., 0] == 0
    assert torch.isfinite(good).all()
    assert (not torch.isfinite(bad[masked]).all()
            or (bad - good)[masked].abs().max().item() > 1e-2)
    # valid rows do not depend on the merge
    valid = ~masked
    assert (bad - good)[valid].abs().max().item() <= TOL_BLOCK


@pytest.mark.parametrize("Dh, cols", [(8, 32), (16, 32), (32, 32), (64, 64),
                                      (128, 128)])
def test_query_tiles_hold_whole_heads(Dh, cols):
    from raggesture_tpu_torch.ops.cross_attention import query_tile_cols

    assert query_tile_cols(Dh) == cols
    assert cols % Dh == 0 and cols >= 32


@pytest.mark.parametrize("rows, D, heads, nz, floats", [
    (86, 512, 16, 1, 86 * 512 + 2 * 86 * 16),        # K4 at the sampling shape
    (86, 512, 16, 3, 3 * 86 * 512 + 2 * 3 * 86 * 16),  # K7
    (129, 256, 2, 1, 129 * 256 + 2 * 129 * 2),       # Dh 128: two tiles a row
    (3, 96, 3, 1, 3 * 96 + 2 * 3 * 3 + 2),           # rounded to float4s
])
def test_query_workspace_holds_y_and_the_partials(rows, D, heads, nz,
                                                  floats):
    from raggesture_tpu_torch.ops.cross_attention import (
        query_workspace_floats,
    )

    got = query_workspace_floats(rows, D, heads, nz)
    assert got == floats and got % 4 == 0
