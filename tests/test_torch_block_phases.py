"""The arithmetic of the self-attention and FFN block kernels (K5
``fused_self_attention``, K8 ``fused_ffn``), emulated in PyTorch on the CPU,
where the kernels themselves cannot run, with the kernels' tiling:

  K5  self_qkv      per 16-row tile (tiles straddle sequences: T = 43) and
                    column tile of max(32, Dh) columns (whole heads):
                    LayerNorm, then for z in {q, k, v} (four warps each)
                    xn Wz^T + bz with K split over the warps' k-groups, the
                    feature softmax of q, the key mask of k, the value mask
                    of v (after the bias);
      self_context  per (sequence, head): the time softmax of k over the
                    sequence's own rows, ctx = k_sm^T v, y = q_sm ctx, and
                    per row the (mean, M2) of y over the head's columns;
  K8  ffn_up        per 16-row tile and 32 columns of F: GELU(x W1^T + b1);
      ffn_down      per 16-row tile and 32 columns of D: f W2^T + b2 over K
                    = F, f staged 1024 columns at a time, and per row the
                    (mean, M2) over the 32 columns;
  both cross_output each row's statistics merged by Chan's formula (np = H
                    partials for K5, D / 32 for K8), the stylization and the
                    output product with the residual.

A warp's product takes every KS-th 16-deep k-chunk and the KS partial tiles
are added in group order, KS as ``csrc/split_layer.cu``'s ``Split`` sets
it.  The emulation is held against the plain versions (what the kernels are
held against on the card) and against the JAX package's Pallas kernels in
interpret mode, with inputs made from a numpy seed: head widths 8, 16, 32
and 64 (a head of 8 has four heads a column tile; 64 its own tile), F other
than 2D (fewer columns, and more than one ffn_down stage), per-sequence and
batch-shared (stride 0) adaLN rows, a fully masked partner sequence (its
time softmax takes its own max and stays finite), and B = 3 sequences of 43
tokens, so that tiles straddle both sequence boundaries.

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
NEG_MASK = -1e6
LN_EPS = 1e-5
TILE_ROWS = 16                # rows of a tile (split_layer.cu kQRows)
OUT_COLS = 32                 # columns of an ffn_up, ffn_down, output tile
CHUNK = 16                    # depth of a warp's k-chunk
FFN_STAGE = 1024              # columns of f a ffn_down stage holds
QKV_WARPS, UP_WARPS, DOWN_WARPS, OUT_WARPS = 4, 8, 16, 16   # a product's


def k_groups(cols, warps):
    """KS of ``Split<cols, warps>``: warps take 8-column subtiles, PER of
    them each (2 with 8 warps, else 4), and the groups of warps that cover
    a tile's columns split K between them."""
    per = 2 if warps == 8 else 4
    return warps // (cols // 8 // per)


def warp_product(a, w, ks, stage=None):
    """a (n, K) w (N, K)^T as the kernels sum it: K in 16-deep chunks,
    k-group g takes the chunks c = g (mod ks) of each stage of ``stage``
    columns (all of K by default) and keeps its sum across stages; the
    groups' partial tiles are added in group order."""
    K = a.shape[1]
    stage = stage or K
    acc = [torch.zeros(a.shape[0], w.shape[0]) for _ in range(ks)]
    for k0 in range(0, K, stage):
        sl = slice(k0, min(k0 + stage, K))
        ac = a[:, sl].reshape(a.shape[0], -1, CHUNK)
        wc = w[:, sl].reshape(w.shape[0], -1, CHUNK)
        for g in range(ks):
            acc[g] = acc[g] + torch.einsum("nck,mck->nm", ac[:, g::ks],
                                           wc[:, g::ks])
    out = acc[0]
    for g in range(1, ks):
        out = out + acc[g]
    return out


def layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def row_tiles(R):
    return [slice(r0, min(r0 + TILE_ROWS, R)) for r0 in range(0, R, TILE_ROWS)]


def stats(y):
    """(mean, M2) of each row of y over its columns, two passes."""
    m = y.mean(-1)
    return torch.stack([m, ((y - m[:, None]) ** 2).sum(-1)], -1)


# ------------------------------------------------------ the emulation

def self_qkv(x, m, w, heads):
    """q_sm | k | v (R, 3D) of x (R, D), token mask m (R,)."""
    R = x.shape[0]
    Dh = D // heads
    NC = max(32, Dh)
    ks = k_groups(NC, QKV_WARPS)
    qkv = torch.empty(R, 3 * D)
    for rows in row_tiles(R):
        xn = layer_norm(x[rows], w.ln_g, w.ln_b)
        mm = m[rows, None]
        for z, (W, bias) in enumerate(((w.wq, w.bq), (w.wk, w.bk),
                                       (w.wv, w.bv))):
            for c0 in range(0, D, NC):
                cols = slice(c0, c0 + NC)
                v = warp_product(xn, W[cols], ks) + bias[cols]
                if z == 0:
                    qh = v.reshape(-1, NC // Dh, Dh)
                    e = torch.exp(qh - qh.amax(-1, keepdim=True))
                    v = (e / e.sum(-1, keepdim=True).clamp_min(1e-30)
                         ).reshape(-1, NC)
                elif z == 1:
                    v = v + (1.0 - mm) * NEG_MASK
                else:
                    v = v * mm
                qkv[rows, z * D + c0:z * D + c0 + NC] = v
    return qkv


def self_context(qkv, heads):
    """y (R, D) and its (mean, M2) per row and head (R, H, 2)."""
    Dh = D // heads
    R = qkv.shape[0]
    y = torch.empty(R, D)
    part = torch.empty(R, heads, 2)
    for b in range(R // T):
        rows = slice(b * T, (b + 1) * T)
        for h in range(heads):
            c = slice(h * Dh, (h + 1) * Dh)
            k = qkv[rows, D + h * Dh:D + (h + 1) * Dh]
            v = qkv[rows, 2 * D + h * Dh:2 * D + (h + 1) * Dh]
            e = torch.exp(k - k.amax(0, keepdim=True))   # this sequence's max
            ctx = (e / e.sum(0, keepdim=True)).T @ v
            yh = qkv[rows, c] @ ctx
            y[rows, c] = yh
            part[rows, h] = stats(yh)
    return y, part


def ffn_up(x, w):
    """GELU(x W1^T + b1), (R, F)."""
    F = w.w1.shape[0]
    ks = k_groups(OUT_COLS, UP_WARPS)
    f = torch.empty(x.shape[0], F)
    for rows in row_tiles(x.shape[0]):
        for c0 in range(0, F, OUT_COLS):
            cols = slice(c0, c0 + OUT_COLS)
            v = warp_product(x[rows], w.w1[cols], ks) + w.b1[cols]
            f[rows, cols] = v * 0.5 * (1.0 + torch.erf(v * 0.7071067811865476))
    return f


def ffn_down(f, w):
    """y = f W2^T + b2 (R, D) and its (mean, M2) per row and 32-column tile
    (R, D / 32, 2)."""
    ks = k_groups(OUT_COLS, DOWN_WARPS)
    y = torch.empty(f.shape[0], D)
    part = torch.empty(f.shape[0], D // OUT_COLS, 2)
    for rows in row_tiles(f.shape[0]):
        for ct in range(D // OUT_COLS):
            cols = slice(ct * OUT_COLS, (ct + 1) * OUT_COLS)
            v = warp_product(f[rows], w.w2[cols], ks, FFN_STAGE) + w.b2[cols]
            y[rows, cols] = v
            part[rows, ct] = stats(v)
    return y, part


def merge(part):
    """Each row's mean and variance over D from its np partials of D / np
    columns, by Chan's formula for groups of equal size."""
    np_ = part.shape[1]
    mean = part[..., 0].sum(-1) / np_
    m2 = (part[..., 1].sum(-1)
          + (D // np_) * ((part[..., 0] - mean[:, None]) ** 2).sum(-1))
    return mean, m2 / D


def block_output(x, y, part, sc, sh, w):
    """cross_output: x + hn Wo^T + bo, hn the stylization input of y from the
    merged statistics; sc, sh (R, D), each row's sequence's adaLN rows."""
    mean, var = merge(part)
    h = (y - mean[:, None]) * torch.rsqrt(var + LN_EPS)[:, None]
    hn = Fn.silu((h * w.sn_g + w.sn_b) * (1.0 + sc) + sh)
    ks = k_groups(OUT_COLS, OUT_WARPS)
    out = torch.empty_like(x)
    for rows in row_tiles(x.shape[0]):
        for c0 in range(0, D, OUT_COLS):
            cols = slice(c0, c0 + OUT_COLS)
            out[rows, cols] = x[rows, cols] + (
                warp_product(hn[rows], w.wo[cols], ks) + w.bo[cols])
    return out


# -------------------------------------------------------------- the cases

def _normal(rng):
    def n(*shape, s=1.0):
        return (s * rng.randn(*shape)).astype(np.float32)
    return n


def _adaln(c):
    """The (B, D) adaLN rows as the wrappers get them (a stride-0 expand of
    one row where the batch shares it) and each row's (R, D)."""
    sc, sh = t32(c["sc"]), t32(c["sh"])
    if c["shared"]:
        sc, sh = sc[:1].expand(B, D), sh[:1].expand(B, D)
    seq = torch.arange(B * T) // T
    return sc, sh, sc[seq], sh[seq]


def _case(rng, shared_adaln, mask):
    n = _normal(rng)
    sc, sh = n(B, D, s=0.1), n(B, D, s=0.1)
    if shared_adaln:
        sc, sh = sc[:1].repeat(B, 0), sh[:1].repeat(B, 0)
    return dict(x=n(B, T, D), mask=mask, sc=sc, sh=sh, shared=shared_adaln)


def _stylization(n):
    return dict(sn_g=1.0 + n(D, s=0.1), sn_b=n(D, s=0.1),
                wo=n(D, D, s=D ** -0.5), bo=n(D, s=0.1))


def _proj_out(w):
    return {"norm": {"scale": w["sn_g"], "bias": w["sn_b"]},
            "out_proj": {"kernel": w["wo"].T, "bias": w["bo"]}}


def _k5_case(heads, shared_adaln, dead_partner=False, seed=0):
    rng = np.random.RandomState(seed + heads + 100 * shared_adaln)
    n = _normal(rng)
    w = dict(ln_g=1.0 + n(D, s=0.1), ln_b=n(D, s=0.1))
    for z in "qkv":
        w[f"w{z}"], w[f"b{z}"] = n(D, D, s=D ** -0.5), n(D, s=0.1)
    w.update(_stylization(n))
    mask = np.ones((B, T, 1), np.float32)
    mask[0, 5] = 0.0          # a masked token in a tile that straddles 0|1
    mask[2, 1] = 0.0          # and one in the tile that straddles 1|2
    if dead_partner:
        mask[1] = 0.0
    return dict(_case(rng, shared_adaln, mask), heads=heads, w=w)


def _k5_pack(c):
    from raggesture_tpu_torch.ops.self_attention import SelfAttentionWeights

    return SelfAttentionWeights(*[t32(c["w"][k])
                                  for k in SelfAttentionWeights.names])


def _k5_jax_params(w):
    p = {"norm": {"scale": w["ln_g"], "bias": w["ln_b"]},
         "proj_out": _proj_out(w)}
    for z, name in zip("qkv", ("query", "key", "value")):
        p[name] = {"kernel": w[f"w{z}"].T, "bias": w[f"b{z}"]}
    return p


def _emulate_k5(c):
    w, heads = _k5_pack(c), c["heads"]
    x = t32(c["x"]).reshape(B * T, D)
    qkv = self_qkv(x, t32(c["mask"]).reshape(B * T), w, heads)
    y, part = self_context(qkv, heads)
    _, _, sc, sh = _adaln(c)
    return block_output(x, y, part, sc, sh, w).reshape(B, T, D)


def _k5_against_plain_and_jax(c):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_self_attention as jax_k5,
    )
    from raggesture_tpu_torch.ops.self_attention import (
        fused_self_attention_reference,
    )

    got = _emulate_k5(c).numpy()
    sc, sh, _, _ = _adaln(c)
    plain = fused_self_attention_reference(
        t32(c["x"]), t32(c["mask"]), sc, sh, _k5_pack(c), c["heads"]).numpy()
    want = np.asarray(jax_k5(c["x"], c["mask"], c["sc"], c["sh"],
                             _k5_jax_params(c["w"]), num_heads=c["heads"],
                             interpret=True))
    valid = c["mask"][..., 0] > 0
    # every row finite, the masked ones too: the next layer's value mask
    # multiplies them by 0, and NaN * 0 would reach every row
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], plain[valid], atol=TOL_BLOCK)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL_BLOCK)
    return got, valid


def _k8_case(F, shared_adaln, seed=0):
    rng = np.random.RandomState(seed + F + 100 * shared_adaln)
    n = _normal(rng)
    w = dict(w1=n(F, D, s=D ** -0.5), b1=n(F, s=0.1),
             w2=n(D, F, s=F ** -0.5), b2=n(D, s=0.1))
    w.update(_stylization(n))
    return dict(_case(rng, shared_adaln, None), w=w)


def _k8_pack(c):
    from raggesture_tpu_torch.ops.ffn import FFNWeights

    return FFNWeights(*[t32(c["w"][k]) for k in FFNWeights.names])


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("shared_adaln", [False, True])
@pytest.mark.parametrize("heads", [16, 8, 4, 2])     # Dh 8, 16, 32, 64
def test_k5_phases_match_the_plain_version_and_the_tpu_kernel(heads,
                                                              shared_adaln):
    _k5_against_plain_and_jax(_k5_case(heads, shared_adaln))


def test_k5_phases_with_a_fully_masked_partner_sequence():
    """Sequence 1 masked whole: its keys sit at -1e6 + O(1) and its values
    at zero.  The time softmax takes that sequence's own max, so its
    context and y are zero, its rows finite, and its partners' rows (the
    tiles around it straddle them) as without it."""
    dead = _k5_against_plain_and_jax(_k5_case(4, False, dead_partner=True))
    alive = _emulate_k5(_k5_case(4, False)).numpy()
    got, valid = dead
    assert not valid[1].any()
    np.testing.assert_array_equal(got[[0, 2]], alive[[0, 2]])


@pytest.mark.parametrize("shared_adaln", [False, True])
@pytest.mark.parametrize("F", [
    256,     # 2D, the shipped ratio
    96,      # F != 2D: three 32-column tiles of f
    1056,    # F != 2D and > 1024: two ffn_down stages of f
])
def test_k8_phases_match_the_plain_version_and_the_tpu_kernel(F,
                                                              shared_adaln):
    from raggesture_tpu.ops.pallas.linear_attention_kernel import (
        fused_ffn as jax_k8,
    )
    from raggesture_tpu_torch.ops.ffn import fused_ffn_reference

    c = _k8_case(F, shared_adaln)
    w = _k8_pack(c)
    x = t32(c["x"]).reshape(B * T, D)
    sc, sh, sc_rows, sh_rows = _adaln(c)
    y, part = ffn_down(ffn_up(x, w), w)
    got = block_output(x, y, part, sc_rows, sh_rows, w).reshape(B, T, D)
    got = got.numpy()
    plain = fused_ffn_reference(t32(c["x"]), sc, sh, w).numpy()
    cw = c["w"]
    want = np.asarray(jax_k8(
        c["x"], c["sc"], c["sh"],
        {"linear1": {"kernel": cw["w1"].T, "bias": cw["b1"]},
         "linear2": {"kernel": cw["w2"].T, "bias": cw["b2"]},
         "proj_out": _proj_out(cw)}, interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, plain, atol=TOL_BLOCK)
    # the TPU kernel's erf is a polynomial, |error| < 1.5e-7 before linear2
    np.testing.assert_allclose(got, want, atol=TOL_BLOCK)


@pytest.mark.parametrize("cols, warps, ks", [
    (32, 4, 4),      # self_qkv's q, k or v at Dh <= 32
    (64, 4, 2),      # at Dh 64
    (128, 4, 1),     # at Dh 128
    (32, 8, 4),      # ffn_up
    (32, 16, 16),    # ffn_down, cross_output
])
def test_warp_k_groups_cover_each_k_chunk_once(cols, warps, ks):
    assert k_groups(cols, warps) == ks
    # the emulated split adds every chunk once: a product of ones counts K
    K = 1056
    a, w = torch.ones(2, K), torch.ones(3, K)
    assert torch.equal(warp_product(a, w, ks, FFN_STAGE),
                       torch.full((2, 3), float(K)))


@pytest.mark.parametrize("rows, D_, heads, floats", [
    (86, 512, 16, 4 * 86 * 512 + 2 * 86 * 16),    # the sampling shape
    (129, 128, 16, 4 * 129 * 128 + 2 * 129 * 16),  # head width 8
    (1, 32, 1, 132),                               # 130, rounded to float4s
])
def test_self_attention_workspace_holds_qkv_y_and_the_partials(rows, D_,
                                                               heads, floats):
    from raggesture_tpu_torch.ops.self_attention import (
        self_attention_workspace_floats,
    )

    got = self_attention_workspace_floats(rows, D_, heads)
    assert got == floats and got % 4 == 0


@pytest.mark.parametrize("rows, D_, F, floats", [
    (86, 512, 1024, 86 * 1536 + 2 * 86 * 16),      # the sampling shape
    (129, 128, 1056, 129 * 1184 + 2 * 129 * 4),
    (3, 96, 160, 788),                             # 786, rounded to float4s
])
def test_ffn_workspace_holds_f_y_and_the_partials(rows, D_, F, floats):
    from raggesture_tpu_torch.ops.ffn import ffn_workspace_floats

    got = ffn_workspace_floats(rows, D_, F)
    assert got == floats and got % 4 == 0


@pytest.mark.parametrize("D_, heads, t_max", [(512, 16, 568), (256, 4, 274)])
def test_self_attention_admits_every_token_count_its_context_block_holds(
        D_, heads, t_max):
    """The longest sequence K5 takes at head widths 32 and 64: a context
    block holds the head's q_sm, k and v rows, its context and a float a
    thread in 227 KB, as the first design's core did."""
    from raggesture_tpu_torch.ops import split_layer as S

    Dh = D_ // heads
    assert S.context_smem_bytes(t_max, Dh) <= S.MAX_SMEM
    assert (t_max * (3 * Dh + 4) + Dh * Dh + 256) * 4 <= 232448
    S.expect_widths(D_, heads, t_max, self_attention=True)
    with pytest.raises(ValueError, match="shared memory"):
        S.expect_widths(D_, heads, t_max + 1, self_attention=True)
    # the 16-row tiles of the other launches take any T
    S.expect_widths(D_, heads, t_max + 1, self_attention=False)
