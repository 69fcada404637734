"""One whole denoiser DecoderLayer per call at sampling time: kernel K1.

``fused_decoder_layer`` replaces the TPU kernel
``raggesture_tpu/ops/pallas/linear_attention_kernel.py::fused_decoder_layer``
and ``pack_decoder_layer`` its operand layout.  On CUDA tensors it launches
the hand-written kernels of ``csrc/decoder_layer.cu`` (whose header note
says what bounds them and how they are laid out); on CPU tensors it runs
``fused_decoder_layer_reference``, the plain PyTorch version of the same
function, which is also what the kernel is held against on the card.

Rows are the B sequences of Tp tokens merged, (B·Tp, D).  The cached
cross-attention contexts come per head, (B, 3, H, Dh, Dh): the TPU kernel's
dense block-diagonal (B, 3, D, D) contexts were a Mosaic layout whose
off-diagonal blocks are zero.  Products round their activation operand to
the pack's dtype and accumulate in float32, as the TPU kernel's ``mm`` did;
every LayerNorm and softmax is float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build
from .linear_attention import NEG_MASK

LN_EPS = 1e-5


def _kernel_of(linear: torch.nn.Linear) -> torch.Tensor:
    """A Linear's weight in the JAX Dense (in, out) layout."""
    return linear.weight.detach().t()


@torch.no_grad()
def pack_decoder_layer(layer: torch.nn.Module,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, torch.Tensor]:
    """Pack one ``models.denoiser.DecoderLayer``'s parameters.

    Layout (as the TPU kernel's pack):
      vecs (31, D) f32 — 0-7 sa: ln_s, ln_b, bq, bk, bv, styl_ln_s,
        styl_ln_b, bo; 8-25 per CA i (6 each): ln_s, ln_b, bq, styl_ln_s,
        styl_ln_b, bo; 26 ca_mix bias; 27-30 ffn: b2, styl_ln_s, styl_ln_b, bo
      b1 (F,) f32 — ffn linear1 bias
      mats (14, D, D) ``dtype`` — 0-3 sa wq/wk/wv/wo, 4-9 CA (wq, wo) x3,
        10-12 ca_mix thirds, 13 ffn stylization out
      w1 (D, F), w2 (F, D) ``dtype``
    """
    sa = layer.sa_block
    cas = [layer.ca_xf_text, layer.ca_xf_audio, layer.ca_xf_spk]
    ffn = layer.ffn
    D = sa.query.weight.shape[0]

    def styl(block):
        po = block.proj_out
        return [po.norm.weight, po.norm.bias, po.out_proj.bias], po.out_proj

    sa_styl, sa_wo = styl(sa)
    vec_list = [sa.norm.weight, sa.norm.bias, sa.query.bias, sa.key.bias,
                sa.value.bias] + sa_styl
    mat_list = [_kernel_of(sa.query), _kernel_of(sa.key),
                _kernel_of(sa.value), _kernel_of(sa_wo)]
    for ca in cas:
        ca_styl, ca_wo = styl(ca)
        vec_list += [ca.norm.weight, ca.norm.bias, ca.query.bias] + ca_styl
        mat_list += [_kernel_of(ca.query), _kernel_of(ca_wo)]
    vec_list.append(layer.ca_mix.bias)
    wmix = _kernel_of(layer.ca_mix)
    mat_list += [wmix[i * D:(i + 1) * D] for i in range(3)]
    ffn_styl, ffn_wo = styl(ffn)
    vec_list += [ffn.linear2.bias] + ffn_styl
    mat_list.append(_kernel_of(ffn_wo))
    return {
        "vecs": torch.stack([v.detach().float() for v in vec_list]),
        "b1": ffn.linear1.bias.detach().float().clone(),
        "mats": torch.stack([m.to(dtype) for m in mat_list]).contiguous(),
        "w1": _kernel_of(ffn.linear1).to(dtype).contiguous(),
        "w2": _kernel_of(ffn.linear2).to(dtype).contiguous(),
    }


def fused_decoder_layer_reference(
    x: torch.Tensor,            # (B*Tp, D) float32 rows
    src_mask: torch.Tensor,     # (B*Tp, 1) token validity
    query_mask3: torch.Tensor,  # (B*Tp, 3) cross-attention query masks
    scale5: torch.Tensor,       # (5, D) adaLN scales (sa, 3 CAs, ffn)
    shift5: torch.Tensor,       # (5, D) adaLN shifts
    ctx3: torch.Tensor,         # (B, 3, Hc, Dh, Dh) per-head contexts
    packed: Dict[str, torch.Tensor],
    num_heads: int,
    ca_heads: int,
    batch: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_decoder_layer`."""
    R, D = x.shape
    Tp = R // batch
    cd = packed["mats"].dtype
    vecs, mats = packed["vecs"], packed["mats"]
    w1, w2, b1 = packed["w1"], packed["w2"], packed["b1"]
    m = src_mask.reshape(R, 1).float()
    qm = query_mask3.reshape(R, 3).float()

    def rnd(a):
        return a.to(cd).float()

    def mm(a, w):
        return rnd(a) @ w.float()

    def center(v):
        mu = v.mean(-1, keepdim=True)
        var = ((v - mu) ** 2).mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + LN_EPS)

    def stylize(y, j, wo, k):
        # styl-norm affine and adaLN affine combined, as the TPU kernel does
        es = vecs[j] * (1.0 + scale5[k])
        eb = vecs[j + 1] * (1.0 + scale5[k]) + shift5[k]
        h = center(y) * es + eb
        h = h * torch.sigmoid(h)
        return mm(h, wo) + vecs[j + 2]

    def feature_softmax(q, heads):
        qh = q.reshape(R, heads, D // heads)
        qe = torch.exp(qh - qh.amax(-1, keepdim=True))
        return (qe / qe.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(R, D)

    def per_head(a, heads):
        return rnd(a).reshape(batch, Tp, heads, D // heads)

    # ---- self attention ----
    H = num_heads
    xn = center(x) * vecs[0] + vecs[1]
    q = mm(xn, mats[0]) + vecs[2]
    k = mm(xn, mats[1]) + vecs[3] + (1.0 - m) * NEG_MASK
    v = (mm(xn, mats[2]) + vecs[4]) * m
    q_sm = feature_softmax(q, H)
    # time softmax per sequence (never across the batch)
    k_sm = torch.softmax(k.reshape(batch, Tp, D), dim=1).reshape(R, D)
    ctx = torch.einsum("bthd,bthe->bhde", per_head(k_sm, H), per_head(v, H))
    y = torch.einsum("bthd,bhde->bthe", per_head(q_sm, H), rnd(ctx))
    h1 = x + stylize(y.reshape(R, D), 5, mats[3], 0)

    # ---- three cached-context cross attentions + ca_mix ----
    Hc = ca_heads
    hc = center(h1)
    acc = None
    for i in range(3):
        base = 8 + 6 * i
        q = mm(hc * vecs[base] + vecs[base + 1], mats[4 + 2 * i]) + vecs[base + 2]
        q_sm = feature_softmax(q, Hc)
        y = torch.einsum("bthd,bhde->bthe", per_head(q_sm, Hc),
                         ctx3[:, i].float()).reshape(R, D)
        y = y + (1.0 - qm[:, i:i + 1]) * NEG_MASK
        o_i = h1 + stylize(y, base + 3, mats[5 + 2 * i], 1 + i)
        term = mm(o_i, mats[10 + i])
        acc = term if acc is None else acc + term
    h2 = acc + vecs[26]

    # ---- FFN ----
    f = mm(h2, w1) + b1
    f = f * 0.5 * (1.0 + torch.erf(f * 0.7071067811865476))
    y = mm(f, w2) + vecs[27]
    return h2 + stylize(y, 28, mats[13], 4)


def _library() -> ctypes.CDLL:
    lib = build.load("decoder_layer")
    fn = lib.rg_decoder_layer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.rg_decoder_layer_max_k.restype = ctypes.c_int
    lib.rg_decoder_layer_max_k.argtypes = [ctypes.c_int]
    return lib


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if (t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} CUDA tensor of "
            f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def fused_decoder_layer(
    x: torch.Tensor,
    src_mask: torch.Tensor,
    query_mask3: torch.Tensor,
    scale5: torch.Tensor,
    shift5: torch.Tensor,
    ctx3: torch.Tensor,
    packed: Dict[str, torch.Tensor],
    num_heads: int,
    ca_heads: int,
    batch: int,
) -> torch.Tensor:
    """One DecoderLayer over ``batch`` sequences merged into rows.

    CPU tensors take :func:`fused_decoder_layer_reference`.  CUDA tensors
    launch the kernels (``fused_decoder_layer.launches`` counts calls that
    did) and must be float32 apart from the bf16 ``mats``/``w1``/``w2`` and
    ``ctx3``; anything else raises."""
    if x.device.type == "cpu":
        return fused_decoder_layer_reference(
            x, src_mask, query_mask3, scale5, shift5, ctx3, packed,
            num_heads, ca_heads, batch)
    R, D = x.shape
    F = packed["w1"].shape[-1]
    Tp = R // batch
    Dh, Dhc = D // num_heads, D // ca_heads
    if (R % batch or D % 32 or F % 32 or D % num_heads or D % ca_heads):
        raise ValueError(f"unsupported shape: rows {R}, batch {batch}, "
                         f"D {D}, F {F}, heads {num_heads}/{ca_heads}")
    f32, bf16 = torch.float32, torch.bfloat16
    _expect("x", x, f32, (R, D))
    _expect("src_mask", src_mask, f32, (R, 1))
    _expect("query_mask3", query_mask3, f32, (R, 3))
    _expect("scale5", scale5, f32, (5, D))
    _expect("shift5", shift5, f32, (5, D))
    _expect("ctx3", ctx3, bf16, (batch, 3, ca_heads, Dhc, Dhc))
    _expect("vecs", packed["vecs"], f32, (31, D))
    _expect("b1", packed["b1"], f32, (F,))
    _expect("mats", packed["mats"], bf16, (14, D, D))
    _expect("w1", packed["w1"], bf16, (D, F))
    _expect("w2", packed["w2"], bf16, (F, D))
    # the attention cores run 128 threads, a whole number of them to each
    # of a head's columns, and take 8 columns per work item
    if any(w % 8 or 128 % w for w in (Dh, Dhc)):
        raise ValueError(f"head widths {Dh}/{Dhc}: the attention cores take "
                         f"8, 16, 32, 64 or 128")
    if (max(Tp * (3 * Dh + 4) + Dh * Dh + 256, Tp * (Dhc + 4) + Dhc * Dhc)
            * 4 > 48 * 1024):
        raise ValueError(f"{Tp} tokens of head width {Dh}/{Dhc} exceed the "
                         f"attention cores' 48 KB of shared memory")
    lib = _library()
    if (max(3 * D, F) > lib.rg_decoder_layer_max_k(0)
            or D > lib.rg_decoder_layer_max_k(1)):
        raise ValueError(f"contractions of {3 * D} and {F}, or normalised "
                         f"rows of {D}, exceed the GEMM's shared memory")
    out = torch.empty_like(x)
    ws = torch.empty(R * (17 * D + F), device=x.device, dtype=f32)
    status = lib.rg_decoder_layer(
        x.data_ptr(), src_mask.data_ptr(), query_mask3.data_ptr(),
        scale5.data_ptr(), shift5.data_ptr(), ctx3.data_ptr(),
        packed["vecs"].data_ptr(), packed["b1"].data_ptr(),
        packed["mats"].data_ptr(), packed["w1"].data_ptr(),
        packed["w2"].data_ptr(), out.data_ptr(), ws.data_ptr(),
        batch, Tp, D, num_heads, ca_heads, F,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "rg_decoder_layer", status)
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0
