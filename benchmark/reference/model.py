"""Plain PyTorch reference of RAG-Gesture's generation: the denoiser's
forward, the 50-step DDIM loop with the scale function's mixing, and the
part VAEs' decode to 6d rotations, translation, expressions and contacts.

Written from the model's equations (the upstream ``ReGestureTransformer``,
``EfficientSelfAttention``/``EfficientCrossAttention`` and the
``all_encoder`` part VAEs), on a dict of weights, in float32 with TF32 off.
It runs each request's own computation: the whole denoiser forward in every
step, per sequence, with no cached contexts, packs or tables.  It keeps the
upstream model's quirks, since they are its function: the cross
attention's query mask is added to its output at tokens [L, 2L, 3L], a
dropped condition keeps its value bias, and the VAE decoder adds its
position table twice.

``mm`` is the product that the denoiser's decoder layers use; the control
(``quantized_mm``) rounds both operands of those products to a lower
precision, and the operands of the layers' linear attentions (the
softmaxed queries and keys, the values and the contexts) with them; every
other product stays float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1_000_000.0
LN_EPS = 1e-5
COND_KEYS = ("xf_text", "xf_audio", "xf_spk")

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def plain_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T in float32."""
    return a @ w.t()


def quantized_mm(dtype: torch.dtype) -> Mm:
    """a @ w.T with both operands rounded to ``dtype``, each scaled by its
    largest magnitude into the format's range where it is an 8-bit format
    (a per-tensor scale, as a low-precision path would keep), the product
    summed in float32."""
    wide = torch.finfo(dtype).bits >= 16      # bf16, fp16: no scale needed
    fmax = torch.finfo(dtype).max / 2

    def rnd(x: torch.Tensor) -> torch.Tensor:
        if wide:
            return x.to(dtype).float()
        s = x.abs().amax().clamp_min(1e-30) / fmax
        return (x / s).to(dtype).float() * s

    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(w).t()

    mm.rnd = rnd
    return mm


def _operand(mm: Mm):
    """The rounding ``mm`` applies to an attention operand (none for the
    float32 products)."""
    return getattr(mm, "rnd", lambda x: x)


def layer_norm(x, W, name):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], LN_EPS)


def linear(x, W, name, mm: Mm = plain_mm):
    return mm(x, W[name + ".weight"]) + W[name + ".bias"]


# ------------------------------------------------------------- the denoiser

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sine_table(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def query_masks(c: dict, n: int, device) -> torch.Tensor:
    """The production query masks (n, T): ones but at tokens [L, 2L, 3L]."""
    L = c["max_seq_len"] // c["frame_chunk_size"]
    m = torch.ones(n, 4 * L + 3, device=device)
    m[:, [L, 2 * L, 3 * L]] = 0.0
    return m


def token_mask(c: dict, frame_mask: torch.Tensor) -> torch.Tensor:
    """Frame mask (n, 150) -> token mask (n, 43): a token per chunk, each
    part's tokens, zero separators between them."""
    m = frame_mask[:, ::c["frame_chunk_size"]]
    z = torch.zeros_like(m[:, :1])
    return torch.cat([m, z, m, z, m, z, m], dim=1)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    n, T, D = x.shape
    return x.reshape(n, T, H, D // H)


def _stylize(y, emb_silu, W, name, mm: Mm):
    ss = linear(emb_silu, W, name + ".emb_layer")[:, None]
    scale, shift = ss.chunk(2, dim=-1)
    h = layer_norm(y, W, name + ".norm") * (1 + scale) + shift
    return linear(F.silu(h), W, name + ".out_proj", mm)


def denoise(W: Dict[str, torch.Tensor], c: dict, x: torch.Tensor,
            t: torch.Tensor, tmask: torch.Tensor, word: torch.Tensor,
            audio: torch.Tensor, speaker: torch.Tensor,
            cond_mask: torch.Tensor, qmask: torch.Tensor,
            mm: Mm = plain_mm) -> torch.Tensor:
    """One forward: latents x (n, T, D), original-scale timesteps t (n,),
    token mask (n, T), raw conditions word (n, Nt, 768), audio (n, Na, 768),
    speaker ids (n,), cond_mask (n,) (0 drops the conditions) and query
    masks (n, T) -> the x0 prediction (n, T, D)."""
    p = "denoiser"
    n, T, D = x.shape
    H = c["num_heads"]
    Hc = c.get("ca_num_heads") or H
    emb = linear(F.silu(linear(timestep_embedding(t, D), W,
                               f"{p}.time_embed_1")), W, f"{p}.time_embed_2")
    es = F.silu(emb)
    conds = {"xf_text": linear(word, W, f"{p}.text_pre_proj"),
             "xf_audio": linear(audio, W, f"{p}.audio_pre_proj"),
             "xf_spk": W[f"{p}.speaker_embedding.weight"][speaker.long()][:, None]}
    L = c["max_seq_len"] // c["frame_chunk_size"]
    pos = sine_table(L, D, x.device)
    sep = torch.zeros_like(pos[:1])
    pos = torch.cat([pos, sep, pos, sep, pos, sep, pos])
    h = (linear(x, W, f"{p}.joint_embed") + pos[None, :T]
         + W[f"{p}.global_positional_embedding.pe"][None, :T])
    src = tmask[..., None]
    rnd = _operand(mm)
    cm = cond_mask.reshape(n, 1, 1)
    qm = qmask.reshape(n, T, 1, 1)
    for i in range(c["num_layers"]):
        b = f"{p}.block_{i}"
        # linear self attention: queries softmaxed over each head's
        # features, keys over time (masked tokens at -1e6), values masked
        xn = layer_norm(h, W, f"{b}.sa_block.norm")
        q = torch.softmax(_heads(linear(xn, W, f"{b}.sa_block.query", mm), H),
                          dim=-1)
        k = torch.softmax(linear(xn, W, f"{b}.sa_block.key", mm)
                          + (1.0 - src) * NEG, dim=1)
        v = linear(xn, W, f"{b}.sa_block.value", mm) * src
        ctx = torch.einsum("bnhd,bnhl->bhdl", _heads(rnd(k), H),
                           _heads(rnd(v), H))
        y = torch.einsum("bnhd,bhdl->bnhl", rnd(q), rnd(ctx)).reshape(n, T, D)
        h = h + _stylize(y, es, W, f"{b}.sa_block.proj_out", mm)
        outs = []
        for key in COND_KEYS:
            ca = f"{b}.ca_{key}"
            xn = layer_norm(h, W, f"{ca}.norm")
            xf = layer_norm(conds[key], W, f"{ca}.text_norm")
            q = torch.softmax(_heads(linear(xn, W, f"{ca}.query", mm), Hc),
                              dim=-1)
            k = torch.softmax(linear(xf, W, f"{ca}.key") + (1.0 - cm) * NEG,
                              dim=1)
            v = linear(xf * cm, W, f"{ca}.value")
            ctx = torch.einsum("bnhd,bnhl->bhdl", _heads(k, Hc), _heads(v, Hc))
            y = torch.einsum("bnhd,bhdl->bnhl", rnd(q), rnd(ctx))
            y = (y + (1.0 - qm) * NEG).reshape(n, T, D)
            outs.append(h + _stylize(y, es, W, f"{ca}.proj_out", mm))
        h = linear(torch.cat(outs, dim=-1), W, f"{b}.ca_mix", mm)
        f = linear(F.gelu(linear(h, W, f"{b}.ffn.linear1", mm)), W,
                   f"{b}.ffn.linear2", mm)
        h = h + _stylize(f, es, W, f"{b}.ffn.proj_out", mm)
    return linear(h, W, f"{p}.out")


# ------------------------------------------------------------ the schedule

def _betas(name: str, steps: int) -> np.ndarray:
    if name == "scaled_linear":
        return np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, steps,
                           dtype=np.float64) ** 2
    if name == "linear":
        s = 1000.0 / steps
        return np.linspace(s * 1e-4, s * 0.02, steps, dtype=np.float64)
    raise ValueError(f"beta schedule {name!r}")


def _sections(steps: int, counts: str) -> list:
    """The kept original timesteps of a respacing by section counts: each
    of len(counts) equal parts spanned by its count of evenly spaced
    steps (the upstream ``space_timesteps``)."""
    counts = [int(x) for x in counts.split(",")]
    size, extra = divmod(steps, len(counts))
    start, kept = 0, []
    for i, n in enumerate(counts):
        part = size + (1 if i < extra else 0)
        stride = 1 if n <= 1 else (part - 1) / (n - 1)
        cur = 0.0
        for _ in range(n):
            kept.append(start + round(cur))
            cur += stride
        start += part
    return sorted(set(kept))


class Schedule:
    """The respaced DDIM schedule: the kept timesteps and the update's
    coefficients, worked out in float64 and held in float32 on
    ``device``."""

    def __init__(self, spec: dict, device):
        betas = _betas(spec["beta_scheduler"], spec["diffusion_steps"])
        abar = np.cumprod(1.0 - betas)
        kept = (_sections(spec["diffusion_steps"], spec["respace"])
                if spec.get("respace") else list(range(len(betas))))
        a = abar[kept]
        prev = np.append(1.0, a[:-1])

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        self.timesteps = torch.tensor(kept, device=device)
        self.recip = f32(np.sqrt(1.0 / a))             # sqrt(1 / abar)
        self.recipm1 = f32(np.sqrt(1.0 / a - 1.0))     # sqrt(1 / abar - 1)
        self.prev = f32(np.sqrt(prev))                 # sqrt(abar_prev)
        self.prev_m1 = f32(np.sqrt(1.0 - prev))        # sqrt(1 - abar_prev)
        self.steps = len(kept)


def mix_weights(sched: Schedule, sf: dict, original_steps: int):
    """Per step, the weights of the conditioned and unconditioned outputs:
    above t = 100, w = t/1000 * coarse_scale + 1 and 1 - w (the coin of
    the scale function picks between two splits with the same sums); at
    and below, both + text and retr + none of the tuned coefficients."""
    t = sched.timesteps.double()
    w = t / original_steps * sf["coarse_scale"] + 1.0
    lo = sf["both_coef"] + sf["text_coef"]
    hi_mask = t > 100
    wc = torch.where(hi_mask, w, torch.full_like(w, lo))
    wu = torch.where(hi_mask, 1.0 - w, torch.full_like(w, 1.0 - lo))
    return wc.float(), wu.float()


def ddim_sample(W, cfg: dict, noise, word, audio, speaker, frame_mask,
                mm: Mm = plain_mm, qmask=None) -> torch.Tensor:
    """Deterministic DDIM (eta 0) from ``noise`` (n, T, D) down to the clean
    latents, the START_X prediction mixing the conditioned and the
    conditions-dropped forward at each step.  ``qmask`` (n, T) replaces
    the production query masks (a test's true separators)."""
    c = cfg["denoiser"]
    sched = Schedule(cfg["diffusion_test"], noise.device)
    wc, wu = mix_weights(sched, cfg["scale_func"],
                         cfg["diffusion_train"]["diffusion_steps"])
    n = noise.shape[0]
    tm = token_mask(c, frame_mask)
    tm2 = torch.cat([tm, tm])
    qm2 = (query_masks(c, 2 * n, noise.device) if qmask is None
           else torch.cat([qmask, qmask]))
    w2, a2, s2 = (torch.cat([word, word]), torch.cat([audio, audio]),
                  torch.cat([speaker, speaker]))
    cm2 = torch.cat([torch.ones(n, device=noise.device),
                     torch.zeros(n, device=noise.device)])
    x = noise
    for i in range(sched.steps - 1, -1, -1):
        t2 = sched.timesteps[i].expand(2 * n)
        out = denoise(W, c, torch.cat([x, x]), t2, tm2, w2, a2, s2, cm2, qm2,
                      mm)
        x0 = out[:n] * wc[i] + out[n:] * wu[i]
        eps = (x * sched.recip[i] - x0) / sched.recipm1[i]
        x = x0 * sched.prev[i] + sched.prev_m1[i] * eps
    return x


# ---------------------------------------------------------------- the codec

def _mha(W, name, q_in, k_in, v_in, heads: int):
    n, T, D = q_in.shape
    q = _heads(linear(q_in, W, name + ".q_proj"), heads)
    k = _heads(linear(k_in, W, name + ".k_proj"), heads)
    v = _heads(linear(v_in, W, name + ".v_proj"), heads)
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k)
                      / math.sqrt(D // heads), dim=-1)
    y = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(n, T, D)
    return linear(y, W, name + ".out_proj")


def _encoder_layer(W, name, x, pos, heads):
    qk = x + pos
    x = layer_norm(x + _mha(W, name + ".self_attn", qk, qk, x, heads), W,
                   name + ".norm1")
    f = linear(F.gelu(linear(x, W, name + ".linear1")), W, name + ".linear2")
    return layer_norm(x + f, W, name + ".norm2")


def vae_decode(W, cc: dict, part: str, z: torch.Tensor) -> torch.Tensor:
    """One part VAE's ``all_encoder`` decode: z (n, L, D) and 150 zero
    queries through the skip-connected post-norm stack (the position table
    added to the input and again to every layer's queries and keys) ->
    (n, 150, features)."""
    v = f"codec.{part}_vae"
    n, L, D = z.shape
    frames = L * cc["frame_chunk_size"]
    heads = 8 * (cc["lowertrans_num_heads"] if part == "lowertrans"
                 else cc["num_heads"])
    x = torch.cat([z, z.new_zeros(n, frames, D)], dim=1)
    pos = x + W[f"{v}.query_pos_decoder.pe"][None, :L + frames]
    layers = cc["num_layers"] + (1 - cc["num_layers"] % 2)
    blocks = (layers - 1) // 2
    d = f"{v}.decoder"
    skips = []
    for i in range(blocks):
        x = _encoder_layer(W, f"{d}.input_{i}", x, pos, heads)
        skips.append(x)
    x = _encoder_layer(W, f"{d}.middle", x, pos, heads)
    for i in range(blocks):
        x = linear(torch.cat([x, skips.pop()], -1), W, f"{d}.skip_linear_{i}")
        x = _encoder_layer(W, f"{d}.output_{i}", x, pos, heads)
    x = layer_norm(x, W, f"{d}.final_norm")[:, L:]
    return linear(x, W, f"{v}.final_layer")


def d6_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """(..., J*6) -> (..., J, 3, 3): Gram-Schmidt of each joint's two
    6d rows, the third row their cross product."""
    a = x.reshape(x.shape[:-1] + (-1, 2, 3))
    b1 = a[..., 0, :] / a[..., 0, :].norm(dim=-1, keepdim=True).clamp_min(1e-6)
    r2 = a[..., 1, :] - (b1 * a[..., 1, :]).sum(-1, keepdim=True) * b1
    b2 = r2 / r2.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-2)


def decode(W, cc: dict, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 43-token latents -> each rotation part as matrices (n, 150, J,
    3, 3), and translation, expressions and contacts (n, 150, k)."""
    L = (z.shape[1] - 3) // 4
    spans = {"upper": z[:, :L], "hands": z[:, L + 1:2 * L + 1],
             "face": z[:, 2 * L + 2:3 * L + 2], "lowertrans": z[:, 3 * L + 3:]}
    f = {p: vae_decode(W, cc, p, zp) for p, zp in spans.items()}
    lt, face = f["lowertrans"], f["face"]
    return {"upper": d6_to_matrix(f["upper"]),
            "hands": d6_to_matrix(f["hands"]),
            "facepose": d6_to_matrix(face[..., :6]),
            "lower": d6_to_matrix(lt[..., :54]),
            "transl": lt[..., 54:57], "exps": face[..., 6:],
            "contact": lt[..., 57:]}


@torch.no_grad()
def generate(W, cfg: dict, noise, word, audio, speaker, frame_mask,
             mm: Mm = plain_mm) -> Dict[str, torch.Tensor]:
    """A clip batch's latents and decoded motion."""
    z = ddim_sample(W, cfg, noise, word, audio, speaker, frame_mask, mm)
    out = decode(W, cfg["codec"], z)
    out["latents"] = z
    return out


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., J*3) axis-angle -> (..., J, 3, 3) by Rodrigues' formula: how
    the comparison reads the program's rotations."""
    r = aa.reshape(aa.shape[:-1] + (-1, 3)).double()
    theta = r.norm(dim=-1, keepdim=True)
    k = r / theta.clamp_min(1e-12)
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).reshape(
        k.shape[:-1] + (3, 3))
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return (eye + s * K + (1 - c) * (K @ K)).float()
