"""Plain PyTorch reference of the denoiser's training step: the frozen
part VAEs' encode of the motion, the noised latents, the masked MSE of the
x0 prediction, its gradients by autograd and Adam's update with the
cosine learning rate; float32 with TF32 off.

The draws (each part's encode noise, the timesteps, the latent noise, the
condition-dropout mask) are arguments: the benchmark makes them and gives
the same to the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import model as R


def aa_to_6d(aa: torch.Tensor) -> torch.Tensor:
    """(..., J*3) axis-angle -> (..., J*6): each rotation matrix's first
    two rows."""
    m = R.axis_angle_to_matrix(aa)
    return m[..., :2, :].reshape(aa.shape[:-1] + (-1,))


def part_features(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The four part VAEs' input features of a batch: 6d joints, the jaw
    with the expressions, the lower body with the translation (x and z
    relative to the first frame) and the foot contacts."""
    tr = b["trans"].clone()
    tr[..., 0] -= b["trans"][..., 0:1, 0]
    tr[..., 2] -= b["trans"][..., 0:1, 2]
    return {"upper": aa_to_6d(b["motion_upper"]),
            "hands": aa_to_6d(b["motion_hands"]),
            "face": torch.cat([aa_to_6d(b["motion_face"]), b["facial"]], -1),
            "lowertrans": torch.cat([aa_to_6d(b["motion_lower"]), tr,
                                     b["contact"]], -1)}


def vae_encode(W, cc: dict, part: str, feats: torch.Tensor) -> tuple:
    """One part VAE's encode: (n, 150, features) in chunks of 15 frames,
    two distribution tokens in front, the position table added, the
    skip-connected post-norm stack -> (mu, logvar), each (n, 10, D)."""
    v = f"codec.{part}_vae"
    n, frames, nf = feats.shape
    chunk = cc["frame_chunk_size"]
    L = frames // chunk
    x = R.linear(feats.reshape(n * L, chunk, nf), W, f"{v}.skel_embedding")
    tok = W[f"{v}.global_motion_token"][None].expand(n * L, -1, -1)
    x = torch.cat([tok, x], dim=1)
    x = x + W[f"{v}.query_pos_encoder.pe"][None, :x.shape[1]]
    heads = cc["lowertrans_num_heads"] if part == "lowertrans" else \
        cc["num_heads"]
    layers = cc["num_layers"] + (1 - cc["num_layers"] % 2)
    blocks = (layers - 1) // 2
    e = f"{v}.encoder"
    zero = torch.zeros_like(x)
    skips = []
    for i in range(blocks):
        x = R._encoder_layer(W, f"{e}.input_{i}", x, zero, heads)
        skips.append(x)
    x = R._encoder_layer(W, f"{e}.middle", x, zero, heads)
    for i in range(blocks):
        x = R.linear(torch.cat([x, skips.pop()], -1), W, f"{e}.skip_linear_{i}")
        x = R._encoder_layer(W, f"{e}.output_{i}", x, zero, heads)
    x = R.layer_norm(x, W, f"{e}.final_norm")
    return x[:, 0].reshape(n, L, -1), x[:, 1].reshape(n, L, -1)


def encode(W, cc: dict, batch: dict, eps: Dict[str, torch.Tensor]
           ) -> torch.Tensor:
    """The 43-token latents z = mu + exp(logvar / 2) eps of each part, zero
    separators between the parts."""
    f = part_features(batch)
    zs = {}
    for p in ("upper", "hands", "face", "lowertrans"):
        mu, logvar = vae_encode(W, cc, p, f[p])
        zs[p] = mu + torch.exp(0.5 * logvar) * eps[p]
    sep = torch.zeros_like(zs["upper"][:, :1])
    return torch.cat([zs["upper"], sep, zs["hands"], sep, zs["face"], sep,
                      zs["lowertrans"]], dim=1)


def train_alphas(spec: dict, device) -> torch.Tensor:
    """The training schedule's sqrt(abar) and sqrt(1 - abar), float32."""
    betas = R._betas(spec["beta_scheduler"], spec["diffusion_steps"])
    abar = np.cumprod(1.0 - betas)
    return (torch.tensor(np.sqrt(abar), dtype=torch.float32, device=device),
            torch.tensor(np.sqrt(1.0 - abar), dtype=torch.float32,
                         device=device))


def loss(W, cfg: dict, batch: dict, draws: dict) -> torch.Tensor:
    """The masked mean over valid tokens of the x0 prediction's squared
    error (each part weighted by the config, all 1 here), the production
    query masks in the cross attentions."""
    dc = cfg["denoiser"]
    with torch.no_grad():
        z0 = encode(W, cfg["codec"], batch, draws["enc_eps"])
    sa, som = train_alphas(cfg["diffusion_train"], z0.device)
    t = draws["t"]
    x_t = sa[t][:, None, None] * z0 + som[t][:, None, None] * draws["noise"]
    n = z0.shape[0]
    tm = R.token_mask(dc, batch["motion_mask"])
    pred = R.denoise(W, dc, x_t, t, tm, batch["word"], batch["audio"],
                     batch["speaker_ids"], draws["cond_mask"].reshape(n),
                     R.query_masks(dc, n, z0.device))
    sq = ((pred - z0) ** 2).mean(dim=-1)
    return (sq * tm).sum() / tm.sum().clamp_min(1.0)


def cosine_lr(opt: dict, step: int) -> float:
    frac = min(step, opt["total_steps"]) / opt["total_steps"]
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return opt["lr"] * ((1.0 - opt["min_lr_ratio"]) * cos
                        + opt["min_lr_ratio"])


def train_steps(W: Dict[str, torch.Tensor], cfg: dict, batches: List[dict],
                draws: List[dict]) -> dict:
    """Adam steps (b1 0.9, b2 0.999, eps 1e-8) over the denoiser's
    parameters, one per batch, from the weights ``W`` (left unchanged):
    each step's loss, the first step's gradients and the parameters
    after the last step."""
    opt = cfg["optimizer"]
    names = [k for k in W if k.startswith("denoiser.")]
    params = {k: W[k].clone().requires_grad_(True) for k in names}
    frozen = {k: v for k, v in W.items() if k not in params}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    for step, (batch, d) in enumerate(zip(batches, draws)):
        lval = loss({**frozen, **params}, cfg, batch, d)
        grads = torch.autograd.grad(lval, list(params.values()),
                                    allow_unused=True)
        losses.append(float(lval.detach()))
        g = {k: (torch.zeros_like(p) if gr is None else gr)
             for (k, p), gr in zip(params.items(), grads)}
        if first is None:
            first = {k: v.detach().clone() for k, v in g.items()}
        lr = cosine_lr(opt, step)
        c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        with torch.no_grad():
            for k, p in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                p.sub_(lr / c1 * m[k] / ((v2[k] / c2).sqrt() + eps))
    return {"losses": losses, "grads": first,
            "params": {k: p.detach() for k, p in params.items()}}
