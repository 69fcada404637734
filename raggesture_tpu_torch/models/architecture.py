"""MotionDiffusion: codec + denoiser, the training loss and generation.
Port of ``raggesture_tpu/models/architecture.py`` (``DiffusionSpec``,
``ArchitectureConfig``, ``MotionDiffusionModel``, ``lossweight_mask``,
``training_loss``, ``InferenceOptions``, ``generate``,
``invert_exemplars`` and ``StagedGenerator``: plain, outpaint, long-form
handoff and retrieval-guided sampling with the DDIM inversion of
exemplars and its per-exemplar cache, ``inversion_self_check`` and the
``params`` setter).

The training loss takes its random draws as arguments (the timesteps, the
noise, the encode's per-part eps and the condition-dropout mask), so that
a test can feed in the JAX package's; a ``torch.Generator`` draws what is
not given.  Generation takes its draws the same way.

Generation runs the batch twice per step, conditioned and unconditioned,
mixes the two with the scale-function coefficients, and decodes the final
latents.  ``generate`` runs the plain denoiser and decodes part by part.
In ``StagedGenerator`` with ``fused=True`` every denoiser call goes
through ``fused_denoiser.fused_denoise_ctx`` (on the card kernel K1 per
layer, or with ``layer_kernel=False``/``merged_ca=True`` the split
blocks' kernels K5 and K4 or K7), with ``fused=False`` through
``fused_denoiser.fused_denoise`` (K5 and the uncached K6); every codec
attention goes through kernel K2, and the stacked decode of
``fused_codec`` runs upper, hands and face as one.  On the card each
pipeline is one CUDA graph replay (``utils/cuda_graph.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..datasets.latent_cache import tree_fingerprint
from ..device import resolve_device
from ..diffusion import gaussian as G
from ..diffusion.gaussian import MeanType, VarType
from ..diffusion.sampling import (
    ddim_guided_sample_loop,
    ddim_reverse_sample_loop,
    ddim_sample_loop,
    ddpm_sample_loop,
)
from ..diffusion.schedules import DiffusionSchedule, make_schedule
from ..ops.cond_ctx import cond_contexts
from ..utils.cuda_graph import GraphCache
from ..utils.wire import cast_condition_features
from .codec import PART_NAMES, CodecConfig, GestureCodec, part_features
from .conditioning import (
    ScaleFuncConfig,
    double_conditions,
    joint_scale_vector,
    make_conditioned_model_fn,
    make_mixed_model_fn,
    mix_outputs,
    scale_func_table,
)
from .denoiser import (
    COND_KEYS,
    DenoiserConfig,
    GestureDenoiser,
    default_query_masks,
    latent_motion_mask,
)
from .fused_codec import fused_decode, stack_codec_params, stackable
from .fused_denoiser import (
    adaln_table,
    fused_denoise,
    fused_denoise_ctx,
    layer_kernel_mask_rows,
    pack_layers,
    pack_split_layers,
    pack_unfused_layers,
    precompute_cross_contexts,
    split_mask_rows,
    stack_adaln_weights,
    stack_layer_contexts,
    train_denoise_ctx,
)
from .layers import (
    DropoutDraws,
    LearnedPositionEmbedding,
    sine_position_table,
)
from .vae import PositionalEmbedding, TransformerVAE


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    beta_scheduler: str = "scaled_linear"
    diffusion_steps: int = 1000
    model_mean_type: str = "start_x"
    model_var_type: str = "fixed_large"
    respace: Optional[str] = None
    num_inference_timesteps: Optional[int] = None
    classifier_free_guidance_scale: float = 0.0

    def schedule(self, device=None) -> DiffusionSchedule:
        return make_schedule(self.beta_scheduler, self.diffusion_steps,
                             self.respace, self.num_inference_timesteps,
                             device=device)

    @property
    def mean_type(self) -> MeanType:
        return MeanType(self.model_mean_type)

    @property
    def var_type(self) -> VarType:
        return VarType(self.model_var_type)


@dataclasses.dataclass(frozen=True)
class ArchitectureConfig:
    denoiser: DenoiserConfig = DenoiserConfig()
    codec: CodecConfig = CodecConfig()
    diffusion_train: DiffusionSpec = DiffusionSpec()
    diffusion_test: DiffusionSpec = DiffusionSpec(
        respace="15,15,8,6,6", num_inference_timesteps=50)
    scale_func: Optional[ScaleFuncConfig] = ScaleFuncConfig()
    per_joint_scale: Optional[Dict[str, float]] = None
    body_part_lossweights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(upper=1.0, hands=1.0, face=1.0,
                                     lowertransl=1.0))
    inference_type: str = "ddim"


class MotionDiffusionModel(nn.Module):
    """Codec + denoiser under one parameter tree ({codec, denoiser}, as the
    JAX package's bundle)."""

    def __init__(self, cfg: ArchitectureConfig = ArchitectureConfig()):
        super().__init__()
        self.cfg = cfg
        self.codec = GestureCodec(cfg.codec)
        self.denoiser = GestureDenoiser(cfg.denoiser)

    def encode_conditions(self, batch) -> Dict[str, torch.Tensor]:
        return self.denoiser.encode_conditions(batch["word"], batch["audio"],
                                               batch["speaker_ids"])

    def _part_features(self, batch) -> Dict[str, torch.Tensor]:
        return part_features(batch["motion_upper"], batch["motion_lower"],
                             batch["motion_face"], batch["motion_hands"],
                             batch["trans"], batch["facial"], batch["contact"])

    def encode_motion(self, batch, eps: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Latents (B, 43, D) and token mask (B, 43) of a batch's motion;
        ``eps`` as in ``GestureCodec.encode``."""
        return self.codec.encode(self._part_features(batch),
                                 batch.get("motion_mask"), eps)

    def encode_motion_dist(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar) at the 43-token layout: the latent cache's encode."""
        return self.codec.encode_dist(self._part_features(batch),
                                      batch.get("motion_mask"))

    def decode_latents(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.codec.decode(z)

    def batch_fed_modules(self) -> Tuple[nn.Module, ...]:
        """The modules whose inputs are the batch's features: the codec
        (the motion) and the denoiser's condition encoders.  Under
        ``bf16_compute`` they compute in the batch's bf16; the rest of the
        denoiser starts from the float32 x_t and time embedding."""
        return (self.codec,) + self.denoiser.condition_encoders()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 zero_init_std: float = 0.0) -> None:
    """Random weights from ``generator``: normal(0, 1/sqrt(fan_in)) for
    Linear weights, zero biases, unit LayerNorms, normal/D speaker
    embeddings, xavier-uniform position tables.  The Linears the JAX package
    zero-initialises stay zero, or get normal(0, ``zero_init_std``) weights
    and biases when it is positive (so that every path reaches the output
    of a randomly initialised model)."""
    g = generator
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            if getattr(mod, "zero_init", False):
                mod.weight.normal_(0.0, zero_init_std, generator=g)
                mod.bias.normal_(0.0, zero_init_std, generator=g)
            else:
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=g)
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / mod.embedding_dim, generator=g)
        elif isinstance(mod, (LearnedPositionEmbedding, PositionalEmbedding)):
            L, d = mod.pe.shape
            if isinstance(mod.pe, nn.Parameter):
                limit = math.sqrt(6.0 / (d + L * d))
                mod.pe.uniform_(-limit, limit, generator=g)
            else:   # the sine table, a buffer made anew on the device
                mod.pe.copy_(sine_position_table(L, d, device=mod.pe.device))
        elif isinstance(mod, TransformerVAE):
            mod.global_motion_token.normal_(0.0, 1.0, generator=g)


def create_model(cfg: ArchitectureConfig = ArchitectureConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, zero_init_std: float = 0.0
                 ) -> MotionDiffusionModel:
    """A model with random weights made from ``seed``, in eval mode, on the
    CUDA card unless ``device`` names another."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MotionDiffusionModel(cfg)
    model = model.to_empty(device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed),
                 zero_init_std)
    return model.eval()


def lossweight_mask(cfg: ArchitectureConfig,
                    token_mask: torch.Tensor) -> torch.Tensor:
    """Per-token loss weights from ``body_part_lossweights``."""
    w = torch.ones_like(token_mask)
    names = {"upper": "upper", "hands": "hands", "face": "face",
             "lowertrans": "lowertransl"}
    for part, sl in cfg.denoiser.part_slices().items():
        w[:, sl] = cfg.body_part_lossweights[names[part]]
    return w


def _draw(given, generator, what: str, fn, B: int, shard=None):
    """``given``, or ``fn(n)`` drawn from ``generator`` for ``n = B`` rows;
    with a data-parallel ``shard`` the draw is the global batch's and this
    rank takes its rows, so that the ranks together draw what one process
    draws for the whole batch."""
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"training_loss needs a generator or {what}")
    if shard is None:
        return fn(B)
    return fn(shard.global_batch)[shard.start:shard.start + B]


def training_loss(model: MotionDiffusionModel, sched_train: DiffusionSchedule,
                  batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  enc_eps=None, cond_mask: Optional[torch.Tensor] = None,
                  t_weights: Optional[torch.Tensor] = None,
                  return_per_sample: bool = False,
                  query_masks: Optional[Dict[str, torch.Tensor]] = None,
                  ctx_fn: Callable = cond_contexts,
                  fused_ctx: bool = True,
                  shard=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked, part-weighted MSE of the denoiser's x0 prediction.

    The frozen codec encodes the batch's motion (no gradient), with
    ``enc_eps`` {part: (B, 10, D)} as the rsample draws; a batch with
    ``latent_mu``/``latent_logvar`` (the latent cache) is drawn from
    instead, ``enc_eps`` then (B, 43, D).  ``t`` (B,) timesteps, ``noise``
    (B, 43, D) and ``cond_mask`` (B, 1, 1) condition dropout (about 10 %
    zeros) complete the draws; whatever is not given comes from
    ``generator`` in that order, in the dtype of what it perturbs (a bf16
    batch's encode draws and, from its bf16 latents, the noise and the
    condition mask are bf16, as the JAX package draws them under
    ``bf16_compute``).  ``fused_ctx`` (the JAX package's default) runs the
    denoiser through ``train_denoise_ctx`` (kernel K3 on the card,
    ``ctx_fn``), which takes no dropout; ``fused_ctx=False`` runs the
    denoiser's own per-layer forward, plain PyTorch on any device, with
    the config's dropout drawn from ``generator`` after the other draws.
    ``query_masks`` default to the reference's quirk masks.

    ``shard`` (``parallel/mesh.py::Shard``) makes this one data-parallel
    rank's part of the global batch's loss: the draws made here are the
    global batch's, this rank's rows taken; the loss is normalized by the
    token-mask sum all-reduced over the ranks (with ``t_weights``, by the
    global batch), so that the ranks' losses sum to the global loss and
    their summed gradients are its gradients.  The logs are then this
    rank's parts of the global values (their sums over the ranks);
    ``per_sample_loss`` stays per row.  Returns (loss, logs)."""
    cfg = model.cfg
    dc = cfg.denoiser
    dev = next(model.parameters()).device
    g = generator
    drops = dc.dropout > 0 or dc.ca_drop > 0
    if fused_ctx and drops:
        raise ValueError(f"the fused_ctx training path takes no dropout, "
                         f"the denoiser has dropout {dc.dropout} "
                         f"(cross attention {dc.ca_drop}); use "
                         f"fused_ctx=False")
    if "latent_mu" in batch:
        mu = batch["latent_mu"].float()
        eps = _draw(enc_eps, g, "enc_eps", lambda n: torch.randn(
            (n,) + mu.shape[1:], generator=g, device=dev), mu.shape[0], shard)
        z0 = mu + torch.exp(0.5 * batch["latent_logvar"].float()) * eps
        token_mask = latent_motion_mask(dc, batch["motion_mask"])
    else:
        B0 = batch["motion_upper"].shape[0]
        n_chunks = batch["motion_upper"].shape[1] // cfg.codec.frame_chunk_size
        edt = batch["motion_upper"].dtype
        eps = enc_eps
        if eps is None:
            eps = {p: _draw(None, g, "enc_eps", lambda n: torch.randn(
                       n, n_chunks, cfg.codec.latent_dim, generator=g,
                       device=dev, dtype=edt), B0, shard)
                   for p in PART_NAMES}
        z0, token_mask = model.encode_motion(batch, eps)
    B = z0.shape[0]
    t = _draw(t, g, "t", lambda n: torch.randint(
        0, sched_train.num_timesteps, (n,), generator=g, device=dev), B,
        shard)
    noise = _draw(noise, g, "noise", lambda n: torch.randn(
        (n,) + z0.shape[1:], generator=g, device=dev, dtype=z0.dtype), B,
        shard)
    cond_mask = _draw(cond_mask, g, "cond_mask", lambda n: (
        torch.randint(0, 100, (n, 1, 1), generator=g, device=dev) % 10 > 0
    ).to(z0.dtype), B, shard)
    x_t = G.q_sample(sched_train, z0, t, noise)
    conds = model.encode_conditions(batch)
    if query_masks is None:
        query_masks = default_query_masks(dc, B, device=dev)
    if fused_ctx:
        pred = train_denoise_ctx(model.denoiser, x_t, t, token_mask, conds,
                                 query_masks, cond_mask, ctx_fn)
    else:
        drop = None
        if drops:
            if g is None:
                raise ValueError("dropout is drawn from the generator; "
                                 "pass one")
            drop = DropoutDraws(g, None if shard is None
                                else (shard.start, shard.global_batch))
        pred = model.denoiser(x_t, t, token_mask, conds, query_masks,
                              cond_mask, drop=drop)
    target = G.training_target(sched_train, cfg.diffusion_train.mean_type,
                               z0, x_t, noise, t)
    sq = ((pred - target) ** 2).mean(dim=-1)              # (B, T)
    masked = sq * token_mask * lossweight_mask(cfg, token_mask)
    per_sample = masked.sum(dim=1) / token_mask.sum(dim=1).clamp_min(1.0)
    denom = token_mask.sum()
    if shard is not None:
        denom = shard.sum(denom)
    denom = denom.clamp_min(1.0)
    if t_weights is None:
        loss = masked.sum() / denom
    elif shard is None:
        loss = (per_sample * t_weights).mean()
    else:
        loss = (per_sample * t_weights).sum() / shard.global_batch
    logs = {"recon_loss": loss,
            "mse_unweighted": (sq * token_mask).sum() / denom}
    if return_per_sample:
        logs["per_sample_loss"] = per_sample
        logs["t"] = t
    return loss, logs


# ---------------------------------------------------------------- inference


@dataclasses.dataclass(frozen=True)
class InferenceOptions:
    """The JAX package's inference options: ``use_inversion`` DDIM-inverts
    the retrieved exemplars under their own conditions and splices their
    windows into the start noise, ``insertion_guidance`` overwrites those
    windows at every step, ``outpaint`` overwrites with the retrieved
    latents themselves, ``use_prev_latent`` hands the previous chunk's last
    tokens on (long-form synthesis).  ``eta > 0`` (stochastic DDIM) is
    taken by ``generate`` only, as in the JAX package."""

    use_inversion: bool = False
    insertion_guidance: bool = False
    guidance_lr: float = 0.1
    inversion_start_time: int = -1
    outpaint: bool = False
    use_prev_latent: bool = False
    eta: float = 0.0

    def validate(self) -> None:
        """Raise ValueError on the combinations the JAX package refuses."""
        if self.outpaint and (self.use_inversion or self.insertion_guidance):
            raise ValueError("outpaint excludes use_inversion and "
                             "insertion_guidance")
        if self.insertion_guidance and not self.use_inversion:
            raise ValueError("insertion_guidance needs use_inversion")
        if self.use_prev_latent and self.outpaint:
            raise ValueError("use_prev_latent excludes outpaint")


def guidance_iters_schedule(name_or_list, num_steps: int = 50
                            ) -> torch.Tensor:
    """A named guidance-iteration schedule (S,) int32, indexed by spaced
    step i (0 = cleanest), or a list taken as it is."""
    h = num_steps // 2
    if isinstance(name_or_list, (list, tuple)):
        arr = list(name_or_list)
    elif name_or_list == "all_one":
        arr = [1] * num_steps
    elif name_or_list in ("all_zero", "none"):
        arr = [0] * num_steps
    elif name_or_list in ("all_10", "constant"):
        arr = [10] * num_steps
    elif name_or_list == "decreasing":
        arr = list(range(num_steps))
    elif name_or_list == "increasing":
        arr = list(range(num_steps - 1, -1, -1))
    elif name_or_list == "drop_decreasing_till_25":
        arr = [0] * h + list(range(num_steps))[h:]
    elif name_or_list == "step_increasing_from_25":
        arr = list(range(num_steps - 1, -1, -1))[:h] + [0] * (num_steps - h)
    elif name_or_list == "decreasing_till_25":
        arr = [0] * h + list(range(num_steps - h))
    elif name_or_list == "increasing_from_25":
        arr = list(range(h - 1, -1, -1)) + [0] * (num_steps - h)
    else:
        raise ValueError(f"unknown guidance schedule {name_or_list}")
    if len(arr) != num_steps:
        raise ValueError(f"guidance schedule of {len(arr)} steps, the "
                         f"sampler takes {num_steps}")
    return torch.tensor(arr, dtype=torch.int32)


def masked_prev_latent(cfg: DenoiserConfig,
                       prev_latent: torch.Tensor) -> torch.Tensor:
    """The long-form handoff: each part's last latent token moved to its
    first position, zeros elsewhere."""
    out = torch.zeros_like(prev_latent)
    for sl in cfg.part_slices().values():
        out[:, sl.start] = prev_latent[:, sl.stop - 1]
    return out


def zero_first_tokens(cfg: DenoiserConfig, inv: torch.Tensor) -> torch.Tensor:
    """Each part's first token zeroed across all inversion steps (S, B, T,
    D): with the handoff, guidance never fights the handed-on token."""
    inv = inv.clone()
    for sl in cfg.part_slices().values():
        inv[:, :, sl.start] = 0.0
    return inv


def splice_maps(cfg: DenoiserConfig, splice, B: int, T: int, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B·T,) gather index into the flattened exemplar rows (Q·T) and
    the (B, T) write mask of the latent window splice, built on the host.
    ``splice`` (Q, 4) rows (batch_idx, q_start, r_start, length) in latent
    tokens place exemplar q's window [r_start, r_start + length) at
    [q_start, ...) of sequence batch_idx, in the upper and the hands rows;
    later rows overwrite earlier ones.  A row that reaches outside its
    part or the batch raises ValueError."""
    L = cfg.tokens_per_part
    rows = np.asarray(splice.cpu() if isinstance(splice, torch.Tensor)
                      else splice)
    src_idx = np.full((B, T), -1, np.int64)
    for q in range(rows.shape[0]):
        b, q_start, r_start, ln = (int(v) for v in rows[q])
        if ln <= 0:
            continue
        if (b < 0 or b >= B or q_start < 0 or r_start < 0
                or q_start + ln > L or r_start + ln > L):
            raise ValueError(
                f"splice row {q} out of range: (b={b}, q_start={q_start}, "
                f"r_start={r_start}, len={ln}) for L={L}, B={B}")
        cols = np.arange(ln)
        for off in (0, L + 1):  # the upper row, the hands row
            src_idx[b, off + q_start + cols] = q * T + off + r_start + cols
    keep = src_idx < 0
    gather = torch.from_numpy(np.where(keep, 0, src_idx).reshape(-1))
    mask = torch.from_numpy((~keep).astype(np.float32))
    return gather.to(device), mask.to(device)


def _splice_apply(start_noise: torch.Tensor, inv_stack: torch.Tensor,
                  gather: torch.Tensor, mask: torch.Tensor,
                  inversion_start_time: int, with_guidance: bool):
    """The start noise with the windows of the inverted exemplars at step
    ``inversion_start_time`` spliced in, and with guidance the (S, B, T, D)
    per-step targets (zeros outside the windows)."""
    S = inv_stack.shape[0]
    B, T, D = start_noise.shape
    m = mask[..., None]
    spliced = inv_stack[inversion_start_time].reshape(-1, D)[gather]
    start_noise = start_noise * (1.0 - m) + spliced.reshape(B, T, D) * m
    if not with_guidance:
        return start_noise, None
    inv_all = inv_stack.reshape(S, -1, D)[:, gather].reshape(S, B, T, D)
    return start_noise, inv_all * m[None]


def splice_inverted(cfg: DenoiserConfig, start_noise: torch.Tensor,
                    inv_stack: torch.Tensor, splice,
                    inversion_start_time: int, with_guidance: bool):
    """Splice the inverted exemplar windows (upper and hands rows) into the
    start noise and, with guidance, build the per-step targets."""
    gather, mask = splice_maps(cfg, splice, *start_noise.shape[:2],
                               device=start_noise.device)
    return _splice_apply(start_noise, inv_stack, gather, mask,
                         int(inversion_start_time), bool(with_guidance))


def _no_guidance(cfg_scale: float, where: str) -> None:
    """Refuse classifier-free guidance where the model function is the
    scale function's or the conditioned one: both return B rows, and
    guidance reads 2B, unconditioned first.  (The JAX package passes them
    on, and ``p_mean_variance`` then mixes other samples' rows as the
    unconditioned and conditioned halves at B = 2, and fails at B = 1.)"""
    if cfg_scale > 0:
        raise ValueError(
            f"{where}: classifier_free_guidance_scale = {cfg_scale} needs a "
            f"model function of 2B rows, unconditioned first; this path's "
            f"returns B.  Sample with conditioning.make_cfg_model_fn and "
            f"the diffusion.sampling loops instead")


def _inv_conds_core(re_dict, device) -> Dict[str, torch.Tensor]:
    """The retrieved exemplars' own raw conditions, on ``device``."""
    conds = re_dict["inv_conds"]
    return {k: torch.as_tensor(conds[k], device=device)
            for k in ("word", "audio", "speaker_ids")}


def _expand_query_masks(cfg: DenoiserConfig, query_masks, n: int, device
                        ) -> Dict[str, torch.Tensor]:
    """``{key: (T,) or (n, T)}`` broadcast to ``n`` sequences; the
    reference's quirk masks when None."""
    if query_masks is None:
        return default_query_masks(cfg, n, device=device)
    return {k: torch.as_tensor(v, device=device).float()
            .expand(n, cfg.num_tokens).contiguous()
            for k, v in query_masks.items()}


@torch.no_grad()
def invert_exemplars(model: MotionDiffusionModel, sched_test: DiffusionSchedule,
                     re_dict, *, mean_type, var_type, cfg_scale,
                     query_masks=None) -> torch.Tensor:
    """The batched DDIM inversion of every retrieved exemplar, each under its
    own text, audio and speaker conditions (no mixing), through the plain
    denoiser: (S, Q, T, D), clean to noisy.  ``query_masks`` as in
    :func:`generate`.  ``cfg_scale > 0`` raises ValueError (the conditioned
    model function returns B rows)."""
    _no_guidance(cfg_scale, "invert_exemplars")
    dev = next(model.parameters()).device
    inv_lat = torch.as_tensor(re_dict["inv_latents"], device=dev).float()
    inv_mask = torch.as_tensor(re_dict["inv_mask"], device=dev).float()
    conds = model.encode_conditions(_inv_conds_core(re_dict, dev))
    qm = _expand_query_masks(model.cfg.denoiser, query_masks,
                             inv_lat.shape[0], dev)
    model_fn = make_conditioned_model_fn(model.denoiser, conds, inv_mask, qm)
    return ddim_reverse_sample_loop(model_fn, sched_test.to(dev), inv_lat,
                                    mean_type=mean_type, var_type=var_type,
                                    cfg_scale=cfg_scale)


@torch.no_grad()
def generate(model: MotionDiffusionModel, sched_test: DiffusionSchedule,
             batch, generator: Optional[torch.Generator] = None,
             opts: InferenceOptions = InferenceOptions(), re_dict=None,
             guidance_iters=None, prev_latent=None, *,
             noise: Optional[torch.Tensor] = None,
             coef_table: Optional[torch.Tensor] = None,
             in_seq_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[torch.Tensor] = None,
             query_masks: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
    """Full inference through the plain denoiser, with every option,
    stochastic DDIM (``opts.eta > 0``) and the DDPM sampler
    (``inference_type="ddpm"``) included: the JAX package's ``generate``.

    ``batch`` holds the motion as well as the conditions: its ground truth
    is encoded (the means, no draw) for the token mask and the latent
    shape.  ``re_dict``, ``guidance_iters`` and ``prev_latent`` are as in
    ``StagedGenerator.__call__`` (the exemplars are not bucketed here).
    The draws are ``noise`` (B, T, D), ``coef_table`` (S, 4), and the loop's
    ``in_seq_noise`` and ``step_noise`` (S, B, T, D), indexed by spaced
    step; a ``generator`` draws what is not given, in the JAX order: the
    start noise, the coefficient table, the loop's.  DDPM with inversion,
    guidance, outpainting or the handoff raises ValueError, as in the JAX
    package; so does a test spec with ``classifier_free_guidance_scale >
    0``, where the JAX package mixes the wrong rows (``_no_guidance``).
    Every beta schedule, respacing, mean and variance type is taken.
    Returns the decoded parts and the final latents."""
    opts.validate()
    cfg = model.cfg
    _no_guidance(cfg.diffusion_test.classifier_free_guidance_scale,
                 "generate")
    dc = cfg.denoiser
    dev = next(model.parameters()).device
    sched = sched_test.to(dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    z_gt, token_mask = model.encode_motion(b)
    B, T, D = z_gt.shape
    if noise is None:
        if generator is None:
            raise ValueError("generate needs a generator or the start noise")
        noise = torch.randn(B, T, D, generator=generator, device=dev)
    start = torch.as_tensor(noise, device=dev)
    conds = model.encode_conditions(b)
    qm = _expand_query_masks(dc, query_masks, B, dev)
    if cfg.scale_func is not None:
        if coef_table is None:
            coef_table = scale_func_table(
                sched, cfg.scale_func, cfg.diffusion_train.diffusion_steps,
                generator=generator)
        js = joint_scale_vector(dc, cfg.per_joint_scale, device=dev)
        model_fn = make_mixed_model_fn(model.denoiser, conds, token_mask, qm,
                                       torch.as_tensor(coef_table, device=dev),
                                       js)
    else:
        model_fn = make_conditioned_model_fn(model.denoiser, conds,
                                             token_mask, qm)
    spec = cfg.diffusion_test
    common = dict(mean_type=spec.mean_type, var_type=spec.var_type,
                  cfg_scale=spec.classifier_free_guidance_scale)
    prev = opts.use_prev_latent and prev_latent is not None
    inv_all = None
    if opts.use_inversion:
        if re_dict is None or "inv_latents" not in re_dict:
            raise ValueError("use_inversion needs re_dict['inv_latents']")
        inv_stack = invert_exemplars(model, sched, re_dict,
                                     query_masks=query_masks, **common)
        start, inv_all = splice_inverted(
            dc, start, inv_stack, re_dict["splice"],
            opts.inversion_start_time, opts.insertion_guidance)
        if opts.insertion_guidance and prev:
            inv_all = zero_first_tokens(dc, inv_all)
    in_seq = None
    if prev:
        in_seq = masked_prev_latent(dc, torch.as_tensor(prev_latent,
                                                        device=dev))
    elif opts.outpaint:
        rml = torch.as_tensor(re_dict["raw_motion_latents"], device=dev)
        in_seq = rml[:, 0] if rml.dim() == 4 else rml
    draws = dict(in_seq_noise=in_seq_noise, step_noise=step_noise,
                 generator=generator, **common)
    if cfg.inference_type == "ddpm":
        if opts.use_inversion or opts.insertion_guidance or in_seq is not None:
            raise ValueError(
                "inference_type='ddpm' supports none of use_inversion/"
                "insertion_guidance/outpaint/prev-latent — use the ddim "
                "sampler (the shipped config) for retrieval-guided modes")
        out = ddpm_sample_loop(model_fn, sched, start, step_noise=step_noise,
                               generator=generator, **common)
    elif opts.insertion_guidance:
        gi = (guidance_iters if guidance_iters is not None else
              guidance_iters_schedule("constant", sched.num_timesteps))
        out = ddim_guided_sample_loop(
            model_fn, sched, start, inverted_latents=inv_all,
            guidance_iters=gi, guidance_lr=opts.guidance_lr, eta=opts.eta,
            init_in_seq=in_seq, **draws)
    else:
        out = ddim_sample_loop(model_fn, sched, start, eta=opts.eta,
                               in_seq=in_seq, **draws)
    results = {f"pred_{k}": v for k, v in model.decode_latents(out).items()}
    results["prev_latentout"] = out
    results["output_latents"] = out
    return results


class StagedGenerator:
    """Deterministic DDIM generation, the JAX ``StagedGenerator``: ``sample``
    and ``__call__`` (plain, outpaint, long-form handoff and
    retrieval-guided sampling, with the per-exemplar inversion cache),
    ``inversion_self_check``, and the ``params`` setter.  Like the JAX class
    it runs eta = 0 only (:func:`generate` takes eta > 0).

    ``fused=True`` routes every denoiser call through ``fused_denoise_ctx``:
    the adaLN rows of every step are one table built here, the
    cross-attention contexts are computed once per pipeline, and the layers
    run kernel K1 (bf16 packs on the card, float32 on the CPU, where the
    plain version then matches the JAX package in float32), or with
    ``layer_kernel=False`` the split blocks' float32 kernels K5 and K4, or
    with ``merged_ca=True`` K5 and K7 (``merged_ca`` wins over the layer
    kernel, as in the JAX package).  It is the port's default, and what
    ``bench.py`` asks of the JAX class on the accelerator
    (``fused=on_tpu``); the JAX constructor's default is ``fused=False``.
    The options are keyword-only: their order differs from the JAX
    signature's.

    ``fused=False`` routes every call through ``fused_denoise``, the
    uncached call with ``GestureDenoiser.forward``'s arguments: the time
    embedding and the adaLN product per call from per-sample timesteps,
    and each cross attention's keys and values from the condition rows in
    every call (kernels K5 and K6); ``layer_kernel`` and ``merged_ca`` are
    then ignored, as in the JAX package.  Its weight packs are the modules'
    own tensors, and its adaLN projections are stacked in every pipeline,
    so weights updated in place between calls are read.  The cached path
    instead keeps the copies built by ``_refresh_prologue`` (the adaLN
    table, K1's bf16 packs, the codec stack): new weights reach it through
    the ``params`` setter, which rebuilds them.

    ``fused_codec`` (default: ``fused``, as in the JAX class, for the
    shipped part VAEs; part by part for the other variants) decodes upper,
    hands and face as one stack (``fused_codec.fused_decode``).

    ``graphs`` (default: on for a CUDA model, off on the CPU; True on the
    CPU raises) runs each of the six pipelines (``_sample_pipeline``,
    ``_sample_inseq_pipeline``, ``_guided_pipeline``,
    ``_guided_pipeline_cached``, and the JAX class's staged path as
    ``_invert_sample_pipeline`` and ``_guided_inseq_pipeline``) and the
    cache's inversion of misses as one CUDA graph replay
    (``utils/cuda_graph.py``), from the condition encoders to the decode.
    The draws, the splice maps and the inversion cache's bookkeeping stay
    on the host side of the graph.

    The random draws are arguments: the scale function's coin flips (as
    ``coef_table``), the start noise, and the in-seq overwrite's bulk noise
    (S, B, T, D); a ``torch.Generator`` draws what is not given, in that
    order.  Query masks ``{key: (T,) or (n, T)}`` broadcast to each
    call's batch (the exemplars' too) and default to the reference's quirk
    masks.

    ``bf16_conditions`` ships host word and audio features (the batch's
    and the exemplars') to the device as bfloat16 (``utils/wire.py``); they
    run widened back to float32, as jnp promotes them.  Off by default: on
    in the JAX class only on a TPU.

    Every beta schedule, respacing, mean and variance type of the test spec
    runs, eager and replayed; a spec with ``classifier_free_guidance_scale
    > 0`` raises ValueError (``_no_guidance``)."""

    def __init__(self, model: MotionDiffusionModel, sched: DiffusionSchedule,
                 *, fused: bool = True, layer_kernel: bool = True,
                 merged_ca: bool = False, fused_codec: Optional[bool] = None,
                 graphs: Optional[bool] = None,
                 bf16_conditions: bool = False):
        self.model = model
        self.bf16_conditions = bool(bf16_conditions)
        self.device = next(model.parameters()).device
        self.sched = sched.to(self.device)
        self.fused = fused
        self.merged_ca = merged_ca
        self.layer_kernel = layer_kernel and not merged_ca
        self.fused_codec = ((fused and stackable(model.cfg.codec))
                            if fused_codec is None else fused_codec)
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a model on a CUDA device, "
                             f"this one is on {self.device}")
        self.graphs = GraphCache(self.device) if graphs else None
        # the per-exemplar inversion cache: an exemplar's (S, T, D)
        # trajectory, by its name (re_dict["inv_names"]), oldest first; and
        # the assembled (S, Qb, T, D) stacks by (names, Qb)
        self.inv_cache_capacity = 64
        # exemplar lookups in the cache since construction: hits (the
        # trajectory was there, or the assembled stack) and misses
        self.inv_cache_hits = 0
        self.inv_cache_misses = 0
        self._inv_cache: Dict[str, torch.Tensor] = {}
        self._inv_stack_cache: Dict[tuple, torch.Tensor] = {}
        self._splice_memo: Dict[tuple, tuple] = {}
        spec = model.cfg.diffusion_test
        _no_guidance(spec.classifier_free_guidance_scale, "StagedGenerator")
        self._common = dict(mean_type=spec.mean_type, var_type=spec.var_type,
                            cfg_scale=spec.classifier_free_guidance_scale)
        self._js = joint_scale_vector(model.cfg.denoiser,
                                      model.cfg.per_joint_scale,
                                      device=self.device)
        self._refresh_prologue()

    # ------------------------------------------------------- the parameters

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict()``."""
        return self.model.state_dict()

    @params.setter
    def params(self, state: Dict[str, torch.Tensor]) -> None:
        """Load ``state`` into the model (strictly: any missing or
        unexpected key raises KeyError before anything changes), then
        rebuild what is built from the weights, empty both inversion caches and drop every
        captured graph: the next call of each pipeline captures anew."""
        own = set(self.model.state_dict())
        missing, unexpected = sorted(own - set(state)), sorted(set(state) - own)
        if missing or unexpected:
            raise KeyError(f"params: {len(missing)} missing keys "
                           f"{missing[:3]}, {len(unexpected)} unexpected "
                           f"{unexpected[:3]}")
        self.model.load_state_dict(state, strict=True)
        self._inv_cache.clear()
        self._inv_stack_cache.clear()
        if self.graphs is not None:
            self.graphs.clear()
        self._refresh_prologue()

    @torch.no_grad()
    def _refresh_prologue(self) -> None:
        """What the pipelines read of the weights, built once per set of
        weights: the adaLN table of every step and the layer packs (K1's
        bf16 packs, or the split or uncached packs), and the codec stack."""
        den = self.model.denoiser
        self._codec_stack = (stack_codec_params(self.model.codec)
                             if self.fused_codec else None)
        if self.fused:
            self.pack_dtype = (torch.bfloat16 if self.device.type == "cuda"
                               and self.layer_kernel else torch.float32)
            self.adaln_scale, self.adaln_shift = adaln_table(
                den, self.sched.timestep_map)
            self.packs = (pack_layers(den, self.pack_dtype)
                          if self.layer_kernel else pack_split_layers(den))
        else:
            self.packs = pack_unfused_layers(den)

    # ------------------------------------------------------------ the pieces

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _conditions(self, d) -> Dict[str, torch.Tensor]:
        """``d``'s word, audio and speaker_ids on the device, contiguous,
        the features float32 (copied as bf16 under ``bf16_conditions``)."""
        if self.bf16_conditions:
            d = cast_condition_features(d)
        out = {k: self._tensor(d[k]).contiguous()
               for k in ("word", "audio", "speaker_ids")}
        for k in ("word", "audio"):
            out[k] = out[k].float()
        return out

    def _query_masks(self, query_masks, n: int) -> Dict[str, torch.Tensor]:
        return _expand_query_masks(self.model.cfg.denoiser, query_masks, n,
                                   self.device)

    def _qm_rows(self, query_masks, n: int) -> torch.Tensor:
        """The query masks as one (3, n, T) tensor, in COND_KEYS order."""
        qm = self._query_masks(query_masks, n)
        return torch.stack([qm[k] for k in COND_KEYS])

    def _model_fn(self, conds, token_mask, query_masks, coef_table, js,
                  mixed: bool):
        """The sampler's model_fn.  ``mixed`` (with a scale function): the
        batch runs twice, conditioned and with the conditions dropped, and
        the halves mix; otherwise it runs conditioned once."""
        den = self.model.denoiser
        mixed = mixed and self.model.cfg.scale_func is not None
        if not self.fused:
            # stacked per pipeline: weights updated in place are read
            adaln_weights = stack_adaln_weights(den)

            def apply(x, t_orig, mask, cc, qm, cm):
                return fused_denoise(den, x, t_orig, mask, cc, qm, cm,
                                     self.packs, adaln_weights)

            if mixed:
                return make_mixed_model_fn(apply, conds, token_mask,
                                           query_masks, coef_table, js)
            return make_conditioned_model_fn(apply, conds, token_mask,
                                             query_masks)

        B = token_mask.shape[0]
        if mixed:
            conds, token_mask, query_masks, cond_mask = double_conditions(
                conds, token_mask, query_masks)
        else:
            cond_mask = torch.ones(B, 1, 1, device=self.device)
        ctx = precompute_cross_contexts(den, conds, cond_mask)
        # the split path's contexts stay float32 (pack_dtype is then float32)
        ctx3s = stack_layer_contexts(den.cfg, ctx, self.pack_dtype)
        mask_rows = (layer_kernel_mask_rows if self.layer_kernel
                     else split_mask_rows)
        m_rows, qm_rows = mask_rows(token_mask, query_masks)

        def model_fn(x, t_orig, step_idx):
            # t_orig is timestep_map[step_idx]: its adaLN rows are in the table
            out = fused_denoise_ctx(
                den, torch.cat([x, x]) if mixed else x,
                self.adaln_scale[step_idx], self.adaln_shift[step_idx],
                self.packs, ctx3s, m_rows, qm_rows,
                layer_kernel=self.layer_kernel, merged_ca=self.merged_ca)
            return mix_outputs(out, B, coef_table, step_idx, js) if mixed else out

        return model_fn

    def _core(self, batch, generator, noise, coef_table, query_masks
              ) -> Dict[str, torch.Tensor]:
        """A pipeline's inputs from the clip batch, made outside any graph:
        the conditions and the frame mask on the device, the scale
        function's coefficients and the start noise (drawn in that order
        when not given), and the query masks (3, B, T)."""
        cfg = self.model.cfg
        dc = cfg.denoiser
        core = self._conditions(batch)
        core["motion_mask"] = self._tensor(batch["motion_mask"]).float()
        B = core["motion_mask"].shape[0]
        if coef_table is None:
            if cfg.scale_func is None:
                coef_table = torch.zeros(self.sched.num_timesteps, 4,
                                         device=self.device)
            else:
                coef_table = scale_func_table(
                    self.sched, cfg.scale_func,
                    cfg.diffusion_train.diffusion_steps, generator=generator)
        if noise is None:
            if generator is None:
                raise ValueError("generation needs a generator or the start "
                                 "noise")
            noise = torch.randn(B, dc.num_tokens, dc.latent_dim,
                                generator=generator, device=self.device)
        core["coef_table"] = self._tensor(coef_table).float()
        core["noise"] = self._tensor(noise)
        core["qm"] = self._qm_rows(query_masks, B)
        return core

    def _in_seq_noise(self, given, generator, B: int) -> torch.Tensor:
        """The in-seq overwrite's bulk draw (S, B, T, D)."""
        dc = self.model.cfg.denoiser
        if given is not None:
            return self._tensor(given)
        if generator is None:
            raise ValueError("the in-seq overwrite needs in_seq_noise or a "
                             "generator")
        return torch.randn(self.sched.num_timesteps, B, dc.num_tokens,
                           dc.latent_dim, generator=generator,
                           device=self.device)

    def _pipeline_prologue(self, word, audio, speaker_ids, motion_mask,
                           coef_table, qm):
        """Every pipeline's head: the condition encoders, the token mask
        from the frame mask, and the mixed model_fn."""
        conds = self.model.encode_conditions(
            {"word": word, "audio": audio, "speaker_ids": speaker_ids})
        token_mask = latent_motion_mask(self.model.cfg.denoiser, motion_mask)
        return self._model_fn(conds, token_mask, dict(zip(COND_KEYS, qm)),
                              coef_table, self._js, mixed=True)

    def _inv_model_fn(self, inv_mask, inv_word, inv_audio, inv_speaker_ids,
                      inv_qm):
        """The exemplars' conditioned model_fn, under their own conditions."""
        conds = self.model.encode_conditions(
            {"word": inv_word, "audio": inv_audio,
             "speaker_ids": inv_speaker_ids})
        return self._model_fn(conds, inv_mask, dict(zip(COND_KEYS, inv_qm)),
                              None, None, mixed=False)

    def _invert_section(self, inv_latents, inv_mask, inv_word, inv_audio,
                        inv_speaker_ids, inv_qm) -> torch.Tensor:
        """The exemplars' DDIM inversion: (S, Q, T, D), clean to noisy."""
        model_fn = self._inv_model_fn(inv_mask, inv_word, inv_audio,
                                      inv_speaker_ids, inv_qm)
        return ddim_reverse_sample_loop(model_fn, self.sched, inv_latents,
                                        **self._common)

    def _inv_inputs(self, re_dict, query_masks, Qb: int,
                    index: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """The exemplars' inversion inputs: their latents, token masks, raw
        conditions and query masks, rows ``index`` when given, else every
        row padded with zero rows (mask 0) to ``Qb``; contiguous, as a
        graph's copies of them are, so that an eager run reads the same
        layouts (an expanded view takes other products' kernels)."""
        inputs = {"inv_latents": self._tensor(re_dict["inv_latents"]).float(),
                  "inv_mask": self._tensor(re_dict["inv_mask"]).float()}
        inputs.update({f"inv_{k}": v for k, v in
                       self._conditions(re_dict["inv_conds"]).items()})
        if index is not None:
            idx = torch.tensor(index, device=self.device)
            inputs = {k: v[idx] for k, v in inputs.items()}
        Q = inputs["inv_latents"].shape[0]
        if Qb != Q:
            inputs = {k: torch.cat([v, v.new_zeros((Qb - Q,) + v.shape[1:])])
                      for k, v in inputs.items()}
        inputs = {k: v.contiguous() for k, v in inputs.items()}
        inputs["inv_qm"] = self._qm_rows(query_masks, Qb)
        return inputs

    def _invert(self, re_dict, query_masks):
        """The exemplars' DDIM inversion under their own conditions (no
        mixing): (S, Q, T, D), clean to noisy, and the conditioned model_fn
        it ran (the inversion self-check)."""
        Q = np.shape(re_dict["inv_latents"])[0]
        inputs = self._inv_inputs(re_dict, query_masks, Q)
        model_fn = self._inv_model_fn(
            *(inputs[k] for k in ("inv_mask", "inv_word", "inv_audio",
                                  "inv_speaker_ids", "inv_qm")))
        stack = ddim_reverse_sample_loop(model_fn, self.sched,
                                         inputs["inv_latents"],
                                         **self._common)
        return stack, model_fn

    def _results(self, out: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decode and the return contract: the same keys for every
        option combination."""
        if self._codec_stack is not None:
            decoded = fused_decode(self.model.codec, self._codec_stack, out)
        else:
            decoded = self.model.decode_latents(out)
        results = {f"pred_{k}": v for k, v in decoded.items()}
        results["prev_latentout"] = out
        results["output_latents"] = out
        return results

    def _run(self, name: str, fn, inputs: Dict[str, torch.Tensor],
             static: tuple = ()):
        """``fn(**inputs)``: a graph replay when graphs are on."""
        if self.graphs is None:
            return fn(**inputs)
        return self.graphs.run(name, fn, inputs, static)

    # -------------------------------------------------------- the pipelines

    def _sample_pipeline(self, noise, **core):
        """Plain DDIM generation: the condition encoders, the 50-step loop,
        the decode."""
        model_fn = self._pipeline_prologue(**core)
        return self._results(ddim_sample_loop(model_fn, self.sched, noise,
                                              **self._common))

    def _sample_inseq_pipeline(self, noise, in_seq, in_seq_noise, **core):
        """``_sample_pipeline`` with the in-seq overwrite (outpainting, the
        long-form handoff)."""
        model_fn = self._pipeline_prologue(**core)
        return self._results(ddim_sample_loop(
            model_fn, self.sched, noise, in_seq=in_seq,
            in_seq_noise=in_seq_noise, **self._common))

    def _guided_tail(self, model_fn, noise, inv_stack, gather, smask,
                     in_seq_noise, inversion_start_time: int):
        start, inv_all = _splice_apply(noise, inv_stack, gather, smask,
                                       inversion_start_time, True)
        return self._results(ddim_guided_sample_loop(
            model_fn, self.sched, start, inverted_latents=inv_all,
            guidance_iters=None, init_in_seq=torch.zeros_like(start),
            in_seq_noise=in_seq_noise, **self._common))

    def _guided_pipeline(self, noise, gather, smask, in_seq_noise,
                         inv_latents, inv_mask, inv_word, inv_audio,
                         inv_speaker_ids, inv_qm, *,
                         inversion_start_time: int, **core):
        """The exemplars' inversion, the window splice, insertion-guided
        DDIM and the decode (retrieval-guided sampling without outpainting
        or the handoff)."""
        model_fn = self._pipeline_prologue(**core)
        inv_stack = self._invert_section(inv_latents, inv_mask, inv_word,
                                         inv_audio, inv_speaker_ids, inv_qm)
        return self._guided_tail(model_fn, noise, inv_stack, gather, smask,
                                 in_seq_noise, inversion_start_time)

    def _guided_pipeline_cached(self, noise, gather, smask, in_seq_noise,
                                inv_stack, *, inversion_start_time: int,
                                **core):
        """``_guided_pipeline`` with the inversion trajectories ``inv_stack``
        (S, Qb, T, D) given, from the inversion cache."""
        model_fn = self._pipeline_prologue(**core)
        return self._guided_tail(model_fn, noise, inv_stack, gather, smask,
                                 in_seq_noise, inversion_start_time)

    def _invert_sample_pipeline(self, noise, gather, smask, inv_latents,
                                inv_mask, inv_word, inv_audio,
                                inv_speaker_ids, inv_qm, prev_latent=None,
                                in_seq_noise=None, *,
                                inversion_start_time: int, **core):
        """Inversion without guidance: the exemplars' inversion, the
        window splice into the start noise, plain DDIM (with the long-form
        handoff's in-seq overwrite when ``prev_latent`` is given) and the
        decode."""
        model_fn = self._pipeline_prologue(**core)
        inv_stack = self._invert_section(inv_latents, inv_mask, inv_word,
                                         inv_audio, inv_speaker_ids, inv_qm)
        start, _ = _splice_apply(noise, inv_stack, gather, smask,
                                 inversion_start_time, False)
        in_seq = (None if prev_latent is None else
                  masked_prev_latent(self.model.cfg.denoiser, prev_latent))
        return self._results(ddim_sample_loop(
            model_fn, self.sched, start, in_seq=in_seq,
            in_seq_noise=in_seq_noise, **self._common))

    def _guided_inseq_pipeline(self, noise, gather, smask, in_seq_noise,
                               prev_latent, inv_latents, inv_mask, inv_word,
                               inv_audio, inv_speaker_ids, inv_qm, *,
                               inversion_start_time: int, **core):
        """Retrieval-guided sampling with the long-form handoff: the
        exemplars' inversion, the window splice, each part's first token of
        the guidance targets zeroed, insertion-guided DDIM whose first
        overwrite is the previous chunk's handed-on tokens, the decode."""
        dc = self.model.cfg.denoiser
        model_fn = self._pipeline_prologue(**core)
        inv_stack = self._invert_section(inv_latents, inv_mask, inv_word,
                                         inv_audio, inv_speaker_ids, inv_qm)
        start, inv_all = _splice_apply(noise, inv_stack, gather, smask,
                                       inversion_start_time, True)
        return self._results(ddim_guided_sample_loop(
            model_fn, self.sched, start,
            inverted_latents=zero_first_tokens(dc, inv_all),
            guidance_iters=None,
            init_in_seq=masked_prev_latent(dc, prev_latent),
            in_seq_noise=in_seq_noise, **self._common))

    # ------------------------------------------------- the inversion cache

    def _cached_inv_stack(self, re_dict, names, q_bucket: int, query_masks
                          ) -> torch.Tensor:
        """(S, q_bucket, T, D) inversion trajectories of the exemplars
        ``names`` (rows of ``re_dict``), zero rows after them, from the
        per-exemplar cache.  The misses are inverted in one call, their
        count bucketed to a power of two (the first miss repeated); the
        cache is LRU (hits are touched before anything is evicted, and a
        name this call needs is never evicted, so Q above the capacity
        overflows it for a while); the assembled stack is memoized by
        (names, q_bucket)."""
        skey = (tuple(names), q_bucket)
        hit = self._inv_stack_cache.get(skey)
        if hit is not None:
            self.inv_cache_hits += len(names)
            return hit
        cache = self._inv_cache
        for n in names:
            if n in cache:
                cache[n] = cache.pop(n)
        missing = [i for i, n in enumerate(names) if n not in cache]
        self.inv_cache_misses += len(missing)
        self.inv_cache_hits += len(names) - len(missing)
        if missing:
            Qb = _bucket(len(missing))
            inputs = self._inv_inputs(
                re_dict, query_masks, Qb,
                index=missing + [missing[0]] * (Qb - len(missing)))
            stack = self._run("invert", self._invert_section, inputs)
            for j, i in enumerate(missing):
                cache[names[i]] = stack[:, j].contiguous()
            need = set(names)
            for victim in list(cache):
                if len(cache) <= self.inv_cache_capacity:
                    break
                if victim not in need:
                    cache.pop(victim)
        rows = [cache[n] for n in names]
        rows += [torch.zeros_like(rows[0])] * (q_bucket - len(rows))
        assembled = torch.stack(rows, dim=1)
        self._inv_stack_cache[skey] = assembled
        while len(self._inv_stack_cache) > self.inv_cache_capacity:
            self._inv_stack_cache.pop(next(iter(self._inv_stack_cache)))
        return assembled

    def inv_cache_fingerprint(self) -> str:
        """What a persisted trajectory depends on, hashed: the parameters
        (``tree_fingerprint`` of the state dict), the test schedule's
        timestep map, the sampler's mean and variance types and CFG scale,
        and the denoiser path (``fused``, ``layer_kernel``, ``merged_ca``,
        ``bf16_conditions``), whose results differ by rounding."""
        ident = {
            "params": tree_fingerprint(self.model.state_dict()),
            "timestep_map": [int(t) for t in self.sched.timestep_map],
            "mean_type": str(self._common["mean_type"]),
            "var_type": str(self._common["var_type"]),
            "cfg_scale": float(self._common["cfg_scale"]),
            "path": [bool(self.fused), bool(self.layer_kernel),
                     bool(self.merged_ca), self.bf16_conditions],
        }
        return hashlib.sha1(
            json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]

    def save_inv_cache(self, path: str) -> int:
        """Write the per-exemplar inversion cache to ``path``: one ``.npz``
        of the (N, S, T, D) trajectories, oldest first, and a manifest of
        the names and the fingerprint, written to a temporary file and then
        moved into place.  Returns the entries written (0: the cache is
        empty and no file is touched)."""
        names = list(self._inv_cache)
        if not names:
            return 0
        stack = np.stack([self._inv_cache[n].float().cpu().numpy()
                          for n in names])
        meta = json.dumps({"fingerprint": self.inv_cache_fingerprint(),
                           "names": names})
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, stack=stack,
                     meta=np.frombuffer(meta.encode(), np.uint8))
        os.replace(tmp, path)
        return len(names)

    def load_inv_cache(self, path: str) -> int:
        """Load what :meth:`save_inv_cache` wrote into the cache, in its
        LRU order, the newest ``inv_cache_capacity`` entries.  A missing
        file or another fingerprint (other weights, schedule or path)
        loads nothing.  Returns the entries loaded."""
        if not os.path.exists(path):
            return 0
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            if meta.get("fingerprint") != self.inv_cache_fingerprint():
                return 0
            stack = np.asarray(z["stack"])
        names = meta["names"]
        keep = names[max(0, len(names) - self.inv_cache_capacity):]
        off = len(names) - len(keep)
        for j, n in enumerate(keep):
            self._inv_cache[n] = torch.from_numpy(stack[off + j]).to(
                self.device)
        return len(keep)

    def _splice_maps_memo(self, splice, B: int):
        """``splice_maps`` on the device, memoized by the splice rows."""
        rows = np.asarray(splice.cpu() if isinstance(splice, torch.Tensor)
                          else splice)
        key = (rows.tobytes(), rows.shape, B)
        hit = self._splice_memo.get(key)
        if hit is None:
            hit = splice_maps(self.model.cfg.denoiser, rows, B,
                              self.model.cfg.denoiser.num_tokens,
                              device=self.device)
            self._splice_memo[key] = hit
            while len(self._splice_memo) > 256:
                self._splice_memo.pop(next(iter(self._splice_memo)))
        return hit

    # ------------------------------------------------------ the entry points

    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               coef_table: Optional[torch.Tensor] = None,
               query_masks: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """One plain generation run, ``self(batch, generator)`` with the
        default options.  ``batch``: word (B, Nt, 768), audio (B, Na, 768),
        speaker_ids (B,), motion_mask (B, 150).  Returns pred_{upper,
        lower, facepose, hands, transl, exps, contact} and the final
        latents (``output_latents``, ``prev_latentout``)."""
        return self._run("sample", self._sample_pipeline,
                         self._core(batch, generator, noise, coef_table,
                                    query_masks))

    @torch.no_grad()
    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 opts: InferenceOptions = InferenceOptions(), re_dict=None,
                 guidance_iters=None, prev_latent=None, *,
                 noise: Optional[torch.Tensor] = None,
                 coef_table: Optional[torch.Tensor] = None,
                 in_seq_noise: Optional[torch.Tensor] = None,
                 query_masks: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """Generation with the inference options.  ``re_dict`` is the
        retrieval product: ``raw_motion_latents`` (B, T, D) or (B, K, T, D)
        for outpainting; ``inv_latents`` (Q, T, D), ``inv_conds`` {word,
        audio, speaker_ids} of the Q exemplars, ``inv_mask`` (Q, T) and
        ``splice`` (Q, 4) for inversion, with ``inv_names`` (Q names) and
        ``num_queries`` for the inversion cache.  ``guidance_iters`` (S,)
        defaults to the "constant" schedule and is read only by the
        literal guidance of ``ddim_guided_sample_loop(exact_iters=True)``,
        which no route takes; ``prev_latent`` (B, T, D) is the previous
        chunk's ``prev_latentout``.  The routes and the draws are the JAX
        class's: retrieval-guided sampling without outpainting or the
        handoff is one pipeline, its exemplars bucketed to a power of two
        and taken from the inversion cache when they are named; plain,
        outpaint and handoff sampling without inversion another; inversion
        without guidance, and guidance with the handoff, the JAX class's
        staged path, one each, their exemplars neither bucketed nor
        cached.  The ground-truth motion is never encoded, since nothing
        reads it.  The results are the pipeline's own tensors (clones of a
        graph's outputs), so a held ``prev_latentout`` survives the next
        call."""
        opts.validate()
        if opts.eta:
            raise NotImplementedError(
                "StagedGenerator compiles eta=0 DDIM only; use generate() "
                "for eta > 0")
        dc = self.model.cfg.denoiser
        prev = opts.use_prev_latent and prev_latent is not None
        core = self._core(batch, generator, noise, coef_table, query_masks)
        B = core["noise"].shape[0]
        if (opts.use_inversion and opts.insertion_guidance
                and not opts.outpaint and not prev):
            gather, smask = self._splice_maps_memo(re_dict["splice"], B)
            Q = np.shape(re_dict["inv_latents"])[0]
            Qb = _bucket(Q)
            ist = int(opts.inversion_start_time)
            core.update(gather=gather, smask=smask, in_seq_noise=(
                self._in_seq_noise(in_seq_noise, generator, B)))
            names = re_dict.get("inv_names")
            if (self.inv_cache_capacity > 0 and names is not None
                    and len(names) == Q and re_dict.get("num_queries")):
                core["inv_stack"] = self._cached_inv_stack(
                    re_dict, list(names), Qb, query_masks)
                return self._run("guided_cached", functools.partial(
                    self._guided_pipeline_cached, inversion_start_time=ist),
                    core, (ist,))
            core.update(self._inv_inputs(re_dict, query_masks, Qb))
            return self._run("guided", functools.partial(
                self._guided_pipeline, inversion_start_time=ist), core,
                (ist,))
        if not opts.use_inversion:
            # plain, outpaint and handoff sampling
            if prev:
                core.update(
                    in_seq=masked_prev_latent(dc, self._tensor(prev_latent)))
            elif opts.outpaint:
                rml = self._tensor(re_dict["raw_motion_latents"])
                core["in_seq"] = rml[:, 0] if rml.dim() == 4 else rml
            else:
                return self._run("sample", self._sample_pipeline, core)
            core["in_seq"] = core["in_seq"].float().contiguous()
            core["in_seq_noise"] = self._in_seq_noise(in_seq_noise,
                                                      generator, B)
            return self._run("sample_inseq", self._sample_inseq_pipeline,
                             core)

        # the JAX class's staged path: inversion without guidance (with or
        # without the handoff), and guidance with the handoff.  Its
        # exemplars are not bucketed and not cached, as there; a graph is
        # captured for each distinct exemplar count.
        gather, smask = self._splice_maps_memo(re_dict["splice"], B)
        Q = np.shape(re_dict["inv_latents"])[0]
        ist = int(opts.inversion_start_time)
        core.update(gather=gather, smask=smask)
        core.update(self._inv_inputs(re_dict, query_masks, Q))
        if prev:
            core["prev_latent"] = self._tensor(prev_latent).float().contiguous()
        if opts.insertion_guidance or prev:
            core["in_seq_noise"] = self._in_seq_noise(in_seq_noise,
                                                      generator, B)
        if opts.insertion_guidance:
            name, fn = "guided_inseq", self._guided_inseq_pipeline
        else:
            name, fn = "invert_sample", self._invert_sample_pipeline
        return self._run(name, functools.partial(
            fn, inversion_start_time=ist), core, (ist,))

    @torch.no_grad()
    def inversion_self_check(self, re_dict, query_masks=None
                             ) -> Dict[str, object]:
        """The DDIM inversion's round trip: ``error_curve`` (S, Q), the MSE
        of each inversion step's latent against the clean exemplar (it
        grows with the noise level); ``recon_error`` (Q,), the MSE after
        conditioned DDIM back down from the last inverted latent (small:
        the round trip is the identity up to discretisation); and
        ``recon_decoded``, the decoded reconstruction."""
        inv_lat = self._tensor(re_dict["inv_latents"]).float()
        stack, model_fn = self._invert(re_dict, query_masks)
        error_curve = ((stack - inv_lat[None]) ** 2).mean(dim=(2, 3))
        recon = ddim_sample_loop(model_fn, self.sched, stack[-1],
                                 **self._common)
        recon_error = ((recon - inv_lat) ** 2).mean(dim=(1, 2))
        return {"error_curve": error_curve, "recon_error": recon_error,
                "recon_decoded": {f"pred_{k}": v for k, v in
                                  self.model.decode_latents(recon).items()}}


def _bucket(q: int) -> int:
    """The next power of two at or above ``q``."""
    return 1 << max(q - 1, 0).bit_length()
