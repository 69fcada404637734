"""MotionDiffusion: codec + denoiser, the training loss and plain DDIM
generation.  Port of ``raggesture_tpu/models/architecture.py``
(``DiffusionSpec``, ``ArchitectureConfig``, ``MotionDiffusionModel``,
``lossweight_mask``, ``training_loss`` and the plain path of
``StagedGenerator``: ``pipeline_prologue`` -> ``ddim_sample_loop`` ->
``pipeline_results``).

The training loss takes its random draws as arguments (the timesteps, the
noise, the encode's per-part eps and the condition-dropout mask), so that
a test can feed in the JAX package's; a ``torch.Generator`` draws what is
not given.

Generation runs the batch twice per step, conditioned and unconditioned,
mixes the two with the scale-function coefficients, and decodes the final
latents part by part.  Every denoiser call goes through
``fused_denoiser.fused_denoise_ctx`` (on the card kernel K1 per layer, or
with ``layer_kernel=False``/``merged_ca=True`` the split blocks' kernels
K5 and K4 or K7); every codec attention through kernel K2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..diffusion import gaussian as G
from ..diffusion.gaussian import MeanType, VarType
from ..diffusion.sampling import ddim_sample_loop
from ..diffusion.schedules import DiffusionSchedule, make_schedule
from ..ops.cond_ctx import cond_contexts
from .codec import PART_NAMES, CodecConfig, GestureCodec, part_features
from .conditioning import (
    ScaleFuncConfig,
    joint_scale_vector,
    mix_outputs,
    scale_func_table,
)
from .denoiser import (
    DenoiserConfig,
    GestureDenoiser,
    default_query_masks,
    latent_motion_mask,
)
from .fused_denoiser import (
    adaln_table,
    fused_denoise_ctx,
    layer_kernel_mask_rows,
    pack_layers,
    pack_split_layers,
    precompute_cross_contexts,
    split_mask_rows,
    stack_layer_contexts,
    train_denoise_ctx,
)
from .layers import LearnedPositionEmbedding
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
            limit = math.sqrt(6.0 / (d + L * d))
            mod.pe.uniform_(-limit, limit, generator=g)
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


def _draw(given, generator, what: str, fn):
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"training_loss needs a generator or {what}")
    return fn()


def training_loss(model: MotionDiffusionModel, sched_train: DiffusionSchedule,
                  batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  enc_eps=None, cond_mask: Optional[torch.Tensor] = None,
                  t_weights: Optional[torch.Tensor] = None,
                  return_per_sample: bool = False,
                  query_masks: Optional[Dict[str, torch.Tensor]] = None,
                  ctx_fn: Callable = cond_contexts
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked, part-weighted MSE of the denoiser's x0 prediction.

    The frozen codec encodes the batch's motion (no gradient), with
    ``enc_eps`` {part: (B, 10, D)} as the rsample draws; a batch with
    ``latent_mu``/``latent_logvar`` (the latent cache) is drawn from
    instead, ``enc_eps`` then (B, 43, D).  ``t`` (B,) timesteps, ``noise``
    (B, 43, D) and ``cond_mask`` (B, 1, 1) condition dropout (about 10 %
    zeros) complete the draws; whatever is not given comes from
    ``generator`` in that order.  The denoiser runs through
    ``train_denoise_ctx`` (the JAX package's default ``fused_ctx`` path:
    kernel K3 on the card, ``ctx_fn``).  ``query_masks`` default to the
    reference's quirk masks.  Returns (loss, logs)."""
    cfg = model.cfg
    dc = cfg.denoiser
    dev = next(model.parameters()).device
    g = generator
    if dc.dropout > 0:
        raise ValueError(f"the fused_ctx training path takes no dropout, "
                         f"the denoiser has dropout {dc.dropout}")
    if "latent_mu" in batch:
        mu = batch["latent_mu"].float()
        eps = _draw(enc_eps, g, "enc_eps",
                    lambda: torch.randn(mu.shape, generator=g, device=dev))
        z0 = mu + torch.exp(0.5 * batch["latent_logvar"].float()) * eps
        token_mask = latent_motion_mask(dc, batch["motion_mask"])
    else:
        n_chunks = batch["motion_upper"].shape[1] // cfg.codec.frame_chunk_size
        shape = (batch["motion_upper"].shape[0], n_chunks,
                 cfg.codec.latent_dim)
        eps = _draw(enc_eps, g, "enc_eps", lambda: {
            p: torch.randn(shape, generator=g, device=dev)
            for p in PART_NAMES})
        z0, token_mask = model.encode_motion(batch, eps)
    B = z0.shape[0]
    t = _draw(t, g, "t", lambda: torch.randint(
        0, sched_train.num_timesteps, (B,), generator=g, device=dev))
    noise = _draw(noise, g, "noise",
                  lambda: torch.randn(z0.shape, generator=g, device=dev))
    cond_mask = _draw(cond_mask, g, "cond_mask", lambda: (
        torch.randint(0, 100, (B, 1, 1), generator=g, device=dev) % 10 > 0
    ).float())
    x_t = G.q_sample(sched_train, z0, t, noise)
    conds = model.encode_conditions(batch)
    if query_masks is None:
        query_masks = default_query_masks(dc, B, device=dev)
    pred = train_denoise_ctx(model.denoiser, x_t, t, token_mask, conds,
                             query_masks, cond_mask, ctx_fn)
    target = G.training_target(sched_train, cfg.diffusion_train.mean_type,
                               z0, x_t, noise, t)
    sq = ((pred - target) ** 2).mean(dim=-1)              # (B, T)
    masked = sq * token_mask * lossweight_mask(cfg, token_mask)
    per_sample = masked.sum(dim=1) / token_mask.sum(dim=1).clamp_min(1.0)
    if t_weights is not None:
        loss = (per_sample * t_weights).mean()
    else:
        loss = masked.sum() / token_mask.sum().clamp_min(1.0)
    logs = {"recon_loss": loss,
            "mse_unweighted": (sq * token_mask).sum()
            / token_mask.sum().clamp_min(1.0)}
    if return_per_sample:
        logs["per_sample_loss"] = per_sample
        logs["t"] = t
    return loss, logs


class StagedGenerator:
    """Plain deterministic DDIM generation (the JAX ``StagedGenerator``'s
    ``sample``).  The adaLN table of every step is built once here, and the
    weight packs of the layer kernel when it runs; cross-attention contexts
    and mask rows once per call, outside the step loop.  Packs are bf16 on
    the card (what the kernel takes) and float32 on the CPU (where the plain
    version then matches the JAX package in float32).

    ``layer_kernel=False`` runs each layer as the split blocks' float32
    kernels (self attention, then three cached-context cross attentions and
    ca_mix, then the eager FFN) on weight packs of the modules' own tensors;
    ``merged_ca=True`` runs the three cross attentions and ca_mix as one
    kernel instead, and wins over the layer kernel, as in the JAX package."""

    def __init__(self, model: MotionDiffusionModel, sched: DiffusionSchedule,
                 layer_kernel: bool = True, merged_ca: bool = False):
        self.model = model
        self.device = next(model.parameters()).device
        self.sched = sched.to(self.device)
        self.merged_ca = merged_ca
        self.layer_kernel = layer_kernel and not merged_ca
        self.pack_dtype = (torch.bfloat16 if self.device.type == "cuda"
                           and self.layer_kernel else torch.float32)
        den = model.denoiser
        self.adaln_scale, self.adaln_shift = adaln_table(
            den, self.sched.timestep_map)
        # the layer kernel's bf16 packs, or the split path's packs of the
        # modules' own float32 tensors
        self.packs = (pack_layers(den, self.pack_dtype) if self.layer_kernel
                      else pack_split_layers(den))
        spec = model.cfg.diffusion_test
        self._common = dict(mean_type=spec.mean_type, var_type=spec.var_type,
                            cfg_scale=spec.classifier_free_guidance_scale)

    def _model_fn(self, conds, token_mask, query_masks, coef_table, js):
        """The sampler's model_fn; with a scale function the batch runs
        twice (conditioned, then with the conditions dropped) and mixes."""
        den = self.model.denoiser
        B = token_mask.shape[0]
        mixed = self.model.cfg.scale_func is not None
        ones = torch.ones(B, 1, 1, device=self.device)
        if mixed:
            conds = {k: torch.cat([v, v]) for k, v in conds.items()}
            token_mask = torch.cat([token_mask, token_mask])
            query_masks = {k: torch.cat([v, v]) for k, v in query_masks.items()}
            cond_mask = torch.cat([ones, torch.zeros_like(ones)])
        else:
            cond_mask = ones
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

    @torch.no_grad()
    def sample(self, batch, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               coef_table: Optional[torch.Tensor] = None,
               query_masks: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """One plain generation run.  ``batch``: word (B, Nt, 768), audio
        (B, Na, 768), speaker_ids (B,), motion_mask (B, 150).  The scale
        function's coin flips, then the start noise (B, 43, D), are drawn
        from ``generator`` unless given; query masks default to the
        reference's quirk masks.  Returns pred_{upper, lower, facepose,
        hands, transl, exps, contact} and the final latents."""
        cfg = self.model.cfg
        dc = cfg.denoiser
        b = {k: torch.as_tensor(batch[k], device=self.device)
             for k in ("word", "audio", "speaker_ids", "motion_mask")}
        conds = self.model.encode_conditions(b)
        token_mask = latent_motion_mask(dc, b["motion_mask"].float())
        B = token_mask.shape[0]
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
                raise ValueError("sample needs a generator or the start noise")
            noise = torch.randn(B, dc.num_tokens, dc.latent_dim,
                                generator=generator, device=self.device)
        if query_masks is None:
            query_masks = default_query_masks(dc, B, device=self.device)
        js = joint_scale_vector(dc, cfg.per_joint_scale, device=self.device)
        model_fn = self._model_fn(conds, token_mask, query_masks,
                                  coef_table.to(self.device), js)
        out = ddim_sample_loop(model_fn, self.sched, noise.to(self.device),
                               **self._common)
        results = {f"pred_{k}": v
                   for k, v in self.model.decode_latents(out).items()}
        results["prev_latentout"] = out
        results["output_latents"] = out
        return results
