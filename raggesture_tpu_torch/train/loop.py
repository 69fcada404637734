"""The denoiser's training step: Adam (or AdamW) with cosine decay over the
denoiser, an optional global-norm clip, the codec frozen.  Port of
``raggesture_tpu/train/loop.py`` (``OptimConfig``, ``param_labels``/
``make_optimizer``, ``create_train_state``, ``make_train_step``,
``make_multi_train_step``, ``make_val_step``, ``build_optimizers``).

Inside a process group (``parallel/mesh.py``) the step is one
data-parallel rank's: its loss is its part of the global
batch's (``training_loss(shard=...)``), one flat all-reduce sums the
denoiser's gradients after the backward (the psum XLA inserts into the
JAX step), and the clip, the update and the logs see the global values.

The JAX package freezes the codec as a parameter partition (its updates
set to zero); here the codec's parameters have ``requires_grad`` off and
the optimizer holds the denoiser's alone, so the codec stays bitwise
unchanged.  The step updates the model and the optimizer in place.

``bf16_compute`` (bf16 mixed precision) runs the forward and backward on
every parameter and the batch's float fields rounded to bf16, as the JAX
step does: the frozen encode and the condition encoders compute in bf16,
kernel K3 takes its bf16 entry points, and where jnp's promotion makes a
bf16 weight and a float32 activation a float32 product (the denoiser's
trunk, which starts from the float32 x_t) the port computes in float32
on the bf16-rounded weights (``bf16_loss``).  The model names the
modules that read the batch (``batch_fed_modules``); the rounding is one
cast on a flat buffer of the parameters.  The gradients reach the
float32 master parameters through the casts, and Adam's moments stay
float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..diffusion.schedules import DiffusionSchedule
from ..models.architecture import MotionDiffusionModel, training_loss


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """The JAX package's OptimConfig, for what the step reads: Adam at
    ``lr`` with cosine decay to ``lr * min_lr_ratio`` over
    ``total_steps``; ``grad_clip`` clips the denoiser's gradients to that
    global norm (the optax rule); ``weight_decay > 0`` takes AdamW
    (decoupled decay).  ``bf16_compute`` and ``fused_codec`` are what the
    runner hands :func:`make_train_step`, with ``fused_ctx`` (False: the
    denoiser's per-layer forward, the only one that takes dropout).
    ``bf16_conditions=True`` makes the runner ship the condition features
    as bf16 (``utils/wire.py``); None, the JAX package's auto (on only on a
    TPU), is off."""

    lr: float = 1e-4
    min_lr_ratio: float = 1e-6
    total_steps: int = 100_000
    grad_clip: Optional[float] = None
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    bf16_compute: bool = False
    bf16_conditions: Optional[bool] = None
    fused_codec: bool = False
    fused_ctx: bool = True


def cosine_lr(cfg: OptimConfig, step: int) -> float:
    """``optax.cosine_decay_schedule(lr, total_steps, alpha=min_lr_ratio)``
    at update ``step`` (the first update is step 0 and uses ``lr``)."""
    frac = min(step, cfg.total_steps) / cfg.total_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return cfg.lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)


@dataclasses.dataclass
class TrainState:
    model: MotionDiffusionModel
    optimizer: torch.optim.Optimizer
    optim_cfg: OptimConfig
    step: int = 0


def _adam(params, cfg: OptimConfig) -> torch.optim.Optimizer:
    """Adam, or AdamW when ``weight_decay > 0`` (eps 1e-8, as optax's)."""
    kw = dict(lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def create_train_state(model: MotionDiffusionModel,
                       optim_cfg: OptimConfig = OptimConfig()) -> TrainState:
    """Freeze the codec and build Adam, or AdamW when ``weight_decay > 0``
    (eps 1e-8, as optax's), over the denoiser's parameters."""
    model.codec.requires_grad_(False)
    return TrainState(model, _adam(model.denoiser.parameters(), optim_cfg),
                      optim_cfg)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all the tensors together (0-dim)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: where the global ``norm`` is
    at or above ``max_norm``, each gradient becomes (g / norm) * max_norm;
    below it they stay as they are (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  No host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class _Loss(nn.Module):
    """``training_loss`` as a module call, so that ``functional_call`` can
    run it on other parameters."""

    def __init__(self, model: MotionDiffusionModel):
        super().__init__()
        self.model = model

    def forward(self, sched_train, batch, generator, kw):
        return training_loss(self.model, sched_train, batch, generator, **kw)


def _bf16_rounded(params: List[torch.Tensor], dtype: torch.dtype
                  ) -> List[torch.Tensor]:
    """Each of ``params`` rounded to bf16 and held in ``dtype``, as views
    of one flat buffer: one concatenation and the casts for them all, not
    a cast per parameter.  Each view starts at a multiple of 64 elements:
    a product or a LayerNorm on a weight that is not 16-byte aligned takes
    a slower kernel.  The casts' backward rounds each gradient to bf16 and
    carries it to the float32 parameter."""
    if not params:
        return []
    pads = [-p.numel() % 64 for p in params]
    zeros = params[0].new_zeros(max(pads) or 1)
    pieces, sizes = [], []
    for p, pad in zip(params, pads):
        pieces += [p.reshape(-1), zeros[:pad]]
        sizes += [p.numel(), pad]
    flat = torch.cat(pieces).to(torch.bfloat16).to(dtype)
    return [v.view_as(p) for v, p in
            zip(flat.split(sizes)[::2], params)]


def bf16_loss(model: MotionDiffusionModel, sched_train: DiffusionSchedule,
              batch: Dict, generator: Optional[torch.Generator] = None,
              codec_cache: Optional[Dict] = None, **kw):
    """``training_loss`` under ``bf16_compute``, as the JAX step computes
    it: every float32 parameter rounded to bf16 and the batch's float
    fields cast to bf16.  The parameters of the model's
    ``batch_fed_modules`` (the codec, the condition encoders) run as bf16
    copies; every other one as the float32 value of its bf16 rounding,
    which is what jnp's promotion of a bf16 weight against a float32
    activation computes, with no mixed-dtype call.  ``codec_cache`` keeps
    the frozen parameters' bf16 copies between steps, made again when one
    of them changes in place (its version moves).  The loss is float32."""
    bf16, f32 = torch.bfloat16, torch.float32
    low = {id(p) for m in model.batch_fed_modules() for p in m.parameters()}
    params, groups = {}, {bf16: ([], []), f32: ([], [])}
    frozen = []
    for name, p in model.named_parameters():
        if p.dtype != f32:
            params["model." + name] = p
        elif id(p) in low and not p.requires_grad and codec_cache is not None:
            frozen.append((name, p))
        else:
            names, ps = groups[bf16 if id(p) in low else f32]
            names.append("model." + name)
            ps.append(p)
    for dtype, (names, ps) in groups.items():
        params.update(zip(names, _bf16_rounded(ps, dtype)))
    if frozen:
        versions = tuple(p._version for _, p in frozen)
        if codec_cache.get("versions") != versions:
            codec_cache["versions"] = versions
            with torch.no_grad():
                codec_cache["params"] = dict(zip(
                    ["model." + n for n, _ in frozen],
                    _bf16_rounded([p for _, p in frozen], bf16)))
        params.update(codec_cache["params"])
    batch = {k: v.to(bf16) if isinstance(v, torch.Tensor)
             and v.dtype == f32 else v for k, v in batch.items()}
    loss, logs = torch.func.functional_call(
        _Loss(model), params, (sched_train, batch, generator, kw))
    return loss.float(), logs


def _rows(batch: Dict) -> int:
    return next(v.shape[0] for v in batch.values()
                if isinstance(v, torch.Tensor))


def _reduced_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A rank's parts of the loss logs summed over the ranks (one
    all-reduce): the global batch's values, on every rank."""
    from ..parallel.mesh import all_reduce_sum

    keys = ("recon_loss", "mse_unweighted")
    total = all_reduce_sum(torch.stack([logs[k].float() for k in keys]))
    return dict(logs, **dict(zip(keys, total.unbind(0))))


def make_train_step(sched_train: DiffusionSchedule, *,
                    bf16_compute: bool = False,
                    with_timesteps: bool = False,
                    log_per_sample: bool = False,
                    fused_codec: bool = False,
                    fused_ctx: bool = True):
    """The JAX package's ``make_train_step``: the step
    ``train_step(state, batch, generator=None, **draws) -> logs``, the
    training loss (draws as in ``training_loss``, ``t`` and ``t_weights``
    from a schedule sampler among them), its gradient, the clip of the
    state's ``grad_clip``, one Adam or AdamW update at the step's cosine
    learning rate.  Logs: ``recon_loss``, ``mse_unweighted`` and
    ``grad_norm`` (the global norm of the denoiser's gradients before the
    clip), 0-dim tensors; ``with_timesteps`` adds the per-sample losses
    ``per_sample_loss`` and ``t`` (the sampler's ``update_with_losses``),
    ``log_per_sample`` the per-sample losses alone.  ``fused_ctx=False``
    runs the denoiser's per-layer forward with its dropout, drawn from
    ``generator``.  ``fused_codec`` is taken for the JAX signature and
    changes nothing: a batch without cached latents goes through the
    4-part encode either way.  On the H100
    the JAX package's stacked 3-part encode gave the same values bitwise
    and was slower, so it is not ported (ROADMAP §C).  ``bf16_compute``
    runs the loss through :func:`bf16_loss` (the draws given to the step
    are taken as they are; those from ``generator`` are made in the
    dtype of what they perturb: bf16 for the live encode).

    In a process group (``parallel/mesh.py``) ``batch`` is this rank's
    rows, each rank as many: the draws from ``generator`` are the global
    batch's (every rank's generator seeded alike), the loss is this rank's
    part of the global one, and one flat all-reduce sums the denoiser's
    gradients before the norm, the clip and the update, so that every
    rank takes the same update.  The logs are the global batch's: the
    losses all-reduced, ``per_sample_loss`` all-gathered in rank order
    under ``log_per_sample`` (with ``with_timesteps`` it stays this rank's
    rows, for the synced sampler's gather)."""
    from ..parallel.mesh import all_gather_rows, all_reduce_grads_, local_shard

    codec_cache: Dict = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   **draws) -> Dict[str, torch.Tensor]:
        model, opt, cfg = state.model, state.optimizer, state.optim_cfg
        opt.zero_grad(set_to_none=True)
        shard = local_shard(_rows(batch))
        kw = dict(draws, return_per_sample=with_timesteps or log_per_sample,
                  fused_ctx=fused_ctx, shard=shard)
        if bf16_compute:
            loss, logs = bf16_loss(model, sched_train, batch, generator,
                                   codec_cache, **kw)
        else:
            loss, logs = training_loss(model, sched_train, batch, generator,
                                       **kw)
        loss.backward()
        params = [p for p in model.denoiser.parameters()
                  if p.grad is not None]
        logs = {k: v.detach() for k, v in logs.items()}
        if shard is not None:
            all_reduce_grads_(params)
            logs = _reduced_logs(logs)
            if log_per_sample and not with_timesteps:
                logs["per_sample_loss"] = all_gather_rows(
                    logs["per_sample_loss"])
        grads = [p.grad for p in params]
        if log_per_sample and not with_timesteps:
            logs.pop("t")
        logs["grad_norm"] = global_norm(grads)
        if cfg.grad_clip is not None:
            clip_by_global_norm_(grads, logs["grad_norm"], cfg.grad_clip)
        lr = cosine_lr(cfg, state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return logs

    return train_step


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else tree


def make_multi_train_step(sched_train: DiffusionSchedule, **kw):
    """k train steps per call: ``multi_step(state, stacked_batch,
    generator=None, **stacked_draws) -> logs``, every tensor of the batch
    and of the draws with a leading k axis, the logs stacked (k, ...).
    Equal, bitwise, to k ``make_train_step(**kw)`` calls on the slices in
    order (the JAX package folds the step count into one key; here the
    draws are per step, given or from ``generator`` in the same order)."""
    step = make_train_step(sched_train, **kw)

    def multi_step(state: TrainState, stacked_batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   **stacked_draws) -> Dict[str, torch.Tensor]:
        k = next(v.shape[0] for v in stacked_batch.values()
                 if isinstance(v, torch.Tensor))
        logs = [step(state, _index(stacked_batch, i), generator,
                     **_index(stacked_draws, i)) for i in range(k)]
        return {n: torch.stack([l[n] for l in logs]) for n in logs[0]}

    return multi_step


def make_val_step(sched_train: DiffusionSchedule, fused_ctx: bool = True):
    """The training loss without gradients: ``val_step(state, batch,
    generator=None, **draws) -> logs``; the global batch's in a process
    group, as the step's.  ``fused_ctx=False`` takes the per-layer forward,
    its dropout drawn as in training, as the JAX package's validation
    does."""
    from ..parallel.mesh import local_shard

    @torch.no_grad()
    def val_step(state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, **draws):
        shard = local_shard(_rows(batch))
        logs = training_loss(state.model, sched_train, batch, generator,
                             fused_ctx=fused_ctx, shard=shard, **draws)[1]
        return logs if shard is None else _reduced_logs(logs)

    return val_step


class _Optimizers:
    """What :func:`build_optimizers` returns."""

    def __init__(self, model: nn.Module, cfg_map: Dict[str, OptimConfig]):
        children = dict(model.named_children())
        unknown = sorted(set(cfg_map) - set(children))
        if unknown:
            raise KeyError(f"no top-level submodule {unknown} in the model "
                           f"(it has {sorted(children)})")
        self.cfgs = dict(cfg_map)
        self.params = {k: list(children[k].parameters()) for k in cfg_map}
        self.optimizers = {k: _adam(self.params[k], cfg)
                           for k, cfg in cfg_map.items()}
        self.frozen = sorted(set(children) - set(cfg_map))
        self.count = 0

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> Dict[str, torch.Tensor]:
        """One update of every group; returns each group's gradient norm
        before its clip."""
        norms = {}
        for key, opt in self.optimizers.items():
            cfg = self.cfgs[key]
            grads = [p.grad for p in self.params[key] if p.grad is not None]
            if not grads:
                continue
            norms[key] = global_norm(grads)
            if cfg.grad_clip is not None:
                clip_by_global_norm_(grads, norms[key], cfg.grad_clip)
            for group in opt.param_groups:
                group["lr"] = cosine_lr(cfg, self.count)
            opt.step()
        self.count += 1
        return norms


def build_optimizers(cfg_map: Dict[str, OptimConfig],
                     model: nn.Module) -> _Optimizers:
    """Per-submodule optimizers, after the reference's dict-of-configs
    builder (mogen/core/optimizer/builder.py:8-52): ``cfg_map`` maps
    top-level submodule names of ``model`` ("denoiser", "codec") to their
    ``OptimConfig``, and each named submodule gets its own global-norm clip
    (over its own gradients), Adam or AdamW and cosine schedule, counted in
    its own updates as an optax schedule is.  The parameters of every
    other submodule are in no optimizer: their update is zero, as under
    ``optax.set_to_zero``.  The result's ``step()`` updates every group
    from the gradients on the parameters and returns each group's norm
    before its clip; ``zero_grad()`` clears them."""
    return _Optimizers(model, cfg_map)
