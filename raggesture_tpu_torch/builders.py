"""Config → the port's objects (mogen's builders).

Port of ``raggesture_tpu/builders.py``: the reference builds its
architecture and datasets from nested config dicts
(mogen/models/builder.py:19-36, mogen/datasets/builder.py:31-52); the same
nested dicts are mapped onto the port's frozen dataclass configs
(``ArchitectureConfig`` and friends) with the JAX package's defaults, so
``configs/raggesture_beatx/basegesture_len150_beat.py`` builds the shipped
model; ``optim_config_from`` maps the optimizer blocks onto the training
step's ``OptimConfig``.  The JAX package's type registry has no caller in
the port and is not ported (ROADMAP §C).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import torch

from .datasets.beatx import BeatXConfig
from .models.architecture import (
    ArchitectureConfig,
    DiffusionSpec,
    MotionDiffusionModel,
    create_model,
)
from .models.codec import CodecConfig
from .models.conditioning import ScaleFuncConfig
from .models.denoiser import DenoiserConfig
from .retrieval.database import RetrievalConfig
from .train.loop import OptimConfig


def _get(cfg: Optional[Mapping], key: str, default=None):
    if cfg is None:
        return default
    return cfg.get(key, default)


def diffusion_spec_from(cfg: Mapping[str, Any]) -> DiffusionSpec:
    """diffusion_train/diffusion_test blocks (basegesture_len150_beat.py:140-158)."""
    return DiffusionSpec(
        beta_scheduler=_get(cfg, "beta_scheduler", "scaled_linear"),
        diffusion_steps=_get(cfg, "diffusion_steps", 1000),
        model_mean_type=_get(cfg, "model_mean_type", "start_x"),
        model_var_type=_get(cfg, "model_var_type", "fixed_large"),
        respace=_get(cfg, "respace"),
        num_inference_timesteps=_get(cfg, "num_inference_timesteps"),
        classifier_free_guidance_scale=_get(
            cfg, "classifier_free_guidance_scale", 0.0),
    )


def denoiser_config_from(mcfg: Mapping[str, Any]) -> DenoiserConfig:
    """The inner model dict (type ReGestureTransformer,
    basegesture_len150_beat.py:46-137)."""
    sa = _get(mcfg, "sa_block_cfg", {}) or {}
    ca = _get(mcfg, "ca_block_cfg", {}) or {}
    ffn = _get(mcfg, "ffn_cfg", {}) or {}
    text = _get(mcfg, "text_encoder", {}) or {}
    audio = _get(mcfg, "audio_encoder", {}) or {}
    spk = _get(mcfg, "speaker_embedding", {}) or {}
    return DenoiserConfig(
        latent_dim=_get(mcfg, "latent_dim", 512),
        time_embed_dim=_get(mcfg, "time_embed_dim", 2048),
        num_layers=_get(mcfg, "num_layers", 8),
        num_heads=_get(sa, "num_heads", 16),
        ca_num_heads=_get(ca, "num_heads", 0),
        ca_dropout=float(_get(ca, "dropout", -1.0)
                         if _get(ca, "dropout") is not None else -1.0),
        ff_size=_get(ffn, "ffn_dim", 1024),
        dropout=float(_get(sa, "dropout", 0.0) or 0.0),
        text_latent_dim=_get(text, "latent_dim", 768),
        audio_latent_dim=_get(audio, "latent_dim", 768),
        num_speakers=_get(spk, "num_speakers", 25),
        max_seq_len=_get(mcfg, "max_seq_len", 150),
        frame_chunk_size=_get(mcfg, "frame_chunk_size", 15),
        text_num_layers=_get(text, "num_layers", 0),
        audio_num_layers=_get(audio, "num_layers", 0),
        cond_enc_ff=_get(text, "ff_size", 2048),
    )


def codec_config_from(mcfg: Mapping[str, Any]) -> CodecConfig:
    vae = _get(mcfg, "vae_cfg", {}) or {}
    return CodecConfig(
        latent_dim=_get(vae, "latent_dim", _get(mcfg, "latent_dim", 512)),
        frame_chunk_size=_get(vae, "frame_chunk_size",
                              _get(mcfg, "frame_chunk_size", 15)),
        num_frames=_get(mcfg, "max_seq_len", 150),
        num_layers=_get(vae, "num_layers", 8),
        num_heads=_get(vae, "num_heads", 4),
        lowertrans_num_heads=_get(vae, "lowertrans_num_heads", 8),
        ff_size=_get(vae, "ff_size", 1024),
        dropout=_get(vae, "dropout", 0.1),
        activation=_get(vae, "transformer_activation",
                        _get(vae, "activation", "gelu")),
        normalize_before=_get(vae, "transformer_normalize_before",
                              _get(vae, "normalize_before", False)),
        position_embedding=_get(vae, "position_embedding", "learned"),
    )


def scale_func_config_from(mcfg: Mapping[str, Any]) -> Optional[ScaleFuncConfig]:
    sf = _get(mcfg, "scale_func_cfg")
    if sf is None:
        return None
    return ScaleFuncConfig(
        coarse_scale=_get(sf, "coarse_scale", 6.5),
        both_coef=_get(sf, "both_coef", 0.52351),
        text_coef=_get(sf, "text_coef", -0.28419),
        retr_coef=_get(sf, "retr_coef", 2.39872),
    )


def retrieval_config_from(mcfg: Mapping[str, Any]) -> Optional[RetrievalConfig]:
    r = _get(mcfg, "retrieval_cfg")
    if r is None:
        return None
    return RetrievalConfig(
        num_retrieval=_get(r, "num_retrieval", 1),
        topk=_get(r, "topk", 2),
        max_seq_len=_get(r, "max_seq_len", 150),
        motion_fps=_get(r, "motion_fps", 15),
        frame_chunk_size=_get(r, "motion_framechunksize",
                              _get(r, "frame_chunk_size", 15)),
        latent_dim=_get(r, "latent_dim", 512),
        text_latent_dim=_get(r, "text_latent_dim", 768),
        stratified=_get(r, "stratified_db_creation", True),
        stratification_interval=_get(r, "stratification_interval", 15),
    )


def arch_config_from(model_cfg: Mapping[str, Any]) -> ArchitectureConfig:
    """The top-level ``model`` dict (type MotionDiffusion)."""
    mcfg = _get(model_cfg, "model", {}) or {}
    return ArchitectureConfig(
        denoiser=denoiser_config_from(mcfg),
        codec=codec_config_from(mcfg),
        diffusion_train=diffusion_spec_from(_get(model_cfg, "diffusion_train", {})),
        diffusion_test=diffusion_spec_from(_get(model_cfg, "diffusion_test", {})),
        scale_func=scale_func_config_from(mcfg),
        body_part_lossweights=dict(_get(
            model_cfg, "body_part_lossweights",
            dict(upper=1.0, hands=1.0, face=1.0, lowertransl=1.0))),
        inference_type=_get(model_cfg, "inference_type", "ddim"),
    )


def build_architecture(model_cfg: Mapping[str, Any],
                       device: Optional[Union[str, torch.device]] = None,
                       seed: int = 0) -> MotionDiffusionModel:
    """The model of a config's ``model`` dict, with random weights from
    ``seed`` (``create_model``), in eval mode, on the CUDA card unless
    ``device`` names another."""
    arch_type = _get(model_cfg, "type", "MotionDiffusion")
    if arch_type != "MotionDiffusion":
        raise KeyError(f"unknown architecture type {arch_type!r}")
    return create_model(arch_config_from(model_cfg), device=device, seed=seed)


def beatx_config_from(dcfg: Mapping[str, Any]) -> BeatXConfig:
    """A data.train/val/test dict (configs/_base_/datasets/
    beatx_len150_15fps.py:21-60)."""
    return BeatXConfig(
        data_root=_get(dcfg, "data_path", "datasets/beat_english_v2.0.0"),
        cache_dir=_get(dcfg, "cache_path", "datasets/cache"),
        split=_get(dcfg, "split", "train"),
        pose_rep=_get(dcfg, "pose_rep", "smplxflame_30"),
        pose_fps=_get(dcfg, "pose_fps", _get(dcfg, "fps", 15)),
        pose_length=_get(dcfg, "pose_length", 150),
        stride=_get(dcfg, "stride", 5),
        audio_sr=_get(dcfg, "audio_sr", _get(dcfg, "sample_rate", 16000)),
        test_cache_mode=_get(dcfg, "test_cache_mode", "windowed"),
        audio_rep=_get(dcfg, "audio_rep", "wav2vec"),
        num_mels=_get(dcfg, "num_mels", 80),
        hop_length=_get(dcfg, "hop_length", 512),
        training_speakers=tuple(_get(dcfg, "training_speakers",
                                     tuple(range(1, 31)))),
        clean_first_seconds=_get(dcfg, "clean_first_seconds", 0),
        clean_final_seconds=_get(dcfg, "clean_final_seconds", 0),
        debug=_get(dcfg, "debug", False),
        tiny=_get(dcfg, "tiny", False),
        new_cache=_get(dcfg, "new_cache", False),
        smplx_asset=_get(dcfg, "smplx_asset", None),
        allow_fake_contacts=_get(dcfg, "allow_fake_contacts", False),
    )


def optim_config_from(cfg: Mapping[str, Any], total_steps: int) -> OptimConfig:
    """The config's ``optimizer``, ``optimizer_config`` and ``lr_config``
    blocks as the step's OptimConfig, as the JAX package reads them: Adam
    or AdamW (``weight_decay`` for AdamW only), the clip, the cosine
    floor; bf16 mixed precision from ``optimizer.bf16=True`` or a
    top-level ``fp16=dict(...)``."""
    opt = cfg.get("optimizer", {}) or {}
    opt_cfg = cfg.get("optimizer_config", {}) or {}
    lr_cfg = cfg.get("lr_config", {}) or {}
    opt_type = _get(opt, "type", "Adam")
    if opt_type.lower() not in ("adam", "adamw"):
        raise KeyError(f"unsupported optimizer type {opt_type!r}")
    return OptimConfig(
        lr=_get(opt, "lr", 1e-4),
        min_lr_ratio=_get(lr_cfg, "min_lr_ratio", 1e-6),
        total_steps=total_steps,
        grad_clip=_get(opt_cfg, "grad_clip"),
        weight_decay=_get(opt, "weight_decay", 0.0)
        if opt_type.lower() == "adamw" else 0.0,
        bf16_compute=bool(cfg.get("fp16") is not None
                          or _get(opt, "bf16", False)),
        bf16_conditions=_get(opt, "bf16_conditions"),
        fused_codec=bool(_get(opt, "fused_codec", False)),
        fused_ctx=bool(_get(opt, "fused_ctx", True)),
    )
