#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``raggesture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every CUDA kernel of the main path from ops/csrc/;
  3. K1      - fused_decoder_layer against its plain PyTorch version at the
               sampling shape (2 sequences of 43 -> 48 tokens, D 512, 16
               heads, F 1024, bf16 packs, true-separator query masks);
  4. K2      - fused_softmax_mha against its plain version at the codec
               decoder shapes (1, 160, 512) with 32 and 64 heads, and
               torch's scaled_dot_product_attention timed beside it;
  5. main    - StagedGenerator.sample at the shipped full width, batch 1,
               50 DDIM steps, VAE decode, random weights from a seed: the
               kernel launch counts of that run, output shapes and
               finiteness, one full-width denoiser call against the plain
               path, and clips/s;
  6. profile - device time by kernel over one more clip (torch.profiler),
               and its share of the clip time measured in phase 5;
then the nvidia-smi line, the kernels line and, last, the result line.  Any
failure raises, so the script exits non-zero without the result line; it
also exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

# Tolerances (max |kernel - plain| over valid rows):
#  K1: both versions round the same activations to bf16 before each product,
#      but sum in different orders, so an operand near a rounding boundary
#      can land one bf16 ulp (2^-8 relative) apart; a few such flips move an
#      O(1)-sized layer output by ~1e-3.
#  K2: float32 throughout, differing only in summation order.
#  DENOISER: eight K1 layers and the output head, one full-width call.
TOL_K1 = 2e-2
TOL_K2 = 1e-4
TOL_DENOISER = 5e-2

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
F32_FLOPS = 67e12              # float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # imported only now: outside a checkout of the repo this fails
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        StagedGenerator,
        create_model,
        init_weights,
    )
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DecoderLayer,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        cross_context,
        fused_denoise_ctx,
        layer_kernel_mask_rows,
        padded_tokens,
        precompute_cross_contexts,
        stack_layer_contexts,
    )
    from raggesture_tpu_torch.ops import build
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
        pack_decoder_layer,
    )
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ----
    t0 = time.perf_counter()
    seconds = build.build(["decoder_layer", "mha"])
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0})

    cfg = ArchitectureConfig()
    dc = cfg.denoiser
    D, T, H, F = dc.latent_dim, dc.num_tokens, dc.num_heads, dc.ff_size
    Hc = dc.ca_heads
    g = torch.Generator(device=dev).manual_seed(1)

    def parity_query_masks(batch):
        m = torch.ones(batch, T, device=dev)
        m[:, list(dc.sep_indices)] = 0.0
        return {k: m for k in COND_KEYS}

    # ---- 3. K1 vs plain at the sampling shape ----
    B = 2
    Tp = padded_tokens(T)
    R = B * Tp
    with torch.device(dev):
        layer = DecoderLayer(dc)
    init_weights(layer, g, zero_init_std=0.02)
    packed = pack_decoder_layer(layer, torch.bfloat16)
    token_mask = latent_motion_mask(dc, torch.ones(B, dc.max_seq_len,
                                                   device=dev))
    m_rows, qm_rows = layer_kernel_mask_rows(token_mask, parity_query_masks(B))
    x = torch.nn.functional.pad(
        torch.randn(B, T, D, generator=g, device=dev),
        (0, 0, 0, Tp - T)).reshape(R, D)
    scale5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    shift5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    conds = {"xf_text": torch.randn(B, 150, D, generator=g, device=dev),
             "xf_audio": torch.randn(B, 499, D, generator=g, device=dev),
             "xf_spk": torch.randn(B, 1, D, generator=g, device=dev)}
    cm = torch.tensor([1.0, 0.0], device=dev).reshape(B, 1, 1)
    ctx3 = torch.stack([cross_context(getattr(layer, f"ca_{k}"), conds[k], cm,
                                      Hc) for k in COND_KEYS],
                       dim=1).to(torch.bfloat16).contiguous()
    args = (x, m_rows, qm_rows, scale5, shift5, ctx3)
    out_k = fused_decoder_layer(*args, packed, H, Hc, B)
    out_p = fused_decoder_layer_reference(*args, packed, H, Hc, B)
    torch.cuda.synchronize()
    valid = m_rows[:, 0] > 0
    k1_err = (out_k - out_p)[valid].abs().max().item()
    if not (torch.isfinite(out_k[valid]).all() and k1_err <= TOL_K1):
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"max_abs_err {k1_err} > {TOL_K1}")
    # eight copies of the pack, cycled as the eight layers of a step are:
    # 75 MB of weights do not stay in the 50 MB L2 between calls
    packs = [{k: v.clone() for k, v in packed.items()} for _ in range(8)]
    cyc = {"i": 0}

    def k1_call(fn):
        def call():
            cyc["i"] = (cyc["i"] + 1) % len(packs)
            fn(*args, packs[cyc["i"]], H, Hc, B)
        return call

    k1_ms = cuda_ms(torch, k1_call(fused_decoder_layer), iters=40)
    k1_plain_ms = cuda_ms(torch, k1_call(fused_decoder_layer_reference),
                          iters=10)
    Dh, Dhc = D // H, D // Hc
    k1_bytes = (sum(t.numel() * t.element_size() for t in args)
                + sum(t.numel() * t.element_size() for t in packed.values())
                + x.numel() * 4)
    # 14 (D, D) products (q, k, v, out; q, out of three CAs; ca_mix; the
    # FFN's stylization out), the FFN's two, and the per-head attention
    k1_flops = (2 * R * D * (14 * D + 2 * F)
                + 4 * R * D * Dh + 3 * 2 * R * D * Dhc)
    k1_bound, k1_by = bound(k1_bytes, k1_flops, BF16_FLOPS)
    emit({"phase": "K1", "max_abs_err": k1_err, "tolerance": TOL_K1,
          "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
          "bound_by": k1_by, "bytes": k1_bytes, "flops": k1_flops})

    # ---- 4. K2 vs plain at the decoder shapes ----
    k2 = []
    for heads in (32, 64):
        Tq = dc.max_seq_len + dc.tokens_per_part
        q, k, v = (torch.randn(1, Tq, D, generator=g, device=dev)
                   for _ in range(3))
        dh = D // heads
        scale = 1.0 / math.sqrt(dh)
        out_k = fused_softmax_mha(q, k, v, heads, scale)
        out_p = softmax_mha_reference(q, k, v, heads, scale)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        if not (torch.isfinite(out_k).all() and err <= TOL_K2):
            raise AssertionError(f"K2 ({heads} heads) disagrees with its plain "
                                 f"version: max_abs_err {err} > {TOL_K2}")
        qh, kh, vh = (t.reshape(1, Tq, heads, dh).transpose(1, 2)
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        nbytes = 4 * q.numel() * 4
        t_b, by = bound(nbytes, 4 * Tq * Tq * D, F32_FLOPS)
        k2.append({
            "heads": heads, "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: fused_softmax_mha(q, k, v, heads,
                                                           scale), iters=50),
            "plain_ms": cuda_ms(torch, lambda: softmax_mha_reference(
                q, k, v, heads, scale), iters=50),
            "library_ms": cuda_ms(torch, lambda: sdpa(qh, kh, vh, scale=scale),
                                  iters=50),
            "bound_ms": t_b, "bound_by": by})
    emit({"phase": "K2", "tolerance": TOL_K2, "shapes": k2})

    # ---- 5. the main path: full-width plain generation, batch 1 ----
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    gen = StagedGenerator(model, cfg.diffusion_test.schedule())
    gb = torch.Generator(device=dev).manual_seed(2)
    batch = {"word": torch.randn(1, 150, dc.text_latent_dim, generator=gb,
                                 device=dev),
             "audio": torch.randn(1, 499, dc.audio_latent_dim, generator=gb,
                                  device=dev),
             "speaker_ids": torch.tensor([3], device=dev),
             "motion_mask": torch.ones(1, dc.max_seq_len, device=dev)}
    steps = gen.sched.num_timesteps
    torch.cuda.synchronize()
    fused_decoder_layer.launches = 0
    fused_softmax_mha.launches = 0
    t0 = time.perf_counter()
    out = gen.sample(batch, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"fused_decoder_layer": fused_decoder_layer.launches,
                "fused_softmax_mha": fused_softmax_mha.launches}
    want = {"fused_decoder_layer": steps * dc.num_layers,
            "fused_softmax_mha": 4 * (cfg.codec.num_layers
                                      + 1 - cfg.codec.num_layers % 2)}
    if launches != want:
        raise AssertionError(f"kernel launches on the main path {launches}, "
                             f"expected {want}")
    shapes = {"pred_upper": 39, "pred_lower": 27, "pred_facepose": 3,
              "pred_hands": 90, "pred_transl": 3, "pred_exps": 100,
              "pred_contact": 4}
    for key, width in shapes.items():
        if tuple(out[key].shape) != (1, dc.max_seq_len, width):
            raise AssertionError(f"{key} has shape {tuple(out[key].shape)}")
    if tuple(out["output_latents"].shape) != (1, T, D):
        raise AssertionError("output_latents has the wrong shape")
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite values in the generated clip")

    # one full-width denoiser call (conditioned + unconditioned halves):
    # kernel path against the plain path, true-separator query masks
    den = model.denoiser
    conds = model.encode_conditions(batch)
    conds2 = {k: torch.cat([v, v]) for k, v in conds.items()}
    tmask2 = latent_motion_mask(dc, torch.cat([batch["motion_mask"]] * 2))
    cm2 = torch.tensor([1.0, 0.0], device=dev).reshape(2, 1, 1)
    ctx3s = stack_layer_contexts(
        dc, precompute_cross_contexts(den, conds2, cm2), torch.bfloat16)
    mr, qr = layer_kernel_mask_rows(tmask2, parity_query_masks(2))
    x2 = torch.randn(2, T, D, generator=g, device=dev)
    step = steps // 2
    call = (den, x2, gen.adaln_scale[step], gen.adaln_shift[step], gen.packs,
            ctx3s, mr, qr)
    d_k = fused_denoise_ctx(*call)
    d_p = fused_denoise_ctx(*call, layer_fn=fused_decoder_layer_reference)
    torch.cuda.synchronize()
    tvalid = tmask2 > 0
    den_err = (d_k - d_p)[tvalid].abs().max().item()
    den_scale = d_p[tvalid].abs().max().item()
    if not den_err <= TOL_DENOISER:
        raise AssertionError(f"denoiser call: kernel path vs plain path "
                             f"max_abs_err {den_err} > {TOL_DENOISER}")

    # clips/s after the warm-up run above; the same seed gives the same clip
    runs = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(runs):
        again = gen.sample(batch,
                           generator=torch.Generator(device=dev).manual_seed(0))
    end.record()
    end.synchronize()
    host_s = (time.perf_counter() - t0) / runs
    clip_ms = start.elapsed_time(end) / runs
    if not torch.equal(again["output_latents"], out["output_latents"]):
        raise AssertionError("the same seed gave a different clip")
    emit({"phase": "main", "config": "ArchitectureConfig() full width",
          "batch": 1, "steps": steps, "launches": launches,
          "first_run_s": first_s, "denoiser_max_abs_err": den_err,
          "denoiser_max_abs": den_scale, "tolerance": TOL_DENOISER,
          "ms_per_clip": clip_ms, "host_s_per_clip": host_s,
          "clips_per_s": 1e3 / clip_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})

    # ---- where the time goes: device time by kernel over one clip ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen.sample(batch, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    by_kernel, device_ops = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:   # kernels, copies, memsets
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", ev.key)
            name = name.split("(")[0].split("<")[0][:64]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + ev.self_device_time_total / 1e3)
            device_ops += ev.count
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # K1's fifteen launches per layer call, in launch order: mean device us
    # of each over the clip's 400 calls
    k1_steps = ("ln_x", "qkv", "self_core", "styl_sa", "sa_out", "ln_ca",
                "ca_q", "cross_core", "styl_ca", "ca_out", "ca_mix", "ffn1",
                "ffn2", "styl_ffn", "ffn_out")
    k1_evs = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                    for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA
                    and re.search(r"(gemm_kernel|attention_core|normalise_rows)"
                                  r"\(", ev.name))
    k1_us = None
    if len(k1_evs) == len(k1_steps) * launches["fused_decoder_layer"]:
        k1_us = {name: sum(us for _, us in k1_evs[i::len(k1_steps)])
                 / launches["fused_decoder_layer"]
                 for i, name in enumerate(k1_steps)}
    # busy share against the clip's unprofiled time (the profiler slows the
    # host, not the kernels)
    emit({"phase": "profile", "device_ms": device_ms, "clip_ms": clip_ms,
          "device_busy_share": device_ms / clip_ms,
          "device_ops": device_ops, "top_device_ms": dict(top),
          "k1_launch_us": k1_us})

    # ---- kernels line ----
    w = [3, 1]  # calls per clip at 32 heads (upper, hands, face), at 64
    k2_mean = {key: sum(wi * s[key] for wi, s in zip(w, k2)) / sum(w)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "fused_decoder_layer", "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/decoder_layer.cu",
         "replaces": "raggesture_tpu/ops/pallas/linear_attention_kernel.py:618",
         "launches": launches["fused_decoder_layer"],
         "max_abs_err": k1_err, "tolerance": TOL_K1, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "fused_softmax_mha", "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/mha.cu",
         "replaces": "raggesture_tpu/ops/pallas/mha_kernel.py:143",
         "launches": launches["fused_softmax_mha"],
         "max_abs_err": max(s["max_abs_err"] for s in k2),
         "tolerance": TOL_K2, "ms": k2_mean["ms"],
         "plain_ms": k2_mean["plain_ms"], "bound_ms": k2_mean["bound_ms"],
         "bound_by": k2[0]["bound_by"], "library_ms": k2_mean["library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
