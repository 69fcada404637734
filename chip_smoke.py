#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``raggesture_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every CUDA kernel of the main path from ops/csrc/;
  3. K3      - cond_contexts' three kernels (forward, backward A, backward
               B) against their plain versions at the training shapes of
               the three condition streams (batch 128; 150, 499 and 1 rows;
               8 layers, D 512, 16 heads; dropped conditions included):
               every output's error, two runs bitwise equal, ms (CUDA
               events), device ms and each kernel's device us and
               instances per call (torch.profiler; each kernel of
               K3_KERNELS once a call, the forward's merge none for the
               speaker, whose 8-row sequences lie whole in a row tile),
               plain ms and the bound; beside backward B
               one torch.bmm of its two products (bf16 in, float32 out), a
               products-only yardstick;
  4. K1      - fused_decoder_layer (one cooperative launch per call)
               against its plain PyTorch version at the sampling shape (2
               sequences of 43 -> 48 tokens, D 512, 16 heads, F 1024, bf16
               packs, true-separator query masks): error, two runs bitwise
               equal, a call captured in a CUDA graph replaying to the eager
               call's bits, device ms (torch.profiler, eight packs cycled),
               CUDA-event ms and host enqueue ms, plain ms and the bound;
  5. K2      - fused_softmax_mha against its plain version at a batch-1
               clip's codec decoder shapes: (3, 160, 512) with 32 heads
               (upper, hands and face decoded as one stack) and (1, 160,
               512) with 64 (lowertrans): error,
               two runs bitwise equal, device ms (torch.profiler), CUDA-event
               ms and host enqueue ms of the kernel, of its plain version and
               of torch's scaled_dot_product_attention, and the bound;
  6. main    - StagedGenerator.sample at the shipped full width, batch 1,
               50 DDIM steps, the stacked VAE decode, random weights from a
               seed, run eagerly (graphs=False, as in phases 7-12): the
               kernel launch counts of that run (K1 400, K2 18), output shapes and
               finiteness, one full-width denoiser call against the plain
               path, and clips/s;
  7. profile - device time by kernel and device operations over one more
               clip (torch.profiler), its share of the clip time measured in
               phase 6, and K1's kernel instances (one per layer call);
  8. split_kernels - the split path's float32 kernels K5
               fused_self_attention, K4 fused_cross_attention_cached, K7
               fused_cross_block_cached and K8 fused_ffn against their plain
               versions at the sampling shape (2 sequences of 43 tokens, D
               512, 16 heads, F 1024; a masked token, true-separator query
               masks, the conditions dropped in one sequence): error, every
               output row finite, two runs bitwise equal, a CUDA-graph
               replay bitwise equal, device ms by kernel and kernel
               instances per call (torch.profiler; K5 3, K4 2, K7 3, K8 3)
               and CUDA-event ms of each and of its plain version, the
               host's enqueue ms per call, the bound and the bound of its
               products in 3xTF32; K5 also with its second sequence masked
               whole;
  9. K6      - fused_cross_attention (uncached: keys and values from the
               condition rows in every call) against its plain version at
               the sampling shape for the text, audio and speaker streams
               (150, 499 and 1 rows; inputs as phase 8's): error, two runs
               and a CUDA-graph replay bitwise equal, device ms by kernel
               and kernel instances per call (5; 4 for the speaker's one
               row), event ms, host enqueue ms, plain ms and the bound of
               each stream;
 10. split_main - StagedGenerator(layer_kernel=False) and
               StagedGenerator(merged_ca=True) generation as in phase 6:
               launch counts, shapes, a repeatable clip, clips/s, device
               busy share and device operations over one profiled clip, in
               which each split-path kernel runs as many instances as the
               launch counts and phase 8's instances per call give; one
               denoiser call per
               configuration, kernels against plain versions, one with
               ffn_pallas=True (K8), and the split call against the layer
               kernel's (bf16) call on the same inputs;
 11. unfused_main - StagedGenerator(fused=False).sample as in phase 6, every
               denoiser call the uncached fused_denoise (K5 and K6): launch
               counts, shapes, a repeatable clip, clips/s, device busy
               share and device operations over one profiled clip (kernel
               instances checked as in phase 10, K6's from phase 9); one
               full-width fused_denoise
               call against its plain path and against the cached float32
               fused_denoise_ctx(layer_kernel=False) call at the same
               shared timestep;
 12. guided  - StagedGenerator.__call__ with the inference options:
               retrieval-guided sampling (DDIM inversion of 2 exemplars,
               the window splice, insertion guidance) with fused=False and
               with fused=True, an outpaint and a prev-latent clip
               (fused=False), and inversion_self_check: launch counts,
               finiteness, repeatable clips, ms per clip, and device ms
               and device operations over one profiled clip of each;
 13. graphs  - each one-program pipeline as a CUDA graph replay
               (StagedGenerator's default on the card): plain, in-seq
               (outpaint), retrieval-guided, guided from the inversion
               cache at a full hit (Q = 2), and plain with
               layer_kernel=False, merged_ca=True and fused=False.  For
               each: the eager clip's launches and ms per clip (CUDA
               events), the first call's warm-up and capture (twice the
               eager launches), ms per replayed clip, every replay and the
               first call bitwise equal to the eager clip, no Python launch
               during replays, a held result unchanged by later replays,
               allocated memory the same before and after six replays, and
               over one profiled replay its device ms, device operations,
               busy share and kernel instances by name (K1 400 and K2 18 on
               the plain clip; the eager launches' instances on each path);
 14. serve   - the port's serving tool (raggesture_tpu_torch.tools.visualize)
               in this process at the shipped full width
               (basegesture_len150_beat.py, random weights from a seed
               written with save_params and loaded by the tool) on a
               synthetic BEAT2 directory written here (6 train and 2 test
               clips of 30 s, labels every 5 s; train windows at a 2 s
               stride), gesture-type retrieval, inversion and insertion
               guidance, 2 batches of 4, run twice (the second from the
               first's inversion cache and retrieval memo): the seconds of
               the cache build, corpus build and model load; per batch the
               retrieval host ms, exemplar encode ms, generation ms (CUDA
               events; a batch that captures a graph includes the capture),
               export ms, exemplar count, inversion cache hits, graph
               captures and K1, K2, K5, K6 launches (no K1; K2, K5 and K6
               in a batch that captures; a replay launches nothing from
               Python); every written sample's files, a
               (300, 165) finite pred_motion at 30 fps; the first batch's
               re_dict against the same retrieval on the CPU (host fields
               equal, latents within 1e-4), and its guided batch on the
               kernels against the plain versions under true-separator
               query masks: its denoiser calls (the batch's mixed call and
               the exemplars' inversion call, first and last step), its
               decode, and the whole batch at the tool's steps (from empty
               inversion caches, one set of draws) within 1e-3 on the
               latents; under the tool's quirk masks the same calls and
               batch reported beside the plain versions on the CPU against
               those on the card, and the plain batch repeated bitwise; on
               the second run every exemplar a hit of the loaded cache;
               the device memory allocated after the phase (garbage
               collected) at most TOOL_LEAK_GB above what it was before;
 15. longform - the port's long-form tool (raggesture_tpu_torch.tools.
               longform_synthesis) in this process at the shipped full width
               on phase 14's workspace: the 2 test clips of 30 s cut into 4
               chunks of 150 frames each, gesture-type retrieval, inversion
               and insertion guidance, StagedGenerator(fused=False) with
               CUDA graphs; once one clip a wave and once two.  Per wave the
               retrieval host ms, exemplar encode ms, generation ms (a wave
               that captures a graph includes the capture), export ms,
               exemplars, inversion cache hits, graph captures and their
               seconds, and the K1, K2, K5, K6 launches (K2, K5 and K6 in a
               wave that captures; none in a replay); the take's real-time
               factor (seconds of motion over seconds of wall time).  Gates:
               every wave after a clip's first takes the guided handoff
               pipeline; each held prev_latentout unchanged by every later
               replay; the stitched full_pred_motion.npz 2 x the clip's
               frames at 30 fps, finite; on a handoff wave the two staged
               pipelines (guidance with the handoff, inversion without
               guidance with and without it) replayed bitwise equal to
               their eager runs, launching nothing from Python; a 2-chunk
               handoff take with guidance on the kernels within 1e-3 of the
               plain versions on the card under true-separator query masks
               (latents), every pose output finite, and under the tool's
               quirk masks reported beside it; the device memory as in
               phase 14;
 16. train   - the denoiser training step at the shipped full width and
               device batch 128 (random weights, a synthetic batch made
               from a seed): K3's launches per step, a frozen codec, the
               gradients of one step with the kernels against the same
               step with the plain versions, ms per step and samples/s,
               the peak device memory of the timed steps
               (torch.cuda.max_memory_allocated: K3's forward keeps each
               stream's bf16 LayerNorm rows for backward A) beside what was
               allocated when the phase began and the phase's own copies
               of the parameters (the frozen-codec and update checks), and
               device time by kernel over one profiled step;
               then, with the training step's options: the latent cache of
               phase 14's train windows (build seconds, windows/s), a step
               that reads it (ms, device ms, K3's launches and kernel
               instances, peak memory, its gradients on the kernels against
               the plain versions), the 4-step loop's ms a step beside the
               single step's (each over 4 steps on the same batch, timed
               alternately, twice), and one clipped AdamW step (finite);
 17. train_tool - the port's training tool (raggesture_tpu_torch.tools.
               train) in this process on phase 14's workspace at full width,
               batch 32: live bf16 with validation, the latent cache
               streamed and banked (losses bitwise equal), the banked run
               resumed (``train_tool_phase``);
 18. evaluate - the port's evaluation tools (raggesture_tpu_torch.tools.
               evaluate, evaluate_divonly, evaluate_mm) on phase 14's 8
               result directories (300 frames at 30 fps), with an SMPL-X
               asset and the reference FGD checkpoint as stand-ins made from
               a seed at the release's shapes (10,475 vertices, 55 joints,
               400 shape and expression directions; the checkpoint's 56 keys)
               and the GT joints' mean speeds as --avg-vel: evaluate with
               --srgr on the card and on the CPU, divonly, and
               multimodality over results_0 and one more serving run (seed
               4, one batch); per run its seconds and its FK, FGD and
               host-metric seconds, one profiled directory's device busy
               share, and foot contacts by FK in featurize_clip for the
               workspace's clips on the card and on the CPU.  Gates: every
               summary key finite; FK joints and face vertices of one
               directory within 1e-5 of their largest magnitude of the
               CPU's, one clip's FGD latents within 1e-4; l1div, l1div_gt,
               diversity, mpjpe_retrieval, face_l2 and face_lvd within 1e-3
               relative of the CPU's (fgd, align and srgr reported beside
               the CPU's with the beats and SRGR hits that differ); the
               contacts equal the CPU's but where a foot's speed lies within
               1e-6 of the threshold; the device memory as in phase 14;
 19. ddp     - data-parallel training (``ddp_phase``): the training tool
               with --distributed over NCCL at world size 1 on phase 17's
               latent cache (K3's launches, one gradient all-reduce a step
               and its ms), and one full-width step at global batch 128 by
               two ranks on this card over gloo (each its own process, 64
               rows) against the step of one process: per-sample losses
               and grad_norm within TOL_DDP_LOSS, the reduced gradients
               leaf by leaf within TOL_DDP_GRAD, the updated parameters
               within lr / 100 where the gradient is settled, the replicas
               equal, K3's launches a rank step; a rank's step ms and its
               all-reduce ms;
 20. train_vae - the part-VAE training tool (raggesture_tpu_torch.tools.
               train_vae) for upper (32 decoder heads of 16) and lowertrans
               (64 of 8) at full width, batch 64, 3 steps each on phase
               14's workspace: K2 9 launches a step under autograd (its
               backward the plain recompute), K2 under autograd against
               the plain attention (output TOL_K2, gradients bitwise), a
               step's gradients on K2 against the plain path within
               TOL_VAE_GRAD, a step's ms and its forward's, the two files
               grafted by load_codec_params and a decode from them;
 21. options - the model and diffusion options (``options_phase``):
               StagedGenerator.sample under spec A (cosine, ddim50,
               EPSILON, FIXED_SMALL), spec B (linear, trailing 50, V_PRED)
               and with 2 + 2 condition encoder layers, eager and replayed
               (K1 a layer call, 400 a clip, 408 under spec B's 51 trailing
               steps; K2 18; replays bitwise equal, a denoiser call on K1
               within TOL_DENOISER); fused=False under spec A
               (K5 400, K6 1200, K2 36; the clip within TOL_SPLIT_DENOISER
               of the plain versions' at its scale); generate() with DDPM;
               the DDPM loop through make_cfg_model_fn with pre_seq and
               transl_req, and calc_bpd_loop: the CPU's on the card's model
               outputs within TOL_OPTIONS_CPU, a call every 25 steps within
               TOL_SPLIT_DENOISER of the CPU's;
               the training step with the encoders and an EPSILON target
               at batch 128 (K3 3 + 3 + 3, gradients within TOL_TRAIN_GRAD);
 22. release - the released checkpoint onto the port (``release_phase``),
               on phase 14's workspace at full width: a stand-in release of
               a seeded model in the reference's layouts (epoch_64.pth, mmcv
               ``state_dict`` under ``model.`` with the four VAEs embedded;
               four per-part VAE runs, each a yaml naming its test_ckpt; the
               FGD checkpoint), its names and shapes those of
               tests/fixtures/golden_keys_*.json, converted by
               ``tools.convert_weights --all`` (write, convert seconds and
               bytes; the whole model's file equal to the seeded model
               bitwise; the part files and the FGD file loaded strictly);
               wav2vec2-base-960h and bert-base-cased stand-ins at their
               published configs and depth (12 × 768 each; ForCTC's and
               BertForPreTraining's layouts, a 28,996-word vocabulary) in
               the hub cache layout, found by ``make_default_extractor``,
               which builds fresh test and train window caches on the card
               (seconds, windows/s, featurizer ms a window and a clip; one
               window's features within TOL_FEATURES relative of the same
               modules on the CPU); the serving tool on the converted file
               (gesture-type retrieval, inversion, guidance, one batch of
               2; K5 and K6 launched, K2 where the decode takes it, no K1),
               the same batch as eager clips fused=False (K5 400, K6 1200,
               K2 36) and fused=True (K1 400, K2 18); one denoiser call on
               K1 within TOL_DENOISER and one on K5/K6 within
               TOL_SPLIT_DENOISER of the plain paths, the decode on K2
               within TOL_K2; one replayed clip's
               ``profiling.traced_device_time_ms`` within TOL_TRACE of the
               same window's ``device_busy_ms``; the served call with
               ``--render --smplx-asset`` where a video writer is installed
               (ffmpeg, else PIL): each sample's GT/prediction and
               prediction/retrieval videos (320 × 480 a panel,
               ``write_smplx_standin``'s 20,908 faces; a GIF's size and
               frame count checked; the tool's render ms a frame), and 2
               frames of each of a sample's videos on the card twice
               (bitwise; ms a frame) and on the CPU (RENDER_PIXELS of the
               pixels equal; ms a frame); without a writer,
               ``write_video`` raising, naming both;
Device ms is the time during which at least one device operation ran (a
programmatic dependent launch overlaps the kernel before it, so kernel times
summed would count that stretch twice); ``kernel_ms`` gives each kernel's own.
Then the nvidia-smi line, the kernels line and, last, the result line.  Any
failure raises, so the script exits non-zero without the result line; it
also exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import string
import subprocess
import sys
import tempfile
import time

# the profiler helpers every phase reads its device times with; outside a
# checkout of the repo this import fails and the script exits non-zero
from raggesture_tpu_torch.utils.profiling import (
    device_busy_ms,
    device_profile,
    device_time_by_kernel,
    instances_by_kernel,
    profiled,
)

# Tolerances (max |kernel - plain| over valid rows):
#  K1: both versions round the same activations to bf16 before each product,
#      but sum in different orders, so an operand near a rounding boundary
#      can land one bf16 ulp (2^-8 relative) apart; a few such flips move an
#      O(1)-sized layer output by ~1e-3.
#  K2: float32 throughout, differing only in summation order.
#  SPLIT: K4, K5, K6, K7, K8 are float32 throughout, like their plain
#      versions (float32 cuBLAS products, no TF32): summation order only
#      (the kernels multiply in 3xTF32, whose split operands keep float32
#      accuracy, ~1e-6 relative; K6's key/value products in float32).
#  SPLIT_DENOISER: eight layers of those, one full-width call; each
#      stylization LayerNorm divides by its row's spread.  It also bounds
#      the uncached call (K5, K6) against the cached one (K5, K4) at a
#      shared timestep: the same function, its keys and values computed
#      in the call or once per run.
#  DENOISER: eight K1 layers and the output head, one full-width call.
#  K3: both versions round the same operands to bf16 before each product;
#      max |kernel - plain| over max |plain| per output.  The key side's
#      gradients are measured against the larger of the key and value
#      scales: dbk is zero in exact arithmetic (the time softmax is
#      shift-invariant), and so is dwk for a one-token stream (its softmax
#      weight is exactly 1).
#  K3_BF16_DXF: the bf16 entry points' dxf, written in bf16, against the
#      plain dxf rounded to bf16: where the float32 values of the two sit
#      on either side of a rounding boundary they land one bf16 ulp apart,
#      2^-8 of the largest element at most, on top of TOL_K3.
#  phase serve's guided batch: its calls and the whole batch at the tool's
#      steps on the kernels against the plain versions, under the
#      true-separator query masks, within TOL_SPLIT_DENOISER.  Under the
#      tool's quirk masks a cross attention adds -1e6 to the output rows of
#      two valid tokens before a LayerNorm, which then reads their O(1)
#      part on a 1/16 grid: there two float32 implementations differ by
#      grid steps, so those runs are reported beside the plain versions on
#      the CPU against those on the card, not gated.
#  SERVE_RETRIEVAL: the exemplars' latents of the serving tool's
#      retrieval on the card against the same retrieval on the CPU: the
#      codec encode, float32 on both.  Its attention is masked, so it takes
#      the plain path on both devices: this checks the device placement of
#      the retrieval, not a kernel.
#  TRAIN_GRAD: one training step's parameter gradients, kernels against
#      plain versions: max over parameter tensors of |d|max / |g|max,
#      leaving out the tensors whose gradient is zero in exact arithmetic
#      (see zero_exact_gradient); K3's differences pass through the
#      denoiser's forward and backward.
#  TRAIN_GRAD_BF16: the same under bf16_compute, where K3's dxf comes
#      back rounded to bf16 (one ulp apart where the two versions straddle
#      a rounding boundary, TOL_K3_BF16_DXF) and flows back through the
#      condition encoders' bf16 products.
TOL_K1 = 2e-2
TOL_K2 = 1e-4
TOL_DENOISER = 5e-2
TOL_SPLIT = 1e-4
TOL_SPLIT_DENOISER = 1e-3
TOL_K3 = 2e-3
TOL_K3_BF16_DXF = 6e-3
TOL_TRAIN_GRAD = 1e-2
TOL_TRAIN_GRAD_BF16 = 2e-2
TOL_SERVE_RETRIEVAL = 1e-4
TRAIN_BATCH = 128
# a tool phase's growth of allocated device memory, garbage collected: a
# leaked full-width model would hold 1.17 GB
TOOL_LEAK_GB = 0.25
# K3's kernels by wrapper (csrc/cond_ctx.cu), one launch of each a call;
# the forward's merge only where a sequence spans row tiles
# (cond_ctx.forward_records)
K3_KERNELS = {"forward": ("ln_rows", "ctx_fwd_kv", "ctx_fwd_merge"),
              "bwd_a": ("ctx_bwd_kv", "ctx_bwd_dx", "ln_backward",
                        "sum_partials"),
              "bwd_b": ("ctx_bwd_w", "sum_splits")}

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense tensor-core bf16
F32_FLOPS = 67e12              # float32 outside the tensor cores
TF32_FLOPS = 495e12            # dense tensor-core TF32


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the script's seconds so far
    (``elapsed_s``)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
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


def allocated_gb(torch) -> float:
    """The device memory that live tensors hold, after a garbage collection
    and with cuBLAS's per-stream workspaces released (each stream a graph
    cache made keeps one until then)."""
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated() / 2 ** 30


def cuda_gb_by_name(torch, names: dict, min_gb: float = 0.01) -> dict:
    """{name: GB} of the CUDA tensor storages reachable from each value of
    ``names`` (a function through its closure and defaults only), for the
    names that reach at least ``min_gb``."""
    import types

    out = {}
    for name, root in names.items():
        seen, storages, stack = set(), {}, [root]
        while stack and len(seen) < 200_000:
            o = stack.pop()
            if id(o) in seen or isinstance(o, (type, types.ModuleType, str,
                                               bytes, int, float)):
                continue
            seen.add(id(o))
            if isinstance(o, torch.Tensor):
                if o.is_cuda:
                    st = o.untyped_storage()
                    storages[st.data_ptr()] = st.nbytes()
                continue
            if isinstance(o, types.FunctionType):
                for c in o.__closure__ or ():
                    try:
                        stack.append(c.cell_contents)
                    except ValueError:
                        pass
                stack.extend(o.__defaults__ or ())
                continue
            stack.extend(gc.get_referents(o))
        gb = sum(storages.values()) / 2 ** 30
        if gb >= min_gb:
            out[name] = gb
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def zero_exact_gradient(name: str) -> bool:
    """Denoiser parameters whose gradient is zero in exact arithmetic: the
    key biases feed only a time softmax (shift-invariant per column), and
    the speaker stream has one token, so its softmax weight is exactly 1
    (no key gradient) and every context row is the same v, which a
    feature-softmaxed query (summing to one) reads whatever it is."""
    parts = name.split(".")
    return name.endswith("key.bias") or (
        len(parts) > 2 and parts[1] == "ca_xf_spk"
        and parts[2] in ("key", "query", "norm"))


def host_ms_per_call(torch, fn, calls=40):
    """Host time to enqueue one call of ``fn`` (no wait inside the loop; 40
    calls stay well inside the card's launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host_ms


def graph_replay_equal(torch, fn, eager) -> bool:
    """One call of ``fn`` captured in a CUDA graph replays to the bits of
    ``eager``, the output of an eager call on the same inputs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(captured, eager)


def parity_query_masks(torch, dc, batch, dev):
    """True-separator query masks of ``batch`` sequences, per stream."""
    from raggesture_tpu_torch.models.denoiser import COND_KEYS

    m = torch.ones(batch, dc.num_tokens, device=dev)
    m[:, list(dc.sep_indices)] = 0.0
    return {k: m for k in COND_KEYS}


def k1_case(torch, dc, batch, g, dev):
    """K1's operands at the sampling shape for ``batch`` sequences (the
    halves of batch / 2 clips: conditioned, then unconditioned): the layer
    inputs (x, src_mask, query_mask3, scale5, shift5, ctx3) and a bf16 pack
    of a layer with random weights from ``g``."""
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DecoderLayer,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        cross_context,
        layer_kernel_mask_rows,
        padded_tokens,
    )
    from raggesture_tpu_torch.ops.decoder_layer import pack_decoder_layer

    D, T = dc.latent_dim, dc.num_tokens
    Tp = padded_tokens(T)
    with torch.device(dev):
        layer = DecoderLayer(dc)
    init_weights(layer, g, zero_init_std=0.02)
    packed = pack_decoder_layer(layer, torch.bfloat16)
    token_mask = latent_motion_mask(dc, torch.ones(batch, dc.max_seq_len,
                                                   device=dev))
    m_rows, qm_rows = layer_kernel_mask_rows(
        token_mask, parity_query_masks(torch, dc, batch, dev))
    x = torch.nn.functional.pad(
        torch.randn(batch, T, D, generator=g, device=dev),
        (0, 0, 0, Tp - T)).reshape(batch * Tp, D)
    scale5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    shift5 = 0.1 * torch.randn(5, D, generator=g, device=dev)
    conds = {"xf_text": torch.randn(batch, 150, D, generator=g, device=dev),
             "xf_audio": torch.randn(batch, 499, D, generator=g, device=dev),
             "xf_spk": torch.randn(batch, 1, D, generator=g, device=dev)}
    cm = torch.tensor([1.0, 0.0], device=dev).repeat_interleave(
        batch // 2).reshape(batch, 1, 1)
    ctx3 = torch.stack([cross_context(getattr(layer, f"ca_{k}"), conds[k], cm,
                                      dc.ca_heads) for k in COND_KEYS],
                       dim=1).to(torch.bfloat16).contiguous()
    return (x, m_rows, qm_rows, scale5, shift5, ctx3), packed


def clip_batch(torch, dc, clips, dev):
    """A synthetic batch of ``clips`` clips (text, audio, speaker and motion
    mask) from seed 2: the input of the main path's sampling."""
    gb = torch.Generator(device=dev).manual_seed(2)
    return {"word": torch.randn(clips, 150, dc.text_latent_dim, generator=gb,
                                device=dev),
            "audio": torch.randn(clips, 499, dc.audio_latent_dim,
                                 generator=gb, device=dev),
            "speaker_ids": torch.full((clips,), 3, device=dev),
            "motion_mask": torch.ones(clips, dc.max_seq_len, device=dev)}


def split_case(torch, dc, g, dev, B=2):
    """The split kernels' inputs at the sampling shape (B = 2 sequences of
    43 tokens), float32: eight DecoderLayers with random weights from
    ``g`` (~150 MB, cycled as a step's eight layers are: they do not stay
    in the 50 MB L2 between calls), their split packs and uncached cross
    packs; hidden states, a token mask with one masked token,
    true-separator query masks, per-sequence adaLN rows, the condition rows
    of the text, audio and speaker streams (150, 499, 1) dropped in the
    second sequence, and each layer's per-head contexts."""
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        DecoderLayer,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        cross_context,
        pack_split_layer,
        split_mask_rows,
    )
    from raggesture_tpu_torch.ops.cross_attention import (
        pack_cross_attention_kv,
    )

    D, T, Hc = dc.latent_dim, dc.num_tokens, dc.ca_heads
    with torch.device(dev):
        layers = [DecoderLayer(dc) for _ in range(dc.num_layers)]
    for lyr in layers:
        init_weights(lyr, g, zero_init_std=0.02)
    tmask = latent_motion_mask(dc, torch.ones(B, dc.max_seq_len, device=dev))
    tmask[0, 5] = 0.0                        # one masked token
    src, qm3 = split_mask_rows(tmask, parity_query_masks(torch, dc, B, dev))
    x = torch.randn(B, T, D, generator=g, device=dev)
    scale = 0.1 * torch.randn(B, 5, D, generator=g, device=dev)
    shift = 0.1 * torch.randn(B, 5, D, generator=g, device=dev)
    cm = (torch.arange(B, device=dev) == 0).float().reshape(B, 1, 1)
    conds = {k: torch.randn(B, n, D, generator=g, device=dev)
             for k, n in zip(COND_KEYS, (150, 499, 1))}
    ctx3 = [torch.stack([cross_context(getattr(lyr, f"ca_{k}"), conds[k], cm,
                                       Hc) for k in COND_KEYS],
                        dim=1).contiguous() for lyr in layers]
    return {"packs": [pack_split_layer(lyr) for lyr in layers],
            "kvpacks": [[pack_cross_attention_kv(getattr(lyr, f"ca_{k}"))
                         for k in COND_KEYS] for lyr in layers],
            "x": x, "src": src, "qm3": qm3, "sc": scale, "sh": shift,
            "cm": cm, "conds": conds, "ctx3": ctx3, "H": dc.num_heads,
            "Hc": Hc, "valid": (src[..., 0] > 0) & (qm3 > 0).all(-1)}


def split_args(c, name, i):
    """The arguments of the split kernel whose wrapper is called ``name``
    on layer i of ``split_case`` ``c``; K4 on the audio stream, through the
    column views the split path passes."""
    w = c["packs"][i]
    x, sc, sh = c["x"], c["sc"], c["sh"]
    if name == "fused_self_attention":
        return (x, c["src"], sc[:, 0], sh[:, 0], w.sa, c["H"])
    if name == "fused_cross_attention_cached":
        return (x, c["ctx3"][i][:, 1], c["qm3"][..., 1:2], sc[:, 2],
                sh[:, 2], w.cross_block.cas[1], c["Hc"])
    if name == "fused_cross_block_cached":
        return (x, c["ctx3"][i], c["qm3"], sc[:, 1:4], sh[:, 1:4],
                w.cross_block, c["Hc"])
    return (x, sc[:, 4], sh[:, 4], w.ffn)


def k6_args(c, j, i):
    """K6's arguments on condition stream j (text, audio, speaker) of layer
    i of ``split_case`` ``c``."""
    key = list(c["conds"])[j]
    return (c["x"], c["conds"][key], c["qm3"][..., j:j + 1], c["cm"],
            c["sc"][:, 1 + j], c["sh"][:, 1 + j], c["kvpacks"][i][j], c["Hc"])


def k3_case(torch, dc, B, n_rows, dev):
    """K3's inputs at a training shape: ``n_rows`` condition rows padded
    (pad_rows), ~10 % of the conditions dropped as in training, the stacked
    per-layer parameters with bf16 weights and a context cotangent, all
    from a seed of ``n_rows``: (xf, cm, nv, params, dctx)."""
    from raggesture_tpu_torch.ops.cond_ctx import pad_rows

    D, L, Hc = dc.latent_dim, dc.num_layers, dc.ca_heads
    bf16 = torch.bfloat16
    gk = torch.Generator(device=dev).manual_seed(n_rows)

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gk, device=dev)

    cm = torch.ones(B, 1, 1, device=dev)
    cm[::10] = 0.0            # dropped conditions, ~10 % as in training
    xf, cm3, nv = pad_rows(rn(B, n_rows, D), cm)
    prm = (1.0 + rn(L, D, s=0.1), rn(L, D, s=0.1),
           rn(L, D, D, s=D ** -0.5).to(bf16), rn(L, D, s=0.1),
           rn(L, D, D, s=D ** -0.5).to(bf16), rn(L, D, s=0.1))
    return xf, cm3, nv, prm, rn(B, L, Hc, D // Hc, D // Hc)


def train_batch(torch, dc, B, dev):
    """A synthetic training batch of ``B`` clips in the synthetic_batch
    schema (small axis-angle poses, translation, expressions, contacts,
    word (150 x 768) and audio (499 x 768) features) from seed 3, and the
    draw function ``rt`` (its generator as ``rt.generator``) for more."""
    gt = torch.Generator(device=dev).manual_seed(3)
    frames = dc.max_seq_len

    def rt(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gt, device=dev)

    rt.generator = gt
    batch = {
        "motion_upper": rt(B, frames, 39, s=0.2),
        "motion_lower": rt(B, frames, 27, s=0.2),
        "motion_face": rt(B, frames, 3, s=0.2),
        "motion_hands": rt(B, frames, 90, s=0.2),
        "trans": rt(B, frames, 3, s=0.1),
        "facial": rt(B, frames, 100, s=0.1),
        "contact": (torch.rand(B, frames, 4, generator=gt, device=dev)
                    > 0.5).float(),
        "motion_mask": torch.ones(B, frames, device=dev),
        "word": rt(B, frames, dc.text_latent_dim),
        "audio": rt(B, 499, dc.audio_latent_dim),
        "speaker_ids": torch.randint(0, dc.num_speakers, (B,), generator=gt,
                                     device=dev),
    }
    return batch, rt


# The synthetic BEAT2 directory of phase 15: per 5-second period of a clip,
# five transcript words (an iconic, deictic or metaphoric gesture label on
# the third), a beat, the words' prominence, and one discourse relation
# whose connective is the fourth word, so that every 10-second window
# carries labels.  The layout is the dataset's (SMPL-X npz at 30 fps, 16 kHz
# wav, sem txt, prom, whisper relations JSON, train_test_split.csv).
SERVE_WORDS = (("hello", "this", "house", "because", "reasons"),
               ("look", "there", "tower", "since", "lately"),
               ("think", "big", "idea", "although", "sometimes"),
               ("push", "that", "door", "so", "quickly"))
SERVE_TYPES = ("iconic", "deictic", "metaphoric")


def write_raw_beat2(root: str, clips, n_sec: int, sr: int = 16000) -> None:
    """``clips``: (file_id, split) pairs; each clip ``n_sec`` seconds of
    random motion and noise audio made from its index."""
    import os

    import numpy as np
    from scipy.io import wavfile

    for sub in ("smplxflame_30", "wave16k", "sem", "prom", "discourse_rels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = ["id,type"]
    for i, (fid, split) in enumerate(clips):
        rows.append(f"{fid},{split}")
        rng = np.random.RandomState(i)
        T = n_sec * 30
        np.savez(os.path.join(root, "smplxflame_30", fid + ".npz"),
                 poses=rng.randn(T, 165).astype(np.float32) * 0.1,
                 trans=rng.randn(T, 3).astype(np.float32) * 0.05,
                 betas=rng.randn(300).astype(np.float32) * 0.1,
                 expressions=rng.randn(T, 100).astype(np.float32) * 0.1)
        wavfile.write(os.path.join(root, "wave16k", fid + ".wav"), sr,
                      (rng.randn(n_sec * sr) * 3000).astype(np.int16))
        sem, prom, tokens, rels = [], [], [], []
        for p in range(n_sec // 5):
            o = 5.0 * p
            words = SERVE_WORDS[(i + p) % len(SERVE_WORDS)]
            times = [(o + a, o + a + 0.4) for a in (0.3, 1.0, 2.0, 3.0, 3.8)]
            n0 = len(tokens)
            for w, (a, b) in zip(words, times):
                tokens.append({"surface": w, "startSec": a, "endSec": b})
                prom.append(f"{fid}\t{a}\t{b}\t{w}\t"
                            f"{rng.uniform(0.2, 2.5):.3f}\t0.0")
            sem.append(f"beat_align\t{o + 0.3}\t{o + 0.7}\t0.4\t0.3\t"
                       f"{words[0]}")
            kind = SERVE_TYPES[(i + p) % len(SERVE_TYPES)]
            sem.append(f"{kind}_high\t{o + 2.0}\t{o + 2.4}\t0.4\t0.9\t"
                       f"{words[2]}")
            rels.append({
                "Connective": {"TokenList": [n0 + 3], "RawText": words[3]},
                "Sense": ["Contingency.Cause.Reason"],
                "Arg1": {"TokenList": [n0, n0 + 1, n0 + 2],
                         "RawText": " ".join(words[:3])},
                "Arg2": {"TokenList": [n0 + 4], "RawText": words[4]}})
        with open(os.path.join(root, "sem", fid + ".txt"), "w") as f:
            f.write("\n".join(sem) + "\n")
        with open(os.path.join(root, "prom", fid + ".prom"), "w") as f:
            f.write("\n".join(prom) + "\n")
        with open(os.path.join(root, "discourse_rels",
                               fid + "_whisper_relations.json"), "w") as f:
            json.dump({"sentences": [{"tokens": tokens}],
                       "relations": rels}, f)
    with open(os.path.join(root, "train_test_split.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


SERVE_CONFIG = "configs/raggesture_beatx/basegesture_len150_beat.py"
SERVE_OPTIONS = ["--retrieval-method", "gesture_type", "--use-inversion",
                 "--insertion-guidance", "--guidance-iters", "constant",
                 "--test-batchsize", "4", "--max-batches", "2"]
SERVE_FILES = ("pred_motion.npz", "gt_motion.npz", "gt_text.txt",
               "sem_score.npy", "gt_audio.wav", "retrieval_0.npz",
               "retrieval_list.txt")
# the re_dict fields that are host bookkeeping, compared exactly
SERVE_HOST_FIELDS = ("raw_sample_names", "raw_type2words", "retr_startends",
                     "query_startends", "splice", "re_mask",
                     "raw_latent_mask", "inv_names", "num_queries")


def write_workspace(ws: str, n_sec: int, config_options=()):
    """The synthetic BEAT2 directory of phases 14-16 under ``ws`` (6 train
    and 2 test clips of ``n_sec`` seconds; written once) and the tools'
    ``--options`` that point the config's data, caches, retrieval corpus
    and memo into ``ws``.  Returns (options, seconds spent writing)."""
    import os

    root = os.path.join(ws, "beat2")
    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(root, "train_test_split.csv")):
        write_raw_beat2(root, [(f"2_scott_0_{i}_{i}", "train")
                               for i in range(1, 7)]
                        + [("2_scott_0_7_7", "test"),
                           ("2_scott_0_8_8", "test")], n_sec=n_sec)
    write_s = time.perf_counter() - t0
    # the train windows at a 2-second stride (the config's 1/3 s): a sixth
    # of the corpus to featurize and compress
    options = ["--options"] + [
        f"data.{split}.{k}={v}" for split in ("train", "test")
        for k, v in (("data_path", root),
                     ("cache_path", os.path.join(ws, "cache")),
                     ("allow_fake_contacts", True))] + [
        "data.train.stride=30", *config_options,
        f"model.model.retrieval_cfg.cache_path={ws}/retrieval_cache",
        "model.model.retrieval_cfg.stratification_interval=1",
        "custom_hooks=[{'type': 'DatabaseSaveHook', "
        f"'save_dir': '{ws}/memo'}}]"]
    return options, write_s


def serve_phase(torch, dev, config: str = SERVE_CONFIG, n_sec: int = 30,
                config_options=(), ws=None) -> dict:
    """Phase 14: the port's serving tool (``raggesture_tpu_torch.tools.
    visualize.main``) in this process on ``config`` with ``config_options``
    (the shipped full width by default; tests/test_torch_cuda.py runs it
    narrow), twice on one synthetic workspace of ``n_sec``-second clips; the
    checks listed in the module docstring.  A batch that captures its
    graphs launches K2 where a codec decoder's attention takes it
    (``ops.mha.mha_supported`` at the decode's shapes).  The workspace is
    ``ws`` when given (it is kept, with its caches, for the phases after),
    else a temporary directory removed at the end.  Returns the phase's
    JSON line."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from raggesture_tpu_torch.builders import (
        arch_config_from,
        beatx_config_from,
        retrieval_config_from,
    )
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.build import build_dataset
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models.conditioning import (
        double_conditions,
        scale_func_table,
    )
    from raggesture_tpu_torch.models import vae as V
    from raggesture_tpu_torch.models.denoiser import (
        default_query_masks,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        fused_denoise,
        stack_adaln_weights,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import self_attention as SA
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer
    from raggesture_tpu_torch.models.codec import PART_NAMES
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        mha_supported,
        softmax_mha_reference,
    )
    from raggesture_tpu_torch.retrieval.database import (
        RetrievalCorpus,
        RetrievalDatabase,
        host_batch_from_records,
    )
    from raggesture_tpu_torch.tools import visualize as tool
    from raggesture_tpu_torch.train.checkpoint import load_params, save_params
    from raggesture_tpu_torch.train.runner import device_batch

    counted = (fused_decoder_layer, fused_softmax_mha,
               SA.fused_self_attention, CA.fused_cross_attention)
    own_ws = ws is None
    if own_ws:
        ws = tempfile.mkdtemp(prefix="serve_")
    try:
        options, write_s = write_workspace(ws, n_sec, config_options)
        cfg = Config.fromfile(config)
        cfg.merge_option_strings(options[1:])
        factor = 30 // cfg.data.test.pose_fps
        frames = cfg.data.test.pose_length * factor      # at 30 fps
        arch = arch_config_from(cfg.model)
        # each part's decoder attends over its latent tokens and frames
        cc = arch.codec
        t_dec = cc.tokens_per_part + cc.num_frames
        decode_on_k2 = any(
            mha_supported(t_dec, t_dec, cc.latent_dim,
                          8 * cc.vae_config(part).num_heads)
            for part in PART_NAMES)
        model = A.create_model(arch, device=dev, seed=11,
                               zero_init_std=0.02)
        ckpt = os.path.join(ws, "params.pt")
        save_params(ckpt, model, {"seed": 11})
        del model

        runs, first = [], {}
        for run in range(2):
            out_dir = os.path.join(ws, f"results_{run}")
            seen = []

            def on_batch(info):
                torch.cuda.synchronize()
                gen = info["generator"]
                launches = {fn.__name__: fn.launches for fn in counted}
                for fn in counted:
                    fn.launches = 0
                captures = gen.graphs.captures - (
                    seen[-1]["captures_total"] if seen else 0)
                seen.append(dict(info["stats"], launches=launches,
                                 graph_captures=captures,
                                 captures_total=gen.graphs.captures,
                                 valid=int(info["batch"]["valid_mask"].sum())))
                if run == 0 and info["stats"]["batch"] == 0:
                    first.update(info)

            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            report = tool.main(
                [config, ckpt, "--out-dir", out_dir, "--seed", "3",
                 "--inv-cache", os.path.join(ws, "inv_cache.npz")]
                + SERVE_OPTIONS + options, on_batch=on_batch)
            wall_s = time.perf_counter() - t0
            for b in seen:
                b.pop("captures_total")
                if b["num_queries"] <= 0:
                    raise AssertionError(f"serve run {run}: batch "
                                         f"{b['batch']} retrieved nothing")
                # Python counts the launches of a graph's warm-up and
                # capture; a replayed batch launches none from Python (the
                # exemplar encode's masked attention takes the plain path,
                # as in the JAX package)
                lk = b["launches"]
                if lk["fused_decoder_layer"] or (b["graph_captures"] and not (
                        bool(lk["fused_softmax_mha"]) == decode_on_k2
                        and lk["fused_self_attention"]
                        and lk["fused_cross_attention"])):
                    raise AssertionError(f"serve run {run}: batch "
                                         f"{b['batch']} ({b['graph_captures']}"
                                         f" graphs captured) launched {lk}")
            total = {fn.__name__: sum(b["launches"][fn.__name__]
                                      for b in seen) for fn in counted}
            if not (total["fused_self_attention"]
                    and total["fused_cross_attention"]
                    and bool(total["fused_softmax_mha"]) == decode_on_k2):
                raise AssertionError(f"serve run {run}: a kernel of the "
                                     f"path was never launched: {total}")
            samples = 0
            for dirpath, _, files in os.walk(out_dir):
                if "pred_motion.npz" not in files:
                    continue
                samples += 1
                missing = sorted(set(SERVE_FILES) - set(files))
                d = np.load(os.path.join(dirpath, "pred_motion.npz"))
                if (missing or d["poses"].shape != (frames, 165)
                        or int(d["mocap_frame_rate"]) != 30
                        or str(d["model"]) != "smplx2020"
                        or not all(np.isfinite(d[k]).all() for k in
                                   ("poses", "expressions", "trans"))):
                    raise AssertionError(
                        f"serve run {run}: {dirpath}: missing {missing}, "
                        f"poses {d['poses'].shape}")
            if samples != sum(b["valid"] for b in seen):
                raise AssertionError(f"serve run {run}: {samples} samples "
                                     f"written, expected "
                                     f"{sum(b['valid'] for b in seen)}")
            runs.append({"stages": report["stages"], "batches": seen,
                         "samples": samples, "wall_s": wall_s})

        # run 2 started from run 1's inversion cache and retrieval memo
        second = runs[1]
        if not (second["stages"].get("inv_cache_loaded", 0) > 0
                and all(b["inv_cache_misses"] == 0
                        and b["inv_cache_hits"] == b["num_queries"]
                        for b in second["batches"])
                and [b["num_queries"] for b in second["batches"]]
                == [b["num_queries"] for b in runs[0]["batches"]]):
            raise AssertionError(f"serve run 1 did not start from run 0's "
                                 f"caches: {second}")

        # the card's first re_dict against the same retrieval on the CPU
        cpu_model = A.create_model(arch, device="cpu")
        load_params(ckpt, cpu_model)
        train_ds = build_dataset(beatx_config_from(cfg.data.train))
        db_cpu = RetrievalDatabase(
            RetrievalCorpus.load(cfg.model.model.retrieval_cfg.cache_path),
            retrieval_config_from(cfg.model.model), train_ds)
        names = first["batch"]["sample_name"]
        want = db_cpu(host_batch_from_records(first["records"]), names,
                      tool.make_encode_fn(cpu_model), method="gesture_type")
        got = first["re_dict"]
        for k in SERVE_HOST_FIELDS:
            a, b = got[k], want[k]
            same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b)
            if not same:
                raise AssertionError(f"serve: re_dict[{k!r}] on the card "
                                     f"differs from the CPU's")
        re_err = {k: float(np.abs(np.asarray(got[k]) - want[k]).max())
                  for k in ("inv_latents", "raw_motion_latents")}
        if not all(e <= TOL_SERVE_RETRIEVAL for e in re_err.values()):
            raise AssertionError(f"serve: exemplar latents on the card vs "
                                 f"the CPU {re_err} > {TOL_SERVE_RETRIEVAL}")
        del db_cpu

        # the first batch's guided run on the kernels against the plain
        # versions, under two sets of query masks: the true separators
        # (gated), and the tool's, the reference's quirk masks (reported
        # beside the plain versions on the CPU against those on the card).
        # The quirk masks zero the query mask of valid tokens 2L and 3L,
        # where a cross attention adds -1e6 to its output before the
        # stylization's LayerNorm: those rows keep their O(1) part to a
        # 1/16 grid, so any two float32 implementations flip some of its
        # steps, and the chain carries the flips on
        gen = first["generator"]
        den, dc = gen.model.denoiser, arch.denoiser
        dbatch = device_batch(first["batch"], dev)
        cbatch = device_batch(first["batch"], "cpu")
        cpu_gen = A.StagedGenerator(cpu_model, gen.sched, fused=False)
        re_dict = first["re_dict"]
        g = torch.Generator(device=dev).manual_seed(5)
        B = dbatch["word"].shape[0]
        masks = {"true_sep": lambda n, d: parity_query_masks(torch, dc, n, d),
                 "tool": lambda n, d: default_query_masks(dc, n, device=d)}

        def on_plain(fn):
            saved = (A.fused_denoise, V.fused_softmax_mha)
            A.fused_denoise = functools.partial(fused_denoise,
                                                fns=SPLIT_PLAIN)
            V.fused_softmax_mha = softmax_mha_reference
            try:
                before = {f.__name__: f.launches for f in counted}
                out = fn()
                torch.cuda.synchronize()
                if {f.__name__: f.launches for f in counted} != before:
                    raise AssertionError("serve: the plain run launched a "
                                         "kernel")
            finally:
                A.fused_denoise, V.fused_softmax_mha = saved
            return out

        def call_inputs(gen_, batch, x, qm_fn):
            """The batch's mixed call and the exemplars' inversion call, on
            ``gen_``'s model and device."""
            d, m = gen_.device, gen_.model
            conds2, mask2, qm2, cm2 = double_conditions(
                m.encode_conditions(batch),
                latent_motion_mask(dc, batch["motion_mask"]), qm_fn(B, d))
            inv = {k: torch.as_tensor(np.asarray(v), device=d)
                   for k, v in re_dict["inv_conds"].items()}
            Q = inv["word"].shape[0]
            return {
                "batch": (x.to(d), mask2, conds2, qm2, cm2),
                "exemplars": (torch.as_tensor(re_dict["inv_latents"],
                                              device=d),
                              torch.as_tensor(re_dict["inv_mask"], device=d),
                              m.encode_conditions(
                                  {"word": inv["word"], "audio": inv["audio"],
                                   "speaker_ids": inv["speaker_ids"].long()}),
                              qm_fn(Q, d), torch.ones(Q, 1, 1, device=d))}

        # one denoiser call at the first and the last step: kernels and the
        # plain versions on the CPU, each against the plain versions on the
        # card, over valid tokens
        x = torch.randn(2 * B, dc.num_tokens, dc.latent_dim, generator=g,
                        device=dev)
        adaln = stack_adaln_weights(den)
        cpu_adaln = stack_adaln_weights(cpu_model.denoiser)
        call_err = {}
        for mname, qm_fn in masks.items():
            cpu_calls = call_inputs(cpu_gen, cbatch, x, qm_fn)
            k_err, c_err = {}, {}
            for name, (xc, mask, conds, qm, cm) in call_inputs(
                    gen, dbatch, x, qm_fn).items():
                valid = mask > 0
                cx, cmask, cconds, cqm, ccm = cpu_calls[name]
                for step in (0, gen.sched.num_timesteps - 1):
                    t = gen.sched.timestep_map[step].repeat(xc.shape[0])
                    k_out = fused_denoise(den, xc, t, mask, conds, qm, cm,
                                          gen.packs, adaln)
                    p_out = fused_denoise(den, xc, t, mask, conds, qm, cm,
                                          gen.packs, adaln, fns=SPLIT_PLAIN)
                    c_out = fused_denoise(cpu_model.denoiser, cx, t.cpu(),
                                          cmask, cconds, cqm, ccm,
                                          cpu_gen.packs, cpu_adaln,
                                          fns=SPLIT_PLAIN)
                    key = f"{name}_step{step}"
                    k_err[key] = (k_out - p_out)[valid].abs().max().item()
                    c_err[key] = ((c_out - p_out.cpu())[valid.cpu()]
                                  .abs().max().item())
            call_err[mname] = {"kernels": k_err, "cpu": c_err}
        z = first["out"]["output_latents"]
        k_dec = gen.model.decode_latents(z)
        p_dec = on_plain(lambda: gen.model.decode_latents(z))
        c_dec = cpu_model.decode_latents(z.cpu())
        call_err["decode"] = {
            "kernels": max((k_dec[k] - p_dec[k]).abs().max().item()
                           for k in k_dec),
            "cpu": max((c_dec[k] - p_dec[k].cpu()).abs().max().item()
                       for k in k_dec)}
        gated = [*call_err["true_sep"]["kernels"].values(),
                 call_err["decode"]["kernels"]]
        if not all(math.isfinite(e) and e <= TOL_SPLIT_DENOISER
                   for e in gated):
            raise AssertionError(f"serve: the guided batch's calls, kernels "
                                 f"vs plain {call_err} > "
                                 f"{TOL_SPLIT_DENOISER}")

        # the whole batch at the tool's steps, one set of draws (in the
        # generator's order), each run from empty inversion caches (they
        # are keyed by exemplar, not by query masks)
        opts = A.InferenceOptions(use_inversion=True, insertion_guidance=True)
        g = torch.Generator(device=dev).manual_seed(5)
        S = gen.sched.num_timesteps
        draws = {
            "coef_table": scale_func_table(
                gen.sched, arch.scale_func, arch.diffusion_train.diffusion_steps,
                generator=g) if arch.scale_func is not None
            else torch.zeros(S, 4, device=dev),
            "noise": torch.randn(B, dc.num_tokens, dc.latent_dim,
                                 generator=g, device=dev)}
        draws["in_seq_noise"] = torch.randn(S, *draws["noise"].shape,
                                            generator=g, device=dev)

        def guided(gen_, batch=dbatch, qm=None):
            gen_._inv_cache.clear()
            gen_._inv_stack_cache.clear()
            return gen_(batch, None, opts, re_dict, query_masks=qm, **{
                k: v.to(gen_.device) for k, v in draws.items()})

        def plain_clip(qm=None):
            return on_plain(lambda: guided(A.StagedGenerator(
                gen.model, gen.sched, fused=False, graphs=False), qm=qm))

        # the latents over the batch's valid tokens (the separators' rows
        # are read by nothing)
        tokens = (latent_motion_mask(dc, dbatch["motion_mask"]) > 0).cpu()

        def clip_diff(a, b):
            d = {k: (a[k].cpu() - b[k].cpu()).abs() for k in a
                 if k != "prev_latentout"}
            d["output_latents"] = d["output_latents"][tokens]
            return {k: v.max().item() for k, v in d.items()}

        true_qm = masks["true_sep"](1, dev)
        p_tool = plain_clip()
        t0 = time.perf_counter()
        c_tool = guided(cpu_gen, batch=cbatch)
        cpu_clip_s = time.perf_counter() - t0
        batch_err = {
            "true_sep": {"kernels": clip_diff(guided(gen, qm=true_qm),
                                              plain_clip(true_qm))},
            "tool": {"kernels": clip_diff(guided(gen), p_tool),
                     "cpu": clip_diff(c_tool, p_tool),
                     "plain_repeat": clip_diff(plain_clip(), p_tool)}}
        del cpu_model, cpu_gen
        if not (batch_err["true_sep"]["kernels"]["output_latents"]
                <= TOL_SPLIT_DENOISER
                and not any(batch_err["tool"]["plain_repeat"].values())):
            raise AssertionError(
                f"serve: the whole guided batch, kernels vs plain "
                f"{batch_err['true_sep']} > {TOL_SPLIT_DENOISER} on the "
                f"latents, or the plain run is not deterministic "
                f"{batch_err['tool']['plain_repeat']}")
        return {"phase": "serve", "config": config,
                "options": SERVE_OPTIONS + ["--inv-cache"],
                "write_raw_s": write_s, "runs": runs,
                "retrieval_vs_cpu_max_abs_err": re_err,
                "retrieval_tolerance": TOL_SERVE_RETRIEVAL,
                "guided_calls_vs_plain_max_abs_err": call_err,
                "guided_batch_vs_plain_max_abs_diff": batch_err,
                "guided_tolerance": TOL_SPLIT_DENOISER,
                "guided_cpu_clip_s": cpu_clip_s}
    finally:
        if own_ws:
            shutil.rmtree(ws, ignore_errors=True)


LONGFORM_OPTIONS = ["--retrieval-method", "gesture_type", "--use-inversion",
                    "--insertion-guidance", "--guidance-iters", "constant"]


def longform_phase(torch, dev, ws, config: str = SERVE_CONFIG,
                   n_sec: int = 30, config_options=()) -> dict:
    """Phase 15: the port's long-form tool (``raggesture_tpu_torch.tools.
    longform_synthesis.main``) in this process on ``config`` (the shipped
    full width by default), on the workspace ``ws`` of phase 14 (written
    here when it is not there yet, with random weights from seed 11):
    gesture-type retrieval, inversion and insertion guidance over the 2
    test clips, once one clip a wave and once two.  The checks listed in
    the module docstring.  Returns the phase's JSON line."""
    import os

    import numpy as np

    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.beatx import collate
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models import vae as V
    from raggesture_tpu_torch.models.codec import PART_NAMES
    from raggesture_tpu_torch.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        fused_denoise,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import self_attention as SA
    from raggesture_tpu_torch.ops.decoder_layer import fused_decoder_layer
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        mha_supported,
        softmax_mha_reference,
    )
    from raggesture_tpu_torch.tools import longform_synthesis as tool
    from raggesture_tpu_torch.train.checkpoint import save_params
    from raggesture_tpu_torch.train.runner import device_batch

    counted = (fused_decoder_layer, fused_softmax_mha,
               SA.fused_self_attention, CA.fused_cross_attention)
    options, _ = write_workspace(ws, n_sec, config_options)
    cfg = Config.fromfile(config)
    cfg.merge_option_strings(options[1:])
    arch = arch_config_from(cfg.model)
    dc = arch.denoiser
    cc = arch.codec
    t_dec = cc.tokens_per_part + cc.num_frames
    decode_on_k2 = any(mha_supported(t_dec, t_dec, cc.latent_dim,
                                     8 * cc.vae_config(part).num_heads)
                       for part in PART_NAMES)
    ckpt = os.path.join(ws, "params.pt")
    if not os.path.exists(ckpt):
        save_params(ckpt, A.create_model(arch, device=dev, seed=11,
                                         zero_init_std=0.02), {"seed": 11})
    fps = cfg.data.test.pose_fps
    clip_frames = n_sec * fps

    def launches_now():
        return {fn.__name__: fn.launches for fn in counted}

    def zero_launches():
        for fn in counted:
            fn.launches = 0

    runs, kept = {}, {}
    for cb in (1, 2):
        waves, held = [], []

        def on_wave(w):
            torch.cuda.synchronize()
            launches = launches_now()
            zero_launches()
            st = w["stats"]
            route = ("first" if w["prev_latent"] is None
                     else "guided_inseq" if w["opts"].insertion_guidance
                     else "sample_inseq")
            waves.append(dict(st, route=route, launches=launches))
            # a held result survives every later replay
            held.append((w["out"]["prev_latentout"],
                         w["out"]["prev_latentout"].clone()))
            if not all(torch.equal(a, b) for a, b in held):
                raise AssertionError(f"longform clip-batch {cb}: a held "
                                     f"prev_latentout changed at wave "
                                     f"{st['group']}.{st['chunk']}")
            if cb == 1 and st["group"] == 0 and st["chunk"] < 2:
                kept[st["chunk"]] = w

        zero_launches()
        t0 = time.perf_counter()
        report = tool.main(
            [config, ckpt, "--out-dir", os.path.join(ws, f"longform_{cb}"),
             "--seed", "3", "--clip-batch", str(cb)] + LONGFORM_OPTIONS
            + options, on_wave=on_wave)
        wall_s = time.perf_counter() - t0
        # every wave after its clip's first takes the guided handoff
        later = [b for b in waves if b["route"] != "first"]
        if not later or any(b["route"] != "guided_inseq" for b in later):
            raise AssertionError(f"longform clip-batch {cb}: routes "
                                 f"{[b['route'] for b in waves]}")
        for b in waves:
            lk = b["launches"]
            if lk["fused_decoder_layer"] or (b["graph_captures"] and not (
                    bool(lk["fused_softmax_mha"]) == decode_on_k2
                    and lk["fused_self_attention"]
                    and lk["fused_cross_attention"])):
                raise AssertionError(f"longform clip-batch {cb}: wave "
                                     f"{b['group']}.{b['chunk']} "
                                     f"({b['graph_captures']} graphs "
                                     f"captured) launched {lk}")
            if not b["graph_captures"] and any(lk.values()):
                raise AssertionError(f"longform clip-batch {cb}: a replayed "
                                     f"wave launched from Python: {lk}")
        total = {n: sum(b["launches"][n] for b in waves)
                 for n in waves[0]["launches"]}
        if not (total["fused_self_attention"]
                and total["fused_cross_attention"]
                and bool(total["fused_softmax_mha"]) == decode_on_k2):
            raise AssertionError(f"longform clip-batch {cb}: a kernel of "
                                 f"the path was never launched: {total}")
        # the stitched take: the clip's frames at 30 fps, finite
        for clip in report["clips"]:
            d = np.load(os.path.join(ws, f"longform_{cb}", clip["name"],
                                     "full_pred_motion.npz"))
            want = (2 * clip_frames, 165)
            if (clip["chunks"] != len(tool.chunk_starts(
                    clip_frames, dc.max_seq_len, dc.frame_chunk_size))
                    or d["poses"].shape != want
                    or not all(np.isfinite(d[k]).all()
                               for k in ("poses", "expressions", "trans"))):
                raise AssertionError(f"longform clip-batch {cb}: {clip}, "
                                     f"poses {d['poses'].shape}")
        captured = [b for b in waves if b.get("graph_captures")]
        runs[f"clip_batch_{cb}"] = {
            "stages": report["stages"], "clips": report["clips"],
            "waves": waves, "wall_s": wall_s,
            "graph_captures": sum(b["graph_captures"] for b in waves),
            "capture_s": sum(b["capture_s"] for b in waves),
            "generate_ms_capturing": [b["generate_ms"] for b in captured],
            "generate_ms_replayed": [b["generate_ms"] for b in waves
                                     if not b["graph_captures"]],
            "inv_cache_hits": sum(b["inv_cache_hits"] for b in waves),
            "launches_on_a_capture": captured[-1]["launches"],
            "held_results_checked": len(held)}

    # the two staged pipelines on a handoff wave: a replay bitwise equal to
    # the eager run, and no Python launch during it
    w = kept[1]
    if w["stats"]["num_queries"] <= 0:
        raise AssertionError(f"longform: the handoff wave retrieved "
                             f"nothing: {w['stats']}")
    gen = w["generator"]
    batch = device_batch(collate(w["chunks"]), dev)
    eager = A.StagedGenerator(gen.model, gen.sched, fused=False,
                              graphs=False)
    same = {}
    for name, opts in (
            ("guided_inseq", w["opts"]),
            ("invert_sample_prev", A.InferenceOptions(
                use_inversion=True, use_prev_latent=True)),
            ("invert_sample", A.InferenceOptions(use_inversion=True))):
        def call(g, opts=opts):
            return g(batch, None, opts, w["re_dict"], None,
                     w["prev_latent"], **w["draws"])

        want = call(eager)
        captures = gen.graphs.captures
        first = call(gen)               # captured here unless the tool did
        torch.cuda.synchronize()
        zero_launches()
        replay = call(gen)
        torch.cuda.synchronize()
        if (launches_now() != {fn.__name__: 0 for fn in counted}
                or not all(torch.equal(first[k], want[k])
                           and torch.equal(replay[k], want[k])
                           for k in want)):
            raise AssertionError(f"longform: {name}'s replay differs from "
                                 f"its eager run, or it launched "
                                 f"{launches_now()}")
        same[name] = {"captured_now": gen.graphs.captures - captures,
                      "replay_equals_eager": True}

    # a 2-chunk handoff take with guidance, kernels against the plain
    # versions on the card, from empty inversion caches, on the tool's
    # draws; gated under true-separator query masks, and under the tool's
    # quirk masks reported beside it
    def take(qm, plain):
        saved = (A.fused_denoise, V.fused_softmax_mha)
        if plain:
            A.fused_denoise = functools.partial(fused_denoise,
                                                fns=SPLIT_PLAIN)
            V.fused_softmax_mha = softmax_mha_reference
        try:
            before = launches_now()
            g = A.StagedGenerator(gen.model, gen.sched, fused=False,
                                  graphs=False)
            outs, prev = [], None
            for k in (0, 1):
                wk = kept[k]
                outs.append(g(device_batch(collate(wk["chunks"]), dev),
                              None, wk["opts"], wk["re_dict"], None, prev,
                              query_masks=qm, **wk["draws"]))
                prev = outs[-1]["prev_latentout"]
            torch.cuda.synchronize()
            if plain and launches_now() != before:
                raise AssertionError("longform: the plain take launched a "
                                     "kernel")
        finally:
            A.fused_denoise, V.fused_softmax_mha = saved
        return outs

    tokens = (latent_motion_mask(dc, batch["motion_mask"]) > 0)
    take_err = {}
    for mname, qm in (("true_sep", parity_query_masks(torch, dc, 1, dev)),
                      ("tool", None)):
        k_outs, p_outs = take(qm, False), take(qm, True)
        take_err[mname] = [
            {"latents": (ko["output_latents"] - po["output_latents"])[
                tokens].abs().max().item(),
             "pose": max((ko[n] - po[n]).abs().max().item()
                         for n in ko if n.startswith("pred_")),
             "finite": all(torch.isfinite(ko[n]).all().item()
                           for n in ko if n.startswith("pred_"))}
            for ko, po in zip(k_outs, p_outs)]
    gated = take_err["true_sep"]
    if not all(e["latents"] <= TOL_SPLIT_DENOISER and e["finite"]
               for e in gated):
        raise AssertionError(f"longform: the 2-chunk take, kernels vs "
                             f"plain {gated} > {TOL_SPLIT_DENOISER}")
    return {"phase": "longform", "config": config,
            "options": LONGFORM_OPTIONS, "clip_frames": clip_frames,
            "runs": runs, "pipelines": same,
            "take_vs_plain_max_abs_diff": take_err,
            "take_tolerance": TOL_SPLIT_DENOISER}


def train_options_rows(torch, dev, model, state, tbatch, rt, draws,
                       sched_train, generator, ws, kernel_grad_err,
                       harness_gb: float) -> dict:
    """Phase 16's rows for the training step's options, at full width and
    batch 128: the latent cache built from phase 14's train windows (its
    seconds and windows/s), a step that reads it (ms, device ms, K3's
    launches and kernel instances, peak memory, also less ``harness_gb``,
    what the phase holds besides the training, gradients on the kernels
    against plain), the 4-step loop's ms a step beside the single step's
    (each timed over 4 steps on the same batch, alternately, twice), and
    one clipped AdamW step."""
    from raggesture_tpu_torch.builders import beatx_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.beatx import collate
    from raggesture_tpu_torch.datasets.build import build_dataset
    from raggesture_tpu_torch.datasets.latent_cache import (
        LatentCachedDataset,
        build_latent_cache,
    )
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_multi_train_step,
        make_train_step,
    )
    from raggesture_tpu_torch.train.runner import device_batch

    B = next(iter(tbatch.values())).shape[0]
    k3_fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
    train_step = make_train_step(sched_train)

    def timed_steps(step_fn, batch, steps=5, per_call=1):
        step_fn(state, batch, generator)                  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step_fn(state, batch, generator)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (steps * per_call)

    # the latent cache over phase 14's train windows
    options, _ = write_workspace(ws, 30)
    cfg = Config.fromfile(SERVE_CONFIG)
    cfg.merge_option_strings(options[1:])
    train_ds = build_dataset(beatx_config_from(cfg.data.train))
    path = os.path.join(ws, "latents")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_latent_cache(train_ds, model, path, batch_size=64)
    cache_s = time.perf_counter() - t0
    cached = LatentCachedDataset(train_ds, path, params=model)
    cbatch = device_batch(collate([cached[i % len(cached)]
                                   for i in range(B)]), dev)
    if "latent_mu" not in cbatch or "motion_upper" in cbatch:
        raise AssertionError(f"the cached batch holds {sorted(cbatch)}")

    # a step that reads the cache: K3's launches, ms, peak memory, device
    for fn in k3_fns:
        fn.launches = 0
    train_step(state, cbatch, generator)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in k3_fns}
    if launches != {fn.__name__: 3 for fn in k3_fns}:
        raise AssertionError(f"K3 launches in a cached step {launches}")
    torch.cuda.reset_peak_memory_stats()
    cached_ms = timed_steps(train_step, cbatch)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    by_kernel, ops, prof = device_profile(
        torch, lambda: train_step(state, cbatch, generator))
    inst = instances_by_kernel(prof)
    k3_inst = {n: sum(c for k, c in inst.items() if k.split("::")[-1] == n)
               for names in K3_KERNELS.values() for n in names}
    if any(c != 3 for n, c in k3_inst.items() if n != "ctx_fwd_merge"):
        raise AssertionError(f"K3 kernel instances in a cached step "
                             f"{k3_inst}")
    T, D = cbatch["latent_mu"].shape[1:]
    cdraws = dict(draws, enc_eps=rt(B, T, D))
    c_loss_k, c_loss_p, c_err, c_at, c_zero = kernel_grad_err(
        cbatch, cdraws, "cached-step")

    # k steps over a stacked batch against k single steps, timed the same
    # way (one warm-up call, then k steps) and alternately
    k = 4
    stacked = {n: v.expand(k, *v.shape) for n, v in tbatch.items()}
    multi_step = make_multi_train_step(sched_train)
    single_ms, multi_ms = [], []
    for _ in range(2):
        single_ms.append(timed_steps(train_step, tbatch, steps=k))
        multi_ms.append(timed_steps(multi_step, stacked, steps=1,
                                    per_call=k))

    # one clipped AdamW step
    cstate = create_train_state(model, OptimConfig(grad_clip=1.0,
                                                   weight_decay=0.01))
    clogs = {n: v.item() for n, v in train_step(cstate, cbatch,
                                                generator).items()}
    if not (all(math.isfinite(v) for v in clogs.values())
            and all(torch.isfinite(p).all()
                    for p in model.denoiser.parameters())):
        raise AssertionError(f"the clipped AdamW step is not finite {clogs}")
    return {
        "latent_cache": {"windows": len(train_ds), "build_s": cache_s,
                         "windows_per_s": len(train_ds) / cache_s},
        "cached_step": {
            "ms_per_step": cached_ms, "samples_per_s": B * 1e3 / cached_ms,
            "peak_mem_gb": peak_gb,
            "peak_without_harness_gb": peak_gb - harness_gb,
            "profiled_device_ms": sum(by_kernel.values()),
            "device_ops": ops, "k3_launches": launches,
            "k3_kernel_instances": k3_inst, "loss_kernels": c_loss_k,
            "loss_plain": c_loss_p, "grad_rel_err_max": c_err,
            "grad_rel_err_at": c_at, "zero_exact_gradient_max": c_zero,
            "grad_tolerance": TOL_TRAIN_GRAD},
        "multi_step": {"k": k, "ms_per_step": multi_ms,
                       "single_step_ms": single_ms},
        "clipped_adamw_step": {"grad_clip": 1.0, "weight_decay": 0.01,
                               "logs": clogs}}


def bf16_step_rows(torch, dev, model, tbatch, draws, sched_train, generator,
                   step_grads, harness_gb: float) -> dict:
    """Phase 16's row for one ``bf16_compute`` step at batch 128 (bf16
    mixed precision: K3's bf16 entry points): ms a step (CUDA events over
    5 steps), device ms and K3's device ms and kernel instances over one
    profiled step, K3's launches, peak memory (also less ``harness_gb``),
    the frozen bf16 encode's ms; its gradients on the kernels against the
    plain versions on the same bf16 draws (gated, TOL_TRAIN_GRAD_BF16),
    the master parameters and Adam's moments float32 after the steps
    (gated), and the distance of its gradients from the float32 step's
    (``step_grads``) on the same draws (reported)."""
    import copy

    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts_plain,
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        bf16_loss,
        create_train_state,
        make_train_step,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    B = next(iter(tbatch.values())).shape[0]
    k3_fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
    state = create_train_state(model, OptimConfig(bf16_compute=True))
    step = make_train_step(sched_train, bf16_compute=True)
    for fn in k3_fns:
        fn.launches = 0
    step(state, tbatch, generator)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in k3_fns}
    if launches != {fn.__name__: 3 for fn in k3_fns}:
        raise AssertionError(f"K3 launches in a bf16 step {launches}")
    step(state, tbatch, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        logs = step(state, tbatch, generator)
    end.record()
    end.synchronize()
    host_s = (time.perf_counter() - t0) / steps
    step_ms = start.elapsed_time(end) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    logs = {k: v.item() for k, v in logs.items()}
    moments = [v for st in state.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0]
    if not (all(math.isfinite(v) for v in logs.values())
            and all(p.dtype == f32 for p in model.parameters())
            and moments and all(v.dtype == f32 for v in moments)):
        raise AssertionError(f"the bf16 step: logs {logs}, parameter "
                             f"dtypes {({p.dtype for p in model.parameters()})}"
                             f", moment dtypes {({v.dtype for v in moments})}")
    by_kernel, ops, prof = device_profile(
        torch, lambda: step(state, tbatch, generator))
    inst = instances_by_kernel(prof)
    k3_inst = {n: sum(c for k, c in inst.items() if k.split("::")[-1] == n)
               for names in K3_KERNELS.values() for n in names}
    if any(c != 3 for n, c in k3_inst.items() if n != "ctx_fwd_merge"):
        raise AssertionError(f"K3 kernel instances in a bf16 step {k3_inst}")
    k3_ms = sum(v for k, v in by_kernel.items()
                if any(k.split("::")[-1] in ns for ns in K3_KERNELS.values()))
    codec = copy.deepcopy(model.codec).to(bf16)
    bb = {k: v.to(bf16) if v.dtype == f32 else v for k, v in tbatch.items()}
    eps = {p: e.to(bf16) for p, e in draws["enc_eps"].items()}
    with torch.no_grad():
        encode_ms = cuda_ms(torch, lambda: codec.encode(
            model._part_features(bb), bb["motion_mask"], eps),
            iters=3, warmup=1)
    del codec

    # gradients: the kernels against the plain versions, and against the
    # float32 step, on the same draws
    bdraws = dict(draws, enc_eps=eps, noise=draws["noise"].to(bf16),
                  cond_mask=draws["cond_mask"].to(bf16))
    cache = {}

    def grads(**kw):
        model.denoiser.zero_grad(set_to_none=True)
        loss, _ = bf16_loss(model, sched_train, tbatch, None, cache,
                            **bdraws, **kw)
        loss.backward()
        return loss.item(), {k: v.grad.clone()
                             for k, v in model.denoiser.named_parameters()}

    loss_k, g_k = grads()
    loss_p, g_p = grads(ctx_fn=functools.partial(cond_contexts_plain,
                                                 operand_dtype=bf16))
    loss_32, g_32 = step_grads(tbatch, draws)
    model.denoiser.zero_grad(set_to_none=True)

    def rel(a, b):
        return {k: ((a[k] - b[k]).abs().max() / b[k].abs().max()).item()
                for k in a if not zero_exact_gradient(k)}

    err = rel(g_k, g_p)
    worst = max(err, key=err.get)
    if not err[worst] <= TOL_TRAIN_GRAD_BF16:
        raise AssertionError(f"bf16 step gradients, kernels vs plain: "
                             f"{worst} {err[worst]} > {TOL_TRAIN_GRAD_BF16}")
    dist = rel(g_k, g_32)
    far = max(dist, key=dist.get)
    return {"batch": B, "steps_timed": steps, "ms_per_step": step_ms,
            "samples_per_s": B * 1e3 / step_ms, "host_s_per_step": host_s,
            "profiled_device_ms": sum(by_kernel.values()), "device_ops": ops,
            "k3_device_ms": k3_ms, "k3_launches": launches,
            "k3_kernel_instances": k3_inst, "codec_encode_bf16_ms": encode_ms,
            "peak_mem_gb": peak_gb,
            "peak_without_harness_gb": peak_gb - harness_gb, "logs": logs,
            "loss_kernels": loss_k, "loss_plain": loss_p,
            "grad_rel_err_max": err[worst], "grad_rel_err_at": worst,
            "grad_tolerance": TOL_TRAIN_GRAD_BF16,
            "loss_float32_step": loss_32,
            "grad_dist_from_float32_max": dist[far],
            "grad_dist_from_float32_at": far,
            "grad_dist_from_float32_median": sorted(dist.values())[
                len(dist) // 2]}


TRAIN_TOOL_CUTS = ["runner.max_epochs=2", "log_config.tensorboard=False"]


def train_tool_phase(torch, dev, ws, config: str = SERVE_CONFIG,
                     batch: int = 32, config_options=()) -> dict:
    """Phase 17: the port's training tool (``raggesture_tpu_torch.tools.
    train.main``) in this process on phase 14's workspace ``ws`` at
    ``config``'s width, device batch ``batch``, 2 epochs, one step a
    batch, validation on the train windows (the workspace's 6 test
    windows are fewer than a batch): (a) the live encode in bf16
    (``optimizer.bf16=True``) with validation; (b) from the latent cache,
    streaming, and (c) the same with ``--cond-bank 128``, whose
    metrics.jsonl losses must equal (b)'s bitwise; (d) (c) resumed from
    latest to a third epoch.  Per run its steps/s and samples/s, each
    epoch's seconds, the bank's hits and misses, the checkpoints written,
    K3's launches (3 of each wrapper a step; the forward's also 3 a
    validation batch), every logged value finite, every parameter on the
    card."""
    import json
    import os
    import shutil

    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.tools import train as tool

    k3_fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
    options, _ = write_workspace(ws, 30, config_options)
    root = os.path.join(ws, "beat2")
    val = [f"data.val.{k}={v}" for k, v in (
        ("data_path", root), ("cache_path", os.path.join(ws, "cache")),
        ("allow_fake_contacts", True), ("split", "train"))]
    common = ["--device-batch-size", str(batch)]
    latents = ["--latent-cache", os.path.join(ws, "tool_latents"),
               "--no-validate"]
    runs = {"a_live_bf16": ([], ["optimizer.bf16=True", *val]),
            "b_cached": (latents, []),
            "c_cached_bank": (latents + ["--cond-bank", "128"], []),
            "d_resumed": (latents + ["--cond-bank", "128", "--resume-from"],
                          ["runner.max_epochs=3"])}
    out = {}
    for name, (flags, opts) in runs.items():
        # run d resumes run c's work dir
        wd = os.path.join(ws, "train_" + ("c" if name[0] == "d" else name[0]))
        for fn in k3_fns:
            fn.launches = 0
        t0 = time.perf_counter()
        stats = tool.main([config, "--work-dir", wd, *common, *flags,
                           *options, *TRAIN_TOOL_CUTS, *opts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            rows = [json.loads(l) for l in f]
        steps = sum(e["steps"] for e in stats["epochs"])
        val_rows = [r for r in rows if r["prefix"] == "val"]
        val_batches = stats.get("val_batches", 0)
        launches = {fn.__name__: fn.launches for fn in k3_fns}
        want = {"cond_ctx_forward": 3 * (steps + val_batches),
                "cond_ctx_backward_a": 3 * steps,
                "cond_ctx_backward_b": 3 * steps}
        values = [v for r in rows for v in r.values()
                  if isinstance(v, float)]
        if (launches != want or not steps
                or not all(math.isfinite(v) for v in values)
                or stats["param_devices"] != ["cuda:0"]
                or (name == "a_live_bf16") != bool(val_rows)):
            raise AssertionError(f"train_tool run {name}: launches "
                                 f"{launches} (expected {want}), {steps} "
                                 f"steps, parameters on "
                                 f"{stats['param_devices']}, {len(val_rows)} "
                                 f"val rows, finite {all(map(math.isfinite, values))}")
        out[name] = {
            "steps": steps, "train_s": stats["train_s"], "wall_s": wall,
            "steps_per_s": steps / stats["train_s"],
            "samples_per_s": steps * batch / stats["train_s"],
            "epoch_wall_s": [e["wall_s"] for e in stats["epochs"]],
            "bank": stats.get("bank"), "checkpoints": stats["checkpoints"],
            "k3_launches": launches, "val_batches": val_batches,
            "losses": [r["recon_loss"] for r in rows
                       if r["prefix"] == "train"]}
        if name[0] in "ab":     # ~2.3 GB a checkpoint at full width
            shutil.rmtree(os.path.join(wd, "checkpoints"))
    b, c = out["b_cached"]["losses"], out["c_cached_bank"]["losses"]
    if b != c or out["d_resumed"]["steps"] != out["b_cached"]["steps"] // 2:
        raise AssertionError(f"train_tool: banked losses {c} against "
                             f"streaming {b}, or the resume ran "
                             f"{out['d_resumed']['steps']} steps")
    return {"phase": "train_tool", "config": config, "batch": batch,
            "cuts": TRAIN_TOOL_CUTS + ["--device-batch-size %d" % batch],
            "banked_equals_streaming": True, "runs": out}


# the stand-ins of phase evaluate (the release's shapes, values from a seed)
SMPLX_VERTICES = 10475
SMPLX_JOINTS = 55
SMPLX_FACES = 20908
EVAL_CONTINUOUS = ("l1div", "l1div_gt", "diversity", "mpjpe_retrieval",
                   "face_l2", "face_lvd")
EVAL_KEYS = ("fgd", "align", "srgr") + EVAL_CONTINUOUS
# phase evaluate's gates: FK on the card against the CPU within TOL_FK of
# the largest magnitude (float32 products on both, summed in other orders);
# one clip's FGD latents within TOL_FGD; the continuous summary keys within
# TOL_EVAL relative (host metrics over those FK and FGD outputs)
TOL_FK = 1e-5
TOL_FGD = 1e-4
TOL_EVAL = 1e-3


def write_smplx_standin(path: str, seed: int = 0) -> None:
    """An SMPL-X npz in the release layout at its shapes: 10,475 vertices,
    55 joints on the SMPL-X tree (``kintree_table``), ``shapedirs`` (V, 3,
    400) of 300 betas then 100 expressions, ``posedirs`` (486, V*3), a
    ``J_regressor`` and skinning ``weights`` whose rows sum to one.  Sizes
    as the release's: a body about a metre tall, blend shapes scaled by
    0.01 (pose correctives 1e-3).  Each vertex belongs to one joint and is
    skinned to it and its parent; the 20,908 faces (``f``) join a vertex to
    its nearest neighbours of the same joint."""
    import numpy as np

    from raggesture_tpu_torch.models.eval_fgd import default_smplx_parents

    r = np.random.RandomState(seed)
    V, J = SMPLX_VERTICES, SMPLX_JOINTS
    parents = default_smplx_parents().astype(np.int64)
    joints = np.zeros((J, 3), np.float32)
    for j in range(1, J):
        joints[j] = joints[parents[j]] + (r.rand(3) - 0.5) * 0.2
    owner = np.arange(V) * J // V
    v_template = (joints[owner] + r.randn(V, 3) * 0.03).astype(np.float32)
    j_reg = np.zeros((J, V), np.float32)
    j_reg[owner, np.arange(V)] = 1.0
    j_reg /= j_reg.sum(1, keepdims=True)
    weights = np.zeros((V, J), np.float32)
    u = r.uniform(0.5, 1.0, V).astype(np.float32)
    u[owner == 0] = 1.0
    weights[np.arange(V), owner] = u
    weights[np.arange(V), np.maximum(parents[owner], 0)] += 1.0 - u
    # the release's 20,908 triangles, as small as a body mesh's: each
    # vertex with its nearest and second-nearest neighbours of the same
    # joint, and with its second and third
    faces = []
    for j in range(J):
        ids = np.nonzero(owner == j)[0]
        p = v_template[ids]
        d = ((p[:, None] - p[None]) ** 2).sum(-1)
        near = ids[np.argsort(d, axis=1, kind="stable")[:, 1:4]]
        faces.append(np.stack([ids, near[:, 0], near[:, 1]], 1))
        faces.append(np.stack([ids, near[:, 1], near[:, 2]], 1))
    faces = np.concatenate(faces)[:SMPLX_FACES]
    np.savez(path, v_template=v_template,
             shapedirs=(r.randn(V, 3, 400) * 0.01).astype(np.float32),
             posedirs=(r.randn(9 * (J - 1), V * 3) * 1e-3).astype(np.float32),
             J_regressor=j_reg, weights=weights,
             kintree_table=np.stack([parents, np.arange(J)]),
             f=faces.astype(np.int32))


def write_fgd_standin(path: str, seed: int = 0) -> None:
    """The reference FGD checkpoint's stand-in (``fgd_standin_state``) as
    a ``{"model_state": ...}`` file."""
    import torch

    torch.save({"model_state": fgd_standin_state(seed)}, path)


def fgd_standin_state(seed: int = 0) -> dict:
    """The reference FGD checkpoint's state on the 56 keys and shapes of
    AESKConv_240_100.bin (``tests/fixtures/golden_keys_fgd.json``), its
    masks and pool matrices the reference's (``golden_fgd_topology.npz``),
    weights from the seed (small, so that tanh stays off saturation)."""
    import numpy as np
    import torch

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures")
    with open(os.path.join(fix, "golden_keys_fgd.json")) as f:
        golden = json.load(f)
    topo = np.load(os.path.join(fix, "golden_fgd_topology.npz"))
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(
        topo[k].astype(np.float32) if k in topo.files
        else (r.randn(*shape) * 0.05).astype(np.float32))
        for k, shape in golden.items()}


def evaluate_phase(torch, dev, ws, config: str = SERVE_CONFIG,
                   config_options=()) -> dict:
    """Phase 18: the port's evaluation tools on phase 14's result
    directories (``ws/results_0``) with the stand-in SMPL-X asset and FGD
    checkpoint and an ``--avg-vel`` of the GT joints' mean speeds: (a)
    ``tools.evaluate`` with ``--srgr`` on the card, and again with
    ``--device cpu``; (b) ``tools.evaluate_divonly``; (c)
    ``tools.evaluate_mm`` over results_0 (seed 3) and one more serving run
    with ``--seed 4 --max-batches 1``; foot contacts by FK in
    ``featurize_clip`` for the workspace's clips on the card and on the
    CPU.  Per run its seconds and those of its FK, FGD and host metrics; one
    profiled result directory's device busy share.  Gates: every summary
    key finite; one directory's joints and face vertices on the card within
    TOL_FK of the largest magnitude of the CPU's, one clip's FGD latents
    within TOL_FGD; the continuous keys within TOL_EVAL relative of the
    CPU's (fgd, align, srgr reported beside the CPU's, with the beats and
    SRGR hits that differ, the beats of the predicted and of the GT
    joints); the contacts equal the CPU's but where a foot's speed lies
    within 1e-6 of the threshold."""
    import numpy as np

    from raggesture_tpu_torch.builders import beatx_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.beatx import (
        StubFeatureExtractor,
        featurize_clip,
    )
    from raggesture_tpu_torch.datasets.build import (
        load_raw_clip,
        read_split_csv,
    )
    from raggesture_tpu_torch.eval import metrics as M
    from raggesture_tpu_torch.eval.evaluator import (
        _load_pose,
        find_result_dirs,
        pose_aa_to_6d_np,
    )
    from raggesture_tpu_torch.models.smplx import lbs, load_smplx
    from raggesture_tpu_torch.tools import evaluate as ev_tool
    from raggesture_tpu_torch.tools import evaluate_divonly, evaluate_mm
    from raggesture_tpu_torch.tools import visualize
    from raggesture_tpu_torch.utils.logger import get_root_logger

    results = os.path.join(ws, "results_0")
    dirs = find_result_dirs(results)
    asset = os.path.join(ws, "SMPLX_NEUTRAL_2020.npz")
    fgd_bin = os.path.join(ws, "AESKConv_240_100.bin")
    t0 = time.perf_counter()
    write_smplx_standin(asset, seed=0)
    write_fgd_standin(fgd_bin, seed=0)
    standin_s = time.perf_counter() - t0
    models = {"card": load_smplx(asset, device=dev),
              "cpu": load_smplx(asset, device="cpu")}
    fk = {k: ev_tool.build_fk_fn("", model=m) for k, m in models.items()}
    face_fk = {k: ev_tool.build_face_fk_fn("", model=m)
               for k, m in models.items()}
    fgd = {k: ev_tool.build_fgd_fn(fgd_bin, device=d)
           for k, d in (("card", dev), ("cpu", "cpu"))}

    def fk_joints(f, path):
        """A result file's joints as the evaluator FKs them: transl and
        expressions zeroed, the file's betas."""
        p, _, _, b = _load_pose(path, 300)
        n = len(p)
        return f(p, np.zeros((n, 3), np.float32),
                 np.zeros((n, 100), np.float32), b)

    # --avg-vel: the GT joints' mean speed per joint over the directories
    speeds = [np.linalg.norm(np.diff(fk_joints(
        fk["card"], os.path.join(d, "gt_motion.npz")), axis=0), axis=-1) * 30
        for d in dirs]
    # the root, under zeroed translation, stands still: floored at 1e-6
    avg_vel = np.maximum(np.concatenate(speeds).mean(0), 1e-6)
    avg_vel_path = os.path.join(ws, "avg_vel.npy")
    np.save(avg_vel_path, avg_vel)

    # FK and FGD of one directory on the card against the CPU
    pose, trans, exps, betas = _load_pose(
        os.path.join(dirs[0], "pred_motion.npz"), 300)
    T = len(pose)
    zeros = (np.zeros((T, 3), np.float32), np.zeros((T, 100), np.float32))
    fk_err = {}
    for name, call in (("joints", lambda f, g: f(pose, *zeros, betas)),
                       ("face_vertices",
                        lambda f, g: g(pose, exps, betas))):
        card = call(fk["card"], face_fk["card"])
        cpu = call(fk["cpu"], face_fk["cpu"])
        fk_err[name] = {"max_abs_err": float(np.abs(card - cpu).max()),
                        "scale": float(np.abs(cpu).max())}
    p6 = pose_aa_to_6d_np(pose[: T - T % 32], dev)[None]
    lat = {k: fn(p6) for k, fn in fgd.items()}
    fgd_err = float(np.abs(lat["card"] - lat["cpu"]).max())
    if not (all(e["max_abs_err"] <= TOL_FK * e["scale"]
                for e in fk_err.values()) and fgd_err <= TOL_FGD):
        raise AssertionError(f"evaluate: FK on the card vs the CPU {fk_err} "
                             f"(tolerance {TOL_FK} of the scale), FGD "
                             f"latents {fgd_err} > {TOL_FGD}")

    # the beats (of the predicted and the GT joints) and the SRGR hits that
    # the card's joints and the CPU's count differently: beat alignment's
    # and SRGR's thresholds read them
    align = M.BeatAlignment(mean_velocity=avg_vel)
    beats_counted = beat_flips = hits_counted = hit_flips = 0
    for d in dirs:
        joints = {(side, k): fk_joints(f, os.path.join(d, f"{side}_motion.npz"))
                  for side in ("pred", "gt") for k, f in fk.items()}
        n = min(len(v) for v in joints.values())
        joints = {key: v[:n] for key, v in joints.items()}
        for side in ("pred", "gt"):
            beats = {k: align.motion_beats(joints[side, k].reshape(n, -1), 30,
                                           t_start=10, t_end=n - 10)
                     for k in fk}
            beats_counted += sum(map(len, beats["cpu"]))
            beat_flips += sum(len(set(a.tolist()) ^ set(b.tolist()))
                              for a, b in zip(beats["card"], beats["cpu"]))
        hits = {k: np.abs(joints["pred", k] - joints["gt", k]).sum(-1) < 0.3
                for k in fk}
        hits_counted += int(hits["cpu"].sum())
        hit_flips += int((hits["card"] != hits["cpu"]).sum())

    # (a) on the card, then with --device cpu
    runs = {}
    argv = [results, "--srgr", "--avg-vel", avg_vel_path, "--smplx", asset,
            "--fgd-weights", fgd_bin]
    for side, extra in (("card", ["--device", str(dev)]),
                        ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        rep = ev_tool.main(argv + extra + [
            "--out", os.path.join(ws, f"metrics_{side}.json")])
        runs[f"evaluate_{side}"] = dict(rep, wall_s=time.perf_counter() - t0)
    card = runs["evaluate_card"]["summary"]
    cpu = runs["evaluate_cpu"]["summary"]
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
           for k in EVAL_CONTINUOUS}
    if not (sorted(card) == sorted(EVAL_KEYS)
            and all(math.isfinite(v) for v in card.values())
            and all(e <= TOL_EVAL for e in rel.values())):
        raise AssertionError(f"evaluate: summary on the card {card} against "
                             f"the CPU's {cpu}: relative {rel} > {TOL_EVAL}")

    # one result directory profiled on the card: device busy share
    args = ev_tool.parse_args(argv)
    ev = ev_tool.build_evaluator(args, dev, get_root_logger())
    ev.add_result_dir(dirs[0])                 # warm
    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        ev.add_result_dir(dirs[1])
        torch.cuda.synchronize()
        dir_ms = (time.perf_counter() - t0) * 1e3
    dir_device_ms = device_busy_ms(prof)
    dir_kernels, dir_ops = device_time_by_kernel(prof)
    del ev

    # (b) divonly
    t0 = time.perf_counter()
    rep = evaluate_divonly.main([results, "--avg-vel", avg_vel_path,
                                 "--smplx", asset, "--device", str(dev),
                                 "--out",
                                 os.path.join(ws, "metrics_divonly.json")])
    runs["divonly"] = dict(rep, wall_s=time.perf_counter() - t0)

    # (c) multimodality over two repetitions: results_0 (seed 3) and one
    # more serving run (seed 4, its first batch)
    options, _ = write_workspace(ws, 30, config_options)
    prefix = os.path.join(ws, "mm")
    shutil.copytree(results, prefix + "_rep0")
    t0 = time.perf_counter()
    visualize.main([config, os.path.join(ws, "params.pt"), "--out-dir",
                    prefix + "_rep1", "--seed", "4", "--inv-cache",
                    os.path.join(ws, "inv_cache.npz"), "--device", str(dev)]
                   + SERVE_OPTIONS + ["--max-batches", "1"] + options)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    shared = sorted(
        {os.path.relpath(d, prefix + "_rep1")
         for d in find_result_dirs(prefix + "_rep1")}
        & {os.path.relpath(d, results) for d in dirs})
    t0 = time.perf_counter()
    rep = evaluate_mm.main([prefix, "--reps", "2", "--smplx", asset,
                            "--device", str(dev)])
    runs["mm"] = dict(rep, wall_s=time.perf_counter() - t0,
                      serve_rep1_s=serve_s, shared_names=len(shared))
    if not (shared and math.isfinite(rep["multimodality"])
            and rep["multimodality"] > 0):
        raise AssertionError(f"evaluate_mm: {rep} over {len(shared)} "
                             f"shared result names")

    # foot contacts by FK in featurize_clip, card against CPU
    cfg = Config.fromfile(config)
    cfg.merge_option_strings(options[1:])
    dcfg = beatx_config_from(cfg.data.train)
    contacts = {"seconds": {}, "frames": 0, "bits_on": 0,
                "near_threshold_flips": 0}
    ext = StubFeatureExtractor()
    for fid, _ in read_split_csv(dcfg.data_root):
        raw = load_raw_clip(dcfg, fid)
        bits = {}
        for k, m in models.items():
            t0 = time.perf_counter()
            recs = featurize_clip(fid, raw, dcfg, ext, is_test=True,
                                  smplx_model=m)
            contacts["seconds"][k] = (contacts["seconds"].get(k, 0.0)
                                      + time.perf_counter() - t0)
            bits[k] = np.concatenate([r["contact"] for r in recs])
        s = 30 // dcfg.pose_fps
        p = torch.as_tensor(np.asarray(raw["poses30"], np.float32)[::s])
        n = len(p)
        j, _ = lbs(models["cpu"], torch.as_tensor(
            np.asarray(raw["betas"], np.float32)[:300]).expand(n, 300), p,
            expression=torch.as_tensor(np.asarray(
                raw["expressions30"], np.float32)[::s][:, :100]),
            transl=torch.as_tensor(np.asarray(raw["trans30"],
                                              np.float32)[::s]),
            return_verts=False)
        fj = j[:, (7, 8, 10, 11)].numpy()
        vel = np.zeros((n, 4), np.float32)
        vel[:-1] = np.linalg.norm(fj[1:] - fj[:-1], axis=-1)
        vel = vel[: len(bits["cpu"])]
        diff = bits["card"] != bits["cpu"]
        near = np.abs(vel - 0.01) < 1e-6
        if (diff & ~near).any():
            raise AssertionError(f"evaluate: clip {fid}'s foot contacts on "
                                 f"the card differ from the CPU's at "
                                 f"{np.argwhere(diff & ~near)[:5].tolist()}")
        contacts["near_threshold_flips"] += int(diff.sum())
        contacts["frames"] += len(bits["card"])
        contacts["bits_on"] += int(bits["card"].sum())
    contacts["clips"] = len(read_split_csv(dcfg.data_root))
    contacts["share_on"] = contacts["bits_on"] / (4 * contacts["frames"])
    del models, fk, face_fk, fgd
    return {"phase": "evaluate", "result_dirs": len(dirs),
            "frames": T, "standins_write_s": standin_s,
            "runs": runs, "fk_vs_cpu": fk_err, "fk_tolerance": TOL_FK,
            "fgd_latents_vs_cpu_max_abs_err": fgd_err,
            "fgd_tolerance": TOL_FGD,
            "summary_vs_cpu_rel": rel, "summary_tolerance": TOL_EVAL,
            "ungated_vs_cpu": {k: {"card": card[k], "cpu": cpu[k]}
                               for k in ("fgd", "align", "srgr")},
            "beats_counted": beats_counted, "beats_differing": beat_flips,
            "srgr_hits_counted": hits_counted,
            "srgr_hits_differing": hit_flips,
            "profiled_dir": {"wall_ms": dir_ms, "device_ms": dir_device_ms,
                             "device_ops": dir_ops,
                             "busy_share": dir_device_ms / dir_ms,
                             "top_device_ms": dict(sorted(
                                 dir_kernels.items(),
                                 key=lambda kv: -kv[1])[:8])},
            "contacts": contacts}


# phase ddp: the 2-rank step against the 1-rank step at the global batch.
# The per-sample losses go through the same float32 operations (K3's in
# 3xTF32) on 64 rows as on 128, whose products may tile and sum in other
# orders: TOL_DDP_LOSS relative.  The reduced gradient that rank 0's update
# took against the 1-rank step's, leaf by leaf: TOL_DDP_GRAD of the leaf's
# largest element (of the step's largest for a leaf whose gradient is zero
# in exact arithmetic, ``zero_exact_gradient``).  K3's backward B sums the
# condition streams' key and value weight gradients in 3xTF32 over split-K
# partials whose plan follows the row count (64 against 128), and K3 is
# held to TOL_K3 of scale against its plain version; the first run on the
# card measured 2.0e-4 (block_5.ca_xf_spk.value.weight).  A leaf left out
# of the reduction, or reduced wrongly, misses by O(1).  One Adam step
# moves an element by lr * g / (|g| + eps), which changes by at most lr
# times g's relative error; so where |g| exceeds DDP_SETTLED times its
# leaf's error (a settled element) the updated parameters are held to
# lr / DDP_SETTLED.  An element whose gradient is within rounding of zero
# may step either way.
TOL_DDP_LOSS = 1e-4
TOL_DDP_GRAD = 1e-3
DDP_SETTLED = 100
DDP_STEPS_TIMED = 3

DDP_WORKER = r'''
import json, sys, time
import torch
import chip_smoke as cs
from raggesture_tpu_torch.models.architecture import create_model
from raggesture_tpu_torch.ops.cond_ctx import (cond_ctx_backward_a,
                                               cond_ctx_backward_b,
                                               cond_ctx_forward)
from raggesture_tpu_torch.parallel import mesh
from raggesture_tpu_torch.train.loop import (OptimConfig, create_train_state,
                                             make_train_step)

addr, rank, world, out, B, cfg_path = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]), sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = mesh.init_distributed(addr, world, rank, device="cuda",
                            backend="gloo")
sync = torch.cuda.synchronize
cfg = torch.load(cfg_path, weights_only=False)
model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
batch, _ = cs.train_batch(torch, cfg.denoiser, B, dev)
mine = mesh.shard_batch(batch)
reduce_ms = []
plain_reduce = mesh.all_reduce_grads_

def timed_reduce(params):
    sync()
    t0 = time.perf_counter()
    n = plain_reduce(params)
    sync()
    reduce_ms.append((time.perf_counter() - t0) * 1e3)
    return n

mesh.all_reduce_grads_ = timed_reduce
state = create_train_state(model, OptimConfig())
step = make_train_step(cfg.diffusion_train.schedule(device=dev),
                       log_per_sample=True)
g = torch.Generator(device=dev).manual_seed(4)
k3 = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
for fn in k3:
    fn.launches = 0
logs = step(state, mine, g)
sync()
launches = {fn.__name__: fn.launches for fn in k3}
if rank == 0:
    torch.save({"logs": {k: v.cpu() for k, v in logs.items()},
                "grads": {k: p.grad.cpu() for k, p in
                          model.denoiser.named_parameters()
                          if p.grad is not None},
                "denoiser": {k: v.cpu() for k, v in
                             model.denoiser.state_dict().items()}}, out)
sums = mesh.all_gather_rows(torch.stack([
    p.detach().double().sum() for p in model.denoiser.parameters()])[None])
step_ms = []
for _ in range(cs.DDP_STEPS_TIMED):
    sync()
    t0 = time.perf_counter()
    step(state, mine, g)
    sync()
    step_ms.append((time.perf_counter() - t0) * 1e3)
mesh.barrier()
print(json.dumps({"rank": rank, "k3_launches_first_step": launches,
                  "replicas_equal": bool((sums == sums[:1]).all()),
                  "rows": len(mine["motion_mask"]), "step_ms": step_ms,
                  "all_reduce_ms": reduce_ms,
                  "reduced_elements": sum(p.numel() for p in
                                          model.denoiser.parameters()),
                  "backend": torch.distributed.get_backend(),
                  "device": str(dev)}), flush=True)
mesh.shutdown()
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_phase(torch, dev, ws, config: str = SERVE_CONFIG, batch: int = 128,
              tool_batch: int = 32, config_options=(), arch=None) -> dict:
    """Phase 19: data-parallel training (``parallel/mesh.py``).  (a) The
    training tool with ``--distributed`` at world size 1 over NCCL, in
    this process, on phase 17's latent cache (``tool_batch`` rows, one
    epoch): K3's launches, one gradient all-reduce a step and its ms.  (b)
    One full-width step of the plain process at global batch ``batch``
    (the synthetic batch of phase 16, generator seed 4), and the same step
    by two ranks on this card over gloo (each ``batch / 2`` rows, its own
    process): the 2-rank step's per-sample losses, grad_norm and updated
    denoiser parameters against the 1-rank step's, the replicas equal, K3's
    launches in a rank's step, then a rank's step ms and its all-reduce ms
    over ``DDP_STEPS_TIMED`` more steps.  Between them, the one-process
    step's ms with fused contexts (K3) and with the per-layer forward
    (``fused_ctx=False``), in turns.  ``arch`` (an
    ``ArchitectureConfig``, default the full width) is the model of (b).
    ``dev`` must be the card."""
    import json
    import os
    import shutil
    import subprocess
    import sys

    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        create_model,
    )
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.parallel import mesh
    from raggesture_tpu_torch.tools import train as tool
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )

    if dev.type != "cuda":
        raise ValueError(f"ddp: the phase runs on the card, not {dev}")
    k3 = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
    sync = torch.cuda.synchronize
    # (a) the tool, NCCL at world size 1
    options, _ = write_workspace(ws, 30, config_options)
    reduce_ms = []
    plain_reduce = mesh.all_reduce_grads_

    def timed_reduce(params):
        sync()
        t0 = time.perf_counter()
        n = plain_reduce(params)
        sync()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return n

    for fn in k3:
        fn.launches = 0
    calls0 = plain_reduce.calls
    mesh.all_reduce_grads_ = timed_reduce
    try:
        t0 = time.perf_counter()
        stats = tool.main([
            config, "--work-dir", os.path.join(ws, "train_nccl"),
            "--device-batch-size", str(tool_batch), "--no-validate",
            "--latent-cache", os.path.join(ws, "tool_latents"),
            "--distributed", "--coordinator", f"localhost:{_free_port()}",
            "--num-processes", "1", "--process-id", "0",
            "--device", "cuda", *options,
            "runner.max_epochs=1", "log_config.tensorboard=False"])
        sync()
        tool_wall = time.perf_counter() - t0
    finally:
        mesh.all_reduce_grads_ = plain_reduce
    shutil.rmtree(os.path.join(ws, "train_nccl", "checkpoints"))
    steps = sum(e["steps"] for e in stats["epochs"])
    tool_launches = {fn.__name__: fn.launches for fn in k3}
    if (tool_launches != {fn.__name__: 3 * steps for fn in k3}
            or not steps
            or plain_reduce.calls - calls0 != steps
            or stats["world_size"] != 1 or mesh.in_group()):
        raise AssertionError(f"ddp: the NCCL tool run launched {tool_launches}"
                             f" and {plain_reduce.calls - calls0} all-reduces "
                             f"in {steps} steps (world {stats['world_size']})")

    # (b) the 1-rank step, then two ranks over gloo on this card
    cfg = arch or ArchitectureConfig()
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    tbatch, _ = train_batch(torch, cfg.denoiser, batch, dev)
    state = create_train_state(model, OptimConfig())
    step = make_train_step(cfg.diffusion_train.schedule(device=dev),
                           log_per_sample=True)
    for fn in k3:
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    ref_logs = step(state, tbatch, torch.Generator(device=dev).manual_seed(4))
    sync()
    one_rank_ms = (time.perf_counter() - t0) * 1e3
    ref_launches = {fn.__name__: fn.launches for fn in k3}
    ref = {k: v.detach().clone()
           for k, v in model.denoiser.state_dict().items()}
    ref_grads = {k: p.grad.detach().clone()
                 for k, p in model.denoiser.named_parameters()
                 if p.grad is not None}
    lr = state.optimizer.defaults["lr"]
    # the step with fused contexts (K3) beside the per-layer forward
    # (fused_ctx=False, plain layers), in turns: True False False True
    fused_ms = {True: [], False: []}
    tg = torch.Generator(device=dev).manual_seed(5)
    for fused in (True, False, False, True):
        fstep = make_train_step(cfg.diffusion_train.schedule(device=dev),
                                fused_ctx=fused)
        fstep(state, tbatch, tg)
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fstep(state, tbatch, tg)
            sync()
            fused_ms[fused].append((time.perf_counter() - t0) * 1e3)
    del state, step, fstep, tbatch
    out = os.path.join(ws, "ddp_rank0.pt")
    cfg_path = os.path.join(ws, "ddp_arch.pt")
    torch.save(cfg, cfg_path)
    addr = f"tcp://localhost:{_free_port()}"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DDP_WORKER, addr, str(r), "2", out,
         str(batch), cfg_path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=root)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    workers_wall = time.perf_counter() - t0
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"ddp: a gloo rank failed ({p.returncode}):"
                                 f"\n{o[-2000:]}\n{e[-3000:]}")
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    two = torch.load(out, weights_only=True)
    os.remove(out)
    ps_two = two["logs"]["per_sample_loss"].double()
    ps_one = ref_logs["per_sample_loss"].double().cpu()
    loss_err = ((ps_two - ps_one).abs() / ps_one.abs()).max().item()
    gn_err = abs(two["logs"]["grad_norm"].item()
                 / ref_logs["grad_norm"].item() - 1.0)
    # the reduced gradient, leaf by leaf, and the settled elements' update
    step_scale = max(g.abs().max().item() for g in ref_grads.values())
    grad_err, settled_n, settled_max = {}, 0, 0.0
    for k, w in ref_grads.items():
        d = (two["grads"][k].to(dev) - w).abs()
        own = (step_scale if zero_exact_gradient(k)
               else max(w.abs().max().item(), 1e-30))
        grad_err[k] = d.max().item() / own
        settled = w.abs() > DDP_SETTLED * d.max()
        settled_n += int(settled.sum())
        if settled.any():
            moved = (two["denoiser"][k].to(dev) - ref[k]).abs()[settled]
            settled_max = max(settled_max, moved.max().item())
    grad_worst = max(grad_err.items(), key=lambda kv: kv[1])
    n_elems = sum(w.numel() for w in ref_grads.values())
    want = {fn.__name__: 3 for fn in k3}
    if not (len(ps_two) == batch and loss_err <= TOL_DDP_LOSS
            and gn_err <= TOL_DDP_LOSS and set(two["grads"]) == set(ref_grads)
            and grad_worst[1] <= TOL_DDP_GRAD
            and settled_max <= lr / DDP_SETTLED
            and all(r["replicas_equal"] and r["k3_launches_first_step"] == want
                    and r["rows"] == batch // 2 for r in ranks)
            and ref_launches == want):
        raise AssertionError(
            f"ddp: 2 ranks against 1: per-sample losses {loss_err} "
            f"(tolerance {TOL_DDP_LOSS}), grad_norm {gn_err}, the reduced "
            f"gradients {grad_worst} at worst (tolerance {TOL_DDP_GRAD}), "
            f"the settled parameters {settled_max} apart (lr / "
            f"{DDP_SETTLED} = {lr / DDP_SETTLED}); ranks {ranks}")
    del ref, ref_grads, two, model
    torch.cuda.empty_cache()
    return {"phase": "ddp", "config": config, "global_batch": batch,
            "nccl_tool": {"world_size": 1, "batch": tool_batch,
                          "steps": steps, "wall_s": tool_wall,
                          "k3_launches": tool_launches,
                          "all_reduce_ms": reduce_ms,
                          "checkpoints": stats["checkpoints"]},
            "one_rank_step_ms": one_rank_ms,
            "step_ms_fused_ctx": fused_ms[True],
            "step_ms_per_layer": fused_ms[False],
            "gloo_two_ranks": ranks, "workers_wall_s": workers_wall,
            "per_sample_loss_rel_err": loss_err,
            "grad_norm_rel_err": gn_err,
            "grad_leaf_rel_err_worst": sorted(
                grad_err.items(), key=lambda kv: -kv[1])[:6],
            "grad_leaf_rel_err_median": sorted(grad_err.values())[
                len(grad_err) // 2],
            "settled_share": settled_n / n_elems,
            "settled_param_max_abs_diff": settled_max, "lr": lr,
            "tolerances": {"loss": TOL_DDP_LOSS, "grad": TOL_DDP_GRAD,
                           "settled_params": f"lr / {DDP_SETTLED}"}}


# phase train_vae: K2 under autograd against the plain path on the card.
# The backward is the plain recompute on the same saved inputs, so the
# gradients are the plain version's bitwise; the forward is K2's, float32
# in another summation order (TOL_K2).  A whole VAE step's gradients on
# K2 against the plain attention: TOL_VAE_GRAD of the largest gradient.
TOL_VAE_GRAD = 1e-3
VAE_EPOCHS = 3


def train_vae_phase(torch, dev, ws, config: str = SERVE_CONFIG,
                    batch: int = 64, config_options=()) -> dict:
    """Phase 20: part-VAE training (``raggesture_tpu_torch.tools.
    train_vae``) for upper (32 decoder heads of 16) and lowertrans (64 of
    8) at ``config``'s width, batch ``batch``, ``VAE_EPOCHS`` epochs each
    (one step an epoch at full width: 66 train windows), on phase 14's
    workspace, in this process.  Gates: K2 launched 9 times a
    step (the decoder's unmasked attentions; the encoder's are masked and
    plain) with as many backward recomputes; K2 under autograd against the
    plain attention at the decoder's shapes (output within TOL_K2,
    gradients bitwise); one step's gradients on K2 against the plain path
    within TOL_VAE_GRAD; the tool's file grafted by ``load_codec_params``
    and a decode from it finite.  Per part: the tool's step ms, a step's ms
    (CUDA events) split into forward and backward + update."""
    import os
    import types

    from raggesture_tpu_torch.builders import arch_config_from
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.models import vae as V
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.codec import GestureCodec
    from raggesture_tpu_torch.models.vae_architecture import (
        VAETrainConfig,
        vae_training_loss,
    )
    from raggesture_tpu_torch.ops.mha import (
        SoftmaxMHA,
        fused_softmax_mha,
        mha_supported,
        softmax_mha_reference,
    )
    from raggesture_tpu_torch.tools import train_vae as tool
    from raggesture_tpu_torch.train.checkpoint import load_codec_params

    if dev.type != "cuda":
        raise ValueError(f"train_vae: the phase runs on the card, not {dev}")
    sync = torch.cuda.synchronize
    options, _ = write_workspace(ws, 30, config_options)
    cfg = Config.fromfile(config)
    cfg.merge_option_strings(options[1:])
    ccfg = arch_config_from(cfg.model).codec
    parts, paths = {}, {}
    g = torch.Generator(device=dev).manual_seed(12)
    for part in ("upper", "lowertrans"):
        vcfg = ccfg.vae_config(part)
        heads = vcfg.num_heads * 8
        fused_softmax_mha.launches = 0
        back0 = SoftmaxMHA.backwards
        t0 = time.perf_counter()
        stats = tool.main([config, "--part", part, "--epochs",
                           str(VAE_EPOCHS), "--batch-size", str(batch),
                           "--work-dir", os.path.join(ws, f"vae_{part}"),
                           "--device", "cuda", *options])
        sync()
        wall = time.perf_counter() - t0
        steps = stats["steps"]
        T = vcfg.num_frames + vcfg.num_frames // vcfg.frame_chunk_size
        D = vcfg.latent_dim
        # the decoder's attentions a step: K2 where it takes the shape
        n_dec = (2 * (vcfg.num_layers // 2) + 1) * mha_supported(T, T, D,
                                                                 heads)
        launches = fused_softmax_mha.launches
        backs = SoftmaxMHA.backwards - back0
        if (steps != sum(e["steps"] for e in stats["epochs"]) or not steps
                or launches != n_dec * steps
                or backs != n_dec * steps
                or {d.split(":")[0] for d in stats["param_devices"]}
                != {"cuda"}
                or not all(math.isfinite(v) for v in stats["logs"].values())):
            raise AssertionError(f"train_vae {part}: {steps} steps, K2 "
                                 f"{launches} launches and {backs} backward "
                                 f"recomputes (expected {n_dec} a step), "
                                 f"{stats}")
        paths[part] = stats["params_path"]

        # K2 under autograd at the decoder's shapes
        q, k, v = (torch.randn(batch, T, D, generator=g, device=dev,
                               requires_grad=True) for _ in range(3))
        up = torch.randn(batch, T, D, generator=g, device=dev)
        scale = 1.0 / math.sqrt(D // heads)
        out_k = fused_softmax_mha(q, k, v, heads, scale)
        grads_k = torch.autograd.grad(out_k, (q, k, v), up)
        out_p = softmax_mha_reference(q, k, v, heads, scale)
        grads_p = torch.autograd.grad(out_p, (q, k, v), up)
        k2_err = (out_k - out_p).abs().max().item()
        k2_grad_equal = all(torch.equal(a, b)
                            for a, b in zip(grads_k, grads_p))
        if not (k2_err <= TOL_K2 and k2_grad_equal):
            raise AssertionError(f"train_vae {part}: K2 under autograd "
                                 f"{k2_err} (tolerance {TOL_K2}), gradients "
                                 f"equal {k2_grad_equal}")
        del q, k, v, up, out_k, out_p, grads_k, grads_p

        # a step's gradients on K2 against the plain attention, and its ms
        vae = tool.build_vae(vcfg, dev, 0)
        vae.load_state_dict(torch.load(paths[part], weights_only=True))
        feats = 0.3 * torch.randn(batch, vcfg.num_frames, vcfg.nfeats,
                                  generator=g, device=dev)
        mask = torch.ones(batch, vcfg.num_frames, device=dev)
        mask[::4, vcfg.num_frames // 2:] = 0.0
        eps = torch.randn(batch, vcfg.num_frames // vcfg.frame_chunk_size,
                          D, generator=g, device=dev)
        tcfg = VAETrainConfig(part=part)

        def loss_grads():
            vae.zero_grad(set_to_none=True)
            loss, _ = vae_training_loss(vae, feats, mask, eps, tcfg)
            loss.backward()
            return loss.item(), {n: p.grad.clone()
                                 for n, p in vae.named_parameters()}

        loss_k, gk = loss_grads()
        V.fused_softmax_mha = softmax_mha_reference
        try:
            loss_p, gp = loss_grads()
        finally:
            V.fused_softmax_mha = fused_softmax_mha
        g_scale = max(t.abs().max().item() for t in gp.values())
        grad_err = max((gk[n] - gp[n]).abs().max().item()
                       for n in gp) / g_scale
        if grad_err > TOL_VAE_GRAD:
            raise AssertionError(f"train_vae {part}: a step's gradients on "
                                 f"K2 against the plain path {grad_err} > "
                                 f"{TOL_VAE_GRAD}")
        opt = torch.optim.Adam(vae.parameters(), lr=1e-4)

        def fwd():
            return vae_training_loss(vae, feats, mask, eps, tcfg)[0]

        def full():
            opt.zero_grad(set_to_none=True)
            fwd().backward()
            opt.step()

        fwd_ms = cuda_ms(torch, fwd, iters=3, warmup=1)
        step_ms = cuda_ms(torch, full, iters=3, warmup=1)
        fused_softmax_mha.launches = 0
        full()
        step_launches = fused_softmax_mha.launches
        parts[part] = {
            "decoder_heads": heads, "head_width": D // heads,
            "tool_steps": steps, "tool_wall_s": wall,
            "tool_step_s": [e["wall_s"] for e in stats["epochs"]],
            "k2_launches": launches, "k2_backward_recomputes": backs,
            "k2_launches_per_step": step_launches,
            "k2_autograd_max_abs_err": k2_err,
            "k2_autograd_grads_bitwise": k2_grad_equal,
            "step_grad_rel_err": grad_err, "loss_kernel": loss_k,
            "loss_plain": loss_p, "step_ms": step_ms, "forward_ms": fwd_ms,
            "backward_and_update_share": 1.0 - fwd_ms / step_ms,
            "logs": stats["logs"]}
        del vae, opt, feats, mask, eps, gk, gp

    # the tool's files grafted into a codec (the other parts random from a
    # seed), and a decode from them
    with torch.device("meta"):
        codec = GestureCodec(ccfg)
    codec = codec.to_empty(device=dev)
    init_weights(codec, torch.Generator(device=dev).manual_seed(0))
    holder = types.SimpleNamespace(codec=codec)
    loaded = load_codec_params(holder, {f"{p}_ckpt": f
                                        for p, f in paths.items()})
    z = torch.randn(1, ccfg.num_tokens, ccfg.latent_dim, generator=g,
                    device=dev)
    fused_softmax_mha.launches = 0
    with torch.no_grad():
        dec = holder.codec.decode(z)
    finite = all(torch.isfinite(t).all().item() for t in dec.values())
    if loaded != ["upper", "lowertrans"] or not finite:
        raise AssertionError(f"train_vae: grafted {loaded}, decode finite "
                             f"{finite}")
    decode_launches = fused_softmax_mha.launches
    del holder, codec, dec
    torch.cuda.empty_cache()
    return {"phase": "train_vae", "config": config, "batch": batch,
            "parts": parts, "grafted": loaded,
            "decode_k2_launches": decode_launches,
            "tolerances": {"k2": TOL_K2, "step_grad": TOL_VAE_GRAD}}


# The test specs of phase options: spec A (cosine betas, ddim50 over 1000
# steps, EPSILON, FIXED_SMALL) and spec B (linear betas, trailing 50 steps,
# V_PRED, the default FIXED_LARGE); the encoder variant adds 2 text and 2
# audio encoder layers of 4 heads and an FFN of 4 D (2048 at the shipped
# width) to the shipped config.
OPTIONS_SPECS = {
    "spec_a": dict(beta_scheduler="cosine", respace="ddim50",
                   model_mean_type="epsilon", model_var_type="fixed_small"),
    "spec_b": dict(beta_scheduler="linear", respace="trailing",
                   num_inference_timesteps=50, model_mean_type="v_pred"),
}
# the card's eager float32 denoiser against the same on the CPU, over a
# whole sampling chain or bound: both float32 products without TF32,
# summed in other orders; max |card - cpu| over max |cpu| per output
TOL_OPTIONS_CPU = 1e-4


def options_phase(torch, dev, arch=None, train_rows: int = TRAIN_BATCH):
    """Phase 21 (``options``): the model and diffusion options at the
    width of ``arch`` (the shipped ``ArchitectureConfig()``), random
    weights from a seed.  (a) ``StagedGenerator.sample`` at batch 1 under
    spec A, spec B and the encoder variant (OPTIONS_SPECS), eager (its
    launches: K1 a layer call, K2 a codec layer) and replayed from its CUDA
    graph (bitwise equal), ms of each, device ms and busy share of a
    replay, and one denoiser call on K1 against the plain path within
    TOL_DENOISER; (b) ``StagedGenerator(fused=False)`` under spec A (K5,
    K6, K2 part by part), its clip against the plain versions' within
    TOL_SPLIT_DENOISER of the clip's largest magnitude (at least 1) under
    true-separator query masks, and its replay;
    (c) ``generate()`` with DDPM under spec A; (d) the DDPM loop through
    ``make_cfg_model_fn`` with cfg_scale 2, ``pre_seq`` and ``transl_req``
    at batch 2 and (e) ``calc_bpd_loop`` at batch 8 over spec A's steps,
    each against the same loop on the CPU fed the card's model outputs
    (TOL_OPTIONS_CPU), and every 25th step's denoiser call against the
    CPU's on the same inputs (TOL_SPLIT_DENOISER of its scale); (f)
    the training step at batch ``train_rows`` with the encoder variant and
    an EPSILON target on cosine betas: K3 3 + 3 + 3 launches a step, the
    gradients on K3 against its plain versions (TOL_TRAIN_GRAD), ms a step,
    device ms of a profiled step, peak memory beside what was allocated
    before the step's model was made.  Returns the phase's line."""
    import copy
    import dataclasses

    from raggesture_tpu_torch.diffusion.gaussian import MeanType, VarType
    from raggesture_tpu_torch.diffusion.sampling import ddpm_sample_loop
    from raggesture_tpu_torch.diffusion.vlb import calc_bpd_loop
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models import vae as V
    from raggesture_tpu_torch.models.conditioning import (
        make_cfg_model_fn,
        make_conditioned_model_fn,
    )
    from raggesture_tpu_torch.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        fused_denoise,
        fused_denoise_ctx,
        layer_kernel_mask_rows,
        precompute_cross_contexts,
        stack_layer_contexts,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import self_attention as SA
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts_plain,
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_forward,
    )
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
    )
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )

    t_phase = time.perf_counter()
    base = arch or A.ArchitectureConfig()
    dc = base.denoiser
    T, D, L = dc.num_tokens, dc.latent_dim, dc.num_layers
    counted = (fused_decoder_layer, fused_softmax_mha,
               SA.fused_self_attention, CA.fused_cross_attention,
               cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)

    def zero_launches():
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0

    def launches_now():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counted if fn.launches}

    def spec(name, **kw):
        return dataclasses.replace(
            A.DiffusionSpec(**OPTIONS_SPECS[name]), **kw)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    def rel_err(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    def events_ms(run, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n, out

    codec_layers = base.codec.num_layers + 1 - base.codec.num_layers % 2
    batch = clip_batch(torch, dc, 1, dev)
    cfgs = {
        "spec_a": dataclasses.replace(base, diffusion_test=spec("spec_a")),
        "spec_b": dataclasses.replace(base, diffusion_test=spec("spec_b")),
        "encoders": dataclasses.replace(base, denoiser=dataclasses.replace(
            dc, text_num_layers=2, audio_num_layers=2, cond_enc_heads=4,
            cond_enc_ff=4 * D)),
    }
    shared = A.create_model(cfgs["spec_a"], device=dev, seed=0,
                            zero_init_std=0.02)
    models = {"spec_a": shared, "spec_b": copy.copy(shared),
              "encoders": A.create_model(cfgs["encoders"], device=dev,
                                         seed=0, zero_init_std=0.02)}
    models["spec_b"].cfg = cfgs["spec_b"]     # spec A's weights

    @torch.no_grad()
    def denoiser_call_err(gen, model):
        """One denoiser call (conditioned and unconditioned halves, true
        separators, the middle step) on K1 against the plain path."""
        den = model.denoiser
        conds = model.encode_conditions(batch)
        conds2 = {k: torch.cat([v, v]) for k, v in conds.items()}
        tmask2 = latent_motion_mask(dc, torch.cat([batch["motion_mask"]] * 2))
        cm2 = torch.tensor([1.0, 0.0], device=dev).reshape(2, 1, 1)
        ctx3s = stack_layer_contexts(
            dc, precompute_cross_contexts(den, conds2, cm2), torch.bfloat16)
        mr, qr = layer_kernel_mask_rows(
            tmask2, parity_query_masks(torch, dc, 2, dev))
        x2 = torch.randn(2, T, D, generator=seeded(), device=dev)
        s = gen.sched.num_timesteps // 2
        call = (den, x2, gen.adaln_scale[s], gen.adaln_shift[s], gen.packs,
                ctx3s, mr, qr)
        d_k = fused_denoise_ctx(*call)
        d_p = fused_denoise_ctx(*call, layer_fn=fused_decoder_layer_reference)
        valid = tmask2 > 0
        return (d_k - d_p)[valid].abs().max().item()

    def clip_run(label, model, fused=True):
        """The eager clip, its launches and ms, the graph's first call and
        replays (bitwise equal), a profiled replay."""
        sched = model.cfg.diffusion_test.schedule()
        egen = A.StagedGenerator(model, sched, fused=fused, graphs=False)
        S = egen.sched.num_timesteps
        zero_launches()
        want = egen.sample(batch, generator=seeded())
        launches = launches_now()
        expect = ({"fused_decoder_layer": S * L,
                   "fused_softmax_mha": 2 * codec_layers} if fused else
                  {"fused_self_attention": S * L,
                   "fused_cross_attention": 3 * S * L,
                   "fused_softmax_mha": 4 * codec_layers})
        if launches != expect:
            raise AssertionError(f"options {label}: launches {launches}, "
                                 f"expected {expect}")
        out = want["output_latents"]
        if not (all(torch.isfinite(v).all() for v in want.values())
                and tuple(out.shape) == (1, T, D)):
            raise AssertionError(f"options {label}: a non-finite clip or "
                                 f"latents of shape {tuple(out.shape)}")
        eager_ms, again = events_ms(lambda: egen.sample(
            batch, generator=seeded()), 2)
        if not torch.equal(again["output_latents"], out):
            raise AssertionError(f"options {label}: two eager clips differ")
        ggen = A.StagedGenerator(model, sched, fused=fused)
        t0 = time.perf_counter()
        first = ggen.sample(batch, generator=seeded())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        zero_launches()
        replay_ms, held = events_ms(lambda: ggen.sample(
            batch, generator=seeded()), 3)
        if launches_now():
            raise AssertionError(f"options {label}: a replay launched from "
                                 f"Python {launches_now()}")
        if not all(torch.equal(c[k], want[k]) for c in (first, held)
                   for k in want):
            raise AssertionError(f"options {label}: a replay differs from "
                                 f"the eager clip")
        _, ops, prof = device_profile(
            torch, lambda: ggen.sample(batch, generator=seeded()))
        device_ms = device_busy_ms(prof)
        row = {"steps": S, "launches": launches, "eager_ms": eager_ms,
               "replay_first_call_s": first_s, "replay_ms": replay_ms,
               "replay_device_ms": device_ms, "replay_device_ops": ops,
               "replay_busy_share": device_ms / replay_ms,
               "replay_equals_eager": True}
        return row, egen

    # ---- (a) the cached path on K1: spec A, spec B, the encoders ----
    clips = {}
    for label in ("spec_a", "spec_b", "encoders"):
        row, egen = clip_run(label, models[label])
        err = denoiser_call_err(egen, models[label])
        if not err <= TOL_DENOISER:
            raise AssertionError(f"options {label}: a denoiser call on K1 "
                                 f"against the plain path {err} > "
                                 f"{TOL_DENOISER}")
        clips[label] = dict(row, denoiser_max_abs_err=err)
        del egen
    # ---- (b) the uncached path under spec A: K5, K6, part-by-part K2 ----
    row, ugen = clip_run("spec_a fused=False", shared, fused=False)
    qm = {k: v[0] for k, v in parity_query_masks(torch, dc, 1, dev).items()}
    kern = ugen.sample(batch, generator=seeded(), query_masks=qm)
    saved = (A.fused_denoise, V.fused_softmax_mha)
    A.fused_denoise = functools.partial(fused_denoise, fns=SPLIT_PLAIN)
    V.fused_softmax_mha = softmax_mha_reference
    try:
        zero_launches()
        plain = A.StagedGenerator(shared, ugen.sched, fused=False,
                                  graphs=False).sample(
            batch, generator=seeded(), query_masks=qm)
        if launches_now():
            raise AssertionError(f"options: the plain clip launched "
                                 f"{launches_now()}")
    finally:
        A.fused_denoise, V.fused_softmax_mha = saved
    # EPSILON latents of a random model grow to ~1e3 over the chain
    # (x0 = x / sqrt(abar) - ...): the error against the clip's scale
    tvalid = latent_motion_mask(dc, batch["motion_mask"]) > 0
    u_err = (kern["output_latents"] - plain["output_latents"])[
        tvalid].abs().max().item()
    u_scale = max(1.0, plain["output_latents"][tvalid].abs().max().item())
    if not u_err <= TOL_SPLIT_DENOISER * u_scale:
        raise AssertionError(f"options: the uncached clip on the kernels "
                             f"against the plain versions {u_err} > "
                             f"{TOL_SPLIT_DENOISER} of its scale {u_scale}")
    clips["spec_a fused=False"] = dict(row, clip_vs_plain_max_abs_err=u_err,
                                       clip_max_abs=u_scale)
    del ugen, kern, plain

    # ---- (c) generate() with DDPM under spec A ----
    ddpm_model = copy.copy(shared)
    ddpm_model.cfg = dataclasses.replace(cfgs["spec_a"],
                                         inference_type="ddpm")
    tb, _ = train_batch(torch, dc, 1, dev)
    zero_launches()
    t0 = time.perf_counter()
    gout = A.generate(ddpm_model, ddpm_model.cfg.diffusion_test.schedule(),
                      tb, seeded())
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    g_launches = launches_now()
    if (g_launches != {"fused_softmax_mha": 4 * codec_layers}
            or not all(torch.isfinite(v).all() for v in gout.values())):
        raise AssertionError(f"options: generate(ddpm) launches "
                             f"{g_launches}, or a non-finite clip")
    del gout

    # ---- (d), (e): the CFG DDPM loop and the bound, card against CPU ----
    # The free-running chain is chaotic (an EPSILON step divides by
    # sqrt(abar), ~1/32 at the first; the dropped conditions' keys carry
    # -1e6, rounding them to a 1/16 grid), and each term of the bound
    # multiplies a call's rounding by 1/sqrt(abar) and 1/var: so the CPU
    # runs the same loop and bound on the card's model outputs (the
    # loops' own arithmetic, TOL_OPTIONS_CPU), and the denoiser calls of
    # every 25th step on the card's inputs (TOL_SPLIT_DENOISER of their
    # scale on valid tokens, as phase serve's float32 calls).
    t_cpu = time.perf_counter()
    cpu_den = copy.deepcopy(shared.denoiser).cpu()
    sched_a = cfgs["spec_a"].diffusion_test.schedule()
    S = sched_a.num_timesteps
    kw = dict(mean_type=MeanType.EPSILON, var_type=VarType.FIXED_SMALL)
    gc_ = torch.Generator(device="cpu").manual_seed(7)
    transl = torch.tensor([[T - 1, 0.3, -0.2], [T - 2, 0.1, 0.4]])
    loop_in = {"noise": torch.randn(2, T, D, generator=gc_),
               "pre_seq": torch.randn(2, 3, D, generator=gc_),
               "step_noise": torch.randn(S, 2, T, D, generator=gc_),
               "pre_seq_noise": torch.randn(S, 2, 3, D, generator=gc_),
               "transl_noise": torch.randn(S, 2, 2, generator=gc_)}
    bpd_in = {"x_start": torch.tanh(torch.randn(8, T, D, generator=gc_)),
              "noise": torch.randn(S, 8, T, D, generator=gc_)}

    def model_fns(den, d, rows):
        """The CFG model function (``rows`` 2) or the conditioned one (8)
        of ``den`` on device ``d``."""
        c = {k: v.to(d) for k, v in clip_batch(torch, dc, rows, dev).items()}
        conds = den.encode_conditions(c["word"], c["audio"], c["speaker_ids"])
        tmask = latent_motion_mask(dc, c["motion_mask"])
        qm_ = parity_query_masks(torch, dc, rows, d)
        make = make_cfg_model_fn if rows == 2 else make_conditioned_model_fn
        return make(den, conds, tmask, qm_)

    def recording(fn, log):
        def model_fn(x, t_orig, i):
            out = fn(x, t_orig, i)
            log[i] = (x, t_orig, out)
            return out
        return model_fn

    def replaying(log):
        outs = {i: out.cpu() for i, (_, _, out) in log.items()}
        return lambda x, t_orig, i: outs[i]

    def loop(fn, d, sched):
        return ddpm_sample_loop(
            fn, sched, loop_in["noise"].to(d), cfg_scale=2.0,
            pre_seq=loop_in["pre_seq"].to(d), transl_req=transl,
            step_noise=loop_in["step_noise"].to(d),
            pre_seq_noise=loop_in["pre_seq_noise"].to(d),
            transl_noise=loop_in["transl_noise"].to(d), **kw)

    def bpd_of(fn, d, sched):
        return calc_bpd_loop(fn, sched, bpd_in["x_start"].to(d),
                             noise=bpd_in["noise"].to(d), **kw)

    # without autograd: the recorded outputs would keep every call's
    # activations alive (the DDPM chain links them all)
    with torch.no_grad():
        logs = {"cfg_ddpm": {}, "bpd": {}}
        zero_launches()
        t0 = time.perf_counter()
        x_card = loop(recording(model_fns(shared.denoiser, dev, 2),
                                logs["cfg_ddpm"]), dev, sched_a.to(dev))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bpd_card = bpd_of(recording(model_fns(shared.denoiser, dev, 8),
                                   logs["bpd"]), dev, sched_a.to(dev))
        torch.cuda.synchronize()
        bpd_s = time.perf_counter() - t0
        if launches_now():
            raise AssertionError(f"options: the eager denoiser launched "
                                 f"{launches_now()}")
        cpu = torch.device("cpu")
        x_cpu = loop(replaying(logs["cfg_ddpm"]), cpu, sched_a)
        bpd_cpu = bpd_of(replaying(logs["bpd"]), cpu, sched_a)
        cpu_err = {"cfg_ddpm_x": rel_err(x_card.cpu(), x_cpu)}
        cpu_err.update({f"bpd_{k}": rel_err(bpd_card[k].cpu(), v)
                        for k, v in bpd_cpu.items()})
        # on valid tokens: the separators carry the -1e6 query-mask term
        # through a LayerNorm (see parity_query_masks)
        valid = latent_motion_mask(dc, torch.ones(1, dc.max_seq_len))[0] > 0
        call_err = {}
        for name, rows in (("cfg_ddpm", 2), ("bpd", 8)):
            fn = model_fns(cpu_den, cpu, rows)
            worst = 0.0
            for i in range(0, S, 25):
                x, t_orig, out = logs[name][i]
                want = fn(x.cpu(), t_orig.cpu(), i)[:, valid]
                err = (out.cpu()[:, valid] - want).abs().max().item()
                worst = max(worst, err / max(1.0, want.abs().max().item()))
            call_err[name] = worst
    finite = (torch.isfinite(x_card).all()
              and all(torch.isfinite(v).all() for v in bpd_card.values()))
    if (not finite or max(cpu_err.values()) > TOL_OPTIONS_CPU
            or max(call_err.values()) > TOL_SPLIT_DENOISER):
        raise AssertionError(f"options: the card's loops against the CPU's "
                             f"on its model outputs {cpu_err} (tolerance "
                             f"{TOL_OPTIONS_CPU}), its calls {call_err} "
                             f"({TOL_SPLIT_DENOISER}); finite {finite}")
    total_bpd = bpd_card["total_bpd"].tolist()
    del cpu_den, logs, x_card, bpd_card
    cpu_s = time.perf_counter() - t_cpu

    # ---- (f) the training step with the encoders and an EPSILON target ----
    del models, shared, ddpm_model
    torch.cuda.empty_cache()
    held_gb = allocated_gb(torch)
    tcfg = dataclasses.replace(
        cfgs["encoders"], diffusion_train=A.DiffusionSpec(
            beta_scheduler="cosine", model_mean_type="epsilon"))
    tmodel = A.create_model(tcfg, device=dev, seed=0, zero_init_std=0.02)
    sched_train = tcfg.diffusion_train.schedule(device=dev)
    tbatch, rt = train_batch(torch, dc, train_rows, dev)
    state = create_train_state(tmodel, OptimConfig())
    step = make_train_step(sched_train)
    tgen = torch.Generator(device=dev).manual_seed(4)
    k3 = {fn.__name__: 3 for fn in counted[4:]}
    zero_launches()
    step(state, tbatch, tgen)
    if launches_now() != k3:
        raise AssertionError(f"options: launches in a training step with "
                             f"encoders {launches_now()}, expected {k3}")
    torch.cuda.reset_peak_memory_stats()
    steps = 3
    step_ms, logs = events_ms(lambda: step(state, tbatch, tgen), steps)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    logs = {k: v.item() for k, v in logs.items()}
    with profiled(torch) as prof:
        step(state, tbatch, tgen)
        torch.cuda.synchronize()
    t_kernel, t_ops = device_time_by_kernel(prof)
    enc_names = ("text_encoder", "audio_encoder")
    cond_mask = torch.ones(train_rows, 1, 1, device=dev)
    cond_mask[::10] = 0.0
    draws = {"enc_eps": {p: rt(train_rows, dc.max_seq_len
                               // base.codec.frame_chunk_size,
                               base.codec.latent_dim)
                         for p in ("upper", "hands", "face", "lowertrans")},
             "t": torch.randint(0, sched_train.num_timesteps, (train_rows,),
                                generator=rt.generator, device=dev),
             "noise": rt(train_rows, T, D), "cond_mask": cond_mask}

    def grads(**kw):
        tmodel.denoiser.zero_grad(set_to_none=True)
        loss, _ = A.training_loss(tmodel, sched_train, tbatch, **draws, **kw)
        loss.backward()
        return {k: v.grad.clone() for k, v in
                tmodel.denoiser.named_parameters()}

    g_k = grads()
    g_p = grads(ctx_fn=functools.partial(cond_contexts_plain,
                                         operand_dtype=torch.bfloat16))
    tmodel.denoiser.zero_grad(set_to_none=True)
    g_err = {k: rel_err(g_k[k], g_p[k]) for k in g_k
             if not zero_exact_gradient(k)}
    worst = max(g_err, key=g_err.get)
    enc_worst = max(v for k, v in g_err.items() if k.startswith(enc_names))
    if not (g_err[worst] <= TOL_TRAIN_GRAD and all(
            math.isfinite(v) for v in logs.values())):
        raise AssertionError(f"options: training gradients on K3 against "
                             f"the plain versions {worst} {g_err[worst]} > "
                             f"{TOL_TRAIN_GRAD}, or logs {logs}")
    train = {"batch": train_rows, "k3_launches_per_step": k3,
             "ms_per_step": step_ms, "steps_timed": steps,
             "profiled_device_ms": sum(t_kernel.values()),
             "device_ops": t_ops, "peak_mem_gb": peak_gb,
             "allocated_before_gb": held_gb,
             "encoder_parameters": sum(
                 p.numel() for n, p in tmodel.denoiser.named_parameters()
                 if n.startswith(enc_names)),
             "grad_rel_err_max": g_err[worst], "grad_rel_err_at": worst,
             "encoder_grad_rel_err_max": enc_worst,
             "grad_tolerance": TOL_TRAIN_GRAD, "logs": logs,
             "top_device_ms": dict(sorted(t_kernel.items(),
                                          key=lambda kv: -kv[1])[:8])}
    del tmodel, state, step, tbatch, g_k, g_p
    torch.cuda.empty_cache()
    return {"phase": "options", "width": D, "layers": L,
            "specs": {k: dict(OPTIONS_SPECS[k]) for k in OPTIONS_SPECS},
            "clips": clips, "tolerance_denoiser": TOL_DENOISER,
            "tolerance_uncached_clip": TOL_SPLIT_DENOISER,
            "generate_ddpm": {"launches": g_launches, "seconds": gen_s},
            "card_vs_cpu_rel_err": cpu_err,
            "card_vs_cpu_tolerance": TOL_OPTIONS_CPU,
            "calls_card_vs_cpu_err": call_err,
            "calls_tolerance": TOL_SPLIT_DENOISER,
            "cfg_ddpm_card_s": loop_s, "calc_bpd_card_s": bpd_s,
            "card_vs_cpu_s": cpu_s, "total_bpd": total_bpd,
            "train": train, "phase_s": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- release

# wav2vec2-base-960h's and bert-base-cased's published configurations (their
# config.json, preprocessor_config.json and tokenizer_config.json), the
# stand-ins' layouts
W2V_BASE_960H = {
    "architectures": ["Wav2Vec2ForCTC"], "model_type": "wav2vec2",
    "conv_bias": False, "conv_dim": [512] * 7,
    "conv_kernel": [10, 3, 3, 3, 3, 2, 2], "conv_stride": [5, 2, 2, 2, 2, 2, 2],
    "do_stable_layer_norm": False, "feat_extract_activation": "gelu",
    "feat_extract_norm": "group", "hidden_act": "gelu", "hidden_size": 768,
    "intermediate_size": 3072, "layer_norm_eps": 1e-05,
    "mask_feature_prob": 0.0, "mask_time_prob": 0.05,
    "num_attention_heads": 12, "num_conv_pos_embedding_groups": 16,
    "num_conv_pos_embeddings": 128, "num_feat_extract_layers": 7,
    "num_hidden_layers": 12, "vocab_size": 32}
W2V_PREPROCESSOR = {
    "do_normalize": True, "feature_extractor_type": "Wav2Vec2FeatureExtractor",
    "feature_size": 1, "padding_side": "right", "padding_value": 0.0,
    "return_attention_mask": False, "sampling_rate": 16000}
BERT_BASE_CASED = {
    "architectures": ["BertForMaskedLM"], "model_type": "bert",
    "hidden_act": "gelu", "hidden_size": 768, "intermediate_size": 3072,
    "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
    "num_attention_heads": 12, "num_hidden_layers": 12,
    "position_embedding_type": "absolute", "type_vocab_size": 2,
    "vocab_size": 28996}
BERT_TOKENIZER = {"do_lower_case": False, "model_max_length": 512}
RELEASE_OPTIONS = ["--retrieval-method", "gesture_type", "--use-inversion",
                   "--insertion-guidance", "--guidance-iters", "constant",
                   "--test-batchsize", "2", "--max-batches", "1"]
# the card's wav2vec2 and BERT features against the same modules on the
# CPU: max |card - cpu| over max |cpu|; float32 on both, TF32 off
TOL_FEATURES = 1e-4
# traced_device_time_ms (the Chrome trace file) against device_busy_ms of
# the same profiler window (the profile object): the same device records,
# read two ways
TOL_TRACE = 0.02
RENDER_PIXELS = 0.999


def release_layout(state: dict, seed: int = 0):
    """The reference's checkpoint layouts of a port model's state dict (the
    inverse of ``utils/convert_torch.py::convert_release``): the mmcv
    denoiser state (``model.`` prefix, the four VAEs embedded as
    ``gesture_rep_encoder.{part}_vae.*``) and the per-part VAE states; the
    packed ``in_proj`` of every attention, (L, 1, D) position tables, and the
    buffers the port recomputes (``sequence_embedding.pe``,
    ``mem_pos_decoder.pe``) drawn from ``seed``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    rename = ((r"\.input_(\d+)\.", r".input_blocks.\1."),
              (r"\.output_(\d+)\.", r".output_blocks.\1."),
              (r"\.skip_linear_(\d+)\.", r".linear_blocks.\1."),
              (r"\.middle\.", ".middle_block."), (r"\.final_norm\.", ".norm."),
              (r"^time_embed_1\.", "time_embed.0."),
              (r"^time_embed_2\.", "time_embed.2."),
              (r"^block_(\d+)\.", r"temporal_decoder_blocks.\1."),
              (r"\.ca_xf_(text|audio|spk)\.", r".ca_blocks.xf_\1."),
              (r"proj_out\.emb_layer\.", "proj_out.emb_layers.1."),
              (r"proj_out\.out_proj\.", "proj_out.out_layers.2."))

    def reference(sub: dict) -> dict:
        out, qkv = {}, {}
        for k, v in sub.items():
            for a, b in rename:
                k = re.sub(a, b, k)
            m = re.match(r"(.*)\.([qkv])_proj\.(weight|bias)$", k)
            if m:
                qkv.setdefault((m[1], m[3]), {})[m[2]] = v
            elif k.endswith(".pe"):
                out[k] = v[:, None, :]
            else:
                out[k] = v
        for (mod, leaf), parts in qkv.items():
            out[f"{mod}.in_proj_{leaf}"] = torch.cat(
                [parts["q"], parts["k"], parts["v"]])
        return out

    vaes = {}
    for part in ("upper", "hands", "face", "lowertrans"):
        prefix = f"codec.{part}_vae."
        vae = reference({k[len(prefix):]: v for k, v in state.items()
                         if k.startswith(prefix)})
        if "mem_pos_decoder.pe" not in vae:
            vae["mem_pos_decoder.pe"] = torch.randn(
                vae["query_pos_decoder.pe"].shape, generator=g) * 0.02
        vaes[part] = vae
    den = reference({k[len("denoiser."):]: v for k, v in state.items()
                     if k.startswith("denoiser.")})
    D = den["joint_embed.weight"].shape[0]
    den["sequence_embedding.pe"] = torch.randn(10, 1, D, generator=g)
    release = {f"model.{k}": v for k, v in den.items()}
    for part, vae in vaes.items():
        release.update({f"model.gesture_rep_encoder.{part}_vae.{k}": v
                        for k, v in vae.items()})
    return release, vaes


def write_release(root: str, state: dict) -> dict:
    """A release directory under ``root`` in the reference's layout
    (``tools/convert_weights.py::write_release_layout``) from a port
    model's state (``release_layout``), each part's run yaml with the
    shipped VAEs' architecture keys, and the FGD checkpoint's stand-in.
    Returns the release state's names and shapes and the bytes written."""
    from raggesture_tpu_torch.tools.convert_weights import (
        write_release_layout)

    release, vaes = release_layout(state)
    yaml = {p: {"num_layers": 8, "latent_dim": 512,
                "num_heads": 8 if p == "lowertrans" else 4, "ff_size": 1024,
                "transformer_activation": "gelu",
                "transformer_normalize_before": False,
                "position_embedding": "learned",
                "decoder_arch": "all_encoder"} for p in vaes}
    written = write_release_layout(root, release, vaes, yaml,
                                   fgd_standin_state())
    return {"shapes": {k: list(v.shape) for k, v in release.items()},
            "vae_shapes": {p: {k: list(v.shape) for k, v in vae.items()}
                           for p, vae in vaes.items()},
            "bytes": written}


def write_hf_standins(hub: str, words, layers: int, dev, seed: int = 0):
    """wav2vec2-base-960h and bert-base-cased stand-ins in the local hub
    cache layout under ``hub`` (``models--{org}--{name}/snapshots/standin``
    and ``refs/main``), with the published configurations at ``layers``
    layers (12: the release's depth), random weights from ``seed`` (the
    modules' own initialisation) in the released checkpoints' layouts:
    Wav2Vec2ForCTC's ``wav2vec2.`` prefix with its ``lm_head`` and the
    weight-norm ``weight_g``/``weight_v``; BertForPreTraining's ``bert.``
    prefix with its pooler and ``cls.`` heads and the TF-era
    ``LayerNorm.gamma``/``beta``.  The BERT vocabulary has bert-base-cased's
    28,996 entries and its special tokens' ids, and holds ``words``.
    Returns the two snapshot directories."""
    import torch

    from raggesture_tpu_torch.datasets.build import HF_BERT, HF_WAV2VEC2
    from raggesture_tpu_torch.models.featurizers import (BertModel,
                                                         Wav2Vec2Model)

    torch.manual_seed(seed)
    dirs = []
    for name, cfg, extra in (
            (HF_WAV2VEC2, dict(W2V_BASE_960H, num_hidden_layers=layers),
             {"preprocessor_config.json": W2V_PREPROCESSOR}),
            (HF_BERT, dict(BERT_BASE_CASED, num_hidden_layers=layers),
             {"tokenizer_config.json": BERT_TOKENIZER})):
        repo = os.path.join(hub, "models--" + name.replace("/", "--"))
        snap = os.path.join(repo, "snapshots", "standin")
        os.makedirs(snap, exist_ok=True)
        os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
        with open(os.path.join(repo, "refs", "main"), "w") as f:
            f.write("standin")
        for fname, body in dict(extra, **{"config.json": cfg}).items():
            with open(os.path.join(snap, fname), "w") as f:
                json.dump(body, f, indent=1)
        D = cfg["hidden_size"]
        with torch.device(dev):
            if name == HF_WAV2VEC2:
                model = Wav2Vec2Model(cfg)
                conv = model.encoder.pos_conv_embed.conv
                torch.nn.init.normal_(conv.weight_v, std=0.02)
                conv.weight_g.data = conv.weight_v.detach().pow(2).sum(
                    (0, 1), keepdim=True).sqrt()
                torch.nn.init.zeros_(conv.bias)
                torch.nn.init.uniform_(model.masked_spec_embed)
                state = {f"wav2vec2.{k}": v for k, v in
                         model.state_dict().items()}
                state["lm_head.weight"] = torch.randn(cfg["vocab_size"], D)
                state["lm_head.bias"] = torch.zeros(cfg["vocab_size"])
            else:
                model = BertModel(cfg)
                state = {"bert." + k.replace("LayerNorm.weight",
                                             "LayerNorm.gamma")
                         .replace("LayerNorm.bias", "LayerNorm.beta"): v
                         for k, v in model.state_dict().items()}
                V = cfg["vocab_size"]
                state.update({
                    "bert.embeddings.position_ids": torch.arange(
                        cfg["max_position_embeddings"])[None],
                    "bert.pooler.dense.weight": torch.randn(D, D) * 0.02,
                    "bert.pooler.dense.bias": torch.zeros(D),
                    "cls.predictions.bias": torch.zeros(V),
                    "cls.predictions.transform.dense.weight":
                        torch.randn(D, D) * 0.02,
                    "cls.predictions.transform.dense.bias": torch.zeros(D),
                    "cls.predictions.transform.LayerNorm.gamma":
                        torch.ones(D),
                    "cls.predictions.transform.LayerNorm.beta":
                        torch.zeros(D),
                    "cls.predictions.decoder.weight": torch.randn(V, D) * 0.02,
                    "cls.seq_relationship.weight": torch.randn(2, D) * 0.02,
                    "cls.seq_relationship.bias": torch.zeros(2)})
                vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
                         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                         + list(string.punctuation))
                vocab += sorted({w for w in words} - set(vocab))
                vocab += [f"##w{i}" for i in range(V - len(vocab))]
                with open(os.path.join(snap, "vocab.txt"), "w") as f:
                    f.write("\n".join(vocab) + "\n")
        torch.save({k: v.detach().cpu() for k, v in state.items()},
                   os.path.join(snap, "pytorch_model.bin"))
        del model, state
        dirs.append(snap)
    return dirs


def release_phase(torch, dev, ws, config: str = SERVE_CONFIG, n_sec: int = 30,
                  config_options=(), hf_layers: int = 12) -> dict:
    """Phase 22: the released checkpoint onto the port, real featurization
    and rendering, on phase 14's workspace ``ws`` (written here when
    absent).  (a) a stand-in release of a seeded model at ``config``, in
    the reference's layouts (``write_release``; at the shipped width its
    names and shapes are tests/fixtures/golden_keys_*.json's), converted by
    ``tools.convert_weights --all``: the seconds, the bytes, the whole
    model's file equal to the seeded model bitwise, the part files and the
    FGD file loaded strictly; (b) wav2vec2-base-960h and bert-base-cased
    stand-ins at their published configs (``hf_layers`` deep) in the hub
    cache layout, found by ``make_default_extractor`` on the card, which
    builds fresh test and train window caches: the seconds, windows/s,
    featurizer ms a window and a clip, the cache's featurizer name, one
    window's features on the card against the CPU's; (c) the serving
    tool on the converted file (gesture-type retrieval, inversion,
    guidance; one batch of 2): its stages and launches; the same batch as
    one eager clip each way: fused=False (K5, K6, K2 part by part) and
    fused=True (K1, K2 stacked), their launches; one denoiser call on K1
    and one uncached call on K5/K6 against the plain paths, the decode on
    K2 against the plain attention; one replayed clip's
    ``traced_device_time_ms`` against its window's ``device_busy_ms``; (d)
    the videos the serving call's ``--render --smplx-asset`` wrote on the
    card (each sample's GT-vs-prediction and prediction-vs-retrieval mesh
    videos at 320 × 480 a panel; the tool's render ms a frame), 2 frames of
    each of a sample's videos on the card twice (bitwise) and on the CPU
    (pixels equal), ms a frame each; where neither ffmpeg nor PIL is
    installed the call goes without ``--render`` and ``write_video``'s
    error must name both.
    Returns the phase's JSON line."""
    import numpy as np

    from raggesture_tpu_torch.builders import (arch_config_from,
                                               beatx_config_from)
    from raggesture_tpu_torch.config import Config
    from raggesture_tpu_torch.datasets.beatx import HFFeatureExtractor
    from raggesture_tpu_torch.datasets.build import (HF_BERT, HF_WAV2VEC2,
                                                     build_dataset,
                                                     make_default_extractor)
    from raggesture_tpu_torch.models import architecture as A
    from raggesture_tpu_torch.models import vae as V
    from raggesture_tpu_torch.models.codec import PART_NAMES
    from raggesture_tpu_torch.models.denoiser import latent_motion_mask
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN, fused_denoise, fused_denoise_ctx, layer_kernel_mask_rows,
        precompute_cross_contexts, stack_adaln_weights, stack_layer_contexts)
    from raggesture_tpu_torch.models.smplx import load_smplx, load_smplx_faces
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import self_attention as SA
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer, fused_decoder_layer_reference)
    from raggesture_tpu_torch.ops.mha import (fused_softmax_mha,
                                              mha_supported,
                                              softmax_mha_reference)
    from raggesture_tpu_torch.tools import convert_weights
    from raggesture_tpu_torch.tools import evaluate as eval_tool
    from raggesture_tpu_torch.tools import visualize as tool
    from raggesture_tpu_torch.train.checkpoint import (load_codec_params,
                                                       load_params)
    from raggesture_tpu_torch.train.runner import device_batch
    from raggesture_tpu_torch.utils import profiling as PR
    from raggesture_tpu_torch.utils import visualization as VZ

    counted = (fused_decoder_layer, fused_softmax_mha,
               SA.fused_self_attention, CA.fused_cross_attention)
    K5, K6 = "fused_self_attention", "fused_cross_attention"
    t_phase = time.perf_counter()
    line = {"phase": "release"}
    options, _ = write_workspace(ws, n_sec, config_options)
    # the featurized caches, corpus and memo of this phase, beside phase
    # 14's stub-featurized ones
    options += [f"data.{s}.cache_path={ws}/cache_hf" for s in ("train",
                                                              "test")] + [
        # the train windows at a 6 s stride: a third of phase 14's
        "data.train.stride=90",
        f"model.model.retrieval_cfg.cache_path={ws}/retrieval_cache_hf",
        "custom_hooks=[{'type': 'DatabaseSaveHook', "
        f"'save_dir': '{ws}/memo_hf'}}]"]
    cfg = Config.fromfile(config)
    cfg.merge_option_strings(options[1:])
    arch = arch_config_from(cfg.model)
    dc, cc = arch.denoiser, arch.codec

    # ---- (a) the stand-in release, converted ----
    rel = os.path.join(ws, "release")
    t0 = time.perf_counter()
    src = A.create_model(arch, device=dev, seed=21, zero_init_std=0.02)
    src_state = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    del src
    written = write_release(rel, src_state)
    write_s = time.perf_counter() - t0
    # at the shipped model's shapes the stand-in has the release's names
    # and shapes
    with torch.device("meta"):
        ref = A.MotionDiffusionModel(A.ArchitectureConfig())
    shipped = ({k: tuple(v.shape) for k, v in ref.state_dict().items()}
               == {k: tuple(v.shape) for k, v in src_state.items()})
    del ref
    if shipped:
        fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures")
        with open(os.path.join(fix, "golden_keys_denoiser.json")) as f:
            golden = json.load(f)
        with open(os.path.join(fix, "golden_keys_vae.json")) as f:
            golden_vae = json.load(f)
        if written["shapes"] != golden or written["vae_shapes"] != golden_vae:
            raise AssertionError("release: the stand-in's names and shapes "
                                 "are not the release's")
    report = convert_weights.main(["--all", "--root", rel])
    params_pt = os.path.join(rel, "experiments", "diffusion", "params.pt")
    conv = torch.load(params_pt, map_location="cpu", weights_only=True)
    if sorted(conv) != sorted(src_state) or not all(
            torch.equal(conv[k], v) for k, v in src_state.items()):
        raise AssertionError("release: the converted model differs from the "
                             "model the release was written from")
    del conv, src_state
    with torch.device("meta"):
        check = A.MotionDiffusionModel(arch)
    check = check.to_empty(device="cpu")
    vae_dir = os.path.join(rel, "experiments", "vae")
    parts = load_codec_params(check, {f"{p}_ckpt": os.path.join(
        vae_dir, f"{p}.pt") for p in ("upper", "hands", "face",
                                      "lowertrans")})
    del check
    fgd_fn = eval_tool.build_fgd_fn(
        os.path.join(rel, "experiments", "fgd", "aesconv.pt"), device=dev)
    if len(parts) != 4 or fgd_fn is None or len(report["written"]) != 6:
        raise AssertionError(f"release: converted parts {parts}, files "
                             f"{sorted(report['written'])}")
    del fgd_fn
    line["convert"] = {
        "golden_names_and_shapes": shipped, "write_s": write_s,
        "release_bytes": written["bytes"], "convert_s": report["seconds"],
        "bytes_written": sum(report["written"].values()),
        "files": {os.path.relpath(k, rel): v
                  for k, v in report["written"].items()}}

    # ---- (b) the featurizers on the card: a fresh window cache ----
    words = {w for ws_ in SERVE_WORDS for w in ws_}
    t0 = time.perf_counter()
    hub = os.path.join(ws, "hub")
    write_hf_standins(hub, words, hf_layers, dev)
    hf_write_s = time.perf_counter() - t0
    saved_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = hub
    try:
        ext = make_default_extractor(dev)
        if not isinstance(ext, HFFeatureExtractor) or ext.device != dev:
            raise AssertionError(f"release: make_default_extractor gave "
                                 f"{ext!r}")
        calls = {"audio_features": [], "word_embeddings": []}
        for name in calls:
            fn = getattr(ext, name)

            def timed(*a, fn=fn, name=name):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                calls[name].append((time.perf_counter() - t) * 1e3)
                return out

            setattr(ext, name, timed)
        t0 = time.perf_counter()
        test_ds = build_dataset(beatx_config_from(cfg.data.test), ext,
                                device=dev)
        train_ds = build_dataset(beatx_config_from(cfg.data.train), ext,
                                 device=dev)
        cache_s = time.perf_counter() - t0
        names = {d.cache.extractor_name for d in (test_ds, train_ds)}
        if names != {"HFFeatureExtractor"}:
            raise AssertionError(f"release: caches built by {names}")
        windows = len(test_ds) + len(train_ds)
        n_clips = len(os.listdir(os.path.join(ws, "beat2", "wave16k")))
        feat_ms = sum(sum(v) for v in calls.values())
        # one window's features on the card against the CPU's
        rec = test_ds[0]
        cpu_ext = HFFeatureExtractor(HF_WAV2VEC2, HF_BERT, device="cpu")
        feats_err = {}
        for key, card, cpu in (
                ("audio", ext.audio_features(rec["raw_audio"], 16000),
                 cpu_ext.audio_features(rec["raw_audio"], 16000)),
                ("word", ext.word_embeddings(rec["raw_word"])[1],
                 cpu_ext.word_embeddings(rec["raw_word"])[1])):
            if card.shape != cpu.shape:
                raise AssertionError(f"release: {key} features {card.shape} "
                                     f"on the card, {cpu.shape} on the CPU")
            feats_err[key] = float(np.abs(card - cpu).max()
                                   / np.abs(cpu).max())
        if not all(e <= TOL_FEATURES for e in feats_err.values()):
            raise AssertionError(f"release: features on the card against the "
                                 f"CPU {feats_err} > {TOL_FEATURES}")
        del ext, cpu_ext, test_ds, train_ds
    finally:
        if saved_env is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_env
    torch.cuda.empty_cache()
    line["featurize"] = {
        "hf_layers": hf_layers, "standins_write_s": hf_write_s,
        "cache_s": cache_s, "windows": windows,
        "windows_per_s": windows / cache_s,
        "featurizer_ms_per_window": feat_ms / windows,
        "featurizer_ms_per_clip": feat_ms / n_clips,
        "wav2vec2_ms_mean": float(np.mean(calls["audio_features"])),
        "bert_ms_mean": float(np.mean(calls["word_embeddings"])),
        "card_vs_cpu_rel_err": feats_err, "tolerance": TOL_FEATURES}

    # ---- (c) serving the converted release ----
    # K2 where a part decoder's attention takes it: each part's decoder
    # part by part; upper, hands and face as one stack (upper's heads) and
    # lowertrans in the stacked decode
    t_dec = cc.tokens_per_part + cc.num_frames
    on_k2 = {p: mha_supported(t_dec, t_dec, cc.latent_dim,
                              8 * cc.vae_config(p).num_heads)
             for p in PART_NAMES}
    decode_on_k2 = any(on_k2.values())
    seen, first = [], {}

    def on_batch(info):
        torch.cuda.synchronize()
        seen.append(dict(info["stats"], launches={
            fn.__name__: fn.launches for fn in counted}))
        first.update(info)

    # the served samples rendered through --render on the stand-in SMPL-X
    # asset, where a video writer is installed (ffmpeg, else PIL)
    asset = os.path.join(ws, "SMPLX_NEUTRAL_2020.npz")
    write_smplx_standin(asset)
    writer = ("ffmpeg" if VZ.HAS_FFMPEG else "PIL" if VZ._has_pil()
              else None)
    render_flags = ["--render", "--smplx-asset", asset] if writer else []
    out_dir = os.path.join(ws, "results_release")
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    served = tool.main([config, params_pt, "--out-dir", out_dir, "--seed",
                        "3"] + RELEASE_OPTIONS + render_flags + options,
                       on_batch=on_batch)
    serve_s = time.perf_counter() - t0
    lk = seen[0]["launches"]
    if not (seen[0]["num_queries"] > 0 and not lk["fused_decoder_layer"]
            and lk[K5] and lk[K6]
            and bool(lk["fused_softmax_mha"]) == decode_on_k2):
        raise AssertionError(f"release: the served batch retrieved "
                             f"{seen[0]['num_queries']}, launched {lk}")
    gen = first["generator"]
    model, sched = gen.model, gen.sched
    dbatch = device_batch(first["batch"], dev)
    steps, L = sched.num_timesteps, dc.num_layers
    codec_layers = cc.num_layers + 1 - cc.num_layers % 2

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    clips = {}
    for label, kw, want in (
            ("fused=False", dict(fused=False),
             {K5: steps * L, K6: 3 * steps * L, "fused_decoder_layer": 0,
              "fused_softmax_mha": codec_layers * sum(on_k2.values())}),
            ("fused=True", {},
             {K5: 0, K6: 0, "fused_decoder_layer": steps * L,
              "fused_softmax_mha": codec_layers * (
                  on_k2["upper"] + on_k2["lowertrans"])})):
        g_e = A.StagedGenerator(model, sched, graphs=False, **kw)
        for fn in counted:
            fn.launches = 0
        out = g_e.sample(dbatch, generator=seeded())
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counted}
        if got != want or not all(torch.isfinite(v).all()
                                  for v in out.values()):
            raise AssertionError(f"release: a {label} clip launched {got}, "
                                 f"expected {want}")
        clips[label] = {"launches": got, "generator": g_e, "out": out}

    # one denoiser call on K1 and one uncached call on K5/K6 against the
    # plain paths; the decode on K2 against the plain attention
    g = torch.Generator(device=dev).manual_seed(4)
    den, B = model.denoiser, dbatch["word"].shape[0]
    conds = model.encode_conditions(dbatch)
    conds2 = {k: torch.cat([v, v]) for k, v in conds.items()}
    tmask2 = latent_motion_mask(dc, torch.cat([dbatch["motion_mask"]] * 2))
    cm2 = torch.cat([torch.ones(B), torch.zeros(B)]).to(dev).reshape(
        2 * B, 1, 1)
    qm2 = parity_query_masks(torch, dc, 2 * B, dev)
    x2 = torch.randn(2 * B, dc.num_tokens, dc.latent_dim, generator=g,
                     device=dev)
    fgen = clips["fused=True"]["generator"]
    step = steps // 2
    kcall = (den, x2, fgen.adaln_scale[step], fgen.adaln_shift[step],
             fgen.packs, stack_layer_contexts(
                 dc, precompute_cross_contexts(den, conds2, cm2),
                 torch.bfloat16), *layer_kernel_mask_rows(tmask2, qm2))
    ucall = (den, x2, sched.timestep_map[step].repeat(2 * B), tmask2, conds2,
             qm2, cm2, clips["fused=False"]["generator"].packs,
             stack_adaln_weights(den))
    valid = tmask2 > 0
    with torch.no_grad():
        k1_err = (fused_denoise_ctx(*kcall) - fused_denoise_ctx(
            *kcall, layer_fn=fused_decoder_layer_reference))[valid].abs()
        u_err = (fused_denoise(*ucall) - fused_denoise(
            *ucall, fns=SPLIT_PLAIN))[valid].abs()
        z = clips["fused=False"]["out"]["output_latents"]
        dec_k = model.decode_latents(z)
        saved_mha = V.fused_softmax_mha
        V.fused_softmax_mha = softmax_mha_reference
        try:
            dec_p = model.decode_latents(z)
        finally:
            V.fused_softmax_mha = saved_mha
    calls_err = {"k1_denoiser": k1_err.max().item(),
                 "k5_k6_denoiser": u_err.max().item(),
                 "k2_decode": max((dec_k[k] - dec_p[k]).abs().max().item()
                                  for k in dec_p)}
    tol = {"k1_denoiser": TOL_DENOISER, "k5_k6_denoiser": TOL_SPLIT_DENOISER,
           "k2_decode": TOL_K2}
    if not all(calls_err[k] <= tol[k] for k in tol):
        raise AssertionError(f"release: the converted model's calls on the "
                             f"kernels against the plain paths {calls_err}, "
                             f"tolerances {tol}")
    del kcall, ucall, dec_k, dec_p, conds2, x2

    # one replayed clip: the trace file's device time against the profile
    # object's busy time of the same window
    rgen = A.StagedGenerator(model, sched)
    rgen.sample(dbatch, generator=seeded())          # warm-up and capture
    torch.cuda.synchronize()
    traced = PR.traced_device_time_ms(
        lambda: rgen.sample(dbatch, generator=seeded()), iters=1,
        timeout_s=120.0)
    if traced is None or not (abs(traced["busy_ms"] - traced[
            "profile_busy_ms"]) <= TOL_TRACE * traced["profile_busy_ms"]):
        raise AssertionError(f"release: traced_device_time_ms {traced} "
                             f"against the window's busy time")
    line["serve"] = {
        "serve_s": serve_s, "stages": served["stages"],
        "batch": {k: v for k, v in seen[0].items() if k != "videos"},
        "clips_launches": {k: c["launches"] for k, c in clips.items()},
        "calls_max_abs_err": calls_err, "tolerances": tol,
        "replayed_clip_traced": traced, "trace_tolerance": TOL_TRACE}
    del clips, rgen, fgen, gen, first, model, den, conds, z

    # ---- (d) rendering on the card ----
    faces = load_smplx_faces(asset)
    card_rig = load_smplx(asset, device=dev)
    smp = next(d for d, _, files in sorted(os.walk(out_dir))
               if "retrieval_0.npz" in files)
    pairs = {"gt_pred": ([os.path.join(smp, "gt_motion.npz"),
                          os.path.join(smp, "pred_motion.npz")],
                         [VZ.GT_COLOR, VZ.PRED_COLOR]),
             "pred_retrieval": ([os.path.join(smp, "pred_motion.npz"),
                                 os.path.join(smp, "retrieval_0.npz")],
                                [VZ.PRED_COLOR, VZ.RETR_COLOR])}
    # --render's videos: a GT/prediction video for every sample and a
    # prediction/retrieval one where the sample has an exemplar, each of
    # as many 640 × 480 frames as its shorter panel (at most 600)
    videos, n_frames, want = seen[0].get("videos", []), 0, 0
    samples = sorted(d for d, _, files in os.walk(out_dir)
                     if "pred_motion.npz" in files)
    for d in samples if writer else ():
        for name, panels in (("side_by_side", ("gt_motion", "pred_motion")),
                             ("pred_vs_retrieval", ("pred_motion",
                                                    "retrieval_0"))):
            if not os.path.exists(os.path.join(d, panels[1] + ".npz")):
                continue
            want += 1
            T = min(len(np.load(os.path.join(d, q + ".npz"))["poses"][:600])
                    for q in panels)
            got = [v for v in videos
                   if v.startswith(os.path.join(d, name) + ".")]
            if len(got) != 1 or not os.path.getsize(got[0]):
                raise AssertionError(f"release: --render gave {got} for "
                                     f"{name} in {d}")
            if got[0].endswith(".gif"):
                from PIL import Image

                with Image.open(got[0]) as im:
                    if (im.size, im.n_frames) != ((640, 480), T):
                        raise AssertionError(
                            f"release: {got[0]} holds {im.n_frames} frames "
                            f"of {im.size}, expected {T} of (640, 480)")
            n_frames += T
    if writer and (len(samples) != 2 or len(videos) != want):
        raise AssertionError(f"release: --render wrote {videos} for the "
                             f"samples {samples}")
    # 2 frames of each video on the card twice (bitwise) and on the CPU
    # (RENDER_PIXELS of the pixels equal; the same frames, as the camera is
    # framed on the frames drawn); each run timed but the first
    cpu_rig = load_smplx(asset, device="cpu")
    render, card_ms, cpu_ms = {}, [], []

    def frames_ms(rig, paths, colors):
        if rig is card_rig:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = VZ.mesh_side_by_side_frames(paths, colors, rig, faces,
                                          max_frames=2)
        if rig is card_rig:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3 / len(out)

    for key, (paths, colors) in pairs.items():
        a, _ = frames_ms(card_rig, paths, colors)
        b, ms = frames_ms(card_rig, paths, colors)
        card_ms.append(ms)
        c, ms = frames_ms(cpu_rig, paths, colors)
        cpu_ms.append(ms)
        same = min(float((x == y).all(-1).mean()) for x, y in zip(a, c))
        if a[0].shape != (480, 640, 3) or not (
                all(np.array_equal(x, y) for x, y in zip(a, b))
                and same >= RENDER_PIXELS):
            raise AssertionError(f"release: {key} frames of {a[0].shape} on "
                                 f"the card vs the CPU share {same} of their "
                                 f"pixels, or differ between two card runs")
        render[key] = {"pixels_equal_to_cpu": same}
    # without a writer --render did not run: write_video raises, naming both
    writer_error = None
    if writer is None:
        try:
            VZ.write_video(b, os.path.join(ws, "render.mp4"))
        except RuntimeError as e:
            if "ffmpeg" not in str(e) or "PIL" not in str(e):
                raise
            writer_error = str(e)
        else:
            raise AssertionError("release: write_video wrote without ffmpeg "
                                 "or PIL")
    tool_ms = seen[0].get("render_ms")
    line["render"] = {
        "writer": writer, "writer_error": writer_error,
        "videos": [os.path.relpath(v, out_dir) for v in videos],
        "video_frames": n_frames, "panel": [320, 480],
        # --render: FK, rasterizing and writing, per frame of its videos
        "tool_render_ms": tool_ms,
        "tool_ms_per_frame": tool_ms / n_frames if n_frames else None,
        # the frames alone (FK and rasterizing), 2 of each video
        "card_ms_per_frame": float(np.mean(card_ms)),
        "card_frames_per_s": 1e3 / float(np.mean(card_ms)),
        "cpu_ms_per_frame": float(np.mean(cpu_ms)),
        "cpu_frames_per_s": 1e3 / float(np.mean(cpu_ms)),
        "pixels": render, "pixel_tolerance": RENDER_PIXELS}
    del card_rig
    torch.cuda.empty_cache()
    line["phase_s"] = time.perf_counter() - t_phase
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # imported only now: outside a checkout of the repo this fails
    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        InferenceOptions,
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.models.denoiser import (
        COND_KEYS,
        latent_motion_mask,
    )
    from raggesture_tpu_torch.models.fused_denoiser import (
        SPLIT_PLAIN,
        SplitLayerWeights,
        UnfusedLayerWeights,
        fused_denoise,
        fused_denoise_ctx,
        layer_kernel_mask_rows,
        pack_split_layers,
        padded_tokens,
        precompute_cross_contexts,
        split_mask_rows,
        stack_adaln_weights,
        stack_layer_contexts,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import ffn as FF
    from raggesture_tpu_torch.ops import self_attention as SA
    from raggesture_tpu_torch.ops import build
    from raggesture_tpu_torch.ops.decoder_layer import (
        fused_decoder_layer,
        fused_decoder_layer_reference,
    )
    from raggesture_tpu_torch.ops.cond_ctx import (
        cond_contexts_plain,
        cond_ctx_backward_a,
        cond_ctx_backward_b,
        cond_ctx_bwd_a_reference,
        cond_ctx_bwd_b_reference,
        cond_ctx_forward,
        cond_ctx_reference,
        forward_records,
    )
    from raggesture_tpu_torch.ops.mha import (
        fused_softmax_mha,
        softmax_mha_reference,
    )
    from raggesture_tpu_torch.models.architecture import training_loss
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
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
    seconds = build.build(["decoder_layer", "mha", "cond_ctx",
                           "split_layer"])
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0})

    cfg = ArchitectureConfig()
    dc = cfg.denoiser
    D, T, H, F = dc.latent_dim, dc.num_tokens, dc.num_heads, dc.ff_size
    Hc = dc.ca_heads
    g = torch.Generator(device=dev).manual_seed(1)

    def profile_per_call(fn, calls=16):
        """Device busy ms per call of ``fn`` (kernels that overlap counted
        once), and its device ms and kernel instances per call by kernel
        (torch.profiler).  CUDA events over back-to-back calls give the
        same only where the card, not the host's enqueue, is the slower of
        the two: on calls of a few tens of microseconds they time the
        enqueue."""
        fn()
        torch.cuda.synchronize()
        by_kernel, _, prof = device_profile(torch, fn, calls)
        return (device_busy_ms(prof) / calls,
                {k: ms / calls for k, ms in by_kernel.items()},
                {k: n / calls for k, n in instances_by_kernel(prof).items()})

    def device_ms_by_kernel(fn, calls=16):
        return profile_per_call(fn, calls)[1]

    def device_ms_per_call(fn, calls=16):
        return profile_per_call(fn, calls)[0]

    # ---- 3. K3 vs plain at the training shapes of the three streams ----
    # (early: late in a long process the profiler drops device records)
    B = TRAIN_BATCH
    L = dc.num_layers
    Dh = D // Hc
    bf16 = torch.bfloat16
    k3_names = ("ctx", "dxf", "dg", "db", "dwk", "dbk", "dwv", "dbv")
    k3 = []
    for stream, n_rows in (("text", 150), ("audio", 499), ("spk", 1)):
        xf32, cm3, nv, prm, dctx = k3_case(torch, dc, B, n_rows, dev)
        prm_f = tuple(t.float() for t in prm)
        Np = xf32.shape[1]
        entry = {"stream": stream, "rows": n_rows, "padded_rows": Np}
        # the float32 entry points, then the bf16 ones (bf16 xf in, bf16
        # dxf out: the training step's bf16_compute) on xf rounded to bf16
        for xf in (xf32, xf32.to(bf16)):
            low = xf.dtype == bf16

            def fwd():
                return cond_ctx_forward(xf, cm3, nv, *prm, Hc)

            out, saved = fwd()

            def bwd_a():
                return cond_ctx_backward_a(xf, cm3, nv, *prm, out, saved,
                                           dctx, Hc)

            dxf, dg, db, inter = bwd_a()

            def bwd_b():
                return cond_ctx_backward_b(xf, cm3, prm[0], prm[1], saved,
                                           inter)

            got = (out, dxf, dg, db) + bwd_b()
            # the plain versions on xf's values in float32; the bf16
            # entry's dxf is theirs rounded to bf16, as the autograd
            # function returns it (and JAX's custom_vjp)
            args = (xf.float(), cm3, nv) + prm_f
            want = ((cond_ctx_reference(*args, Hc, bf16),)
                    + cond_ctx_bwd_a_reference(*args, dctx, Hc, bf16)
                    + cond_ctx_bwd_b_reference(*args, dctx, Hc, bf16))
            if low:
                want = (want[0], want[1].to(bf16).float()) + want[2:]
            torch.cuda.synchronize()
            scale = {n: w.abs().max().item() for n, w in zip(k3_names, want)}
            for k_side, v_side in (("dwk", "dwv"), ("dbk", "dbv")):
                scale[k_side] = max(scale[k_side], scale[v_side])
            abs_err = {n: (a.float() - w).abs().max().item()
                       for n, a, w in zip(k3_names, got, want)}
            rel_err = {n: abs_err[n] / scale[n] for n in k3_names}
            tol = {n: TOL_K3_BF16_DXF if low and n == "dxf" else TOL_K3
                   for n in k3_names}
            bad = {n: e for n, e in rel_err.items() if not e <= tol[n]}
            if (bad or not all(torch.isfinite(a).all() for a in got)
                    or (got[1].dtype == bf16) != low):
                raise AssertionError(f"K3 ({stream}, {xf.dtype}) disagrees "
                                     f"with its plain versions: {bad}, "
                                     f"tolerances {tol}")
            out2, saved2 = fwd()
            dxf2, dg2, db2, inter2 = cond_ctx_backward_a(
                xf, cm3, nv, *prm, out2, saved2, dctx, Hc)
            again = (out2, dxf2, dg2, db2) + cond_ctx_backward_b(
                xf, cm3, prm[0], prm[1], saved2, inter2)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K3 ({stream}, {xf.dtype}): two runs "
                                     f"differ")
            # the work each kernel does, and the bytes it must move: the
            # forward's inputs and outputs without the LayerNorm rows it
            # keeps for backward A (saved[4], inter[0]), which reads them
            # once
            rows = B * L * Np
            gemm = 2 * rows * D * D
            w_bytes = tensor_bytes(*prm)
            fwd_flops = 2 * gemm + 2 * rows * D * Dh
            fwd_bytes = tensor_bytes(xf, cm3, nv, out, *saved[:4]) + w_bytes
            a_flops = 4 * gemm + 4 * rows * D * Dh
            a_bytes = (tensor_bytes(xf, cm3, nv, out, dctx, *saved[:4], dxf,
                                    dg, db, *inter)
                       + w_bytes)
            b_flops = 2 * gemm
            b_bytes = tensor_bytes(xf, cm3, *saved[:2], *inter, *prm[:2],
                                   *got[4:])
            sub = {"dtype": str(xf.dtype).split(".")[-1],
                   "max_abs_err": abs_err, "rel_err": rel_err,
                   "tolerance": tol}
            # device ms and instances a call by kernel name, the three
            # wrappers in one profiler window and split by their kernels'
            # names (tests/test_torch_cuda.py gates the instances)
            _, k_ms, k_inst = profile_per_call(
                lambda: (fwd(), bwd_a(), bwd_b()), calls=4)
            merge = forward_records(B, Np, D, L, Dh).merge
            want_inst = {k: float(merge or k != "ctx_fwd_merge")
                         for ks in K3_KERNELS.values() for k in ks}
            got_inst = {k: k_inst.get(k, 0.0) for k in want_inst}
            if got_inst != want_inst:
                raise AssertionError(f"K3 ({stream}, {xf.dtype}) kernel "
                                     f"instances a call {got_inst}, "
                                     f"expected {want_inst}")
            for key, fn, plain, flops, nb in (
                    ("forward", fwd,
                     lambda: cond_ctx_reference(*args, Hc, bf16),
                     fwd_flops, fwd_bytes),
                    ("bwd_a", bwd_a, lambda: cond_ctx_bwd_a_reference(
                        *args, dctx, Hc, bf16), a_flops, a_bytes),
                    ("bwd_b", bwd_b, lambda: cond_ctx_bwd_b_reference(
                        *args, dctx, Hc, bf16), b_flops, b_bytes)):
                t_b, by = bound(nb, flops, BF16_FLOPS)
                sub[key] = {"ms": cuda_ms(torch, fn, iters=10, warmup=1),
                            "device_ms": sum(k_ms.get(k, 0.0)
                                             for k in K3_KERNELS[key]),
                            "kernel_us": {k: k_ms.get(k, 0.0) * 1e3
                                          for k in K3_KERNELS[key]},
                            "instances_per_call": {
                                k: k_inst.get(k, 0.0)
                                for k in K3_KERNELS[key]},
                            "plain_ms": cuda_ms(torch, plain, iters=2,
                                                warmup=1),
                            "bound_ms": t_b, "bound_by": by, "flops": flops,
                            "bytes": nb}
            if low:
                entry["bf16"] = sub
            else:
                entry.update(sub)
                # a products-only yardstick beside backward B, which the
                # port never calls: one torch.bmm of the layers' xn^T [dk |
                # cm dv] (bf16 in, float32 out; one kernel, so CUDA events
                # time the device)
                xn_t = inter[0].reshape(L, B * Np, D).transpose(1, 2)
                dkv = torch.cat(inter[1:3], dim=-1).reshape(L, B * Np, 2 * D)
                entry["bwd_b"]["bmm_products_ms"] = cuda_ms(
                    torch, lambda: torch.bmm(xn_t, dkv,
                                             out_dtype=torch.float32),
                    iters=10, warmup=1)
                del xn_t, dkv
            del out, saved, inter, got, want, again, inter2
        k3.append(entry)
        torch.cuda.empty_cache()
    emit({"phase": "K3", "tolerance": TOL_K3, "batch": B, "streams": k3})

    # ---- 4. K1 vs plain at the sampling shape ----
    B = 2
    R = B * padded_tokens(T)
    args, packed = k1_case(torch, dc, B, g, dev)
    x, m_rows = args[0], args[1]
    out_k = fused_decoder_layer(*args, packed, H, Hc, B)
    again = fused_decoder_layer(*args, packed, H, Hc, B)
    out_p = fused_decoder_layer_reference(*args, packed, H, Hc, B)
    torch.cuda.synchronize()
    valid = m_rows[:, 0] > 0
    k1_err = (out_k - out_p)[valid].abs().max().item()
    if not (torch.isfinite(out_k[valid]).all() and k1_err <= TOL_K1):
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"max_abs_err {k1_err} > {TOL_K1}")
    if not torch.equal(out_k, again):
        raise AssertionError("K1: two runs differ")
    # one call captured in a CUDA graph replays to the eager call's bits
    # (the cooperative launch does not stand in the way of capturing the
    # sampling loops)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = fused_decoder_layer(*args, packed, H, Hc, B)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out_g, out_k):
        raise AssertionError("K1: the CUDA-graph replay differs from the "
                             "eager call")
    del graph
    # eight copies of the pack, cycled as the eight layers of a step are:
    # 75 MB of weights do not stay in the 50 MB L2 between calls
    packs = [{k: v.clone() for k, v in packed.items()} for _ in range(8)]
    cyc = {"i": 0}

    def k1_call(fn):
        def call():
            cyc["i"] = (cyc["i"] + 1) % len(packs)
            fn(*args, packs[cyc["i"]], H, Hc, B)
        return call

    # ms: device time (torch.profiler, 16 calls); CUDA-event ms and host
    # enqueue ms beside it
    k1_by_kernel = device_ms_by_kernel(k1_call(fused_decoder_layer))
    k1_ms = sum(k1_by_kernel.values())
    k1_event_ms = cuda_ms(torch, k1_call(fused_decoder_layer), iters=40)
    k1_host_ms = host_ms_per_call(torch, k1_call(fused_decoder_layer))
    k1_plain_ms = device_ms_per_call(k1_call(fused_decoder_layer_reference))
    Dh, Dhc = D // H, D // Hc
    # each input read once, the output written once; the kernel reads the
    # weights from the pack's ``tiles`` (the same bytes in its own order),
    # not from mats, w1 and w2, which are the plain version's
    k1_bytes = (sum(t.numel() * t.element_size() for t in args)
                + sum(t.numel() * t.element_size() for k, t in packed.items()
                      if k not in ("mats", "w1", "w2"))
                + x.numel() * 4)
    # 14 (D, D) products (q, k, v, out; q, out of three CAs; ca_mix; the
    # FFN's stylization out), the FFN's two, and the per-head attention
    k1_flops = (2 * R * D * (14 * D + 2 * F)
                + 4 * R * D * Dh + 3 * 2 * R * D * Dhc)
    k1_bound, k1_by = bound(k1_bytes, k1_flops, BF16_FLOPS)
    emit({"phase": "K1", "max_abs_err": k1_err, "tolerance": TOL_K1,
          "repeatable": True, "graph_replay_equal": True,
          "ms": k1_ms, "kernel_ms": k1_by_kernel, "event_ms": k1_event_ms,
          "host_ms": k1_host_ms, "plain_ms": k1_plain_ms,
          "bound_ms": k1_bound, "bound_by": k1_by, "bytes": k1_bytes,
          "flops": k1_flops})

    # ---- 5. K2 vs plain at the decoder shapes ----
    k2 = []
    # a batch-1 clip's shapes: upper, hands and face stacked (3, Tq, D) at
    # 32 heads, lowertrans (1, Tq, D) at 64; nine calls of each a clip
    for heads, nb in ((32, 3), (64, 1)):
        Tq = dc.max_seq_len + dc.tokens_per_part
        q, k, v = (torch.randn(nb, Tq, D, generator=g, device=dev)
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
        again = fused_softmax_mha(q, k, v, heads, scale)
        if not torch.equal(out_k, again):
            raise AssertionError(f"K2 ({heads} heads): two runs differ")
        qh, kh, vh = (t.reshape(nb, Tq, heads, dh).transpose(1, 2)
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        nbytes = 4 * q.numel() * 4
        t_b, by = bound(nbytes, 4 * nb * Tq * Tq * D, F32_FLOPS)
        entry = {"heads": heads, "batch": nb, "max_abs_err": err}
        # ms: device time (torch.profiler); event ms and host enqueue ms
        # beside it
        for key, fn in (
                ("", lambda: fused_softmax_mha(q, k, v, heads, scale)),
                ("plain_", lambda: softmax_mha_reference(q, k, v, heads,
                                                         scale)),
                ("library_", lambda: sdpa(qh, kh, vh, scale=scale))):
            entry[key + "ms"] = device_ms_per_call(fn, calls=50)
            entry[key + "event_ms"] = cuda_ms(torch, fn, iters=50)
            entry[key + "host_ms"] = host_ms_per_call(torch, fn)
        k2.append(dict(entry, bound_ms=t_b, bound_by=by))
    emit({"phase": "K2", "tolerance": TOL_K2, "shapes": k2})

    # what every generated clip is checked for, and how clips are timed
    shapes = {"pred_upper": 39, "pred_lower": 27, "pred_facepose": 3,
              "pred_hands": 90, "pred_transl": 3, "pred_exps": 100,
              "pred_contact": 4}

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    def check_clip(label, clip):
        for key, width in shapes.items():
            if tuple(clip[key].shape) != (1, dc.max_seq_len, width):
                raise AssertionError(f"{label}: {key} has shape "
                                     f"{tuple(clip[key].shape)}")
        if tuple(clip["output_latents"].shape) != (1, T, D):
            raise AssertionError(f"{label}: output_latents has shape "
                                 f"{tuple(clip['output_latents'].shape)}")
        if not all(torch.isfinite(v).all() for v in clip.values()):
            raise AssertionError(f"{label}: non-finite values in the clip")

    def timed_clips(label, run, first, n):
        """ms (CUDA events) and host s per clip over ``n`` runs of ``run``,
        each of which must equal ``first`` (the same seed)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            again = run()
        end.record()
        end.synchronize()
        if not torch.equal(again["output_latents"], first["output_latents"]):
            raise AssertionError(f"{label}: the same seed gave another clip")
        return start.elapsed_time(end) / n, (time.perf_counter() - t0) / n

    # ---- 6. the main path: full-width plain generation, batch 1 ----
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    # phases 6-12 run the pipelines eagerly (graphs=False), so that every
    # kernel launch is counted where it runs; phase 13 replays them
    gen = StagedGenerator(model, cfg.diffusion_test.schedule(), graphs=False)
    batch = clip_batch(torch, dc, 1, dev)
    steps = gen.sched.num_timesteps
    torch.cuda.synchronize()
    fused_decoder_layer.launches = 0
    fused_softmax_mha.launches = 0
    t0 = time.perf_counter()
    out = gen.sample(batch, generator=seeded())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"fused_decoder_layer": fused_decoder_layer.launches,
                "fused_softmax_mha": fused_softmax_mha.launches}
    # the codec decoders' layers (num_layers rounded up to odd); the
    # stacked decode makes one K2 call a layer for upper, hands and face
    # together and one for lowertrans
    codec_layers = cfg.codec.num_layers + 1 - cfg.codec.num_layers % 2
    want = {"fused_decoder_layer": steps * dc.num_layers,
            "fused_softmax_mha": 2 * codec_layers}
    if launches != want:
        raise AssertionError(f"kernel launches on the main path {launches}, "
                             f"expected {want}")
    check_clip("main", out)

    # one full-width denoiser call (conditioned + unconditioned halves):
    # kernel path against the plain path, true-separator query masks
    den = model.denoiser
    conds = model.encode_conditions(batch)
    conds2 = {k: torch.cat([v, v]) for k, v in conds.items()}
    tmask2 = latent_motion_mask(dc, torch.cat([batch["motion_mask"]] * 2))
    cm2 = torch.tensor([1.0, 0.0], device=dev).reshape(2, 1, 1)
    ctx3s = stack_layer_contexts(
        dc, precompute_cross_contexts(den, conds2, cm2), torch.bfloat16)
    mr, qr = layer_kernel_mask_rows(tmask2, parity_query_masks(torch, dc, 2, dev))
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
    clip_ms, host_s = timed_clips(
        "main", lambda: gen.sample(batch, generator=seeded()), out, runs)
    emit({"phase": "main", "config": "ArchitectureConfig() full width",
          "batch": 1, "steps": steps, "launches": launches,
          "first_run_s": first_s, "denoiser_max_abs_err": den_err,
          "denoiser_max_abs": den_scale, "tolerance": TOL_DENOISER,
          "ms_per_clip": clip_ms, "host_s_per_clip": host_s,
          "clips_per_s": 1e3 / clip_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})

    # ---- where the time goes: device time by kernel over one clip ----
    by_kernel, device_ops, prof = device_profile(
        torch, lambda: gen.sample(batch, generator=seeded()))
    device_ms = device_busy_ms(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # K1 is one kernel per layer call: its instances in the clip
    k1_instances = instances_by_kernel(prof).get("decoder_layer_kernel", 0)
    if k1_instances != launches["fused_decoder_layer"]:
        raise AssertionError(f"K1: {k1_instances} kernel instances in a "
                             f"profiled clip, expected "
                             f"{launches['fused_decoder_layer']}")
    # busy share against the clip's unprofiled time (the profiler slows the
    # host, not the kernels)
    emit({"phase": "profile", "device_ms": device_ms, "clip_ms": clip_ms,
          "device_busy_share": device_ms / clip_ms,
          "device_ops": device_ops, "top_device_ms": dict(top),
          "k1_kernel_instances": k1_instances})

    # ---- 8. K4, K5, K7, K8 vs plain at the sampling shape, float32 ----
    L = dc.num_layers
    sc = split_case(torch, dc, g, dev)
    svalid = sc["valid"]
    sx, ssc, sqm3 = sc["x"], sc["sc"], sc["qm3"]
    R = B * T
    Dhc = D // Hc
    w0 = sc["packs"][0]
    x_bytes = 2 * tensor_bytes(sx)              # read once, written once
    s_bytes = 2 * tensor_bytes(ssc[:, 0])       # one scale and one shift row
    split_work = {   # (bytes, flops) of one call; weights read once
        "fused_self_attention": (
            x_bytes + tensor_bytes(sc["src"]) + s_bytes
            + tensor_bytes(*w0.sa.tensors),
            8 * R * D * D + 4 * R * D * (D // H)),
        "fused_cross_attention_cached": (
            x_bytes + tensor_bytes(sc["ctx3"][0][:, 1], sqm3[..., 1])
            + s_bytes + tensor_bytes(*w0.cross_block.cas[1].tensors),
            4 * R * D * D + 2 * R * D * Dhc),
        "fused_cross_block_cached": (
            x_bytes + tensor_bytes(sc["ctx3"][0], sqm3) + 3 * s_bytes
            + tensor_bytes(*w0.cross_block.tensors),
            18 * R * D * D + 6 * R * D * Dhc),
        "fused_ffn": (
            x_bytes + s_bytes + tensor_bytes(*w0.ffn.tensors),
            4 * R * D * F + 2 * R * D * D),
    }
    # device kernel instances per call: K5 self_qkv, self_context,
    # cross_output; K4 cross_query, cross_output; K7 those and cross_mix; K8
    # ffn_up, ffn_down, cross_output
    split_instances = {"fused_self_attention": 3,
                       "fused_cross_attention_cached": 2,
                       "fused_cross_block_cached": 3, "fused_ffn": 3}
    split_k = {}
    for fn, plain in ((SA.fused_self_attention,
                       SA.fused_self_attention_reference),
                      (CA.fused_cross_attention_cached,
                       CA.fused_cross_attention_cached_reference),
                      (CA.fused_cross_block_cached,
                       CA.fused_cross_block_cached_reference),
                      (FF.fused_ffn, FF.fused_ffn_reference)):
        name = fn.__name__
        out_k = fn(*split_args(sc, name, 0))
        again = fn(*split_args(sc, name, 0))
        out_p = plain(*split_args(sc, name, 0))
        torch.cuda.synchronize()
        err = (out_k - out_p)[svalid].abs().max().item()
        if not (torch.isfinite(out_k[svalid]).all() and err <= TOL_SPLIT):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max_abs_err {err} > {TOL_SPLIT}")
        if not torch.equal(out_k, again):
            raise AssertionError(f"{name}: two runs differ")
        # every row finite, the masked ones too (a masked query row's y is
        # -1e6 + O(1) in the cross attentions), and a CUDA-graph replay
        if not torch.isfinite(out_k).all():
            raise AssertionError(f"{name}: non-finite output rows")
        if not graph_replay_equal(
                torch, lambda name=name: fn(*split_args(sc, name, 0)), out_k):
            raise AssertionError(f"{name}: the CUDA-graph replay differs "
                                 f"from the eager call")
        entry = {"graph_replay_equal": True}
        if name == "fused_self_attention":
            # the second sequence masked whole: its time softmax takes its
            # own max, so every row stays finite and the first sequence's
            # rows agree with the plain version's
            dead = dict(sc, src=sc["src"].clone())
            dead["src"][1] = 0.0
            out_d = fn(*split_args(dead, name, 0))
            out_dp = plain(*split_args(dead, name, 0))
            torch.cuda.synchronize()
            dvalid = dead["src"][..., 0] > 0
            d_err = (out_d - out_dp)[dvalid].abs().max().item()
            if not (torch.isfinite(out_d).all() and d_err <= TOL_SPLIT):
                raise AssertionError(f"{name} with a fully masked partner: "
                                     f"max_abs_err {d_err}, finite "
                                     f"{bool(torch.isfinite(out_d).all())}")
            entry["masked_partner_max_abs_err"] = d_err

        def cycled(f, name=name):
            def call():
                cyc["i"] = (cyc["i"] + 1) % L
                f(*split_args(sc, name, cyc["i"]))
            return call

        busy, by_kernel, per_call = profile_per_call(cycled(fn))
        if sum(per_call.values()) != split_instances[name]:
            raise AssertionError(f"{name}: device kernel instances per call "
                                 f"{per_call}, expected "
                                 f"{split_instances[name]}")
        nbytes, flops = split_work[name]
        t_b, by = bound(nbytes, flops, F32_FLOPS)
        # the same products as three TF32 products each (3xTF32) on the
        # tensor cores; the rest of the work is a few percent
        entry["bound_3xtf32_ms"] = bound(nbytes, 3 * flops, TF32_FLOPS)[0]
        split_k[name] = dict(entry, **{
            "max_abs_err": err, "max_abs": out_p[svalid].abs().max().item(),
            "ms": busy, "kernel_ms": by_kernel,
            "instances_per_call": per_call,
            "plain_ms": device_ms_per_call(cycled(plain)),
            "event_ms": cuda_ms(torch, cycled(fn), iters=40),
            "plain_event_ms": cuda_ms(torch, cycled(plain), iters=16),
            "host_ms": host_ms_per_call(torch, cycled(fn)),
            "plain_host_ms": host_ms_per_call(torch, cycled(plain)),
            "bound_ms": t_b, "bound_by": by, "bytes": nbytes,
            "flops": flops})
    emit({"phase": "split_kernels", "tolerance": TOL_SPLIT, "batch": B,
          "tokens": T, "kernels": split_k})

    # ---- 9. K6 vs plain at the sampling shape, three streams, float32 ----
    # phase 8's inputs: a masked token, true-separator query masks, the
    # conditions dropped in the second sequence (its keys at -1e6)
    k6 = {}
    for j, key in enumerate(COND_KEYS):
        n_rows = sc["conds"][key].shape[1]
        out_k = CA.fused_cross_attention(*k6_args(sc, j, 0))
        again = CA.fused_cross_attention(*k6_args(sc, j, 0))
        out_p = CA.fused_cross_attention_reference(*k6_args(sc, j, 0))
        torch.cuda.synchronize()
        qvalid = sqm3[..., j] > 0
        err = (out_k - out_p)[qvalid].abs().max().item()
        if not (torch.isfinite(out_k).all() and err <= TOL_SPLIT):
            raise AssertionError(f"fused_cross_attention ({key}) disagrees "
                                 f"with its plain version: max_abs_err "
                                 f"{err} > {TOL_SPLIT}")
        if not torch.equal(out_k, again):
            raise AssertionError(f"fused_cross_attention ({key}): two runs "
                                 f"differ")
        if not graph_replay_equal(
                torch, lambda j=j: CA.fused_cross_attention(
                    *k6_args(sc, j, 0)), out_k):
            raise AssertionError(f"fused_cross_attention ({key}): the "
                                 f"CUDA-graph replay differs")

        def cycled(f, j=j):
            def call():
                cyc["i"] = (cyc["i"] + 1) % L
                f(*k6_args(sc, j, cyc["i"]))
            return call

        # weights and each input read once, the output written once; the
        # products q, out (R rows), k, v (B N rows), the contexts and the
        # readout per head
        nbytes = (x_bytes + s_bytes
                  + tensor_bytes(sc["conds"][key], sqm3[..., j], sc["cm"])
                  + tensor_bytes(*sc["kvpacks"][0][j].tensors))
        flops = (4 * R * D * D + 4 * B * n_rows * D * D
                 + 2 * B * n_rows * D * Dhc + 2 * R * D * Dhc)
        t_b, by = bound(nbytes, flops, F32_FLOPS)
        fn, plain = CA.fused_cross_attention, CA.fused_cross_attention_reference
        busy, by_kernel, per_call = profile_per_call(cycled(fn))
        # text_norm, k/v context, combine (not for a one-tile stream), and
        # the query side's two
        want_n = 4 if n_rows <= CA.kv_row_tile(n_rows, Dhc) else 5
        if sum(per_call.values()) != want_n:
            raise AssertionError(f"fused_cross_attention ({key}): device "
                                 f"kernel instances per call {per_call}, "
                                 f"expected {want_n}")
        k6[key] = {
            "rows": n_rows, "max_abs_err": err,
            "max_abs": out_p[qvalid].abs().max().item(),
            "graph_replay_equal": True,
            "ms": busy, "kernel_ms": by_kernel,
            "instances_per_call": per_call,
            "plain_ms": device_ms_per_call(cycled(plain)),
            "event_ms": cuda_ms(torch, cycled(fn), iters=40),
            "plain_event_ms": cuda_ms(torch, cycled(plain), iters=16),
            "host_ms": host_ms_per_call(torch, cycled(fn)),
            "plain_host_ms": host_ms_per_call(torch, cycled(plain)),
            "bound_ms": t_b, "bound_by": by, "bytes": nbytes, "flops": flops}
    emit({"phase": "K6", "tolerance": TOL_SPLIT, "batch": B, "tokens": T,
          "streams": k6})
    del sc

    # ---- 10. the split path: full-width generation, batch 1 ----
    K5, K6 = "fused_self_attention", "fused_cross_attention"

    def split_kernel_instances(launches):
        """Device kernel instances by kernel name that a clip's split-path
        wrapper calls (``launches``) enqueue, from each wrapper's instances
        per call in phases 8 and 9; K6's calls are a third each stream's."""
        want = {}
        for name, calls in launches.items():
            if name == K6:
                tables = [(e["instances_per_call"], calls / len(k6))
                          for e in k6.values()]
            elif name in split_k:
                tables = [(split_k[name]["instances_per_call"], calls)]
            else:
                continue
            for table, n in tables:
                for k, per in table.items():
                    want[k] = want.get(k, 0) + per * n
        return {k: round(v) for k, v in want.items() if round(v)}

    def profile_clip(label, run, launches):
        """device_profile of one clip of ``run``, whose split-path kernels
        must run as many instances by name as its wrapper calls give (a
        window now and then drops device records: at most three windows)."""
        want = split_kernel_instances(launches)
        for _ in range(3):
            kernels, ops, prof = device_profile(torch, run)
            got = {k: n for k, n in instances_by_kernel(prof).items()
                   if k in want}
            if got == want:
                return kernels, ops, prof, got
        raise AssertionError(f"{label}: split-path kernel instances in a "
                             f"profiled clip {got}, expected {want}")

    split_fns = (SA.fused_self_attention, CA.fused_cross_attention_cached,
                 CA.fused_cross_block_cached, FF.fused_ffn)
    counted = split_fns + (fused_decoder_layer, fused_softmax_mha)
    k2_clip = want["fused_softmax_mha"]
    per_clip = steps * dc.num_layers
    # the layer kernel's call of phase 6 on the same inputs, float32
    # contexts and (B, T) masks for the split path
    sctx3s = stack_layer_contexts(
        dc, precompute_cross_contexts(den, conds2, cm2), torch.float32)
    smr, sqr = split_mask_rows(tmask2, parity_query_masks(torch, dc, 2, dev))
    split_main = {}
    for label, opts, want_split in (
            ("layer_kernel=False", dict(layer_kernel=False),
             {"fused_self_attention": per_clip,
              "fused_cross_attention_cached": 3 * per_clip,
              "fused_cross_block_cached": 0, "fused_ffn": 0,
              "fused_decoder_layer": 0, "fused_softmax_mha": k2_clip}),
            ("merged_ca=True", dict(merged_ca=True),
             {"fused_self_attention": per_clip,
              "fused_cross_attention_cached": 0,
              "fused_cross_block_cached": per_clip, "fused_ffn": 0,
              "fused_decoder_layer": 0, "fused_softmax_mha": k2_clip})):
        sgen = StagedGenerator(model, cfg.diffusion_test.schedule(),
                               graphs=False, **opts)
        if sgen.layer_kernel or not all(isinstance(w, SplitLayerWeights)
                                        for w in sgen.packs):
            raise AssertionError(f"{label}: the layer kernel's path was taken")
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        sout = sgen.sample(batch, generator=seeded())
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in counted}
        if got != want_split:
            raise AssertionError(f"{label}: kernel launches in one clip {got}, "
                                 f"expected {want_split}")
        check_clip(label, sout)
        s_clip_ms, s_host = timed_clips(
            label, lambda: sgen.sample(batch, generator=seeded()), sout, runs)
        s_kernel, s_ops, s_prof, s_inst = profile_clip(
            label, lambda: sgen.sample(batch, generator=seeded()), got)
        s_device_ms = device_busy_ms(s_prof)
        # one denoiser call (phase 6's inputs), kernels against plain
        merged = opts.get("merged_ca", False)
        scall = (den, x2, gen.adaln_scale[step], gen.adaln_shift[step],
                 sgen.packs, sctx3s, smr, sqr)
        d_s = fused_denoise_ctx(*scall, layer_kernel=False, merged_ca=merged)
        d_sp = fused_denoise_ctx(*scall, layer_kernel=False, merged_ca=merged,
                                 split_fns=SPLIT_PLAIN)
        torch.cuda.synchronize()
        s_err = (d_s - d_sp)[tvalid].abs().max().item()
        vs_k1 = (d_s - d_k)[tvalid].abs().max().item()
        if not (s_err <= TOL_SPLIT_DENOISER and vs_k1 <= TOL_DENOISER):
            raise AssertionError(
                f"{label} denoiser call: kernels vs plain {s_err} (tolerance "
                f"{TOL_SPLIT_DENOISER}), vs the layer kernel's {vs_k1} "
                f"(tolerance {TOL_DENOISER})")
        split_main[label] = {
            "launches": got, "first_run_s": first_s, "ms_per_clip": s_clip_ms,
            "host_s_per_clip": s_host, "clips_per_s": 1e3 / s_clip_ms,
            "device_ms": s_device_ms, "device_busy_share":
            s_device_ms / s_clip_ms, "device_ops": s_ops,
            "kernel_instances": s_inst,
            "top_device_ms": dict(sorted(s_kernel.items(),
                                         key=lambda kv: -kv[1])[:8]),
            "denoiser_max_abs_err": s_err,
            "denoiser_vs_layer_kernel": vs_k1}
        del sgen, sout
    # fused_denoise_ctx(ffn_pallas=True): K8 once per layer
    for fn in split_fns:
        fn.launches = 0
    d_f = fused_denoise_ctx(*scall, layer_kernel=False, ffn_pallas=True)
    ffn_launches = FF.fused_ffn.launches
    d_fp = fused_denoise_ctx(*scall, layer_kernel=False, ffn_pallas=True,
                             split_fns=SPLIT_PLAIN)
    torch.cuda.synchronize()
    f_err = (d_f - d_fp)[tvalid].abs().max().item()
    if ffn_launches != dc.num_layers or not f_err <= TOL_SPLIT_DENOISER:
        raise AssertionError(f"ffn_pallas=True: {ffn_launches} fused_ffn "
                             f"launches, kernels vs plain {f_err}")
    emit({"phase": "split_main", "config": "ArchitectureConfig() full width",
          "batch": 1, "steps": steps, "runs": split_main,
          "ffn_pallas_launches_per_call": ffn_launches,
          "ffn_pallas_max_abs_err": f_err, "denoiser_max_abs": den_scale,
          "tolerance": TOL_SPLIT_DENOISER, "tolerance_vs_layer_kernel":
          TOL_DENOISER})
    del scall, sctx3s, d_s, d_sp, d_f, d_fp

    # ---- 11. the uncached path: StagedGenerator(fused=False), batch 1 ----
    all_fns = (fused_decoder_layer, fused_softmax_mha, SA.fused_self_attention,
               CA.fused_cross_attention_cached, CA.fused_cross_attention,
               CA.fused_cross_block_cached, FF.fused_ffn)

    def zero_launches():
        torch.cuda.synchronize()
        for fn in all_fns:
            fn.launches = 0

    def launches_now():
        return {fn.__name__: fn.launches for fn in all_fns if fn.launches}

    ugen = StagedGenerator(model, cfg.diffusion_test.schedule(), fused=False,
                           graphs=False)
    if ugen.fused or not all(isinstance(w, UnfusedLayerWeights)
                             for w in ugen.packs):
        raise AssertionError("fused=False: the cached path was taken")
    zero_launches()
    t0 = time.perf_counter()
    uout = ugen.sample(batch, generator=seeded())
    torch.cuda.synchronize()
    u_first_s = time.perf_counter() - t0
    u_launches = launches_now()
    k2_unstacked = 4 * codec_layers       # fused=False: part by part
    want_u = {K5: per_clip, K6: 3 * per_clip,
              "fused_softmax_mha": k2_unstacked}
    if u_launches != want_u:
        raise AssertionError(f"fused=False: kernel launches in one clip "
                             f"{u_launches}, expected {want_u}")
    check_clip("fused=False", uout)
    u_clip_ms, u_host = timed_clips(
        "fused=False", lambda: ugen.sample(batch, generator=seeded()), uout,
        3)
    u_kernel, u_ops, u_prof, u_inst = profile_clip(
        "fused=False", lambda: ugen.sample(batch, generator=seeded()),
        u_launches)
    u_device_ms = device_busy_ms(u_prof)
    # one uncached denoiser call (phase 6's inputs, both halves at the
    # shared timestep of step ``step``): kernels against plain versions,
    # and against the cached float32 call on the same inputs
    qm2 = parity_query_masks(torch, dc, 2, dev)
    t2 = gen.sched.timestep_map[step].repeat(2)
    ucall = (den, x2, t2, tmask2, conds2, qm2, cm2, ugen.packs,
             stack_adaln_weights(den))
    d_u = fused_denoise(*ucall)
    d_up = fused_denoise(*ucall, fns=SPLIT_PLAIN)
    d_c = fused_denoise_ctx(
        den, x2, gen.adaln_scale[step], gen.adaln_shift[step],
        pack_split_layers(den),
        stack_layer_contexts(dc, precompute_cross_contexts(den, conds2, cm2),
                             torch.float32),
        *split_mask_rows(tmask2, qm2), layer_kernel=False)
    torch.cuda.synchronize()
    u_err = (d_u - d_up)[tvalid].abs().max().item()
    u_vs_cached = (d_u - d_c)[tvalid].abs().max().item()
    if not (u_err <= TOL_SPLIT_DENOISER
            and u_vs_cached <= TOL_SPLIT_DENOISER):
        raise AssertionError(
            f"fused_denoise call: kernels vs plain {u_err}, vs the cached "
            f"call {u_vs_cached} (tolerance {TOL_SPLIT_DENOISER})")
    emit({"phase": "unfused_main", "config": "ArchitectureConfig() full width",
          "batch": 1, "steps": steps, "launches": u_launches,
          "first_run_s": u_first_s, "ms_per_clip": u_clip_ms,
          "host_s_per_clip": u_host, "clips_per_s": 1e3 / u_clip_ms,
          "device_ms": u_device_ms,
          "device_busy_share": u_device_ms / u_clip_ms, "device_ops": u_ops,
          "kernel_instances": u_inst,
          "top_device_ms": dict(sorted(u_kernel.items(),
                                       key=lambda kv: -kv[1])[:10]),
          "denoiser_max_abs_err": u_err, "denoiser_vs_cached": u_vs_cached,
          "denoiser_max_abs": d_up[tvalid].abs().max().item(),
          "tolerance": TOL_SPLIT_DENOISER})
    del ucall, d_u, d_up, d_c

    # ---- 12. the inference options: guided, outpaint, prev-latent ----
    Q = 2
    gq = torch.Generator(device=dev).manual_seed(7)
    gs = torch.Generator().manual_seed(7)        # the splice rows, on the host
    Lp = dc.tokens_per_part
    splice = []
    for _ in range(Q):
        ln = int(torch.randint(1, Lp + 1, (1,), generator=gs))
        splice.append([0, int(torch.randint(0, Lp - ln + 1, (1,), generator=gs)),
                       int(torch.randint(0, Lp - ln + 1, (1,), generator=gs)),
                       ln])
    rml = torch.zeros(1, T, D, device=dev)
    rml[:, [0, 1, Lp + 1]] = torch.randn(1, 3, D, generator=gq, device=dev)
    re_dict = {
        "inv_latents": torch.randn(Q, T, D, generator=gq, device=dev),
        "inv_mask": latent_motion_mask(dc, torch.ones(Q, dc.max_seq_len,
                                                      device=dev)),
        "inv_conds": {
            "word": torch.randn(Q, 150, dc.text_latent_dim, generator=gq,
                                device=dev),
            "audio": torch.randn(Q, 499, dc.audio_latent_dim, generator=gq,
                                 device=dev),
            "speaker_ids": torch.tensor([5, 11], device=dev)},
        "splice": splice, "raw_motion_latents": rml}
    guided_opts = InferenceOptions(use_inversion=True, insertion_guidance=True)
    plain_clip = {K5: per_clip, K6: 3 * per_clip,
                  "fused_softmax_mha": k2_unstacked}
    guided = {}
    for label, g_run, opts, kw, want_g, n_timed in (
            ("guided fused=False", ugen, guided_opts, dict(re_dict=re_dict),
             {K5: 2 * per_clip, K6: 6 * per_clip,
              "fused_softmax_mha": k2_unstacked}, 1),
            ("guided fused=True", gen, guided_opts, dict(re_dict=re_dict),
             {"fused_decoder_layer": 2 * per_clip,
              "fused_softmax_mha": k2_clip}, 1),
            ("outpaint fused=False", ugen, InferenceOptions(outpaint=True),
             dict(re_dict=re_dict), plain_clip, 1),
            ("prev_latent fused=False", ugen,
             InferenceOptions(use_prev_latent=True),
             dict(prev_latent=uout["prev_latentout"]), plain_clip, 1)):
        def run(g_run=g_run, opts=opts, kw=kw):
            return g_run(batch, seeded(), opts, **kw)

        zero_launches()
        t0 = time.perf_counter()
        first = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = launches_now()
        if got != want_g:
            raise AssertionError(f"{label}: kernel launches in one clip "
                                 f"{got}, expected {want_g}")
        check_clip(label, first)
        if torch.equal(first["output_latents"], uout["output_latents"]):
            raise AssertionError(f"{label}: the options changed nothing")
        g_ms, g_host = timed_clips(label, run, first, n_timed)
        _, g_ops, g_prof = device_profile(torch, run)
        guided[label] = {"launches": got, "first_run_s": first_s,
                         "ms_per_clip": g_ms, "host_s_per_clip": g_host,
                         "runs_timed": n_timed,
                         "device_ms": device_busy_ms(g_prof),
                         "device_ops": g_ops}
    zero_launches()
    chk = ugen.inversion_self_check(re_dict)
    torch.cuda.synchronize()
    got = launches_now()
    want_chk = {K5: 2 * per_clip, K6: 6 * per_clip,
                "fused_softmax_mha": k2_unstacked}
    curve, recon = chk["error_curve"], chk["recon_error"]
    if (got != want_chk or tuple(curve.shape) != (steps, Q)
            or tuple(recon.shape) != (Q,)
            or not (torch.isfinite(curve).all() and torch.isfinite(recon).all())):
        raise AssertionError(f"inversion_self_check: launches {got} "
                             f"(expected {want_chk}), error_curve "
                             f"{tuple(curve.shape)}, recon_error {recon}")
    emit({"phase": "guided", "config": "ArchitectureConfig() full width",
          "batch": 1, "exemplars": Q, "splice": splice, "steps": steps,
          "runs": guided, "self_check_launches": got,
          "error_curve_first_last": [curve[0].tolist(), curve[-1].tolist()],
          "recon_error": recon.tolist()})
    del ugen, uout, chk

    # ---- 13. the pipelines as CUDA graphs, batch 1 ----
    named = dict(re_dict, inv_names=[f"exemplar_{i}" for i in range(Q)],
                 num_queries=Q)
    k2_kernel, k1_kernel = "mha_kernel", "decoder_layer_kernel"

    def route_run(run_gen, route):
        def run():
            if route == "sample":
                return run_gen.sample(batch, generator=seeded())
            if route == "outpaint":
                return run_gen(batch, seeded(), InferenceOptions(outpaint=True),
                               re_dict)
            return run_gen(batch, seeded(), guided_opts,
                           named if route == "cached" else re_dict)
        return run

    def same_clip(a, b):
        return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                              for k in a)

    def replay_instances(label, run, want):
        """Kernel instances by name over one profiled replay, which must be
        ``want``, its device operations and the profile (a window now and
        then drops device records: at most three windows)."""
        for _ in range(3):
            with profiled(torch) as prof:
                run()
                torch.cuda.synchronize()
            inst = instances_by_kernel(prof)
            got = {k: n for k, n in inst.items() if k in want}
            if got == want:
                return device_time_by_kernel(prof)[1], prof, got
        raise AssertionError(f"{label}: kernel instances in a replay {got}, "
                             f"expected {want}")

    graph_runs = {}
    for label, opts, route in (
            ("sample", {}, "sample"),
            ("sample_inseq (outpaint)", {}, "outpaint"),
            ("guided", {}, "guided"),
            ("guided_cached (full hit)", {}, "cached"),
            ("sample layer_kernel=False", dict(layer_kernel=False), "sample"),
            ("sample merged_ca=True", dict(merged_ca=True), "sample"),
            ("sample fused=False", dict(fused=False), "sample")):
        sched = cfg.diffusion_test.schedule()
        erun = route_run(StagedGenerator(model, sched, graphs=False, **opts),
                         route)
        ggen = StagedGenerator(model, sched, **opts)
        grun = route_run(ggen, route)
        zero_launches()
        want_clip = erun()         # cached: the misses inverted here
        if route == "cached":
            zero_launches()
            want_clip = erun()     # a full hit
        torch.cuda.synchronize()
        e_launches = launches_now()
        e_ms, e_host = timed_clips(f"{label} eager", erun, want_clip, 2)
        # the first call: one eager warm-up, the capture, a replay
        zero_launches()
        t0 = time.perf_counter()
        first = grun()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        capture_launches = launches_now()
        if route != "cached" and capture_launches != {
                k: 2 * n for k, n in e_launches.items()}:
            raise AssertionError(f"{label}: launches of the warm-up and the "
                                 f"capture {capture_launches}, expected twice "
                                 f"{e_launches}")
        if route == "cached" and any(capture_launches.get(k, 0) < 2 * n
                                     for k, n in e_launches.items()):
            raise AssertionError(f"{label}: launches of the captures "
                                 f"{capture_launches}, eager {e_launches}")
        check_clip(label, first)
        zero_launches()
        mem0 = torch.cuda.memory_allocated()
        # six replays timed: memory must be where it was before them
        g_ms, g_host = timed_clips(f"{label} replayed", grun, want_clip, 6)
        torch.cuda.synchronize()
        mem10 = torch.cuda.memory_allocated()
        held = grun()
        held_copy = {k: v.clone() for k, v in held.items()}
        other = grun()
        torch.cuda.synchronize()
        if launches_now():
            raise AssertionError(f"{label}: replays launched from Python: "
                                 f"{launches_now()}")
        if not (same_clip(first, want_clip) and same_clip(other, want_clip)
                and same_clip(held, held_copy)):
            raise AssertionError(f"{label}: a replay differs from the eager "
                                 f"clip, or a held result changed")
        if mem10 != mem0:
            raise AssertionError(f"{label}: device memory {mem0} before ten "
                                 f"replays, {mem10} after")
        want_inst = split_kernel_instances(e_launches)
        for name, fn in ((k1_kernel, "fused_decoder_layer"),
                         (k2_kernel, "fused_softmax_mha")):
            if e_launches.get(fn):
                want_inst[name] = e_launches[fn]
        ops, prof, inst = replay_instances(label, grun, want_inst)
        device_ms = device_busy_ms(prof)
        graph_runs[label] = {
            "eager_launches": e_launches,
            "capture_launches": capture_launches,
            "captured_graphs": len(ggen.graphs),
            "first_call_s": first_s,
            "eager_ms_per_clip": e_ms, "eager_host_s_per_clip": e_host,
            "replay_ms_per_clip": g_ms, "replay_host_s_per_clip": g_host,
            "replay_device_ms": device_ms, "replay_device_ops": ops,
            "replay_busy_share": device_ms / g_ms,
            "kernel_instances_per_replay": inst,
            "replay_equals_eager": True, "memory_steady": mem10 == mem0,
            "memory_allocated_gb": mem10 / 2 ** 30}
        del ggen, grun, erun, first, held, held_copy, other, want_clip
    emit({"phase": "graphs", "config": "ArchitectureConfig() full width",
          "batch": 1, "exemplars": Q, "steps": steps, "runs": graph_runs})
    del re_dict, named


    # ---- 14. the serving tool at full width, on a workspace that phases
    # 15 and 16 read after it ----
    # the full-width model and what holds it go: phase 12's last
    # generator (a loop variable and the last run's default argument); so
    # do the last cases of phases 3 (K3), 4 (K1) and 8 (the split kernels)
    del model, gen, den, call, g_run, run
    del (xf, xf32, cm3, nv, prm, prm_f, dctx, fwd, bwd_a, bwd_b, out2, saved2,
         dxf2, dg2, db2, packed, packs, k1_call, dead, w0)
    leftover = cuda_gb_by_name(torch, dict(locals()))
    torch.cuda.empty_cache()
    ws = tempfile.mkdtemp(prefix="smoke_")

    def tool_phase(phase_fn, *args, **kw):
        """A tool phase's line with the device memory allocated before and
        after it, which must not grow by more than TOOL_LEAK_GB."""
        before = allocated_gb(torch)
        line = phase_fn(torch, dev, *args, **kw)
        after = allocated_gb(torch)
        if after - before > TOOL_LEAK_GB:
            raise AssertionError(f"phase {line['phase']}: {after - before} GB "
                                 f"still allocated after it returned")
        torch.cuda.empty_cache()
        return dict(line, allocated_before_gb=before,
                    allocated_after_gb=after)

    emit(dict(tool_phase(serve_phase, ws=ws),
              allocated_by_leftover_names_gb=leftover))

    # ---- 15. long-form synthesis at full width ----
    emit(tool_phase(longform_phase, ws))

    # ---- 16. the training path: full width, device batch 128 ----
    held_gb = allocated_gb(torch)
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    sched_train = cfg.diffusion_train.schedule(device=dev)
    frames = dc.max_seq_len
    B = TRAIN_BATCH
    tbatch, rt = train_batch(torch, dc, B, dev)
    codec0 = {k: v.clone() for k, v in model.codec.state_dict().items()}
    den0 = {k: v.detach().clone()
            for k, v in model.denoiser.named_parameters()}
    copies_gb = tensor_bytes(*codec0.values(), *den0.values()) / 2 ** 30
    state = create_train_state(model, OptimConfig())
    train_step = make_train_step(sched_train)
    tgen = torch.Generator(device=dev).manual_seed(4)
    k3_fns = (cond_ctx_forward, cond_ctx_backward_a, cond_ctx_backward_b)
    for fn in k3_fns + (fused_decoder_layer, fused_softmax_mha):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = train_step(state, tbatch, tgen)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    step_launches = {fn.__name__: fn.launches for fn in k3_fns}
    if (step_launches != {fn.__name__: 3 for fn in k3_fns}
            or fused_decoder_layer.launches or fused_softmax_mha.launches):
        raise AssertionError(f"kernel launches in one train step "
                             f"{step_launches}, expected 3 of each K3 kernel")
    train_step(state, tbatch, tgen)           # second warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    for fn in k3_fns:
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        logs = train_step(state, tbatch, tgen)
    end.record()
    end.synchronize()
    host_s = (time.perf_counter() - t0) / steps
    step_ms = start.elapsed_time(end) / steps
    timed_launches = {fn.__name__: fn.launches for fn in k3_fns}
    if timed_launches != {fn.__name__: 3 * steps for fn in k3_fns}:
        raise AssertionError(f"K3 launches over {steps} steps "
                             f"{timed_launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    logs = {k: v.item() for k, v in logs.items()}
    if not all(math.isfinite(v) for v in logs.values()):
        raise AssertionError(f"non-finite training logs {logs}")
    for k, v in model.codec.state_dict().items():
        if not torch.equal(v, codec0[k]):
            raise AssertionError(f"the frozen codec changed: {k}")
    unchanged = [k for k, v in model.denoiser.named_parameters()
                 if torch.equal(v, den0[k]) and not zero_exact_gradient(k)]
    if unchanged:
        raise AssertionError(f"denoiser parameters not updated: {unchanged}")

    # one step's gradients, K3's kernels against its plain versions, on
    # the same draws (dropped conditions included)
    n_chunks = frames // cfg.codec.frame_chunk_size
    cond_mask = torch.ones(B, 1, 1, device=dev)
    cond_mask[::10] = 0.0
    draws = {"enc_eps": {p: rt(B, n_chunks, cfg.codec.latent_dim)
                         for p in ("upper", "hands", "face", "lowertrans")},
             "t": torch.randint(0, sched_train.num_timesteps, (B,),
                                generator=rt.generator, device=dev),
             "noise": rt(B, T, D), "cond_mask": cond_mask}

    def step_grads(batch, step_draws, **kw):
        model.denoiser.zero_grad(set_to_none=True)
        loss, _ = training_loss(model, sched_train, batch, **step_draws, **kw)
        loss.backward()
        return loss.item(), {k: v.grad.clone()
                             for k, v in model.denoiser.named_parameters()}

    def kernel_grad_err(batch, step_draws, label):
        """One step's gradients with K3's kernels against its plain
        versions: the worst tensor's relative error, gated."""
        loss_k, grads_k = step_grads(batch, step_draws)
        loss_p, grads_p = step_grads(batch, step_draws,
                                     ctx_fn=functools.partial(
                                         cond_contexts_plain,
                                         operand_dtype=bf16))
        err = {k: ((grads_k[k] - grads_p[k]).abs().max()
                   / grads_p[k].abs().max()).item()
               for k in grads_k if not zero_exact_gradient(k)}
        worst = max(err, key=err.get)
        g_scale = max(g.abs().max().item() for g in grads_p.values())
        zero_max = max(grads_k[k].abs().max().item()
                       for k in grads_k if zero_exact_gradient(k))
        model.denoiser.zero_grad(set_to_none=True)
        if not (err[worst] <= TOL_TRAIN_GRAD and zero_max <= 1e-4 * g_scale):
            raise AssertionError(f"{label} gradients, kernels vs plain: "
                                 f"{worst} {err[worst]} > {TOL_TRAIN_GRAD}, "
                                 f"or zero-gradient tensors at {zero_max}")
        return loss_k, loss_p, err[worst], worst, zero_max

    loss_k, loss_p, grad_worst, worst, zero_grad_max = kernel_grad_err(
        tbatch, draws, "train-step")

    with profiled(torch) as prof:
        train_step(state, tbatch, tgen)
        torch.cuda.synchronize()
    t_kernel, t_ops = device_time_by_kernel(prof)
    t_device_ms = sum(t_kernel.values())
    k3_device_ms = sum(v for k, v in t_kernel.items()
                       if any(k.split("::")[-1] in ns
                              for ns in K3_KERNELS.values()))
    with torch.no_grad():
        encode_ms = cuda_ms(torch, lambda: model.encode_motion(
            tbatch, draws["enc_eps"]), iters=3, warmup=1)
    options_rows = train_options_rows(torch, dev, model, state, tbatch, rt,
                                      draws, sched_train, tgen, ws,
                                      kernel_grad_err, held_gb + copies_gb)
    bf16_row = bf16_step_rows(torch, dev, model, tbatch, draws, sched_train,
                              tgen, step_grads, held_gb + copies_gb)
    emit({"phase": "train", "config": "ArchitectureConfig() full width",
          "batch": B, "steps_timed": steps, "k3_launches_per_step":
          step_launches, "first_step_s": first_step_s,
          "ms_per_step": step_ms, "samples_per_s": B * 1e3 / step_ms,
          "host_s_per_step": host_s, "peak_mem_gb": peak_gb, "logs": logs,
          "allocated_before_the_phase_gb": held_gb,
          "harness_copies_gb": copies_gb,
          "peak_without_harness_gb": peak_gb - held_gb - copies_gb,
          "loss_kernels": loss_k, "loss_plain": loss_p,
          "grad_rel_err_max": grad_worst, "grad_rel_err_at": worst,
          "grad_tolerance": TOL_TRAIN_GRAD,
          "zero_exact_gradient_max": zero_grad_max,
          "profiled_device_ms": t_device_ms,
          "device_busy_share": t_device_ms / step_ms, "device_ops": t_ops,
          "k3_device_ms": k3_device_ms, "codec_encode_ms": encode_ms,
          "top_device_ms": dict(sorted(t_kernel.items(),
                                       key=lambda kv: -kv[1])[:12]),
          **options_rows, "bf16_step": bf16_row})
    bf16_launches = bf16_row["k3_launches"]
    del model, state, train_step, tbatch, rt, codec0, den0, draws
    torch.cuda.empty_cache()

    # ---- 17. the training tool at full width ----
    emit(tool_phase(train_tool_phase, ws))

    # ---- 18. evaluation of phase 14's result directories ----
    emit(tool_phase(evaluate_phase, ws))

    # ---- 19. data-parallel training: NCCL at world size 1 through the
    # tool, and two gloo ranks on this card against one ----
    ddp = tool_phase(ddp_phase, ws)
    emit(ddp)

    # ---- 20. part-VAE training, K2 under autograd ----
    vae_line = tool_phase(train_vae_phase, ws)
    emit(vae_line)

    # ---- 21. the model and diffusion options ----
    opt_line = options_phase(torch, dev)
    emit(opt_line)
    opt_clips = opt_line["clips"]

    # ---- 22. the released checkpoint, featurization and rendering ----
    rel_line = tool_phase(release_phase, ws)
    emit(rel_line)
    rel_clips = rel_line["serve"]["clips_launches"]

    shutil.rmtree(ws, ignore_errors=True)

    # ---- kernels line ----
    w = [1, 1]  # calls per clip: the stack at 32 heads, lowertrans at 64
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
         "library_ms": None,
         # a fused=True clip of the converted release (phase release)
         "launches_release": rel_clips["fused=True"]["fused_decoder_layer"],
         # a clip of phase options under each of its test specs
         "launches_options": {
             k: r["launches"]["fused_decoder_layer"]
             for k, r in opt_clips.items() if k != "spec_a fused=False"}},
        {"name": "fused_softmax_mha", "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/mha.cu",
         "replaces": "raggesture_tpu/ops/pallas/mha_kernel.py:143",
         "launches": launches["fused_softmax_mha"],
         "max_abs_err": max(s["max_abs_err"] for s in k2),
         "tolerance": TOL_K2, "ms": k2_mean["ms"],
         "plain_ms": k2_mean["plain_ms"], "bound_ms": k2_mean["bound_ms"],
         "bound_by": k2[0]["bound_by"], "library_ms": k2_mean["library_ms"],
         # under autograd in a train_vae step (forward only; the backward
         # is the plain recompute), per part
         "launches_train_vae_step": {
             p: r["k2_launches_per_step"]
             for p, r in vae_line["parts"].items()},
         "launches_options": {
             k: r["launches"]["fused_softmax_mha"]
             for k, r in opt_clips.items()},
         "launches_release": {k: r["fused_softmax_mha"]
                              for k, r in rel_clips.items()}},
    ] + [
        # K3: launches per train step (one per condition stream); errors,
        # times and bounds over the three streams (ms: the mean per call)
        {"name": fn.__name__, "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/cond_ctx.cu",
         "replaces": f"raggesture_tpu/ops/pallas/cond_ctx_kernel.py:{line}",
         "launches": step_launches[fn.__name__],
         "max_abs_err": max(e["max_abs_err"][n] for e in k3 for n in names),
         "max_rel_err": max(e["rel_err"][n] for e in k3 for n in names),
         "tolerance": TOL_K3,
         "ms": sum(e[key]["ms"] for e in k3) / len(k3),
         "plain_ms": sum(e[key]["plain_ms"] for e in k3) / len(k3),
         "bound_ms": sum(e[key]["bound_ms"] for e in k3) / len(k3),
         "bound_by": k3[1][key]["bound_by"], "library_ms": None,
         "device_ms": sum(e[key]["device_ms"] for e in k3) / len(k3),
         "kernel_names": sorted({k for e in k3
                                 for k in e[key]["instances_per_call"]}),
         # a data-parallel rank's step (two gloo ranks, global batch 128)
         # and a step of the tool over NCCL at world size 1
         "launches_ddp_rank_step": ddp["gloo_two_ranks"][0][
             "k3_launches_first_step"][fn.__name__],
         "launches_nccl_tool_step": ddp["nccl_tool"]["k3_launches"][
             fn.__name__] // ddp["nccl_tool"]["steps"],
         # a step of phase options (the condition encoders, EPSILON)
         "launches_options_step": opt_line["train"][
             "k3_launches_per_step"][fn.__name__]}
        for fn, key, line, names in (
            (cond_ctx_forward, "forward", 256, ("ctx",)),
            (cond_ctx_backward_a, "bwd_a", 288, ("dxf", "dg", "db")),
            (cond_ctx_backward_b, "bwd_b", 318, ("dwk", "dbk", "dwv", "dbv")))
    ] + [
        # K3's bf16 entry points (bf16 xf in, bf16 dxf out; backward B has
        # none of its own, it reads backward A's bf16 rows): launches per
        # bf16_compute train step; errors, times and bounds over the three
        # streams as above
        {"name": fn.__name__ + "[bf16]", "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/cond_ctx.cu",
         "replaces": f"raggesture_tpu/ops/pallas/cond_ctx_kernel.py:{line}",
         "launches": bf16_launches[fn.__name__],
         "max_abs_err": max(e["bf16"]["max_abs_err"][n] for e in k3
                            for n in names),
         "max_rel_err": max(e["bf16"]["rel_err"][n] for e in k3
                            for n in names),
         "tolerance": max(k3[0]["bf16"]["tolerance"][n] for n in names),
         **{k: sum(e["bf16"][key][k] for e in k3) / len(k3)
            for k in ("ms", "plain_ms", "bound_ms", "device_ms")},
         "bound_by": k3[1]["bf16"][key]["bound_by"], "library_ms": None}
        for fn, key, line, names in (
            (cond_ctx_forward, "forward", 256, ("ctx",)),
            (cond_ctx_backward_a, "bwd_a", 288, ("dxf", "dg", "db")),
            (cond_ctx_backward_b, "bwd_b", 318, ("dwk", "dbk", "dwv", "dbv")))
    ] + [
        # K4, K5, K7: launches per clip of the split configuration that runs
        # them; K8: per denoiser call with ffn_pallas=True
        dict({"name": name, "route": "cuda",
              "source": "raggesture_tpu_torch/ops/csrc/split_layer.cu",
              "replaces": "raggesture_tpu/ops/pallas/"
                          f"linear_attention_kernel.py:{line}",
              "launches": launches_of, "tolerance": TOL_SPLIT,
              "library_ms": None,
              # a fused=False clip of phase options under spec A, and of
              # the converted release (phase release)
              "launches_options": opt_clips["spec_a fused=False"][
                  "launches"].get(name, 0),
              "launches_release": rel_clips["fused=False"].get(name, 0)},
             **{k: split_k[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                              "bound_ms", "bound_by")})
        for name, line, launches_of in (
            ("fused_cross_attention_cached", 304, split_main[
                "layer_kernel=False"]["launches"][
                    "fused_cross_attention_cached"]),
            ("fused_self_attention", 67, split_main[
                "layer_kernel=False"]["launches"]["fused_self_attention"]),
            ("fused_cross_block_cached", 399, split_main[
                "merged_ca=True"]["launches"]["fused_cross_block_cached"]),
            ("fused_ffn", 874, ffn_launches))
    ] + [
        # K6: launches per fused=False clip; errors, times and bounds over
        # the three streams (ms: the mean per call, each stream a third of
        # the calls)
        {"name": "fused_cross_attention", "route": "cuda",
         "source": "raggesture_tpu_torch/ops/csrc/split_layer.cu",
         "replaces": "raggesture_tpu/ops/pallas/linear_attention_kernel.py:172",
         "launches": u_launches[K6],
         "launches_options": opt_clips["spec_a fused=False"]["launches"][K6],
         "launches_release": rel_clips["fused=False"][K6],
         "max_abs_err": max(e["max_abs_err"] for e in k6.values()),
         "tolerance": TOL_SPLIT,
         **{k: sum(e[k] for e in k6.values()) / len(k6)
            for k in ("ms", "plain_ms", "bound_ms")},
         "bound_by": k6["xf_audio"]["bound_by"], "library_ms": None}
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
