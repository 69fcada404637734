#!/usr/bin/env python3
"""Time kernel K1 (``fused_decoder_layer``) and the main sampling path of the
PyTorch/CUDA port on one NVIDIA GPU, at one batch or several, for one tree
of the port or several in turn; or, with ``--split``, the split path's
block kernels K5, K4, K7, K8 and K6 and its clips; or, with ``--k3``, K3 and
the training step.

    python3 bench_torch_k1.py                        # this checkout, batch 1
    python3 bench_torch_k1.py --batches 1 8 32       # clips per batch
    python3 bench_torch_k1.py --trees P C C P        # each tree in turn
    python3 bench_torch_k1.py --trace                # K1's phases
    python3 bench_torch_k1.py --sweep                # K1's two designs
    python3 bench_torch_k1.py --split --trees P C C P
    python3 bench_torch_k1.py --k3 --trees P C C P

Each tree runs in its own process (``--one DIR``), which imports
``raggesture_tpu_torch`` from DIR and prints one JSON line per batch of n
clips, with the inputs, profiler windows and timers of ``chip_smoke.py``:
  * ``k1``: K1 at the sampling shape of n clips (2n sequences of 43 -> 48
    tokens, D 512, 16 heads, F 1024, bf16 packs), 16 calls cycling eight
    copies of the pack (75 MB of weights, more than the 50 MB L2): device
    ms per call from torch.profiler, the device us and instances per call
    of each kernel name, CUDA-event ms and the host's enqueue ms per call,
    and the plain version's device ms per call;
  * ``clips``: StagedGenerator.sample at full width, n clips, 50 DDIM
    steps, VAE decode, random weights from a seed, ``eager`` (graphs=False)
    and ``replayed`` (the pipeline as one CUDA graph, the default on the
    card; a tree from before the graphs runs eagerly only): wall ms per
    batch (CUDA events over 5 batches after a warm-up, which for
    ``replayed`` is the warm-up and the capture), and over one profiled
    batch the device ms (summed by kernel, and ``device_busy_ms``, the
    union of the device operations' intervals), the device operations and
    the instances of each K1 and K2 kernel name.
The ``k1`` line also carries ``out_sha256``, the SHA-256 of one call's
output bytes (the first pack): two trees' lines at a batch hold the same
hash exactly when their kernels give the same bits.
With ``--sweep``, one line for each count of sequences in ``SWEEP``: K1
at that count (the sampling shape, 16 calls cycling eight packs) by
device ms per call under each of its two designs, forced by setting
``ROW_TILE_MIN_SEQUENCES`` (the per-sequence design alone on a tree
without the row-tile design), with each design's largest difference from
the plain version over valid rows; the crossover is the fewest sequences
from which the row-tile design is the faster.
With ``--trace`` (a tree whose K1 takes a trace): K1 at batch 1 with the
kernel's %globaltimer marks, one line: for each phase the time from the
launch's first block entry to the end of the phase's grid barrier (the
last: to the last block's end); the medians over a stage's units of the
time to the start of the product (operands staged, weights arrived), the
product and the epilogue (us); and the SM clock (clock64 cycles over
%globaltimer ns).  With ``--split``, one line a tree: K5
(``fused_self_attention``), K4 (``fused_cross_attention_cached``, the audio
stream), K7 (``fused_cross_block_cached``), K8 (``fused_ffn``) and K6
(``fused_cross_attention``, text, audio and speaker) on ``chip_smoke.py``'s
phase-8 inputs (2 sequences of 43 tokens, float32, eight layers' packs
cycled): device ms per call from torch.profiler, the device us and
instances per call of each kernel name, each kernel's median start and end
from its call's first (``timeline_us``), CUDA-event ms and the host's
enqueue ms per call; then one clip (batch 1, random weights from a seed)
of each of ``StagedGenerator(layer_kernel=False)``, ``(merged_ca=True)``
and ``(fused=False)``: device ms (the union of the device operations'
intervals) and device operations over one profiled clip, after a warm-up
clip.  With ``--k3``, one
line a tree: K3's three wrappers (``cond_ctx_forward``,
``cond_ctx_backward_a``, ``cond_ctx_backward_b``) at the training shapes of
the text, audio and speaker streams (``chip_smoke.py``'s phase-3 inputs:
batch 128, 150 / 499 / 1 rows, D 512, 8 layers, 16 heads), device ms per
call from torch.profiler, the device us and instances per call of each
kernel name, each kernel's median start and end from its call's first
(``timeline_us``) and CUDA-event ms per call; then the full-width training
step at batch 128 (``chip_smoke.py``'s phase-13 batch, two warm-up steps):
ms per step by CUDA events over five steps, the peak device memory of
those steps (``torch.cuda.max_memory_allocated``), and over one profiled
step its device ms (the union of the device operations' intervals) and
K3's share of it by kernel name.  The card's name and
power limit (nvidia-smi) lead the output.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs   # this script's own directory comes first

K1_CALLS = 16
SWEEP = (2, 4, 6, 8, 10, 12, 16, 32, 64, 128)   # sequences
K3_CALLS = 4
CLIPS = 5
# K1's phases in launch order (csrc/decoder_layer.cu): N1 normalises the
# operand of product stage S1, and so on; a grid barrier ends each
PHASES = ("N1", "S1", "N2", "S2", "N3", "S3", "N4", "S4", "S5", "S6", "S7",
          "N8", "S8")


def trace_k1(torch, call, trace_slots) -> dict:
    """Stage times of one K1 call from the kernel's trace (eight packs
    cycled first, as a step's layers are)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tr = torch.zeros(sms, trace_slots(), dtype=torch.int64, device="cuda")
    for i in range(17):
        call(trace=tr if i == 16 else None)
    torch.cuda.synchronize()
    t = tr.cpu().tolist()
    blocks = [row for row in t if row[0]]
    t0 = min(row[0] for row in blocks)
    units, us, nbar = 8, 4, len(PHASES) - 1
    bar0 = 2 + us * units
    ends = [[row[bar0 + b] - t0 for row in blocks] for b in range(nbar)]
    ends.append([row[-1] - t0 for row in blocks])
    per_stage = {}
    for row in blocks:
        bars = row[bar0:bar0 + nbar]
        for j in range(units):
            mk = row[2 + us * j:2 + us * (j + 1)]
            if not mk[0]:
                continue
            ph = PHASES[sum(1 for b in bars if b < mk[0])]
            d = per_stage.setdefault(ph, {"to_product": [], "product": [],
                                          "epilogue": []})
            d["to_product"].append((mk[1] - mk[0]) / 1e3)
            d["product"].append((mk[2] - mk[1]) / 1e3)
            d["epilogue"].append((mk[3] - mk[2]) / 1e3)
    ghz = statistics.median((row[-2] - row[-3]) / (row[-1] - row[0])
                            for row in blocks)
    return {"blocks": len(blocks), "sm_clock_ghz": ghz,
            "copies_us": max(row[1] - row[0] for row in blocks) / 1e3,
            "phase_end_us": dict(zip(PHASES, (max(e) / 1e3 for e in ends))),
            "unit_median": {s: {k: statistics.median(v) if v else None
                                for k, v in d.items()}
                            for s, d in sorted(per_stage.items())}}


def call_timeline(prof, per_call: int) -> dict:
    """Each kernel's median start and end (us) from the first kernel start
    of its call, over a profile of back-to-back calls of ``per_call``
    device operations each: where a dependent launch starts, waits and
    ends beside the kernel before it.  A kernel launched twice a call is
    named by its place the second time (``name#2``)."""
    from torch.autograd import DeviceType

    evs = sorted((ev.time_range.start, ev.time_range.end,
                  cs.kernel_name(ev.name)) for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
    spans = {}
    for i in range(0, len(evs) - per_call + 1, per_call):
        t0 = evs[i][0]
        seen = {}
        for a, b, name in evs[i:i + per_call]:
            seen[name] = seen.get(name, 0) + 1
            key = name if seen[name] == 1 else f"{name}#{seen[name]}"
            spans.setdefault(key, []).append((a - t0, b - t0))
    return {name: [statistics.median(a for a, _ in v),
                   statistics.median(b for _, b in v)]
            for name, v in spans.items()}


def sweep_tree(torch, dc, dev):
    """K1's device ms per call under each design at each count of
    sequences in SWEEP."""
    from raggesture_tpu_torch.ops import decoder_layer as K1

    H, Hc = dc.num_heads, dc.ca_heads
    designs = {"per_sequence": 1 << 30}
    if hasattr(K1, "ROW_TILE_MIN_SEQUENCES"):
        designs["row_tile"] = 0
    for B in SWEEP:
        g = torch.Generator(device=dev).manual_seed(1)
        args, packed = cs.k1_case(torch, dc, B, g, dev)
        valid = args[1][:, 0] > 0
        ref = K1.fused_decoder_layer_reference(*args, packed, H, Hc, B)
        packs = [{k: v.clone() for k, v in packed.items()} for _ in range(8)]
        cyc = {"i": 0}

        def call():
            cyc["i"] = (cyc["i"] + 1) % len(packs)
            return K1.fused_decoder_layer(*args, packs[cyc["i"]], H, Hc, B)

        line = {"module": K1.__file__, "sequences": B}
        for name, least in designs.items():
            if hasattr(K1, "ROW_TILE_MIN_SEQUENCES"):
                K1.ROW_TILE_MIN_SEQUENCES = least
            out = call()
            torch.cuda.synchronize()
            table = cs.device_profile(torch, call, K1_CALLS)[0]
            line[f"{name}_ms"] = sum(table.values()) / K1_CALLS
            line[f"{name}_max_abs_err"] = (
                (out - ref)[valid].abs().max().item())
        yield line
        del packs, packed, args, ref


def split_tree(torch, cfg, dev) -> dict:
    """K5, K4, K7, K8 and K6's device time per call on chip_smoke's split
    inputs, and the split and uncached clips' device time and operations."""
    from raggesture_tpu_torch.models.architecture import (
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.ops import cross_attention as CA
    from raggesture_tpu_torch.ops import ffn as FF
    from raggesture_tpu_torch.ops import self_attention as SA

    dc = cfg.denoiser

    g = torch.Generator(device=dev).manual_seed(1)
    c = cs.split_case(torch, dc, g, dev)
    L = len(c["packs"])
    cyc = {"i": 0}

    def cycled(fn, args):
        def call():
            cyc["i"] = (cyc["i"] + 1) % L
            fn(*args(cyc["i"]))
        return call

    calls = {fn.__name__: cycled(fn, lambda i, name=fn.__name__:
                                 cs.split_args(c, name, i))
             for fn in (SA.fused_self_attention,
                        CA.fused_cross_attention_cached,
                        CA.fused_cross_block_cached, FF.fused_ffn)}
    for j, key in enumerate(c["conds"]):
        calls[f"fused_cross_attention {key}"] = cycled(
            CA.fused_cross_attention, lambda i, j=j: cs.k6_args(c, j, i))
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        table, _, prof = cs.device_profile(torch, call, K1_CALLS)
        counts = cs.instances_by_kernel(prof)
        per_call = round(sum(counts.values()) / K1_CALLS)
        out[name] = {"device_ms": cs.device_busy_ms(prof) / K1_CALLS,
                     "timeline_us": call_timeline(prof, per_call),
                     "kernel_us": {k: ms * 1e3 / K1_CALLS
                                   for k, ms in table.items()},
                     "instances_per_call": {k: n / K1_CALLS
                                            for k, n in counts.items()},
                     "event_ms": cs.cuda_ms(torch, call, iters=64),
                     "host_ms": cs.host_ms_per_call(torch, call)}
    del c, calls
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    batch = cs.clip_batch(torch, dc, 1, dev)
    for label, opts in (("layer_kernel=False", dict(layer_kernel=False)),
                        ("merged_ca=True", dict(merged_ca=True)),
                        ("fused=False", dict(fused=False))):
        gen = StagedGenerator(model, cfg.diffusion_test.schedule(), **opts)

        def clip(gen=gen):
            return gen.sample(
                batch, generator=torch.Generator(device=dev).manual_seed(0))

        clip()
        torch.cuda.synchronize()
        _, ops, prof = cs.device_profile(torch, clip)
        out[f"clip {label}"] = {"device_ms": cs.device_busy_ms(prof),
                                "device_ops": ops}
    return out


def k3_tree(torch, cfg, dev) -> dict:
    """K3's wrappers at the three streams' training shapes, by device time
    and CUDA events, and the training step's ms at batch 128."""
    from raggesture_tpu_torch.models.architecture import create_model
    from raggesture_tpu_torch.ops import cond_ctx as K3
    from raggesture_tpu_torch.train.loop import (
        OptimConfig,
        create_train_state,
        make_train_step,
    )

    dc = cfg.denoiser
    B, H = cs.TRAIN_BATCH, dc.ca_heads
    out = {}
    for stream, n_rows in (("text", 150), ("audio", 499), ("spk", 1)):
        xf, cm, nv, prm, dctx = cs.k3_case(torch, dc, B, n_rows, dev)
        ctx, saved = K3.cond_ctx_forward(xf, cm, nv, *prm, H)
        inter = K3.cond_ctx_backward_a(xf, cm, nv, *prm, ctx, saved, dctx,
                                       H)[3]
        calls = {
            "forward": lambda: K3.cond_ctx_forward(xf, cm, nv, *prm, H),
            "bwd_a": lambda: K3.cond_ctx_backward_a(
                xf, cm, nv, *prm, ctx, saved, dctx, H),
            "bwd_b": lambda: K3.cond_ctx_backward_b(xf, cm, prm[0], prm[1],
                                                    saved, inter)}
        out[stream] = {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            table, _, prof = cs.device_profile(torch, call, K3_CALLS)
            counts = cs.instances_by_kernel(prof)
            per_call = round(sum(counts.values()) / K3_CALLS)
            out[stream][name] = {
                "device_ms": cs.device_busy_ms(prof) / K3_CALLS,
                "timeline_us": call_timeline(prof, per_call),
                "kernel_us": {k: ms * 1e3 / K3_CALLS
                              for k, ms in table.items()},
                "instances_per_call": {k: n / K3_CALLS
                                       for k, n in counts.items()},
                "event_ms": cs.cuda_ms(torch, call, iters=10, warmup=1)}
        del xf, cm, nv, prm, dctx, ctx, saved, inter, calls
        torch.cuda.empty_cache()
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    tbatch, _ = cs.train_batch(torch, dc, B, dev)
    state = create_train_state(model, OptimConfig())
    step = make_train_step(cfg.diffusion_train.schedule(device=dev))
    tgen = torch.Generator(device=dev).manual_seed(4)

    def one_step():
        step(state, tbatch, tgen)

    torch.cuda.reset_peak_memory_stats()
    step_ms = cs.cuda_ms(torch, one_step, iters=5, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    table, _, prof = cs.device_profile(torch, one_step)
    k3_names = {k for ks in cs.K3_KERNELS.values() for k in ks} | {
        "row_stats", "ctx_forward"}       # an older tree's forward kernels
    out["train_step"] = {
        "batch": B, "ms": step_ms, "samples_per_s": B * 1e3 / step_ms,
        "peak_mem_gb": peak_gb, "device_ms": cs.device_busy_ms(prof),
        "k3_kernel_ms": {k: v for k, v in table.items() if k in k3_names}}
    return out


def one_tree(tree: str, batches, trace: bool = False, split: bool = False,
             k3: bool = False, sweep: bool = False):
    sys.path.insert(0, str(Path(tree).resolve()))
    # chip_smoke's import bound this checkout's package: drop it, so that
    # every import below (chip_smoke's helpers import at call time) takes
    # the tree's own
    for name in [m for m in sys.modules if m == "raggesture_tpu_torch"
                 or m.startswith("raggesture_tpu_torch.")]:
        del sys.modules[name]
    import torch

    from raggesture_tpu_torch.models.architecture import (
        ArchitectureConfig,
        StagedGenerator,
        create_model,
    )
    from raggesture_tpu_torch.ops import decoder_layer as K1

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_k1: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = ArchitectureConfig()
    dc = cfg.denoiser
    H, Hc = dc.num_heads, dc.ca_heads
    if split:
        yield {"tree": tree, "split": split_tree(torch, cfg, dev)}
        return
    if k3:
        yield {"tree": tree, "k3": k3_tree(torch, cfg, dev)}
        return
    if sweep:
        for line in sweep_tree(torch, dc, dev):
            yield {"tree": tree, **line}
        return
    model = create_model(cfg, device=dev, seed=0, zero_init_std=0.02)
    sched = cfg.diffusion_test.schedule()
    try:
        gens = {"eager": StagedGenerator(model, sched, graphs=False),
                "replayed": StagedGenerator(model, sched)}
    except TypeError:       # a tree from before the pipelines' graphs
        gens = {"eager": StagedGenerator(model, sched)}
    for n in batches:
        B = 2 * n
        g = torch.Generator(device=dev).manual_seed(1)
        args, packed = cs.k1_case(torch, dc, B, g, dev)
        packs = [{k: v.clone() for k, v in packed.items()} for _ in range(8)]
        cyc = {"i": 0}

        def k1_call(fn, **kw):
            def call():
                cyc["i"] = (cyc["i"] + 1) % len(packs)
                fn(*args, packs[cyc["i"]], H, Hc, B, **kw)
            return call

        if trace:
            yield {"tree": tree, "batch": n, "trace": trace_k1(
                torch, lambda **kw: k1_call(K1.fused_decoder_layer, **kw)(),
                K1.trace_slots)}
            continue
        out = K1.fused_decoder_layer(*args, packs[0], H, Hc, B)
        torch.cuda.synchronize()
        out_sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        call = k1_call(K1.fused_decoder_layer)
        call()
        torch.cuda.synchronize()
        table, _, prof = cs.device_profile(torch, call, K1_CALLS)
        plain = k1_call(K1.fused_decoder_layer_reference)
        plain()
        torch.cuda.synchronize()
        plain_table = cs.device_profile(torch, plain, K1_CALLS)[0]
        k1 = {"module": K1.__file__, "out_sha256": out_sha,
              "device_ms": sum(table.values()) / K1_CALLS,
              "kernel_us": {k: ms * 1e3 / K1_CALLS
                            for k, ms in table.items()},
              "instances_per_call": {
                  k: n / K1_CALLS
                  for k, n in cs.instances_by_kernel(prof).items()},
              "event_ms": cs.cuda_ms(torch, call, iters=64),
              "host_ms": cs.host_ms_per_call(torch, call),
              "plain_device_ms": sum(plain_table.values()) / K1_CALLS}
        del packs, packed, args

        batch = cs.clip_batch(torch, dc, n, dev)
        clips = {}
        for mode, gen in gens.items():
            def clip(gen=gen):
                return gen.sample(batch, generator=torch.Generator(
                    device=dev).manual_seed(0))

            clip()                  # replayed: the warm-up and the capture
            torch.cuda.synchronize()
            wall_ms = cs.cuda_ms(torch, clip, iters=CLIPS, warmup=0)
            table, ops, prof = cs.device_profile(torch, clip)
            clips[mode] = {
                "wall_ms": wall_ms, "device_ms": sum(table.values()),
                "device_busy_ms": cs.device_busy_ms(prof),
                "device_ops": ops,
                "kernel_instances": {
                    k: c for k, c in cs.instances_by_kernel(prof).items()
                    if k in k1["kernel_us"] or k == "mha_kernel"}}
        yield {"tree": tree, "batch": n, "k1": k1, "clips": clips}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts of the port, run in this order")
    ap.add_argument("--batches", nargs="+", type=int, default=[1],
                    help="clips per batch")
    ap.add_argument("--trace", action="store_true",
                    help="K1's stage times from the kernel's trace")
    ap.add_argument("--split", action="store_true",
                    help="K5, K4, K7, K8, K6 and the split path's clips "
                         "instead of K1 and the clip")
    ap.add_argument("--k3", action="store_true",
                    help="K3's wrappers and the training step instead")
    ap.add_argument("--sweep", action="store_true",
                    help="K1's two designs over SWEEP's counts of "
                         "sequences instead")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        for line in one_tree(a.one, a.batches, trace=a.trace, split=a.split,
                             k3=a.k3, sweep=a.sweep):
            print(json.dumps(line), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in a.trees:
        subprocess.run([sys.executable, __file__, "--one", tree, "--batches",
                        *map(str, a.batches)] + ["--trace"] * a.trace
                       + ["--split"] * a.split + ["--k3"] * a.k3
                       + ["--sweep"] * a.sweep,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
