"""What decides ``correct`` in a sampling cell: clips the window served,
drawn from the seed, against the plain reference run on the same inputs.

The reference (``reference/model.py``, float32, TF32 off) regenerates each
drawn clip from the benchmark's own inputs: the weights, the feature pools
and the start noise, all remade from the seed once the program is gone.
Gaps are relative Frobenius norms over the drawn clips: ``latents``, the
final DDIM latents (B, 43, 512); ``motion``, the decoded motion, each
rotation as its matrix (the program's axis-angle read by Rodrigues'
formula, the reference's 6d by Gram-Schmidt, so that an angle near pi,
whose axis-angle is ambiguous, compares by the rotation it means), with
translation, expressions and contacts.

The 50-step chain amplifies any difference, more for some seeds' weights
than for others', and the production query masks add -1e6 to two valid
tokens' rows before a LayerNorm, where any two implementations round
apart.  So the compared number is ``motion_over_bf16``: the program's
motion gap over the gap of the same reference computed at the
configuration's own precision (the decoder layers' products and
attention operands rounded to bf16), on the same clips.  It reads how
much further from float32 the program lies than a plain implementation
of its stated precision does, steady from seed to seed where the raw gap
is not.  Each limit sits in the traffic mix's file (``limits``), with the
readings it was set from in ``PERF.md``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference import model as R
from ..reference.params import make_weights

ROTATIONS = ("upper", "hands", "facepose", "lower")
FEATURES = ("transl", "exps", "contact")
CHUNK = 16          # clips a reference call: 32 sequences with the mixing


def pick_clips(kept: list, seed: int, k: int) -> List[tuple]:
    """``k`` (request position, row) pairs of the served clips, drawn from
    the seed."""
    clips = [(p, j) for p, (req, _) in enumerate(kept)
             for j in range(len(req["speaker"]))]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 4]))
    pick = rng.choice(len(clips), min(k, len(clips)), replace=False)
    return [clips[i] for i in sorted(pick)]


def reference_outputs(config: dict, params: dict, seed: int, kept: list,
                      picks: List[tuple], device, mm=R.plain_mm
                      ) -> Dict[str, torch.Tensor]:
    """The reference's latents and motion of the picked clips, on
    ``device`` in chunks, returned on the host."""
    from ..traffic.sampling import feature_pools, start_noise

    W = make_weights(config, seed, device)
    word_pool, audio_pool = feature_pools(config, params, seed, device)
    noise = {}
    outs: Dict[str, list] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, len(picks), CHUNK):
            part = picks[s:s + CHUNK]
            rows = []
            for p, j in part:
                req = kept[p][0]
                if p not in noise:
                    noise[p] = start_noise(config, req, device)
                rows.append((noise[p][j], int(req["word"][j]),
                             int(req["audio"][j]), int(req["speaker"][j])))
            z = torch.stack([r[0] for r in rows])
            word = word_pool[[r[1] for r in rows]]
            audio = audio_pool[[r[2] for r in rows]]
            spk = torch.tensor([r[3] for r in rows], device=device)
            mask = torch.ones(len(rows), config["denoiser"]["max_seq_len"],
                              device=device)
            out = R.generate(W, config, z, word, audio, spk, mask, mm)
            for k, v in out.items():
                outs.setdefault(k, []).append(v.float().cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del W, word_pool, audio_pool
    return {k: torch.cat(v) for k, v in outs.items()}


def program_outputs(kept: list, picks: List[tuple]) -> Dict[str, torch.Tensor]:
    """The picked clips of what the program served, rotations read as
    matrices."""
    out: Dict[str, list] = {}
    for p, j in picks:
        served = kept[p][1]
        out.setdefault("latents", []).append(served["output_latents"][j])
        for k in ROTATIONS:
            out.setdefault(k, []).append(
                R.axis_angle_to_matrix(served[f"pred_{k}"][j]))
        for k in FEATURES:
            out.setdefault(k, []).append(served[f"pred_{k}"][j])
    return {k: torch.stack(v) for k, v in out.items()}


def gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
         ) -> Dict[str, float]:
    """The relative Frobenius gaps of the latents and of the motion."""
    def rel(keys):
        d = sum(float(((prog[k] - ref[k]).double() ** 2).sum()) for k in keys)
        n = sum(float((ref[k].double() ** 2).sum()) for k in keys)
        return (d / n) ** 0.5 if n > 0 else float("inf")

    return {"latents": rel(["latents"]),
            "motion": rel(list(ROTATIONS) + list(FEATURES))}


def clip_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> List[float]:
    """Each picked clip's relative Frobenius gap of its motion."""
    keys = list(ROTATIONS) + list(FEATURES)
    n = prog["latents"].shape[0]
    d = sum(((prog[k] - ref[k]).double() ** 2).reshape(n, -1).sum(1)
            for k in keys)
    r = sum((ref[k].double() ** 2).reshape(n, -1).sum(1) for k in keys)
    return (d / r).sqrt().tolist()


def readings(config: dict, params: dict, seed: int, kept: list, device,
             variants: dict = None) -> Dict[str, dict]:
    """The gaps to the float32 reference of the program's picked clips
    and of the reference at the configuration's own precision
    (``bf16``), and of each of ``variants`` (name: product), each with
    ``motion_over_bf16``: its motion gap over ``bf16``'s."""
    picks = pick_clips(kept, seed, int(params["check_clips"]))
    ref = reference_outputs(config, params, seed, kept, picks, device)
    sides = {"program": program_outputs(kept, picks)}
    for name, mm in {"bf16": R.quantized_mm(torch.bfloat16),
                     **(variants or {})}.items():
        sides[name] = reference_outputs(config, params, seed, kept, picks,
                                        device, mm)
    out = {k: dict(gaps(v, ref), per_clip=clip_gaps(v, ref))
           for k, v in sides.items()}
    for v in out.values():
        v["motion_over_bf16"] = v["motion"] / out["bf16"]["motion"]
    return out


def check(config: dict, params: dict, seed: int, kept: list, device
          ) -> List[dict]:
    """The compared numbers of a run, each with its limit."""
    got = readings(config, params, seed, kept, device)["program"]
    return [{"name": k, "value": got[k], "limit": lim}
            for k, lim in params["limits"].items()]
