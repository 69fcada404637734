"""What decides ``correct`` in a training cell: the training state's first
three steps, which set-up drove through the window's own call and feed,
against the plain reference's three steps from the same weights on the
same rows and draws (``reference/train.py``, float32, TF32 off).

The compared numbers:

- ``loss``: the largest relative gap of the three steps' losses;
- ``grad``: the first step's gradients as Adam holds them; for each leaf
  the gap between the program's norm and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf; the worst
  leaf;
- ``update``: the same of each leaf's change over the three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought but for rounding, as a key bias under the time softmax)
are left out of ``grad`` and ``update`` by that rule, not by name: Adam
moves them by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..reference import train as RT
from ..reference.params import make_weights

STEPS = 3
TINY = 1e-3


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep
              ) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    med = _median([ref[k] for k in keep])
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def first_steps(config: dict, params: dict, seed: int, device):
    """The rows and draws of the set-up's first three steps, one per
    step."""
    from ..traffic import training as T

    traffic = T.Traffic(params, config, seed)
    data = T.dataset(config, params, seed, device)
    batches, draws = [], []
    for j in range(2):
        req = traffic.warm_up_request(j)
        b, d = T.batch(data, req, device), T.draws(config, req, device)
        for s in range(req["steps"]):
            batches.append({k: v[s] for k, v in b.items()})
            draws.append({"enc_eps": {p: e[s] for p, e in d["enc_eps"].items()},
                          **{k: d[k][s] for k in ("t", "noise", "cond_mask")}})
    return batches[:STEPS], draws[:STEPS]


def reference(config: dict, params: dict, seed: int, device) -> dict:
    W = make_weights(config, seed, device)
    batches, draws = first_steps(config, params, seed, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = RT.train_steps(W, config, batches, draws)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["start"] = {k: W[k] for k in out["params"]}
    return out


def gaps(first: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers, with the median leaf's gaps and the worst
    leaves beside them."""
    g_ref = _norms(ref["grads"])
    med = _median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= TINY * med]
    d_ref = _norms({k: ref["params"][k] - ref["start"][k] for k in keep})
    d_prog = _norms({k: first["params"][k] - ref["start"][k] for k in keep})
    # a leaf that Adam holds no moment of has no gradient on the program's
    # side: its norm is 0
    g_prog = _norms({k: first["grads"][k] for k in keep
                     if k in first["grads"]})
    g = leaf_gaps({k: g_prog.get(k, 0.0) for k in keep}, g_ref, keep)
    d = leaf_gaps(d_prog, d_ref, keep)
    loss = max(abs(p - r) / abs(r) for p, r in
               zip(first["losses"][:STEPS], ref["losses"]))
    return {"loss": loss, "grad": max(g.values()),
            "update": max(d.values()),
            "grad_median_leaf": _median(g.values()),
            "update_median_leaf": _median(d.values()),
            "leaves_left_out": float(len(g_ref) - len(keep)),
            "worst": {"grad": sorted(g, key=g.get)[-3:],
                      "update": sorted(d, key=d.get)[-3:]}}


def check(config: dict, params: dict, seed: int, first: dict, device
          ) -> List[dict]:
    got = gaps(first, reference(config, params, seed, device))
    return [{"name": k, "value": v, "limit": params["limits"][k]}
            for k, v in got.items() if k in params["limits"]]
