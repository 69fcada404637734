"""K3, the all-layer cross-attention contexts of one condition stream with
their gradients (``ops/cond_ctx.py``): per layer the LayerNorm, the key and
value products, the time softmax and the per-head contraction, forward
and backward, at the call's shapes, with bf16 operands."""

from . import shapes


def stream(config: dict, batch: int, rows: int) -> tuple:
    """(FLOPs, bytes) of one stream's forward and backward in a step:
    forward, the two products (4 B N D^2) and the contraction (2 B N D Dh)
    a layer; backward, twice that (the gradients of the inputs and of the
    weights).  Bytes: the features read (forward and backward), the
    float32 weights and biases read (forward and backward), the contexts
    written and their gradients read, the features' gradient and the
    weights' gradients written, each once."""
    s = shapes.denoiser(config)
    D, L, Dh, H = s["D"], s["layers"], s["Dhc"], s["Hc"]
    fwd = L * (4 * batch * rows * D * D + 2 * batch * rows * D * Dh)
    x = 4 * batch * rows * D
    w = 4 * L * (2 * D * D + 4 * D)
    ctx = 4 * batch * L * H * Dh * Dh
    return 3 * fwd, 2 * x + 2 * w + 2 * ctx + x + w


def step(config: dict, batch: int) -> list:
    """The three streams' (FLOPs, bytes) of one training step: text,
    audio, and the one-row speaker stream."""
    s = shapes.denoiser(config)
    return [stream(config, batch, n) for n in (s["Nt"], s["Na"], 1)]
