"""The model FLOPs of one training step, per sample: the frozen encode's
forward, and the denoiser's forward and backward (twice the forward: the
gradients of the activations and of the weights).  The denoiser's forward
is one sequence's: its trunk, its conditions' projections and contexts,
its adaLN projections."""

from . import clip, shapes


def encode(config: dict) -> int:
    """The four part VAEs' encoders over 10 chunks of 2 + 15 tokens."""
    cc = config["codec"]
    D, Ff = cc["latent_dim"], cc["ff_size"]
    chunks = cc["num_frames"] // cc["frame_chunk_size"]
    tx = 2 + cc["frame_chunk_size"]
    layers = cc["num_layers"] + (1 - cc["num_layers"] % 2)
    blocks = (layers - 1) // 2
    per_layer = 2 * tx * (4 * D * D + 2 * D * Ff) + 2 * 2 * tx * tx * D
    embed = 2 * cc["num_frames"] * D * (78 + 180 + 106 + 61)
    return chunks * 4 * (layers * per_layer + blocks * 2 * tx * 2 * D * D) \
        + embed


def denoiser_forward(config: dict) -> int:
    s = shapes.denoiser(config)
    return clip.trunk(s) + clip.conditions(s) // 2 + clip.adaln(s)


def sample(config: dict) -> int:
    return encode(config) + 3 * denoiser_forward(config)
