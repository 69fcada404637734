"""The model FLOPs one sampled clip needs: the mathematics of the plain
reference's clip with each value that does not change across the steps
counted once, and nothing shared between clips.  So no cache inside the
program lowers this count, and a program that computes less for the same
clip shows as a higher share of the peak.

- the conditions, once a clip: the text and audio projections, and each
  layer's three cross-attention contexts (keys and values over the
  condition rows, the per-head contraction), for the conditioned and the
  conditions-dropped forward;
- each step: the time embedding and the 5 adaLN projections of every
  layer, once, and the denoiser's trunk twice (conditioned and dropped):
  the token embedding, every layer's 14 D^2 + 2 D F weight products and
  its linear attentions, the output head;
- the decode, once: the four part VAEs' decoders.
"""

from . import shapes


def trunk(s: dict) -> int:
    """One forward's trunk, one sequence."""
    T, D = s["T"], s["D"]
    per_layer = (2 * T * shapes.layer_weights(s) + 2 * 2 * T * D * s["Dh"]
                 + 3 * 2 * T * D * s["Dhc"])
    return 2 * T * D * D * 2 + s["layers"] * per_layer


def conditions(s: dict) -> int:
    D = s["D"]
    proj = 2 * D * (s["Nt"] * s["text_dim"] + s["Na"] * s["audio_dim"])
    ctx = 0
    for n in (s["Nt"], s["Na"], 1):
        ctx += 2 * 2 * n * D * D + 2 * n * D * s["Dhc"]
    return proj + 2 * s["layers"] * ctx


def adaln(s: dict) -> int:
    D, TE = s["D"], s["TE"]
    return 2 * (D * TE + TE * TE) + s["layers"] * 5 * 2 * TE * 2 * D


def decode(config: dict) -> int:
    cc = config["codec"]
    D, Ff = cc["latent_dim"], cc["ff_size"]
    L = cc["num_frames"] // cc["frame_chunk_size"]
    tx = L + cc["num_frames"]
    layers = cc["num_layers"] + (1 - cc["num_layers"] % 2)
    blocks = (layers - 1) // 2
    per_layer = 2 * tx * (4 * D * D + 2 * D * Ff) + 2 * 2 * tx * tx * D
    feats = 78 + 180 + 106 + 61
    return (4 * (layers * per_layer + blocks * 2 * tx * 2 * D * D)
            + 2 * cc["num_frames"] * D * feats)


def clip(config: dict) -> int:
    s = shapes.denoiser(config)
    return (conditions(s) + s["steps"] * (adaln(s) + 2 * trunk(s))
            + decode(config))
