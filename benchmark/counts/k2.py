"""K2, the part VAEs' softmax attention (``ops/mha.py``): softmax(q k^T) v
per head at the call's shapes, float32."""


def attention(n: int, tq: int, tk: int, d: int) -> tuple:
    """(FLOPs, bytes) of n sequences: the two products, q, k, v read and
    the output written once."""
    return 2 * 2 * n * tq * tk * d, 4 * n * (2 * tq + 2 * tk) * d


def decode(config: dict, clips: int) -> list:
    """The (FLOPs, bytes) of every attention of one decode of ``clips``
    clips: each part VAE's decoder layers (the layer count rounded up to
    odd) over L latent tokens and 150 frame queries."""
    cc = config["codec"]
    L = cc["num_frames"] // cc["frame_chunk_size"]
    tx = L + cc["num_frames"]
    layers = cc["num_layers"] + (1 - cc["num_layers"] % 2)
    return [attention(clips, tx, tx, cc["latent_dim"])
            for _ in range(4) for _ in range(layers)]
