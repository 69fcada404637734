"""K1, one decoder layer over a batch of sequences (``ops/decoder_layer.py``):
the layer's mathematics at the call's shapes, with the configuration's bf16
operands."""

from . import shapes


def call(config: dict, sequences: int) -> tuple:
    """(FLOPs, bytes) of one layer over ``sequences`` sequences of T tokens:
    the 14 D^2 + 2 D F weight products of every token, the self attention's
    context and readout and the three cross attentions' readouts per head;
    bytes: the bf16 weights, the float32 vectors (31 D and the FFN's first
    bias), the hidden rows read and written, the token and query masks, the
    step's adaLN rows (2 x 5 D) and the bf16 cross-attention contexts, each
    once."""
    s = shapes.denoiser(config)
    D, F, T = s["D"], s["F"], s["T"]
    rows = sequences * T
    flops = (2 * rows * shapes.layer_weights(s)
             + sequences * (2 * 2 * T * D * s["Dh"] + 3 * 2 * T * D * s["Dhc"]))
    nbytes = (2 * shapes.layer_weights(s) + 4 * (31 * D + F)
              + 2 * 4 * rows * D + 4 * 4 * rows + 4 * 2 * 5 * D
              + 2 * sequences * 3 * s["Hc"] * s["Dhc"] ** 2)
    return flops, nbytes
