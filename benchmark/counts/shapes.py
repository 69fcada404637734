"""The widths a count reads from a configuration's file."""


def denoiser(config: dict) -> dict:
    c = config["denoiser"]
    D = c["latent_dim"]
    L = c["max_seq_len"] // c["frame_chunk_size"]
    H = c["num_heads"]
    Hc = c["ca_num_heads"] or H
    return {"D": D, "F": c["ff_size"], "TE": c["time_embed_dim"],
            "T": 4 * L + 3, "H": H, "Hc": Hc, "Dh": D // H, "Dhc": D // Hc,
            "layers": c["num_layers"], "text_dim": c["text_latent_dim"],
            "audio_dim": c["audio_latent_dim"],
            "Nt": config["conditions"]["text_frames"],
            "Na": config["conditions"]["audio_frames"],
            "steps": config["diffusion_test"]["num_inference_timesteps"]}


def layer_weights(s: dict) -> int:
    """A decoder layer's product weights outside the adaLN table: self
    attention q, k, v, out (4 D^2), three cross attentions' q and out
    (6 D^2), the mix (3 D^2), the FFN (2 D F) and its stylization out
    (D^2): 14 D^2 + 2 D F."""
    return 14 * s["D"] ** 2 + 2 * s["D"] * s["F"]
