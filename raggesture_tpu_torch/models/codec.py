"""GestureCodec: the four frozen body-part VAEs around the diffusion.
Port of the decode path of ``raggesture_tpu/models/codec.py``.

Token layout along time: [upper(10), 0, hands(10), 0, face(10), 0,
lowertrans(10)] -> 43 tokens.  Decoded per-part features:
  upper      13 joints * 6d                          = 78
  hands      30 joints * 6d                          = 180
  face       jaw 6d + 100 FLAME expressions          = 106
  lowertrans 9 joints * 6d + 3 transl + 4 contacts   = 61
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..ops.rotations import d6_feature_to_aa
from .vae import TransformerVAE, VAEConfig

PART_NAMES = ("upper", "hands", "face", "lowertrans")

UPPER_JOINTS = 13
HANDS_JOINTS = 30
LOWER_JOINTS = 9
FACE_JOINTS = 1          # jaw
NUM_EXPRESSIONS = 100
NUM_CONTACTS = 4
TRANSL_DIM = 3


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    latent_dim: int = 512
    frame_chunk_size: int = 15
    num_frames: int = 150
    num_layers: int = 8
    num_heads: int = 4
    lowertrans_num_heads: int = 8
    ff_size: int = 1024
    dropout: float = 0.1
    position_embedding: str = "learned"
    decoder_arch: str = "all_encoder"
    activation: str = "gelu"
    normalize_before: bool = False

    @property
    def tokens_per_part(self) -> int:
        return self.num_frames // self.frame_chunk_size

    @property
    def num_tokens(self) -> int:
        return 4 * self.tokens_per_part + 3

    def vae_config(self, part: str) -> VAEConfig:
        nfeats = {
            "upper": UPPER_JOINTS * 6,
            "hands": HANDS_JOINTS * 6,
            "face": FACE_JOINTS * 6 + NUM_EXPRESSIONS,
            "lowertrans": LOWER_JOINTS * 6 + TRANSL_DIM + NUM_CONTACTS,
        }[part]
        return VAEConfig(
            nfeats=nfeats,
            latent_dim=self.latent_dim,
            num_layers=self.num_layers,
            num_heads=(self.lowertrans_num_heads if part == "lowertrans"
                       else self.num_heads),
            ff_size=self.ff_size,
            dropout=self.dropout,
            position_embedding=self.position_embedding,
            decoder_arch=self.decoder_arch,
            activation=self.activation,
            normalize_before=self.normalize_before,
            frame_chunk_size=self.frame_chunk_size,
            num_frames=self.num_frames,
        )


class GestureCodec(nn.Module):
    """Four frozen TransformerVAEs + the separator token layout."""

    def __init__(self, cfg: CodecConfig = CodecConfig()):
        super().__init__()
        self.cfg = cfg
        for part in PART_NAMES:
            setattr(self, f"{part}_vae", TransformerVAE(cfg.vae_config(part)))

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 43, D) -> axis-angle parts + transl / exps / contact, part
        by part."""
        L = (z.shape[1] - 3) // 4
        n_frames = L * self.cfg.frame_chunk_size
        parts = {"upper": z[:, :L], "hands": z[:, L + 1:2 * L + 1],
                 "face": z[:, 2 * L + 2:3 * L + 2],
                 "lowertrans": z[:, 3 * L + 3:]}
        out = {p: getattr(self, f"{p}_vae").decode(parts[p], n_frames)
               for p in PART_NAMES}
        face, lt = out["face"], out["lowertrans"]
        j6 = LOWER_JOINTS * 6
        return {
            "upper": d6_feature_to_aa(out["upper"]),
            "lower": d6_feature_to_aa(lt[..., :j6]),
            "facepose": d6_feature_to_aa(face[..., :FACE_JOINTS * 6]),
            "hands": d6_feature_to_aa(out["hands"]),
            "transl": lt[..., j6:j6 + TRANSL_DIM],
            "exps": face[..., FACE_JOINTS * 6:],
            "contact": lt[..., j6 + TRANSL_DIM:],
        }
