"""GestureCodec: the four frozen body-part VAEs around the diffusion.
Port of ``raggesture_tpu/models/codec.py``: the encode of per-part motion
features into the 43-token latent layout, and the decode part by part.

Token layout along time: [upper(10), 0, hands(10), 0, face(10), 0,
lowertrans(10)] -> 43 tokens.  Decoded per-part features:
  upper      13 joints * 6d                          = 78
  hands      30 joints * 6d                          = 180
  face       jaw 6d + 100 FLAME expressions          = 106
  lowertrans 9 joints * 6d + 3 transl + 4 contacts   = 61
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.rotations import aa_feature_to_6d, d6_feature_to_aa
from .layers import strided_token_mask
from .vae import TransformerVAE, VAEConfig

PART_NAMES = ("upper", "hands", "face", "lowertrans")
# separator-token logvar: exp(0.5 * SEP_LOGVAR) underflows to exactly 0, so
# a separator token drawn from (mu, logvar) is exactly its mu (= 0)
SEP_LOGVAR = -1e30

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


def part_features(motion_upper, motion_lower, motion_face, motion_hands,
                  motion_transl, motion_facial, motion_contact
                  ) -> Dict[str, torch.Tensor]:
    """The four VAE input features from axis-angle motion (B, T, J*3),
    translation (B, T, 3), expressions (B, T, 100) and contacts (B, T, 4).
    Translation x and z are made relative to the first frame."""
    transl = motion_transl.clone()
    transl[..., 0] = transl[..., 0] - motion_transl[..., 0:1, 0]
    transl[..., 2] = transl[..., 2] - motion_transl[..., 0:1, 2]
    return {
        "upper": aa_feature_to_6d(motion_upper),
        "hands": aa_feature_to_6d(motion_hands),
        "face": torch.cat([aa_feature_to_6d(motion_face), motion_facial], -1),
        "lowertrans": torch.cat([aa_feature_to_6d(motion_lower), transl,
                                 motion_contact], -1),
    }


def _layout(parts: Dict[str, torch.Tensor], sep: torch.Tensor) -> torch.Tensor:
    """Per-part (B, L, D) tokens -> the (B, 4L+3, D) layout with ``sep``
    (B, 1, D) between the parts."""
    return torch.cat([parts["upper"], sep, parts["hands"], sep, parts["face"],
                      sep, parts["lowertrans"]], dim=1)


class GestureCodec(nn.Module):
    """Four frozen TransformerVAEs + the separator token layout."""

    def __init__(self, cfg: CodecConfig = CodecConfig()):
        super().__init__()
        self.cfg = cfg
        for part in PART_NAMES:
            setattr(self, f"{part}_vae", TransformerVAE(cfg.vae_config(part)))

    def _frame_mask(self, feats, frame_mask):
        if frame_mask is None:
            B, T = feats["upper"].shape[:2]
            frame_mask = feats["upper"].new_ones(B, T)
        return frame_mask

    @torch.no_grad()
    def encode(self, feats: Dict[str, torch.Tensor],
               frame_mask: Optional[torch.Tensor] = None,
               eps: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-part encode -> (latents (B, 43, D), token mask (B, 43)).
        With ``eps`` ({part: (B, n_chunks, D)}) each part's latents are
        drawn z = mu + exp(logvar / 2) eps, the reference's rsample at
        encode; without it they are the means."""
        frame_mask = self._frame_mask(feats, frame_mask)
        zs = {p: getattr(self, f"{p}_vae").encode_to_dist(
                  feats[p], None if eps is None else eps[p], frame_mask)[0]
              for p in PART_NAMES}
        latents = _layout(zs, torch.zeros_like(zs["upper"][:, :1]))
        return latents, strided_token_mask(frame_mask,
                                           self.cfg.frame_chunk_size)

    @torch.no_grad()
    def encode_dist(self, feats: Dict[str, torch.Tensor],
                    frame_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar) at the 43-token layout; separators get mu 0 and
        logvar ``SEP_LOGVAR``, so a draw from them is exactly 0."""
        frame_mask = self._frame_mask(feats, frame_mask)
        dists = {p: getattr(self, f"{p}_vae").encode_dist(feats[p], frame_mask)
                 for p in PART_NAMES}
        sep_mu = torch.zeros_like(dists["upper"][0][:, :1])
        mu = _layout({p: d[0] for p, d in dists.items()}, sep_mu)
        logvar = _layout({p: d[1] for p, d in dists.items()},
                         torch.full_like(sep_mu, SEP_LOGVAR))
        return mu, logvar

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
        return decoded_parts(out)


def decoded_parts(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each part VAE's decoded features {part: (B, n_frames, nfeats)} ->
    axis-angle upper / lower / facepose / hands, transl, exps, contact."""
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
