"""FGD embedder: the skeleton-aware convolutional autoencoder (VAESKConv).

Port of ``raggesture_tpu/models/eval_fgd.py``, the EMAGE evaluation model
of ``AESKConv_240_100.bin`` (reference mogen/models/eval_models/model.py:
12-252, skeleton.py): skeleton-masked strided conv1ds with mean pooling
over the SMPL-X kinematic tree, whose latents feed the Fréchet gesture
distance, and the conv decoder a checkpoint carries.

The skeleton topology (edge list, distance-d neighbourhoods, chain pooling)
is host numpy, built once per module.  A ``SkeletonConv`` is ``F.conv1d``
with its weight times the 0/1 mask; Flax's ``GroupNorm(10)`` over (B, T, C)
with contiguous channel groups is ``nn.GroupNorm(10, C)`` over (B, C, T).
The parameters carry the JAX tree's names (``encoder.layer_0.conv.weight``,
``encoder.layer_0.norm.weight`` for its ``scale``, ``decoder.res0_c1_w``),
so ``utils/convert_jax.py::load_jax_params`` fills them.

The calls multiply in float32 on a card (no TF32, scoped to the call): the
latents feed a Fréchet distance, which amplifies small differences.

Replicated quirk: the residual branch normalises with ``GroupNorm(10,
out_channels)`` after the strided conv (skeleton.py:569, EMAGE's FIXME),
kept for checkpoint parity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import float32_products

# ---------------------------------------------------------------------------
# static skeleton topology helpers (host)
# ---------------------------------------------------------------------------


def build_edge_topology(parents: Sequence[int]) -> List[Tuple[int, int]]:
    """(parent, child) edge list with a virtual root edge (0, J)
    (skeleton.py:320-327)."""
    J = len(parents)
    edges = [(0, J)]
    for i in range(1, J):
        edges.append((int(parents[i]), i))
    return edges


def calc_edge_distances(edges: List[Tuple[int, int]]) -> np.ndarray:
    """All-pairs edge distances: adjacent (sharing a joint) = 1, then
    Floyd-Warshall (skeleton.py:377-400)."""
    n = len(edges)
    mat = np.full((n, n), 100000, np.int64)
    np.fill_diagonal(mat, 0)
    for i, a in enumerate(edges):
        for j, b in enumerate(edges):
            if a[0] in b or a[1] in b:
                mat[i, j] = 1
    for k in range(n):
        mat = np.minimum(mat, mat[:, k: k + 1] + mat[k: k + 1, :])
    return mat


def find_neighbor(edges: List[Tuple[int, int]], d: int) -> List[List[int]]:
    mat = calc_edge_distances(edges)
    return [list(np.where(mat[i] <= d)[0]) for i in range(len(edges))]


def find_pooling(edges: List[Tuple[int, int]], last_pool: bool
                 ) -> Tuple[List[List[int]], List[Tuple[int, int]]]:
    """Chain-based skeleton pooling (skeleton.py:166-233): split the edge
    graph into chains between branching joints and end effectors, then
    merge consecutive edge pairs (or whole chains when ``last_pool``)."""
    degree = [0] * 1000
    for a, b in edges:
        degree[a] += 1
        degree[b] += 1

    seq_list: List[List[int]] = []

    def find_seq(j: int, seq: List[int]):
        if degree[j] > 2 and j != 0:
            seq_list.append(seq)
            seq = []
        if degree[j] == 1:
            seq_list.append(seq)
            return
        for idx, e in enumerate(edges):
            if e[0] == j:
                find_seq(e[1], seq + [idx])

    find_seq(0, [])

    pooling_list: List[List[int]] = []
    new_edges: List[Tuple[int, int]] = []
    for seq in seq_list:
        if last_pool:
            pooling_list.append(seq)
            continue
        if len(seq) % 2 == 1:
            pooling_list.append([seq[0]])
            new_edges.append(edges[seq[0]])
            seq = seq[1:]
        for i in range(0, len(seq), 2):
            pooling_list.append([seq[i], seq[i + 1]])
            new_edges.append((edges[seq[i]][0], edges[seq[i + 1]][1]))
    return pooling_list, new_edges


def pool_matrix(pooling_list: List[List[int]], in_edges: int,
                channels_per_edge: int) -> np.ndarray:
    """Mean-pool matrix (out_edges*c, in_edges*c) (skeleton.py:226-233)."""
    w = np.zeros((len(pooling_list) * channels_per_edge,
                  in_edges * channels_per_edge), np.float32)
    for i, pair in enumerate(pooling_list):
        for j in pair:
            for c in range(channels_per_edge):
                w[i * channels_per_edge + c, j * channels_per_edge + c] = (
                    1.0 / len(pair))
    return w


def conv_mask(neighbour_list: List[List[int]], in_per_joint: int,
              out_per_joint: int, kernel: int) -> np.ndarray:
    """0/1 weight mask (out_ch, in_ch, k): each edge's output channels see
    only its distance-d neighbour edges' input channels (skeleton.py:63-66)."""
    n = len(neighbour_list)
    mask = np.zeros((n * out_per_joint, n * in_per_joint, kernel), np.float32)
    for i, nbrs in enumerate(neighbour_list):
        cols = [k * in_per_joint + c for k in nbrs for c in range(in_per_joint)]
        mask[i * out_per_joint: (i + 1) * out_per_joint, cols, :] = 1.0
    return mask


@dataclasses.dataclass(frozen=True)
class FGDConfig:
    """tools/evaluate.py:91-97 of the reference."""

    input_dim: int = 330
    latent_dim: int = 240
    num_layers: int = 4
    channel_base: int = 6
    grow: Tuple[int, ...] = (1, 1, 2, 1)
    skeleton_dist: int = 2
    kernel_size: int = 4
    window: int = 32
    stride: int = 20
    variational: bool = False


def default_smplx_parents() -> np.ndarray:
    """The 55-joint SMPL-X kinematic tree (standard SMPLX_NEUTRAL_2020
    kintree, body 0-21, jaw 22, eyes 23-24, left hand 25-39, right 40-54)."""
    return np.array([
        -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19, 15, 15, 15,
        20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
        21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,
    ], np.int32)


def encoder_topology(cfg: FGDConfig, parents: Sequence[int]) -> List[Dict]:
    """Per encoder stage: its residual and shortcut masks, its pool matrix
    and whether it pools (a pool that keeps every edge is left out, as the
    reference omits the module)."""
    edges = build_edge_topology(list(parents))
    topologies = [edges]
    cb = [cfg.channel_base]
    for g in cfg.grow:
        cb.append(cb[-1] * g)
    stages = []
    for i in range(cfg.num_layers):
        nbrs = find_neighbor(topologies[i], cfg.skeleton_dist)
        last_pool = i == cfg.num_layers - 1
        pooling_list, new_edges = find_pooling(topologies[i], last_pool)
        n_edges = len(topologies[i])
        stages.append({
            "res_mask": conv_mask(nbrs, cb[i], cb[i + 1], cfg.kernel_size),
            # the reference's shortcut SkeletonConv uses the FULL neighbour
            # list too (skeleton.py:573-575), not the identity
            "short_mask": conv_mask(nbrs, cb[i], cb[i + 1], 1),
            "pool_w": pool_matrix(pooling_list, n_edges, cb[i + 1]),
            "do_pool": len(pooling_list) != n_edges})
        topologies.append(new_edges if not last_pool
                          else [(0, 0)] * len(pooling_list))
    return stages


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class SkeletonConv(nn.Module):
    """Masked conv1d over (B, C, T) with zero padding."""

    def __init__(self, mask: np.ndarray, stride: int, padding: int):
        super().__init__()
        out_ch, in_ch, k = mask.shape
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.kaiming_uniform_(self.weight, nonlinearity="relu")
        self.register_buffer("mask", torch.from_numpy(mask),
                             persistent=False)

    def forward(self, x):
        return F.conv1d(x, self.weight * self.mask, self.bias,
                        stride=self.stride, padding=self.padding)


class SkeletonResidualLayer(nn.Module):
    """One encoder stage: strided masked conv + GroupNorm(10) residual, a
    k=1 strided masked shortcut, optional mean pool, tanh
    (skeleton.py:551-589)."""

    def __init__(self, res_mask, short_mask, pool_w, do_pool: bool,
                 kernel: int = 4):
        super().__init__()
        self.conv = SkeletonConv(res_mask, stride=2,
                                 padding=(kernel - 1) // 2)
        self.norm = nn.GroupNorm(10, res_mask.shape[0], eps=1e-5)
        self.shortcut = SkeletonConv(short_mask, stride=2, padding=0)
        self.do_pool = do_pool
        self.register_buffer("pool_w", torch.from_numpy(pool_w),
                             persistent=False)

    def forward(self, x):  # (B, C, T)
        y = self.norm(self.conv(x)) + self.shortcut(x)
        if self.do_pool:
            y = torch.einsum("oc,bct->bot", self.pool_w, y)
        return torch.tanh(y)


class LocalSkeletonEncoder(nn.Module):
    """The skeleton conv encoder (model.py:12-107): (B, T, D) ->
    (B, T / 2^num_layers, out_dim)."""

    def __init__(self, cfg: FGDConfig, parents: Sequence[int]):
        super().__init__()
        self.num_layers = cfg.num_layers
        for i, st in enumerate(encoder_topology(cfg, parents)):
            self.add_module(f"layer_{i}", SkeletonResidualLayer(
                st["res_mask"], st["short_mask"], st["pool_w"],
                st["do_pool"], cfg.kernel_size))
        last = getattr(self, f"layer_{cfg.num_layers - 1}")
        self.out_dim = (last.pool_w.shape[0] if last.do_pool
                        else last.conv.weight.shape[0])

    def forward(self, x):
        y = x.transpose(1, 2)
        for i in range(self.num_layers):
            y = getattr(self, f"layer_{i}")(y)
        return y.transpose(1, 2)


class ConvDecoder(nn.Module):
    """VQDecoderV3 (model.py:165-198): 2 res blocks, num_layers x (2x
    nearest upsample + conv + leaky relu), a final conv.  Its weights are
    raw (out, in, k) parameters named as the JAX tree's leaves."""

    def __init__(self, cfg: FGDConfig):
        super().__init__()
        c = cfg.latent_dim
        channels = [c] * (cfg.num_layers - 1) + [c, cfg.input_dim]
        shapes = {f"res{n}_c{m}": (c, c) for n in range(2) for m in (1, 2)}
        for i in range(cfg.num_layers):
            shapes[f"up{i}"] = (channels[i + 1], channels[i])
        shapes["final"] = (channels[-1], channels[-1])
        self.num_layers = cfg.num_layers
        for name, (o, i) in shapes.items():
            w = nn.Parameter(torch.empty(o, i, 3))
            nn.init.xavier_normal_(w)
            self.register_parameter(f"{name}_w", w)
            self.register_parameter(f"{name}_b",
                                    nn.Parameter(torch.zeros(o)))

    def _conv(self, x, name):
        return F.conv1d(x, getattr(self, f"{name}_w"),
                        getattr(self, f"{name}_b"), padding=1)

    def forward(self, z):  # (B, T', latent)
        x = z.transpose(1, 2)
        for n in range(2):
            y = F.leaky_relu(self._conv(x, f"res{n}_c1"), 0.2)
            x = x + self._conv(y, f"res{n}_c2")
        for i in range(self.num_layers):
            x = torch.repeat_interleave(x, 2, dim=-1)
            x = F.leaky_relu(self._conv(x, f"up{i}"), 0.2)
        return self._conv(x, "final").transpose(1, 2)


class FGDEmbedder(nn.Module):
    """map2latent + conv decoder (VAESKConv, model.py:207-252)."""

    def __init__(self, cfg: FGDConfig = FGDConfig(),
                 parents: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        parents = (default_smplx_parents().tolist() if parents is None
                   else list(parents))
        self.encoder = LocalSkeletonEncoder(cfg, parents)
        self.decoder = ConvDecoder(cfg)
        if cfg.variational:
            self.fc_mu = nn.Linear(self.encoder.out_dim, cfg.latent_dim)
            self.fc_logvar = nn.Linear(self.encoder.out_dim, cfg.latent_dim)

    def map2latent(self, poses_6d: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """(B, T, input_dim) 6d poses -> (B, T / 2^num_layers, latent) FGD
        latents.  A variational embedder draws its noise from
        ``generator``, which it then needs."""
        with float32_products():
            z = self.encoder(poses_6d)
            if self.cfg.variational:
                if generator is None:
                    raise ValueError("a variational FGDEmbedder draws its "
                                     "latents from a generator: pass one")
                mu, logvar = self.fc_mu(z), self.fc_logvar(z)
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device, dtype=mu.dtype)
                z = mu + torch.exp(0.5 * logvar) * eps
        return z

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with float32_products():
            return self.decoder(z)

    def forward(self, poses_6d, generator=None):
        z = self.map2latent(poses_6d, generator)
        return {"poses_feat": z, "rec_pose": self.decode(z)}
