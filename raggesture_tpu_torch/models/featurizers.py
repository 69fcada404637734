"""The featurizers' models without ``transformers``: wav2vec2 and BERT.

The window cache's audio features are wav2vec2-base-960h's last hidden
state and its word features bert-base-cased's hidden states (reference
beatx_dataset.py:501-506, :1115-1179); the JAX package computes them with
HF ``transformers``.  The card's machine has no ``transformers``, so this
module holds what the featurizer needs of it, loaded from a local HF model
directory:

  - ``Wav2Vec2Model``: the conv feature encoder (``feat_extract_norm``
    "group", wav2vec2-base-960h's, or "layer"), the feature projection,
    the weight-normed positional conv with its same-padding, and the post-LN
    (``do_stable_layer_norm=False``) or pre-LN encoder, to
    ``last_hidden_state``; ``normalize_wave`` is the processor's
    ``do_normalize``;
  - ``BertModel``: embeddings and encoder, every hidden state;
  - ``WordPieceTokenizer``: ``BertTokenizerFast``'s ``input_ids`` and
    ``offset_mapping`` for one sentence (the BERT normalizer: text cleaning,
    CJK spacing, accent stripping and lowercasing under ``do_lower_case``;
    whitespace and punctuation pre-tokenization; greedy longest-match
    ``##`` word pieces with ``[UNK]``);
  - the loaders: ``config.json``, ``preprocessor_config.json``,
    ``tokenizer_config.json``, ``vocab.txt``, and ``model.safetensors``
    (``read_safetensors``, header length, JSON header, raw bytes) or
    ``pytorch_model.bin`` (``torch.load(weights_only=True)``); the task
    checkpoints' ``wav2vec2.`` / ``bert.`` prefixes stripped and their heads
    dropped, the old ``LayerNorm.gamma``/``beta`` names and both weight-norm
    namings mapped, as ``from_pretrained`` does; any other unknown or
    missing key raises;
  - ``resolve_model_dir``: a directory, or a hub id found in the local hub
    cache (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``; ``models--{org}--{name}/snapshots/<rev>/``).
    Nothing is downloaded.

Attention runs through ``scaled_dot_product_attention``, as the HF models
do by default; all of it is plain PyTorch on the caller's device.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# weights and configs on disk
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as {name: tensor}: an 8-byte little-endian
    header length, the JSON header ({name: {dtype, shape, data_offsets}}),
    then the tensors' raw little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        buf = bytearray(data[begin:end])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def read_weights(model_dir: str) -> Dict[str, torch.Tensor]:
    """The checkpoint of an HF model directory: ``model.safetensors``, else
    ``pytorch_model.bin`` (tensors only)."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{model_dir}: neither model.safetensors nor "
                            f"pytorch_model.bin")


def read_json(model_dir: str, name: str) -> Dict:
    path = os.path.join(model_dir, name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def hub_cache_dir() -> str:
    """The local HF hub cache: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``,
    else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface",
                        "hub")


def resolve_model_dir(name: str) -> Optional[str]:
    """``name`` when it is a directory; else the hub id's snapshot in the
    local hub cache (the one ``refs/main`` names, else the newest), or None.
    Never downloads."""
    if os.path.isdir(name):
        return name
    repo = os.path.join(hub_cache_dir(), "models--" + name.replace("/", "--"))
    snaps = os.path.join(repo, "snapshots")
    if not os.path.isdir(snaps):
        return None
    ref = os.path.join(repo, "refs", "main")
    if os.path.exists(ref):
        with open(ref) as f:
            rev = os.path.join(snaps, f.read().strip())
        if os.path.isdir(rev):
            return rev
    revs = [os.path.join(snaps, r) for r in os.listdir(snaps)]
    revs = [r for r in revs if os.path.isdir(r)]
    return max(revs, key=os.path.getmtime) if revs else None


# the heads of the released task checkpoints (Wav2Vec2ForCTC,
# BertForPreTraining), dropped as from_pretrained drops them when it loads
# the base model
_HEADS = ("lm_head.", "cls.")


def base_model_state(state: Dict[str, torch.Tensor], prefix: str
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint's base-model keys: ``prefix.`` stripped where the
    checkpoint is a task model's, the heads dropped, the old
    ``LayerNorm.gamma``/``beta`` names and the parametrized weight-norm
    names (``parametrizations.weight.original0/1``) mapped to
    ``LayerNorm.weight``/``bias`` and ``weight_g``/``weight_v``."""
    prefixed = any(k.startswith(prefix + ".") for k in state)
    out = {}
    for key, v in state.items():
        if prefixed:
            if not key.startswith(prefix + "."):
                if key.startswith(_HEADS):
                    continue
            else:
                key = key[len(prefix) + 1:]
        for old, new in (("LayerNorm.gamma", "LayerNorm.weight"),
                         ("LayerNorm.beta", "LayerNorm.bias"),
                         ("parametrizations.weight.original0", "weight_g"),
                         ("parametrizations.weight.original1", "weight_v")):
            if key.endswith(old):
                key = key[:-len(old)] + new
        out[key] = v
    return out


@torch.no_grad()
def load_strict(module: nn.Module, state: Dict[str, torch.Tensor],
                ignored: Tuple[str, ...] = ()) -> None:
    """Copy ``state`` into ``module``: raises on a missing parameter, a key
    with no parameter (other than those ending in ``ignored``) or a shape
    that differs."""
    own = module.state_dict()
    extra = sorted(k for k in state if k not in own
                   and not k.endswith(ignored))
    missing = sorted(set(own) - set(state))
    if extra or missing:
        raise KeyError(f"{type(module).__name__}: {len(missing)} parameters "
                       f"missing, e.g. {missing[:5]}; {len(extra)} unknown "
                       f"keys, e.g. {extra[:5]}")
    for k, t in own.items():
        if tuple(state[k].shape) != tuple(t.shape):
            raise ValueError(f"{type(module).__name__}: {k} has shape "
                             f"{tuple(state[k].shape)}, the model "
                             f"{tuple(t.shape)}")
        t.copy_(state[k].to(t.dtype))


def _activation(name: str):
    """The released models' activation, the exact (erf) GELU."""
    if name != "gelu":
        raise ValueError(f"activation {name!r} is not supported")
    return F.gelu


def _attention(q_proj, k_proj, v_proj, x: torch.Tensor, heads: int
               ) -> torch.Tensor:
    """Unmasked multi-head softmax attention of ``x`` (B, T, D) on itself,
    scaled by head_dim ** -0.5."""
    B, T, D = x.shape
    split = lambda t: t.view(B, T, heads, D // heads).transpose(1, 2)
    y = F.scaled_dot_product_attention(split(q_proj(x)), split(k_proj(x)),
                                       split(v_proj(x)))
    return y.transpose(1, 2).reshape(B, T, D)


# ---------------------------------------------------------------------------
# wav2vec2
# ---------------------------------------------------------------------------

def normalize_wave(wave: np.ndarray) -> np.ndarray:
    """The processor's ``do_normalize`` on one unpadded wave: float32, zero
    mean and unit variance (numpy's float32 mean and variance, + 1e-7)."""
    x = np.asarray(wave, np.float32)
    return (x - x.mean()) / np.sqrt(x.var() + 1e-7)


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Dict, i: int):
        super().__init__()
        cin = cfg["conv_dim"][i - 1] if i > 0 else 1
        cout = cfg["conv_dim"][i]
        self.conv = nn.Conv1d(cin, cout, cfg["conv_kernel"][i],
                              stride=cfg["conv_stride"][i],
                              bias=cfg.get("conv_bias", False))
        norm = cfg.get("feat_extract_norm", "group")
        self.kind = ("layer" if norm == "layer"
                     else "group" if i == 0 else None)
        if self.kind == "layer":
            self.layer_norm = nn.LayerNorm(cout)
        elif self.kind == "group":
            self.layer_norm = nn.GroupNorm(cout, cout, affine=True)
        self.act = _activation(cfg.get("feat_extract_activation", "gelu"))

    def forward(self, x):
        x = self.conv(x)
        if self.kind == "layer":
            x = self.layer_norm(x.transpose(-2, -1)).transpose(-2, -1)
        elif self.kind == "group":
            x = self.layer_norm(x)
        return self.act(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            [_ConvLayer(cfg, i) for i in range(len(cfg["conv_dim"]))])

    def forward(self, wave):
        x = wave[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg["conv_dim"][-1],
                                       eps=cfg.get("layer_norm_eps", 1e-5))
        self.projection = nn.Linear(cfg["conv_dim"][-1], cfg["hidden_size"])

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _PositionalConv(nn.Module):
    """The weight-normed grouped conv (weight = v * g / ||v||, the norm over
    every axis but the kernel's) and ``SamePad`` (the last frame dropped
    for an even kernel), then the activation."""

    def __init__(self, cfg: Dict):
        super().__init__()
        D, k = cfg["hidden_size"], cfg["num_conv_pos_embeddings"]
        groups = cfg["num_conv_pos_embedding_groups"]
        self.kernel, self.groups = k, groups
        self.conv = nn.Module()
        self.conv.weight_g = nn.Parameter(torch.empty(1, 1, k))
        self.conv.weight_v = nn.Parameter(torch.empty(D, D // groups, k))
        self.conv.bias = nn.Parameter(torch.empty(D))
        self.act = _activation(cfg.get("feat_extract_activation", "gelu"))

    def forward(self, x):
        w = torch._weight_norm(self.conv.weight_v, self.conv.weight_g, 2)
        y = F.conv1d(x.transpose(1, 2), w, self.conv.bias,
                     padding=self.kernel // 2, groups=self.groups)
        if self.kernel % 2 == 0:
            y = y[..., :-1]
        return self.act(y).transpose(1, 2)


class _W2VAttention(nn.Module):
    def __init__(self, D: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x):
        return self.out_proj(_attention(self.q_proj, self.k_proj,
                                        self.v_proj, x, self.heads))


class _W2VFeedForward(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg["hidden_size"],
                                            cfg["intermediate_size"])
        self.output_dense = nn.Linear(cfg["intermediate_size"],
                                      cfg["hidden_size"])
        self.act = _activation(cfg.get("hidden_act", "gelu"))

    def forward(self, x):
        return self.output_dense(self.act(self.intermediate_dense(x)))


class _W2VLayer(nn.Module):
    def __init__(self, cfg: Dict, pre_ln: bool):
        super().__init__()
        D, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.pre_ln = pre_ln
        self.attention = _W2VAttention(D, cfg["num_attention_heads"])
        self.layer_norm = nn.LayerNorm(D, eps=eps)
        self.feed_forward = _W2VFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(D, eps=eps)

    def forward(self, x):
        if self.pre_ln:     # Wav2Vec2EncoderLayerStableLayerNorm
            x = x + self.attention(self.layer_norm(x))
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _W2VEncoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.pre_ln = bool(cfg.get("do_stable_layer_norm", False))
        self.pos_conv_embed = _PositionalConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg["hidden_size"],
                                       eps=cfg.get("layer_norm_eps", 1e-5))
        self.layers = nn.ModuleList([_W2VLayer(cfg, self.pre_ln)
                                     for _ in range(cfg["num_hidden_layers"])])

    def forward(self, x):
        x = x + self.pos_conv_embed(x)
        if not self.pre_ln:
            x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return self.layer_norm(x) if self.pre_ln else x


class Wav2Vec2Model(nn.Module):
    """HF ``Wav2Vec2Model``'s inference forward to ``last_hidden_state``,
    from its ``config.json`` dict.  No adapter (``add_adapter`` raises);
    ``masked_spec_embed`` (SpecAugment's training-time mask vector) is held
    only so the checkpoint loads strictly."""

    def __init__(self, cfg: Dict):
        super().__init__()
        if cfg.get("add_adapter"):
            raise ValueError("wav2vec2 with add_adapter is not supported")
        self.cfg = dict(cfg)
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _W2VEncoder(cfg)
        if (cfg.get("mask_time_prob", 0.05) > 0
                or cfg.get("mask_feature_prob", 0.0) > 0):
            self.masked_spec_embed = nn.Parameter(
                torch.empty(cfg["hidden_size"]))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        """(B, samples) normalized waves -> (B, frames, hidden)."""
        feats = self.feature_extractor(input_values).transpose(1, 2)
        return self.encoder(self.feature_projection(feats))


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        D = cfg["hidden_size"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], D)
        self.position_embeddings = nn.Embedding(
            cfg["max_position_embeddings"], D)
        self.token_type_embeddings = nn.Embedding(
            cfg.get("type_vocab_size", 2), D)
        self.LayerNorm = nn.LayerNorm(D, eps=cfg.get("layer_norm_eps", 1e-12))

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (self.word_embeddings(ids)
             + self.token_type_embeddings(torch.zeros_like(ids))
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(x)


class _BertSelf(nn.Module):
    def __init__(self, D: int):
        super().__init__()
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(D, D)
        self.value = nn.Linear(D, D)


class _DenseNorm(nn.Module):
    """``dense`` then ``LayerNorm`` of the residual sum (BertSelfOutput,
    BertOutput)."""

    def __init__(self, din: int, D: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(din, D)
        self.LayerNorm = nn.LayerNorm(D, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class _BertAttention(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        D = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.self = _BertSelf(D)
        self.output = _DenseNorm(D, D, cfg.get("layer_norm_eps", 1e-12))

    def forward(self, x):
        s = self.self
        return self.output(_attention(s.query, s.key, s.value, x,
                                      self.heads), x)


class _BertIntermediate(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.dense = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.act = _activation(cfg.get("hidden_act", "gelu"))

    def forward(self, x):
        return self.act(self.dense(x))


class _BertLayer(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.attention = _BertAttention(cfg)
        self.intermediate = _BertIntermediate(cfg)
        self.output = _DenseNorm(cfg["intermediate_size"], cfg["hidden_size"],
                                 cfg.get("layer_norm_eps", 1e-12))

    def forward(self, x):
        a = self.attention(x)
        return self.output(self.intermediate(a), a)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.layer = nn.ModuleList([_BertLayer(cfg)
                                    for _ in range(cfg["num_hidden_layers"])])


class BertModel(nn.Module):
    """HF ``BertModel``'s inference forward with every hidden state (the
    embeddings' and each layer's), for one unpadded sentence (attention
    over all tokens, token type 0, absolute positions)."""

    # keys of a BertModel checkpoint that the hidden states never read
    IGNORED = ("position_ids", "token_type_ids")
    POOLER = ("pooler.dense.weight", "pooler.dense.bias")

    def __init__(self, cfg: Dict):
        super().__init__()
        if cfg.get("position_embedding_type", "absolute") != "absolute":
            raise ValueError("only absolute BERT position embeddings are "
                             "supported")
        self.cfg = dict(cfg)
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)

    @property
    def max_position_embeddings(self) -> int:
        return self.cfg["max_position_embeddings"]

    def forward(self, input_ids: torch.Tensor) -> List[torch.Tensor]:
        """(B, N) token ids -> the num_hidden_layers + 1 hidden states."""
        h = self.embeddings(input_ids)
        states = [h]
        for layer in self.encoder.layer:
            h = layer(h)
            states.append(h)
        return states


# ---------------------------------------------------------------------------
# the WordPiece tokenizer
# ---------------------------------------------------------------------------

_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_control(c: str) -> bool:
    if c in "\t\n\r":
        return False
    return unicodedata.category(c).startswith("C")


def _is_whitespace(c: str) -> bool:
    return c in " \t\n\r" or c.isspace()


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


class WordPieceTokenizer:
    """``BertTokenizerFast`` for one sentence, from an HF directory's
    ``vocab.txt`` and ``tokenizer_config.json`` (``do_lower_case`` default
    True, ``strip_accents`` default that of ``do_lower_case``,
    ``tokenize_chinese_chars`` default True).  ``__call__`` returns the
    ``input_ids`` ([CLS] pieces [SEP]) and the ``offset_mapping`` into the
    original sentence ((0, 0) for the special tokens)."""

    def __init__(self, vocab: List[str], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", max_input_chars_per_word: int = 100):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.lower = do_lower_case
        self.strip = do_lower_case if strip_accents is None else strip_accents
        self.cjk = tokenize_chinese_chars
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.max_chars = max_input_chars_per_word

    @classmethod
    def from_dir(cls, model_dir: str) -> "WordPieceTokenizer":
        with open(os.path.join(model_dir, "vocab.txt"), encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        tc = read_json(model_dir, "tokenizer_config.json")

        def token(name, default):
            v = tc.get(name, default)
            return v["content"] if isinstance(v, dict) else v

        return cls(vocab, do_lower_case=tc.get("do_lower_case", True),
                   strip_accents=tc.get("strip_accents"),
                   tokenize_chinese_chars=tc.get("tokenize_chinese_chars",
                                                 True),
                   unk_token=token("unk_token", "[UNK]"),
                   cls_token=token("cls_token", "[CLS]"),
                   sep_token=token("sep_token", "[SEP]"))

    def _normalize(self, text: str) -> List[Tuple[str, int]]:
        """The normalized characters, each with its original index."""
        chars = []
        for i, c in enumerate(text):          # clean_text
            if ord(c) == 0 or ord(c) == 0xFFFD or _is_control(c):
                continue
            chars.append((" " if _is_whitespace(c) else c, i))
        if self.cjk:
            spaced = []
            for c, i in chars:
                if _is_cjk(c):
                    spaced += [(" ", i), (c, i), (" ", i)]
                else:
                    spaced.append((c, i))
            chars = spaced
        if self.strip:
            chars = [(d, i) for c, i in chars
                     for d in unicodedata.normalize("NFD", c)
                     if unicodedata.category(d) != "Mn"]
        if self.lower:
            chars = [(d, i) for c, i in chars for d in c.lower()]
        return chars

    def _pre_tokens(self, chars):
        """Split on whitespace (dropped) and punctuation (kept, one a
        token)."""
        words, cur = [], []
        for c, i in chars:
            if _is_whitespace(c):
                if cur:
                    words.append(cur)
                cur = []
            elif _is_punctuation(c):
                if cur:
                    words.append(cur)
                words.append([(c, i)])
                cur = []
            else:
                cur.append((c, i))
        if cur:
            words.append(cur)
        return words

    def _word_pieces(self, word):
        """Greedy longest-match-first pieces of one pre-token, as (id,
        start, end) in its characters; the whole word one [UNK] when a
        part matches nothing or it is too long."""
        text = "".join(c for c, _ in word)
        n = len(text)
        if n > self.max_chars:
            return [(self.unk_id, 0, n)]
        pieces, start = [], 0
        while start < n:
            end = n
            found = None
            while start < end:
                sub = text[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    found = self.vocab[sub]
                    break
                end -= 1
            if found is None:
                return [(self.unk_id, 0, n)]
            pieces.append((found, start, end))
            start = end
        return pieces

    def __call__(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]:
        ids, offsets = [self.cls_id], [(0, 0)]
        for word in self._pre_tokens(self._normalize(text)):
            for tid, s, e in self._word_pieces(word):
                ids.append(tid)
                offsets.append((word[s][1], word[e - 1][1] + 1))
        ids.append(self.sep_id)
        offsets.append((0, 0))
        return ids, offsets


def load_wav2vec2(model_dir: str) -> Tuple[Wav2Vec2Model, Dict]:
    """The wav2vec2 model of an HF directory (on the CPU) and its
    processor config."""
    cfg = read_json(model_dir, "config.json")
    model = Wav2Vec2Model(cfg)
    load_strict(model, base_model_state(read_weights(model_dir), "wav2vec2"))
    return model.eval(), read_json(model_dir, "preprocessor_config.json")


def load_bert(model_dir: str) -> Tuple[BertModel, WordPieceTokenizer]:
    """The BERT model of an HF directory (on the CPU) and its tokenizer."""
    model = BertModel(read_json(model_dir, "config.json"))
    state = {k: v for k, v in base_model_state(
        read_weights(model_dir), "bert").items()
        if k not in BertModel.POOLER}
    load_strict(model, state, ignored=BertModel.IGNORED)
    return model.eval(), WordPieceTokenizer.from_dir(model_dir)
