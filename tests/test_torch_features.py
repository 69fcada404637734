"""The port's HF featurizers (``models/featurizers.py``,
``datasets/beatx.py::HFFeatureExtractor``) against the JAX package's
``HFFeatureExtractor``, which runs HF ``transformers``, on the same tiny
random local models: wav2vec2 in both ``feat_extract_norm`` flavours (and
both encoder stacks), BERT with a written vocabulary, saved as
``model.safetensors`` and as ``pytorch_model.bin``, as base models and as
task checkpoints (``wav2vec2.`` + ``lm_head``, ``bert.`` + ``cls.`` with
the old ``gamma``/``beta`` and ``weight_g``/``weight_v`` names).

Tolerances: features within 1e-5 (both float32, summation order only);
``input_ids``, offsets and word grouping identical.  ~10 s on one worker.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

TOL = 1e-5

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "hello", "world", "aga", "##in", "and", "big", "##ger", "words",
         ",", ".", "!", "cafe", "caf", "##e", "##é", "naive", "na", "##ive",
         "你", "Hello", "World", "Caf", "AG", "##AI", "##N", "-", "'", "s"]

SENTENCES = [
    "hello, world again.",
    "Hello World AGAIN and bigger words zzz",
    "Café naïve 你好 hello!",
    "hello\tworld again  - world's",
    "a" * 120 + " hello",
    "",
]


def _write_bert(d, lower, safetensors, task):
    from transformers import (BertConfig, BertForPreTraining, BertModel,
                              BertTokenizerFast)

    os.makedirs(d, exist_ok=True)
    vocab_path = os.path.join(d, "vocab.txt")
    with open(vocab_path, "w") as f:
        f.write("\n".join(VOCAB))
    BertTokenizerFast(vocab_file=vocab_path,
                      do_lower_case=lower).save_pretrained(d)
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(VOCAB), hidden_size=32,
                     num_hidden_layers=5, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=40)
    model = (BertForPreTraining if task else BertModel)(cfg).eval()
    model.save_pretrained(d, safe_serialization=safetensors)
    if task:
        # the release's TF-era names: LayerNorm.gamma / beta
        path = os.path.join(d, "pytorch_model.bin")
        state = torch.load(path, weights_only=True)
        state = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
                 .replace("LayerNorm.bias", "LayerNorm.beta"): v
                 for k, v in state.items()}
        torch.save(state, path)
    return d


def _write_w2v(d, norm, safetensors, task):
    from transformers import (Wav2Vec2Config, Wav2Vec2CTCTokenizer,
                              Wav2Vec2FeatureExtractor, Wav2Vec2ForCTC,
                              Wav2Vec2Model, Wav2Vec2Processor)

    os.makedirs(d, exist_ok=True)
    vocab = {c: i for i, c in enumerate(
        ["<pad>", "<s>", "</s>", "<unk>", "|", "a", "b"])}
    vpath = os.path.join(d, "vocab.json")
    with open(vpath, "w") as f:
        json.dump(vocab, f)
    Wav2Vec2Processor(
        feature_extractor=Wav2Vec2FeatureExtractor(
            do_normalize=True, return_attention_mask=False),
        tokenizer=Wav2Vec2CTCTokenizer(vpath)).save_pretrained(d)
    torch.manual_seed(1)
    cfg = Wav2Vec2Config(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
        num_feat_extract_layers=3, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, feat_extract_norm=norm,
        do_stable_layer_norm=norm == "layer", conv_bias=norm == "layer")
    model = (Wav2Vec2ForCTC if task else Wav2Vec2Model)(cfg).eval()
    model.save_pretrained(d, safe_serialization=safetensors)
    if task:
        # the older weight-norm naming: weight_g / weight_v
        path = os.path.join(d, "pytorch_model.bin")
        state = torch.load(path, weights_only=True)
        state = {k.replace("parametrizations.weight.original0", "weight_g")
                 .replace("parametrizations.weight.original1", "weight_v"): v
                 for k, v in state.items()}
        torch.save(state, path)
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {
        # base models, safetensors; wav2vec2 "layer" (pre-LN encoder)
        "w2v_layer": _write_w2v(str(root / "w2v_layer"), "layer", True, False),
        "bert_lower": _write_bert(str(root / "bert_lower"), True, True, False),
        # task checkpoints, pytorch_model.bin; wav2vec2 "group" (post-LN,
        # wav2vec2-base-960h's flavour); a cased vocabulary
        "w2v_group": _write_w2v(str(root / "w2v_group"), "group", False, True),
        "bert_cased": _write_bert(str(root / "bert_cased"), False, False,
                                  True),
    }


@pytest.fixture(scope="module")
def pairs(dirs):
    from raggesture_tpu.datasets.beatx import HFFeatureExtractor as JaxHF

    from raggesture_tpu_torch.datasets.beatx import HFFeatureExtractor

    out = {}
    for w2v, bert in (("w2v_layer", "bert_lower"), ("w2v_group",
                                                    "bert_cased")):
        out[(w2v, bert)] = (
            HFFeatureExtractor(dirs[w2v], dirs[bert], device="cpu"),
            JaxHF(wav2vec_name=dirs[w2v], bert_name=dirs[bert]))
    return out


PAIRS = [("w2v_layer", "bert_lower"), ("w2v_group", "bert_cased")]


@pytest.mark.parametrize("pair", PAIRS)
def test_audio_features_match_jax(pairs, pair):
    port, jax_ext = pairs[pair]
    wave = np.random.RandomState(2).randn(7999).astype(np.float32) * 0.1
    got = port.audio_features(wave, 16000)
    want = jax_ext.audio_features(wave, 16000)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("sentence", SENTENCES)
def test_tokens_offsets_and_word_vectors_match_jax(pairs, pair, sentence):
    from raggesture_tpu.datasets.beatx import \
        _tokens_per_whitespace_word as jax_groups

    from raggesture_tpu_torch.datasets.beatx import \
        _tokens_per_whitespace_word

    port, jax_ext = pairs[pair]
    tok = jax_ext.tokenizer(sentence, return_offsets_mapping=True)
    ids, offsets = port.tokenizer(sentence)
    assert ids == tok["input_ids"]
    assert offsets == [tuple(o) for o in tok["offset_mapping"]]
    assert (_tokens_per_whitespace_word(sentence, offsets)
            == jax_groups(sentence, tok["offset_mapping"]))
    vecs, states = port.word_embeddings(sentence)
    jvecs, jstates = jax_ext.word_embeddings(sentence)
    np.testing.assert_allclose(states, jstates, atol=TOL, rtol=0)
    assert len(vecs) == len(jvecs) == len(sentence.split())
    for a, b in zip(vecs, jvecs):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_above_the_position_limit_is_none(pairs):
    port, jax_ext = pairs[PAIRS[0]]
    sentence = " ".join(["hello"] * 39)       # 41 tokens > 40 positions
    assert jax_ext.word_embeddings(sentence) == (None, None)
    assert port.word_embeddings(sentence) == (None, None)
    ok = " ".join(["hello"] * 38)             # 40 tokens
    assert port.word_embeddings(ok)[0] is not None


def test_weights_load_strictly(dirs, tmp_path):
    """An unknown or a missing key raises; the heads and the old names
    do not."""
    from raggesture_tpu_torch.models import featurizers as FZ

    d = str(tmp_path / "bert")
    shutil.copytree(dirs["bert_lower"], d)
    state = FZ.read_safetensors(os.path.join(d, "model.safetensors"))
    assert FZ.load_bert(d)[0] is not None
    os.remove(os.path.join(d, "model.safetensors"))
    extra = dict(state, **{"encoder.layer.0.extra.weight": torch.ones(2)})
    torch.save(extra, os.path.join(d, "pytorch_model.bin"))
    with pytest.raises(KeyError, match="unknown"):
        FZ.load_bert(d)
    missing = {k: v for k, v in state.items() if "layer.4.output" not in k}
    torch.save(missing, os.path.join(d, "pytorch_model.bin"))
    with pytest.raises(KeyError, match="missing"):
        FZ.load_bert(d)


def test_hub_cache_lookup_and_default_extractor(dirs, tmp_path, monkeypatch):
    """Hub ids resolve in the local hub cache (refs/main's snapshot);
    without the weights make_default_extractor returns None."""
    from raggesture_tpu_torch.datasets.beatx import HFFeatureExtractor
    from raggesture_tpu_torch.datasets.build import (HF_BERT, HF_WAV2VEC2,
                                                     make_default_extractor)
    from raggesture_tpu_torch.models.featurizers import resolve_model_dir

    hub = tmp_path / "hub"
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    monkeypatch.delenv("HF_HOME", raising=False)
    assert resolve_model_dir(HF_BERT) is None
    assert make_default_extractor("cpu") is None
    for name, src in ((HF_WAV2VEC2, dirs["w2v_group"]),
                      (HF_BERT, dirs["bert_cased"])):
        repo = hub / ("models--" + name.replace("/", "--"))
        shutil.copytree(src, repo / "snapshots" / "rev1")
        (repo / "snapshots" / "rev0").mkdir()
        (repo / "refs").mkdir()
        (repo / "refs" / "main").write_text("rev1")
    assert resolve_model_dir(HF_BERT) == str(hub / "models--bert-base-cased"
                                             / "snapshots" / "rev1")
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    ext = make_default_extractor("cpu")
    assert isinstance(ext, HFFeatureExtractor)
    assert ext.device == torch.device("cpu")
    assert ext.audio_dim == ext.text_dim == 32
