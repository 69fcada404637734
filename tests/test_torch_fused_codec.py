"""The stacked 3-part codec decode: the port's ``fused_codec.fused_decode``
against the JAX package's ``fused_decode`` and against the port's own
4-pass ``GestureCodec.decode`` on the same weights, the stack's layout,
where its attention takes kernel K2, and the generator's ``fused_codec``
option.

Tolerances: float32 on both sides.  Against JAX 2e-5 (nine post-norm
layers in another framework's summation order, as the 4-pass decode in
tests/test_torch_models.py); against the port's 4-pass decode 1e-5 (the
same products, batched over the stack).
"""

import numpy as np
import pytest
import torch

from test_torch_common import port_model_and_jax_tree

TOL_JAX = 2e-5
TOL_PORT = 1e-5


@pytest.fixture(scope="module")
def case():
    from raggesture_tpu.datasets.fixtures import tiny_arch_config

    jcfg = tiny_arch_config()
    model, params = port_model_and_jax_tree(jcfg)
    rng = np.random.RandomState(4)
    z = rng.randn(3, jcfg.denoiser.num_tokens,
                  jcfg.denoiser.latent_dim).astype(np.float32)
    return dict(jcfg=jcfg, params=params, model=model, z=z)


def test_fused_decode_matches_jax_and_the_four_pass_decode(case):
    from raggesture_tpu.models import fused_codec as JF
    from raggesture_tpu_torch.models.fused_codec import (
        fused_decode,
        stack_codec_params,
    )

    jcfg, codec_p = case["jcfg"], case["params"]["params"]["codec"]
    want = JF.fused_decode(jcfg.codec, codec_p,
                           JF.stack_codec_params(codec_p, jcfg.codec),
                           case["z"])
    codec = case["model"].codec
    z = torch.from_numpy(case["z"])
    got = fused_decode(codec, stack_codec_params(codec), z)
    four = case["model"].decode_latents(z)
    assert sorted(got) == sorted(want) == sorted(four)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL_JAX, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), four[k].numpy(),
                                   atol=TOL_PORT, rtol=0, err_msg=k)


def test_stack_layout(case):
    """Every decode parameter of upper, hands and face stacked along an
    axis of 3 (and nothing of the encode); the output projection padded
    with zero rows to 180 features."""
    from raggesture_tpu_torch.models.fused_codec import (
        PAD_NFEATS,
        STACK_PARTS,
        stack_codec_params,
    )

    codec = case["model"].codec
    st = stack_codec_params(codec)
    names = {n for n, _ in codec.hands_vae.named_parameters()
             if n.startswith(("decoder.", "query_pos_decoder.",
                              "final_layer."))}
    assert set(st) == names
    for j, part in enumerate(STACK_PARTS):
        vae = getattr(codec, f"{part}_vae")
        nf = vae.cfg.nfeats
        w, b = st["final_layer.weight"][j], st["final_layer.bias"][j]
        assert w.shape[0] == b.shape[0] == PAD_NFEATS
        assert torch.equal(w[:nf], vae.final_layer.weight)
        assert torch.equal(b[:nf], vae.final_layer.bias)
        assert not w[nf:].any() and not b[nf:].any()
        assert torch.equal(st["decoder.middle.linear1.weight"][j],
                           vae.decoder.middle.linear1.weight)


def test_stacked_attention_takes_k2_once_a_layer(monkeypatch):
    """At the shipped width (32 and 64 heads of 16 and 8 columns, which
    the kernel takes) the stack's attention is one K2 call a layer over
    (3·B, T, 512), and lowertrans one of its own: 2 a layer, where the
    4-pass decode makes 4."""
    from raggesture_tpu_torch.models import vae
    from raggesture_tpu_torch.models.architecture import init_weights
    from raggesture_tpu_torch.models.codec import CodecConfig, GestureCodec
    from raggesture_tpu_torch.models.fused_codec import (
        fused_decode,
        stack_codec_params,
    )

    calls = []
    real = vae.fused_softmax_mha

    def spy(q, k, v, heads, scale):
        calls.append((tuple(q.shape), heads, q.is_contiguous()))
        return real(q, k, v, heads, scale)

    monkeypatch.setattr(vae, "fused_softmax_mha", spy)
    codec = GestureCodec(CodecConfig(num_layers=2, ff_size=64)).eval()
    init_weights(codec, torch.Generator().manual_seed(0))
    z = torch.randn(2, codec.cfg.num_tokens, 512,
                    generator=torch.Generator().manual_seed(1))
    layers = 3                       # 2 rounded up to odd
    got = fused_decode(codec, stack_codec_params(codec), z)
    Tq = 10 + 150
    assert calls == ([((6, Tq, 512), 32, True)] * layers
                     + [((2, Tq, 512), 64, True)] * layers)
    calls.clear()
    want = codec.decode(z)
    assert len(calls) == 4 * layers
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=TOL_PORT, rtol=0)


def test_generator_decodes_through_the_stack_when_fused(case):
    from raggesture_tpu_torch.diffusion.schedules import make_schedule
    from raggesture_tpu_torch.models.architecture import StagedGenerator

    sched = make_schedule("scaled_linear", 100, "1,1", 2)
    model = case["model"]
    for kw, stacked in ((dict(), True), (dict(fused=False), False),
                        (dict(fused=False, fused_codec=True), True),
                        (dict(fused_codec=False), False)):
        gen = StagedGenerator(model, sched, **kw)
        assert (gen._codec_stack is not None) == stacked, kw
        assert gen.graphs is None           # off on the CPU
    z = torch.from_numpy(case["z"])
    on = StagedGenerator(model, sched)._results(z)
    off = StagedGenerator(model, sched, fused_codec=False)._results(z)
    assert sorted(on) == sorted(off)
    for k in on:
        torch.testing.assert_close(on[k], off[k], atol=TOL_PORT, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        StagedGenerator(model, sched, graphs=True)
