"""The port's caption decoder, its sampling helpers, config and name map
against the JAX package, in f32 on the CPU.

Weights cross over through ``convert/openclip.py`` and inputs are made with
seeded numpy. The JAX side runs as its own tests run it: the ``fused`` and
``flash`` Pallas kernels in interpret mode. Logit tolerance: atol 1e-5 of
the largest logit and rtol 1e-5 -- both sides compute in f32 and differ in
summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.models import decoder as jdec
from openvision_tpu.models import text as jtext
from openvision_tpu.models import vit as jvit
from openvision_tpu.parallel import unbox
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import (
    jax_decoder_to_state_dict,
    state_dict_to_jax_decoder,
)
from openvision_tpu_torch.models import attention_module
from openvision_tpu_torch.models import decoder as tdec
from openvision_tpu_torch.models import text as ttext
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.models.attention_module import MultiHeadAttention

VOCAB, LI, LT, DI, DT = 300, 9, 7, 48, 40
DEC = dict(width=64, depth=2, mlp_dim=128, num_heads=2, num_classes=VOCAB,
           num_learnable_tokens=6)


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, LI, DI)).astype(np.float32),
            rng.standard_normal((2, LT, DT)).astype(np.float32))


def _decoders(fusion, impl):
    img, txt = _tokens()
    jmodel = jdec.TextDecoder(fusion_style=fusion, attn_impl=impl, **DEC)
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(txt))["params"])
    port = tdec.TextDecoder(fusion_style=fusion, attn_impl=impl, image_width=DI, text_width=DT,
                            **DEC)
    port.load_state_dict({k.removeprefix("txt_decoder."): torch.tensor(v)
                          for k, v in jax_decoder_to_state_dict(params).items()})
    return jmodel, params, port.eval()


@pytest.mark.parametrize("impl", ["xla", "fused", "flash"])
@pytest.mark.parametrize("fusion", ["concat", "cross_attn"])
def test_decoder_matches_jax(fusion, impl):
    jmodel, params, port = _decoders(fusion, impl)
    img, txt = _tokens(1)
    want, _ = jmodel.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt))
    want = np.asarray(want)
    with torch.inference_mode():
        got = port(torch.from_numpy(img), torch.from_numpy(txt)).numpy()
    assert got.shape == (2, 6, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    ids = tdec.generate(port, torch.from_numpy(img), torch.from_numpy(txt), eos_id=2)
    jids = jdec.generate(jmodel, params, jnp.asarray(img), jnp.asarray(txt), eos_id=2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("fusion", ["concat", "cross_attn"])
def test_decoder_name_map_round_trips(fusion):
    _, params, port = _decoders(fusion, "xla")
    back = state_dict_to_jax_decoder(
        {f"txt_decoder.{k}": v for k, v in port.state_dict().items()}, num_heads=2)
    flat = {"txt_decoder/" + "/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert back.keys() == flat.keys()
    for name, leaf in flat.items():
        np.testing.assert_array_equal(back[name], np.asarray(leaf), err_msg=name)


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.9), (7, 0.5), (500, 0.0)])
def test_warp_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(2).standard_normal((3, 4, 100)).astype(np.float32) * 3
    want = np.asarray(jdec.warp_logits(jnp.asarray(logits), top_k=top_k, top_p=top_p))
    got = tdec.warp_logits(torch.from_numpy(logits), top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_draws_from_the_warped_support_with_a_generator():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 50)).astype(np.float32))
    draw = lambda seed: tdec.sample_ids(logits, temperature=0.7, top_k=3,
                                        generator=torch.Generator().manual_seed(seed))
    a, b = draw(0), draw(0)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, draw(1))
    top3 = logits.topk(3, dim=-1).indices
    assert (top3 == a[..., None]).any(-1).all()
    with pytest.raises(ValueError, match="Generator"):
        tdec.sample_ids(logits, temperature=1.0)


def test_ids_after_the_first_eos_become_pad():
    ids = torch.tensor([[5, 2, 7, 2, 9], [1, 3, 4, 6, 8]])
    want = torch.tensor([[5, 2, 0, 0, 0], [1, 3, 4, 6, 8]])
    torch.testing.assert_close(tdec.mask_after_eos(ids, eos_id=2, pad_id=0), want)


def test_towers_output_tokens_match_jax():
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(0, 100, (2, 12)).astype(np.int32)
    vcfg = dict(variant="mu/16", posemb="sincos2d", pool_type="gap", emb_head_bias=False,
                output_tokens=True, fast_gelu=True)
    jv = jvit.Model(16, **vcfg)
    pv = unbox(jax.jit(jv.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    _, want = jax.jit(jv.apply)({"params": pv}, images)
    tv = tvit.Model(16, image_size=32, **vcfg)
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    tv.load_state_dict({k.removeprefix("visual."): v
                        for k, v in jax_params_to_state_dict({"img": pv}).items()})
    with torch.inference_mode():
        _, got = tv(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # ignore_cls drops the cls token before the encoder: every token comes out
    pooled_want, want = jax.jit(jvit.Model(16, ignore_cls=True, **vcfg).apply)(
        {"params": pv}, images)
    tv.ignore_cls = True
    with torch.inference_mode():
        pooled, got = tv(torch.from_numpy(images))
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_want), atol=1e-5, rtol=1e-5)

    tcfg_ = dict(width=64, depth=2, mlp_dim=128, num_heads=2, vocab_size=100, output_tokens=True)
    jt = jtext.TextTransformer(16, **tcfg_)
    pt = unbox(jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32))["params"])
    _, want = jax.jit(jt.apply)({"params": pt}, tokens)
    tt = ttext.TextTransformer(16, context_length=12, **tcfg_)
    tt.load_state_dict({k.removeprefix("text."): v
                        for k, v in jax_params_to_state_dict({"txt": pt}).items()})
    with torch.inference_mode():
        _, got = tt(torch.from_numpy(tokens))
    assert got.shape == (2, 11, 64)  # pre-norm, the last ([CLS]) position dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arg", [
    "res=224,img=L/14,txt_name=L,txt_decoder_name=L",
    "res=224,img=L/14,txt_name=L,txt_decoder_name=L,dtype=bfloat16,dec_fusion=cross_attn,"
    "dec_attn_impl=flash",
    "res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
    "pipe_parallelism=2,img_head=False",
])
def test_config_model_section_matches_jax(arg):
    j, t = jcfg.get_config(arg), tcfg.get_config(arg)
    assert t["init_shapes"] == [tuple(s) for s in j.init_shapes]
    assert t["input"]["txt_token_length"] == j.input.txt_token_length
    assert tuple(t["model"]["out_dim"]) == tuple(j.model.out_dim)
    assert t["model"]["text_decoder"] == j.model.text_decoder
    assert t["model"]["temperature_init"] == j.model.temperature_init
    for sec, jsec in (("image", j.model.image), ("text", j.model.text),
                      ("text_decoder_config", j.model.text_decoder_config)):
        common = set(t["model"][sec]) & set(jsec)
        assert {"variant", "attn_impl", "dtype"} <= common
        assert {k: t["model"][sec][k] for k in common} == {k: jsec[k] for k in common}


def test_fused_self_attention_module_would_need_kernel_7(monkeypatch):
    # fused self-attention with no mask runs fused_qkv_attention (Pallas #7),
    # then the out-projection: the xla module's output on the same weights
    mha = MultiHeadAttention(64, 2, attn_impl="fused")
    ref = MultiHeadAttention(64, 2, attn_impl="xla")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    ref.load_state_dict(mha.state_dict())
    x = torch.randn(1, 5, 64, generator=gen)
    calls = []
    real = attention_module.fused_qkv_attention
    monkeypatch.setattr(attention_module, "fused_qkv_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    torch.testing.assert_close(mha(x), ref(x), atol=1e-5, rtol=1e-5)
    assert len(calls) == 1
    # cross-attention and a masked self-attention fall to xla, as in the JAX module
    assert mha(x, torch.zeros(1, 3, 64)).shape == (1, 5, 64)
    assert mha(x, mask=torch.ones(1, 1, 5, 5, dtype=torch.bool)).shape == (1, 5, 64)
