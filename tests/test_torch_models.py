"""The port's layers, towers and CLIP model against the JAX package in f32.

Weights cross over through ``convert/openclip.py`` (the JAX param tree ->
the port's state dict) and inputs are made with seeded numpy, so both
frameworks see the same numbers. Tolerance: atol = rtol = 1e-4 on raw
outputs (the JAX fused-encoder tests' bound) and cosine >= 1 - 1e-6 on the
normalized CLIP embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import clip as jclip
from openvision_tpu.models import layers as jlayers
from openvision_tpu.models import text as jtext
from openvision_tpu.models import vit as jvit
from openvision_tpu.ops.attention import xla_attention as jxla_attention
from openvision_tpu.parallel import unbox
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict,
    jax_to_openclip,
    openclip_to_jax,
)
from openvision_tpu_torch.models import clip as tclip
from openvision_tpu_torch.models import layers as tlayers
from openvision_tpu_torch.models import text as ttext
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.ops.attention import xla_attention

TOL = dict(atol=1e-4, rtol=1e-4)
RES, CTX, VOCAB = 48, 16, 1000


def _np(rng, *shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _init(module, *example):
    return unbox(module.init(jax.random.PRNGKey(0), *example)["params"])


def _apply(module, params, *args):
    return module.apply({"params": params}, *args)


def tower_state_dict(params, tower):
    """One tower's JAX params ("img" or "txt") -> that port module's state dict."""
    prefix = {"img": "visual.", "txt": "text."}[tower]
    return {k.removeprefix(prefix): v
            for k, v in jax_params_to_state_dict({tower: params}).items()}


def test_layer_norm_eps_matches_flax():
    # rows with tiny variance make eps 1e-6 and torch's 1e-5 disagree
    rng = np.random.default_rng(0)
    x = _np(rng, 4, 32, s=1e-3)
    ln = jlayers.layer_norm(jnp.float32, jnp.float32)
    params = {"scale": 1 + _np(rng, 32, s=0.1), "bias": _np(rng, 32, s=0.1)}
    want = np.asarray(ln.apply({"params": params}, x))
    port = tlayers.LayerNorm(32)
    port.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"])})
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    eps5 = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (32,), port.weight, port.bias, eps=1e-5).detach().numpy()
    assert np.abs(eps5 - want).max() > 1e-2


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_mlp_block_gelu_matches_flax(gelu_approx):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 5, 16, s=2.0)
    mlp = jlayers.MlpBlock(mlp_dim=64, gelu_approx=gelu_approx)
    p = _init(mlp, jnp.zeros((1, 5, 16)))
    want = np.asarray(_apply(mlp, p, x))
    port = tlayers.MlpBlock(16, 64, gelu_approx=gelu_approx)
    port.load_state_dict({
        "c_fc.weight": torch.tensor(np.asarray(p["Dense_0"]["kernel"]).T),
        "c_fc.bias": torch.tensor(np.asarray(p["Dense_0"]["bias"])),
        "c_proj.weight": torch.tensor(np.asarray(p["Dense_1"]["kernel"]).T),
        "c_proj.bias": torch.tensor(np.asarray(p["Dense_1"]["bias"])),
    })
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_posembs_match_jax():
    np.testing.assert_allclose(
        tlayers.posemb_sincos_2d(3, 4, 32, cls_token=True).numpy(),
        np.asarray(jlayers.posemb_sincos_2d(3, 4, 32, cls_token=True)), atol=1e-6)
    np.testing.assert_allclose(
        tlayers.posemb_sincos_1d(7, 32).numpy(),
        np.asarray(jlayers.posemb_sincos_1d(7, 32)), atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_attention_matches_jax(causal):
    rng = np.random.default_rng(2)
    q, k, v = (_np(rng, 2, 7, 3, 8) for _ in range(3))
    want = np.asarray(jxla_attention(q, k, v, causal=causal))
    got = xla_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _vit_cfg(**kw):
    cfg = dict(variant="mu/16", posemb="learn", pool_type="gap", emb_head_bias=False,
               fast_gelu=True)
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def images():
    return _np(np.random.default_rng(3), 3, RES, RES, 3)


@pytest.mark.parametrize("impl,posemb,pool", [
    ("xla", "learn", "gap"),
    ("fused_t", "learn", "gap"),
    ("fused_t", "sincos2d", "gap"),
    ("xla", "sincos2d", "tok"),
    ("xla", "learn", "0"),
    ("xla", "learn", "avg"),
])
def test_vit_matches_jax(images, impl, posemb, pool):
    cfg = _vit_cfg(posemb=posemb, pool_type=pool, attn_impl=impl)
    jmodel = jvit.Model(32, **cfg)
    params = _init(jmodel, jnp.zeros((1, RES, RES, 3)))
    want = np.asarray(_apply(jmodel, params, images))
    port = tvit.Model(32, image_size=RES, **cfg)
    port.load_state_dict(tower_state_dict(params, "img"))
    with torch.inference_mode():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_vit_fused_t_needs_tanh_gelu(images):
    # exact GELU makes fused_t ineligible: the stack falls back to the
    # natural-layout fused blocks, as the JAX Encoder does
    cfg = _vit_cfg(fast_gelu=False, attn_impl="fused_t")
    jmodel = jvit.Model(32, **cfg)
    params = _init(jmodel, jnp.zeros((1, RES, RES, 3)))
    want = np.asarray(_apply(jmodel, params, images))
    port = tvit.Model(32, image_size=RES, **cfg)
    port.load_state_dict(tower_state_dict(params, "img"))
    assert not port.transformer._fused_t_eligible(torch.zeros(1, 10, 32), 0)
    with torch.inference_mode():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_causal_text_tower_under_fused_t_falls_back_to_fused():
    tokens = np.random.default_rng(6).integers(0, VOCAB, (2, CTX)).astype(np.int32)
    cfg = _text_cfg(causal=True, attn_impl="fused_t")
    jmodel = jtext.TextTransformer(32, **cfg)
    params = _init(jmodel, jnp.zeros((1, CTX), jnp.int32))
    want = np.asarray(_apply(jmodel, params, tokens))
    port = ttext.TextTransformer(32, context_length=CTX, **cfg)
    port.load_state_dict(tower_state_dict(params, "txt"))
    assert all(b.attn_impl == "fused" for b in port.transformer.resblocks)
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _text_cfg(**kw):
    cfg = dict(width=64, depth=2, mlp_dim=256, num_heads=2, vocab_size=VOCAB,
               posemb="learn", pool_type="last")
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("causal,pool,posemb", [
    (False, "last", "learn"), (True, "last", "learn"), (False, "argmax", "learn"),
    (False, "first", "sincos1d"),
])
def test_text_tower_matches_jax(causal, pool, posemb):
    tokens = np.random.default_rng(4).integers(0, VOCAB, (3, CTX)).astype(np.int32)
    cfg = _text_cfg(causal=causal, pool_type=pool, posemb=posemb)
    jmodel = jtext.TextTransformer(32, **cfg)
    params = _init(jmodel, jnp.zeros((1, CTX), jnp.int32))
    want = np.asarray(_apply(jmodel, params, tokens))
    port = ttext.TextTransformer(32, context_length=CTX, **cfg)
    port.load_state_dict(tower_state_dict(params, "txt"))
    with torch.inference_mode():
        got = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def clip_params():
    jmodel = jclip.Model(out_dim=32, image=_vit_cfg(), text=_text_cfg(), text_decoder="none")
    params = _init(jmodel, jnp.zeros((1, RES, RES, 3)), jnp.zeros((1, CTX), jnp.int32))
    return jmodel, params


@pytest.mark.parametrize("impl", ["xla", "fused_t"])
def test_clip_matches_jax(clip_params, images, impl):
    jmodel, params = clip_params
    tokens = np.random.default_rng(5).integers(0, VOCAB, (3, CTX)).astype(np.int32)
    zimg_j, ztxt_j, out_j = _apply(jmodel, params, images, tokens)
    port = tclip.CLIPModel(out_dim=32, image=dict(_vit_cfg(attn_impl=impl), image_size=RES),
                           text=dict(_text_cfg(), context_length=CTX))
    port.load_state_dict(jax_params_to_state_dict(params))
    with torch.inference_mode():
        zimg, ztxt, out = port(torch.from_numpy(images), torch.from_numpy(tokens))
    for got, want in ((zimg, zimg_j), (ztxt, ztxt_j)):
        cos = (got.numpy() * np.asarray(want)).sum(-1)
        assert cos.min() >= 1 - 1e-6, cos
    np.testing.assert_allclose(out["t"].numpy(), np.asarray(out_j["t"]), rtol=1e-6)
    np.testing.assert_allclose(out["img/norm"].numpy(), np.asarray(out_j["img/norm"]), **TOL)


def test_openclip_name_map_round_trips(clip_params):
    _, params = clip_params
    back = openclip_to_jax(jax_to_openclip(params), num_heads_vision=2, num_heads_text=2)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf))
