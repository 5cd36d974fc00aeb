"""The towers' model options against the JAX modules, on the CPU.

Tiny towers (mu/8 at 32 px: width 32, 2 heads, 16 patches; a one-block
text tower of width 32) built
by the JAX package and by the port from the same flax-initialised params
(carried by ``convert/openclip.py``), f32 on the ``xla`` path unless a
test says otherwise, inputs from seeded numpy:

- the ``map`` pool (MAPHead), the ``stem`` and ``linear`` patch embeds and
  ``post_norm``: outputs within 1e-4 (f32 on both sides; flax's LayerNorm
  takes E[x^2] - mean^2, the port two passes);
- ``final_drop``: identity outside training, and in training at rate 1
  the head sees zeros on both sides (flax's Dropout returns zeros at rate
  1, so no draws are compared);
- ``scan_mlp`` with ``chunk``: chunked (16 tokens, chunk 4) and whole (17
  tokens; 16 tokens at chunk 16), the MLP called once a chunk, and on the
  ``fused`` route (``fused_t`` is not eligible under it) the MLP kernels'
  plain twins once a chunk, against JAX's Pallas ``fused`` blocks in
  interpret mode (1e-4);
- the KV-cache decode: each step's output against the JAX module's step
  and against the full causal forward (1e-5);
- the new parameter names both ways, bit-equal, and every port name's flax
  path in the JAX tree;
- the reference's ``mlp_chunck`` / ``patch_embeding`` keys build the same
  towers, and the OpenCLIP export raises on a map, stem or linear tree as
  the JAX export does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.convert import export as jexport
from openvision_tpu.models import clip as jclip
from openvision_tpu.models import encoder as jencoder
from openvision_tpu.models import text as jtext
from openvision_tpu.models import vit as jvit
from openvision_tpu.parallel import unbox
from openvision_tpu.train import checkpoint as jck
from openvision_tpu_torch.convert import export as texport
from openvision_tpu_torch.convert.openclip import (
    flax_paths,
    jax_params_to_state_dict,
    recover_tree,
    state_dict_to_jax_params,
    tree_flatten_with_names,
)
from openvision_tpu_torch.models import clip as tclip
from openvision_tpu_torch.models import encoder as tencoder
from openvision_tpu_torch.models import text as ttext
from openvision_tpu_torch.models import vit as tvit

TOL = dict(atol=1e-4, rtol=1e-4)
RES, D = 32, 32
TXT = dict(width=32, depth=1, mlp_dim=64, num_heads=2)  # the text tower


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, RES, RES, 3)).astype(np.float32)


def _init(module, *example):
    """The module's flax-initialised params (one jitted init: faster on the
    CPU than op-by-op dispatch)."""
    return unbox(jax.jit(module.init)(jax.random.PRNGKey(0), *example)["params"])


def _apply(module, variables, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def _state(params, prefix):
    return {k.removeprefix(prefix): v for k, v in jax_params_to_state_dict(params).items()}


def _vit_pair(**opts):
    cfg = dict(variant="mu/8", posemb="learn", **opts)
    jmodel = jvit.Model(8, **cfg)
    params = _init(jmodel, jnp.zeros((1, RES, RES, 3)))
    port = tvit.Model(8, image_size=RES, **cfg)
    port.load_state_dict(_state({"img": params}, "visual."))
    return jmodel, params, port


@pytest.mark.parametrize("opts", [dict(pool_type="map"), dict(patch_embedding="stem"),
                                  dict(patch_embedding="linear", pool_type="map"),
                                  dict(post_norm=True, pool_type="tok")])
def test_vit_options_match_jax(images, opts):
    jmodel, params, port = _vit_pair(**opts)
    want = np.asarray(_apply(jmodel, {"params": params}, images))
    with torch.inference_mode():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_final_drop_before_the_head(images):
    jmodel, params, port = _vit_pair(final_drop=1.0)
    bias = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    params = {**params, "head": {**params["head"], "bias": jnp.asarray(bias)}}
    port.proj_bias.data = torch.from_numpy(bias)
    want = np.asarray(_apply(jmodel, {"params": params}, images, train=True,
                             rngs={"dropout": jax.random.PRNGKey(1)}))
    np.testing.assert_allclose(want, np.broadcast_to(bias, want.shape))
    with torch.no_grad():
        got = port(torch.from_numpy(images), train=True, rng=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        eval_want = np.asarray(_apply(jmodel, {"params": params}, images))
        np.testing.assert_allclose(port(torch.from_numpy(images)).numpy(), eval_want, **TOL)


def _encoder_pair(l, **opts):
    jmodel = jencoder.Encoder(depth=2, num_heads=2, mlp_dim=64, **opts)
    x = np.random.default_rng(l).standard_normal((2, l, D)).astype(np.float32)
    params = _init(jmodel, jnp.asarray(x))
    port_opts = {k: v for k, v in opts.items() if k != "init_style"}
    port = tencoder.Encoder(D, 2, 2, 64, init_style=opts.get("init_style", "vit"), **port_opts)
    port.load_state_dict(_state({"img": {"Transformer": params}}, "visual.transformer."))
    return jmodel, params, port, x


@pytest.mark.parametrize("l,chunk,calls", [(16, 4, 4), (17, 4, 1), (16, 16, 1)])
def test_scan_mlp_matches_jax_blockwise_mlp(l, chunk, calls):
    jmodel, params, port, x = _encoder_pair(l, scan_mlp=True, chunk=chunk)
    seen = []
    port.resblocks[0].mlp.register_forward_hook(lambda m, i, o: seen.append(i[0].shape[1]))
    want = np.asarray(_apply(jmodel, {"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert len(seen) == calls and sum(seen) == l


def test_scan_mlp_on_the_fused_route(monkeypatch):
    """fused_t is not eligible under scan_mlp (JAX :581): both stacks run
    fused blocks, the port's MLP kernels (plain twins here) a chunk at a time."""
    opts = dict(scan_mlp=True, chunk=4, attn_impl="fused_t", fast_gelu=True)
    jmodel, params, port, x = _encoder_pair(16, **opts)
    assert not port._fused_t_eligible(torch.from_numpy(x), 0)
    calls = []
    mlp_block = tencoder.mlp_block
    monkeypatch.setattr(tencoder, "mlp_block",
                        lambda y, *a, **k: calls.append(y.shape[1]) or mlp_block(y, *a, **k))
    want = np.asarray(_apply(jmodel, {"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert calls == [4] * 8  # 2 blocks, 4 chunks each


def test_kv_cache_steps_match_jax_and_the_causal_forward():
    l = 6
    jmodel, params, port, x = _encoder_pair(l, causal=True, decode=True,
                                            init_style="scaled")
    cache = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["cache"]
    step = jax.jit(lambda v, xt: jmodel.apply(v, xt, mutable=["cache"]))
    full = tencoder.Encoder(D, 2, 2, 64, init_style="scaled", causal=True)
    full.load_state_dict(port.state_dict())
    port.init_cache(2, l)
    with torch.inference_mode():
        causal = full(torch.from_numpy(x)).numpy()
        for t in range(l):
            want, mut = step({"params": params, "cache": cache}, jnp.asarray(x[:, t:t + 1]))
            cache = mut["cache"]
            got = port(torch.from_numpy(x[:, t:t + 1])).numpy()
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got[:, 0], causal[:, t], atol=1e-5, rtol=1e-5)
    assert port.resblocks[0].attn.cache["index"] == l


def _clip_params(image_opts):
    model = jclip.Model(out_dim=(32, 32),
                        image=dict(variant="mu/8", posemb="learn", **image_opts),
                        text=dict(TXT, pool_type="last", vocab_size=64),
                        text_decoder="none")
    return _init(model, jnp.zeros((1, RES, RES, 3)), jnp.zeros((1, 8), jnp.int32))


@pytest.mark.parametrize("image_opts", [dict(pool_type="map", patch_embedding="stem"),
                                        dict(patch_embedding="linear")])
def test_new_param_names_cross_both_ways_bit_equal(image_opts):
    params = _clip_params(image_opts)
    sd = jax_params_to_state_dict(params)
    port = tclip.CLIPModel(out_dim=(32, 32),
                           image=dict(variant="mu/8", posemb="learn", image_size=RES,
                                      **image_opts),
                           text=dict(TXT, pool_type="last", vocab_size=64, context_length=8))
    port.load_state_dict(sd)  # strict: every port name, no other
    back = tree_flatten_with_names(state_dict_to_jax_params(sd, num_heads_vision=2,
                                                            num_heads_text=2))
    want = tree_flatten_with_names(params)
    assert back.keys() == want.keys()
    for name, leaf in want.items():
        assert back[name].shape == leaf.shape and np.array_equal(back[name], leaf), name
    again = jax_params_to_state_dict(recover_tree(back))
    for name, t in sd.items():
        assert torch.equal(again[name], t), name
        assert all(p in want for p in flax_paths(name)), name


def test_reference_keys_build_the_towers(images):
    keys = dict(mlp_chunck=4, scan_mlp=True)
    jmodel, params, port = _vit_pair(patch_embeding="linear", **keys)
    assert port.patch_embedding == "linear" and port.transformer.resblocks[0].chunk == 4
    with torch.inference_mode():
        np.testing.assert_allclose(port(torch.from_numpy(images)).numpy(),
                                   np.asarray(_apply(jmodel, {"params": params}, images)), **TOL)
    cfg = dict(TXT, vocab_size=64, embed_cls=True, use_dense_general=True, **keys)
    jtxt = jtext.Model(8, **cfg)
    ids = np.random.default_rng(2).integers(1, 64, (2, 8)).astype(np.int32)
    tparams = _init(jtxt, jnp.asarray(ids))
    assert tparams["Transformer"]["encoderblock_0"]["MultiHeadDotProductAttention_0"][
        "query"]["kernel"].ndim == 3
    txt = ttext.Model(8, context_length=8, **cfg)
    txt.load_state_dict(_state({"txt": tparams}, "text."))
    with torch.inference_mode():
        np.testing.assert_allclose(txt(torch.from_numpy(ids)).numpy(),
                                   np.asarray(_apply(jtxt, {"params": tparams}, ids)), **TOL)
    with pytest.raises(NotImplementedError, match="param_dtype"):
        tvit.Model(8, variant="mu/8", param_dtype="float16")
    bf16 = tvit.Model(8, variant="mu/8", param_dtype="bfloat16")  # tests/test_torch_param_dtype.py
    assert bf16.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.bfloat16


@pytest.mark.parametrize("image_opts", [dict(pool_type="map"), dict(patch_embedding="stem"),
                                        dict(patch_embedding="linear")])
def test_export_raises_on_trees_openclip_cannot_hold(tmp_path, image_opts):
    npz = str(tmp_path / "params.npz")
    jck.save_npz(npz, {"params": _clip_params(image_opts)})
    kw = dict(img="mu/8", txt="Ti", res=RES, out_dim=32, context_length=8, vocab_size=64)
    with pytest.raises(Exception):
        jexport.export(npz, str(tmp_path / "jax"), **kw)
    with pytest.raises(ValueError, match="OpenCLIP export takes"):
        texport.export(npz, str(tmp_path / "port"), device="cpu", **kw)
    assert not (tmp_path / "port").exists()
