"""The port's int8 (W8A8) serving encode against the JAX package on the CPU.

A tiny ViT (Ti/16 widths, depth 2, 64 px: 1 + 16 tokens) is initialised in
JAX, its biases and LayerNorm parameters are moved off their init values with
seeded numpy noise, and the same f32 weights cross to the port through
``convert/openclip.py``. The JAX side runs its Pallas kernels in interpret
mode, as its own tests run them on the CPU. Bounds:
- quantised weights: int8 matrices equal to the transposed JAX ones, scales
  within 1 f32 ulp;
- the sub-blocks, on the patch rows' out - x (what a block adds to its
  input): 2**-6 of max|out - x|, plus per element the bf16 rounding of the
  residual add (2**-8 of |out|). The two may differ in summation order, in
  int8 values that flip by 1 where an f32 value lies on a rounding boundary,
  and in the cls row's q/k/v, which the JAX package computes in XLA with a
  two-pass LayerNorm (on this input the patch rows came out bit-equal);
- the whole encode: min cosine >= 0.9999 against JAX's
  ``quantized_encode_fused`` (0.999975 measured: the cls row's rounding
  order differs), >= 0.995 against the f32 float tower (the JAX package's
  own serving bound, tests/test_quant.py);
- uint8 input against float input: 1e-4 (tests/test_quant.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import vit as jvit
from openvision_tpu.ops import fused_encoder as jfe
from openvision_tpu.ops import fused_encoder_int8 as jfe8
from openvision_tpu.parallel import unbox
from openvision_tpu.serving import quant as jquant
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.ops import fused_encoder_int8 as tfe8
from openvision_tpu_torch.serving import quant as tquant

RES, P, W, DEPTH, HEADS, MLP, E = 64, 16, 192, 2, 3, 768, 64
MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)


def _perturb(params, rng):
    """Biases and LayerNorm parameters moved off their init values."""
    def f(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'bias'" in name or "'scale'" in name or "cls" in name:
            return np.asarray(leaf) + rng.standard_normal(leaf.shape).astype(np.float32) * 0.05
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def towers():
    jmodel = jvit.Model(num_classes=E, variant="Ti/16", depth=DEPTH, posemb="learn",
                        pool_type="gap", emb_head_bias=False, fast_gelu=True)
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))["params"])
    params = _perturb(params, np.random.default_rng(0))
    tmodel = tvit.ViT(num_classes=E, patch_size=(P, P), width=W, depth=DEPTH, mlp_dim=MLP,
                      num_heads=HEADS, posemb="learn", pool_type="gap", emb_head_bias=False,
                      fast_gelu=True, image_size=RES)
    sd = {k.removeprefix("visual."): v for k, v in jax_params_to_state_dict({"img": params}).items()}
    tmodel.load_state_dict(sd)
    tmodel.eval().requires_grad_(False)
    jq = jax.jit(jquant.quantize_vit_params)(params)
    return jmodel, params, jq, tmodel, tquant.quantize_vit_params(tmodel)


def test_quantized_weights_match_jax(towers):
    _, _, jq, _, tq = towers
    for i, blk in enumerate(tq["blocks"]):
        jb = jq["Transformer"][f"encoderblock_{i}"]
        pairs = {
            "wqkv": ([jb[p]["q"] for p in ("query", "key", "value")],
                     [jb[p]["s"] for p in ("query", "key", "value")]),
            "wo": ([jb["out"]["q"]], [jb["out"]["s"]]),
            "w1": ([jb["mlp0"]["q"]], [jb["mlp0"]["s"]]),
            "w2": ([jb["mlp1"]["q"]], [jb["mlp1"]["s"]]),
        }
        for name, (qs, ss) in pairs.items():
            want_q = np.concatenate([np.asarray(q) for q in qs], axis=1).T
            assert blk[f"{name}_q"].dtype == torch.int8
            np.testing.assert_array_equal(blk[f"{name}_q"].numpy(), want_q, err_msg=name)
            np.testing.assert_array_max_ulp(
                blk[f"{name}_s"].numpy(), np.concatenate([np.asarray(s) for s in ss]), maxulp=1)
    np.testing.assert_array_equal(tq["head"]["q"].numpy(), np.asarray(jq["head"]["q"]).T)
    np.testing.assert_array_max_ulp(tq["head"]["s"].numpy(), np.asarray(jq["head"]["s"]), maxulp=1)


def test_quantize_refuses_bf16_weights(towers):
    with pytest.raises(TypeError, match="f32 weights as loaded"):
        tquant.quant_w(towers[3].transformer.resblocks[0].attn.in_proj_weight.bfloat16())


def _jax_block_tensors(jb, d):
    """The per-block tensors quantized_encode_fused feeds its kernels (quant.py:348-378)."""
    wqkv_q = jnp.concatenate([jb[p]["q"] for p in ("query", "key", "value")], axis=1)
    wqkv_s = jnp.concatenate([jb[p]["s"] for p in ("query", "key", "value")], axis=0)
    bqkv = jnp.concatenate([jnp.asarray(jb[p]["b"], jnp.float32)
                            for p in ("query", "key", "value")], axis=0)
    z = jnp.zeros((d,), jnp.float32)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    vec_a = jnp.stack([f32(jb["ln0"]["scale"]), f32(jb["ln0"]["bias"]), z, z, z,
                       f32(jb["out"]["b"]), z, z], axis=1)
    vec_m = jnp.stack([f32(jb["ln1"]["scale"]), f32(jb["ln1"]["bias"]), f32(jb["mlp1"]["b"]),
                       z, z, z, z, z], axis=1)
    return wqkv_q, wqkv_s, bqkv, vec_a, vec_m


def _check_residual_block(got, want, x, tol=2**-6):
    """got/want/x: (B, P, D) f32 patch rows; held on out - x."""
    add = want - x
    bound = tol * np.abs(add).max() + 2**-8 * np.abs(want)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"max err/bound {(err / bound).max()}"


def test_int8_subblocks_match_pallas_interpret(towers):
    _, _, jq, _, tq = towers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1 + (RES // P) ** 2, W)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jb, tb = jq["Transformer"]["encoderblock_0"], tq["blocks"][0]
    wqkv_q, wqkv_s, bqkv, vec_a, vec_m = _jax_block_tensors(jb, W)

    # JAX: patches through the Pallas kernel, cls q/k/v in XLA (quant.py:386-389)
    xT, cls, valid = jfe.to_transposed_stream(xb)
    ycls = jquant._ln_raw(cls, vec_a[:, 0], vec_a[:, 1])
    cq, cs = jquant._quant_a(ycls)
    clsqkv = jquant._qdense(cq, cs, wqkv_q, wqkv_s, bqkv).astype(jnp.bfloat16)
    outT, _ = jfe8.mhsa_t_int8(xT, clsqkv, wqkv_q, wqkv_s, jb["out"]["q"], jb["out"]["s"],
                               vec_a, bqkv[:, None], num_heads=HEADS, valid=valid,
                               interpret=True)
    want = np.asarray(jfe.from_transposed_stream(outT, cls, valid)[:, 1:], np.float32)

    xt = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16()
    got = tfe8.mhsa_t_int8(xt, tb["ln1_w"], tb["ln1_b"], tb["wqkv_q"], tb["wqkv_s"], tb["bqkv"],
                           tb["wo_q"], tb["wo_s"], tb["bo"], num_heads=HEADS)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    _check_residual_block(got[:, 1:].float().numpy(), want, np.asarray(xb[:, 1:], np.float32))

    outT = jfe8.mlp_t_int8(xT, jb["mlp0"]["q"], jb["mlp0"]["s"], jb["mlp1"]["q"],
                           jb["mlp1"]["s"], vec_m, jnp.asarray(jb["mlp0"]["b"])[:, None],
                           interpret=True)
    want = np.asarray(jfe.from_transposed_stream(outT, cls, valid)[:, 1:], np.float32)
    got = tfe8.mlp_t_int8(xt, tb["ln2_w"], tb["ln2_b"], tb["w1_q"], tb["w1_s"], tb["b1"],
                          tb["w2_q"], tb["w2_s"], tb["b2"])
    _check_residual_block(got[:, 1:].float().numpy(), want, np.asarray(xb[:, 1:], np.float32))


def test_int8_encode_matches_pallas_interpret(towers):
    jmodel, params, jq, tmodel, tq = towers
    image = np.random.default_rng(2).standard_normal((4, RES, RES, 3)).astype(np.float32)
    want = np.asarray(jquant.quantized_encode_fused(
        jq, jnp.asarray(image), patch_size=P, num_heads=HEADS, depth=DEPTH, posemb="learn",
        interpret=True))
    got = tquant.quantized_encode_fused(tq, torch.from_numpy(image), patch_size=P).numpy()
    assert got.shape == (4, E) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert (got * want).sum(-1).min() >= 0.9999

    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(image)))
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    assert (got * ref).sum(-1).min() >= 0.995


def test_int8_uint8_input_matches_float_input(towers):
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools.model_io import LoadedModel

    _, _, _, tmodel, tq = towers
    model = LoadedModel(vision=tmodel, text=None, logit_scale=1.0, image_size=RES,
                        context_length=0, vocab_size=0, mean=MEAN, std=STD, vocab_path="",
                        device=torch.device("cpu"), int8=tq)
    raw = np.random.default_rng(3).integers(0, 256, (3, RES, RES, 3), dtype=np.uint8)
    pre = ((raw.astype(np.float32) / 255.0 - np.asarray(MEAN)) / np.asarray(STD)).astype(np.float32)
    z_u8 = build_encode_fn(model, int8=True, uint8_input=True)(torch.from_numpy(raw))
    z_f = build_encode_fn(model, int8=True)(torch.from_numpy(pre))
    np.testing.assert_allclose(z_u8.numpy(), z_f.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="int8=True"):
        build_encode_fn(LoadedModel(**{**model.__dict__, "int8": None}), int8=True)
