"""The port's XLA-composed int8 encode, its static scales and disclf's int8
modes against the JAX package, on the CPU.

A tiny ViT (Ti/16 widths, depth 2, 64 px: 1 + 16 tokens), with exact and
with tanh GELU, is initialised in JAX, its biases and LayerNorm parameters
moved off their init values with seeded numpy noise, and the same f32
weights cross to the port. The port's ``quantized_encode`` runs the int8
kernels' plain versions here (the LN as E[x^2] - mean^2, the dequant as
``acc * w_scale * a_scale``, the attention's scores in f32: last-bit
differences from JAX's two-pass LN, ``acc * x_scale * w_scale`` and bf16
scores). Bounds:
- zimg, dynamic and static: min cosine >= 0.999 against JAX's
  ``quantized_encode`` (each with the scales its own ``calibrate_vit``
  gave);
- ``calibrate_vit``'s scales, site by site: within a relative 1e-3 of JAX's
  at block 0's ``attn_in`` and ``attn_out`` (read before any residual add)
  and the head; within 2**-7 at the sites after a residual add, one bf16
  ulp of the residual stream they read (measured up to 4.6e-3 here): JAX's
  composed path keeps QKV in f32 and dequantises as acc * x_scale *
  w_scale, so a stream element can round to its neighbouring bf16 value
  and move that site's abs-max by up to one ulp;
- a static quantise is JAX's ``_quant_a(y, s)`` bit for bit on the same f32
  y, in ``quant_rows`` and (with the LN output kept f32) in
  ``layernorm_quant``;
- disclf ``int8`` with ``int8_calibration`` 64 and 0 on a tiny CLIP: its
  scales are ``calibrate_vit`` of the first 64 images of the first batch,
  its predictions are those of ``quantized_encode`` and agree with JAX's
  int8 disclf wherever JAX's top-2 margin exceeds 1e-2 (int8 noise is
  ~1e-3 of a logit here); a tower whose block matrices are bf16 is
  refused by name.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.configs import openvision as jcfg
from openvision_tpu.data import pipeline as jpipe
from openvision_tpu.evaluators import disclf as jdisclf
from openvision_tpu.models import vit as jvit
from openvision_tpu.parallel import create_mesh, unbox
from openvision_tpu.serving import quant as jquant
from openvision_tpu.train import step as jstep
from openvision_tpu_torch.configs import openvision as tcfg
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict, state_dict_to_jax_params
from openvision_tpu_torch.data import pipeline as tpipe
from openvision_tpu_torch.evaluators import disclf as tdisclf
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.models.encoder import cast_block_matrices
from openvision_tpu_torch.models.init import init_params
from openvision_tpu_torch.ops import fused_encoder_int8 as tfe8
from openvision_tpu_torch.serving import quant as tquant
from openvision_tpu_torch.train import step as tstep
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

RES, P, W, DEPTH, HEADS, MLP, E = 64, 16, 192, 2, 3, 768, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "assets", "bert_base_vocab_bos_eos.txt")


def _perturb(params, rng):
    def f(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'bias'" in name or "'scale'" in name or "cls" in name:
            return np.asarray(leaf) + rng.standard_normal(leaf.shape).astype(np.float32) * 0.05
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module", params=[False, True], ids=["exact GELU", "tanh GELU"])
def towers(request):
    fast = request.param
    jmodel = jvit.Model(num_classes=E, variant="Ti/16", depth=DEPTH, posemb="learn",
                        pool_type="gap", emb_head_bias=False, fast_gelu=fast)
    params = unbox(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)))["params"])
    params = _perturb(params, np.random.default_rng(0))
    tmodel = tvit.ViT(num_classes=E, patch_size=(P, P), width=W, depth=DEPTH, mlp_dim=MLP,
                      num_heads=HEADS, posemb="learn", pool_type="gap", emb_head_bias=False,
                      fast_gelu=fast, image_size=RES)
    sd = {k.removeprefix("visual."): v for k, v in jax_params_to_state_dict({"img": params}).items()}
    tmodel.load_state_dict(sd)
    tmodel.eval().requires_grad_(False)
    jq = jax.jit(jquant.quantize_vit_params)(params)
    geom = dict(patch_size=P, num_heads=HEADS, depth=DEPTH, posemb="learn", fast_gelu=fast)
    return jq, geom, tquant.quantize_vit_params(tmodel)


def _images(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, RES, RES, 3)).astype(np.float32)
    return x * np.float32(0.5)


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)).min())


def test_quantized_encode_dynamic_matches_jax(towers):
    jq, geom, tq = towers
    x = _images(5, 1)
    want = jquant.quantized_encode(jq, jnp.asarray(x), **geom)
    got = tquant.quantized_encode(tq, torch.from_numpy(x), patch_size=P, posemb="learn")
    assert got.shape == (5, E)
    assert _min_cos(got, want) >= 0.999


def test_calibrate_vit_and_static_encode_match_jax(towers):
    jq, geom, tq = towers
    calib, x = _images(40, 2), _images(5, 3)  # two 32-image chunks
    jscales = jquant.calibrate_vit(jq, jnp.asarray(calib), **geom)
    tscales = tquant.calibrate_vit(tq, torch.from_numpy(calib), patch_size=P, posemb="learn")
    assert len(tscales["blocks"]) == DEPTH
    for i, blk in enumerate(tscales["blocks"]):
        want = jscales["Transformer"][f"encoderblock_{i}"]
        assert sorted(blk) == sorted(want) == sorted(tquant.SITES)
        for site, s in blk.items():
            assert s.shape == (1,) and s.dtype == torch.float32
            bound = 1e-3 if i == 0 and site in ("attn_in", "attn_out") else 2**-7
            assert abs(s.item() / float(want[site]) - 1) <= bound, (i, site)
    assert abs(tscales["head_in"].item() / float(jscales["head_in"]) - 1) <= 1e-3

    want = jquant.quantized_encode(jq, jnp.asarray(x), **geom, act_scales=jscales)
    got = tquant.quantized_encode(tq, torch.from_numpy(x), patch_size=P, posemb="learn",
                                  act_scales=tscales)
    assert _min_cos(got, want) >= 0.999
    dynamic = tquant.quantized_encode(tq, torch.from_numpy(x), patch_size=P, posemb="learn")
    assert not torch.equal(got, dynamic)  # the static scales were used


def test_calibration_is_the_running_max_over_chunks(towers):
    _, _, tq = towers
    calib = torch.from_numpy(_images(40, 4))
    whole = tquant.calibrate_vit(tq, calib, patch_size=P, posemb="learn", batch=40)
    chunked = tquant.calibrate_vit(tq, calib, patch_size=P, posemb="learn", batch=8)
    for a, b in zip(whole["blocks"], chunked["blocks"]):
        for site in tquant.SITES:
            assert abs(a[site].item() / b[site].item() - 1) <= 1e-6


@pytest.mark.parametrize("shape", [(3, 7, 24), (5, 40)])
def test_static_quantise_is_jax_quant_a(shape):
    y = np.random.default_rng(6).standard_normal(shape).astype(np.float32) * 3
    s = np.float32(np.abs(y).max() / 127.0 * 0.6)  # saturates the largest values
    wq, ws = jquant._quant_a(jnp.asarray(y), jnp.float32(s))
    q, scale = tfe8.quant_rows(torch.from_numpy(y), static_scale=torch.tensor([s]))
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert q.abs().max().item() == 127
    assert scale.shape == shape[:-1] and bool((scale == float(ws)).all())
    # the LN + quantise: the f32 LN output, quantised by the same scale
    x = torch.from_numpy(y).bfloat16()
    w, b = torch.linspace(0.5, 1.5, shape[-1]), torch.linspace(-0.2, 0.2, shape[-1])
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    ln = ((xf - mean) * torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + 1e-6) * w
          + b)
    q2, _ = tfe8.layernorm_quant(x, w, b, 1e-6, static_scale=torch.tensor([s]))
    wq2, _ = jquant._quant_a(jnp.asarray(ln.numpy()), jnp.float32(s))
    assert np.array_equal(q2.numpy(), np.asarray(wq2))


# ---------------------------------------------------------------------------
# disclf int8
# ---------------------------------------------------------------------------

ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
       f"vocab_size=30522,runlocal=True,remat=none,attn_impl=xla,dec_attn_impl=xla,"
       f"vocab_path={VOCAB}")
TOK = (f'my_eval_bert_tokenize(inkey="texts", max_len=16, vocab_path="{VOCAB}", '
       'add_bos=True, add_eos=True)')
NAMES = ["tench", "goldfish", "a red car", "two dogs", "snowy mountain", "city at night"]


@pytest.fixture(scope="module")
def clip_pair():
    tc = tcfg.get_config(ARG)
    tc["model"]["text"]["depth"] = 2
    tc["model"]["text_decoder_config"]["depth"] = 1
    tc["model"]["out_dim"] = (32, 32)
    model = init_params(tstep.build_model(tc), 0).eval().requires_grad_(False)
    with torch.no_grad():  # biases off zero, so the int8 sites see offsets
        gen = torch.Generator().manual_seed(0)
        for name, p in model.visual.named_parameters():
            if name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    heads = dict(num_heads_vision=model.visual.transformer.resblocks[0].num_heads,
                 num_heads_text=model.text.transformer.resblocks[0].num_heads,
                 num_heads_decoder=model.txt_decoder.transformer.resblocks[0].num_heads)
    params = jax.tree.map(jnp.asarray, state_dict_to_jax_params(
        {k: v.numpy() for k, v in model.state_dict().items()}, **heads))
    jc = jcfg.get_config(ARG)
    jc.model.text.depth = 2
    jc.model.text_decoder_config.depth = 1
    jc.model.out_dim = (32, 32)
    mesh = create_mesh(data=1, fsdp=1, tensor=1, devices=jax.devices()[:1])
    return model, jstep.build_model(jc), params, mesh


@pytest.mark.parametrize("calibration", [64, 0])
def test_disclf_int8_modes(clip_pair, calibration):
    model, jmodel, params, mesh = clip_pair
    rng = np.random.default_rng(8)
    data = {"image": rng.integers(0, 256, (70, 32, 32, 3), np.uint8),
            "label": rng.integers(0, len(NAMES), (70,))}
    kw = dict(pp_img="", pp_txt=TOK, device_norm="vgg", class_names=NAMES,
              prompt_templates="simple", batch_size=67, int8=True,
              int8_calibration=calibration)
    tev = tdisclf.Evaluator(model, source=tpipe.DictSource(data), **kw)
    (_, acc), preds, mask = (lambda r: (r[0][0], r[1], r[2]))(tev.run(return_preds=True))
    assert mask.tolist() == [1.0] * 70 + [0.0] * 64

    from openvision_tpu_torch.train.step import normalize_uint8

    images = normalize_uint8(torch.from_numpy(data["image"]))
    qp = tquant.quantize_vit_params(model.visual)
    scales = None
    if calibration:
        scales = tquant.calibrate_vit(qp, images[:calibration], patch_size=16, posemb="sincos2d")
        for a, b in zip(tev.int8_scales["blocks"], scales["blocks"]):
            assert all(torch.equal(a[k], b[k]) for k in tquant.SITES)
    else:
        assert tev.int8_scales is None
    embs = tev.class_embeddings(tev.prompt_tokens())
    z = tquant.quantized_encode(qp, images, patch_size=16, posemb="sincos2d", act_scales=scales)
    direct = torch.argmax(z @ embs.T, -1).numpy()
    assert np.array_equal(preds[:70], direct)
    assert acc == float((direct == data["label"]).mean())

    jev = jdisclf.Evaluator(jmodel, mesh, source=jpipe.DictSource(data), **kw)
    _, jpreds, _ = jev.run({"params": params}, return_preds=True)
    jembs = jev._build_class_embeddings(params)
    jscales = None
    if calibration:
        jq = jquant.quantize_vit_params(params["img"])
        geom = jev._vit_geometry()
        jscales = jquant.calibrate_vit(jq, jnp.asarray(images[:calibration].numpy()), **geom)
    jz = jquant.quantized_encode(jquant.quantize_vit_params(params["img"]),
                                 jnp.asarray(images.numpy()), **jev._vit_geometry(),
                                 act_scales=jscales)
    top2 = np.sort(np.asarray(jz @ jembs.T), -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-2
    assert sure.sum() >= 40
    assert np.array_equal(preds[:70][sure], jpreds[:70][sure])
    assert _min_cos(z, jz) >= 0.999


def test_disclf_int8_refuses_bf16_block_matrices(clip_pair):
    import copy

    model = copy.deepcopy(clip_pair[0])
    cast_block_matrices(model, torch.bfloat16)
    tev = tdisclf.Evaluator(model, data_dir="synthetic", pp_img="", pp_txt=TOK,
                            device_norm="vgg", class_names=NAMES, prompt_templates="simple",
                            int8=True)
    with pytest.raises(ValueError, match="int8=True"):
        tev.run()
