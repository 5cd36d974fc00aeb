"""LayerScale / drop-path training and fused_qkv_attention (Pallas #7, #8)
against the JAX package, on the CPU.

- ``fused_qkv_attention``: the port's forward and its autograd Function
  (the plain twins of ``_kernel`` and ``_qkv_bwd_kernel`` for CPU tensors)
  against the JAX package's ``fused_qkv_attention`` and ``jax.grad`` of it,
  its Pallas kernels in interpret mode, unmasked, causal and prefix-LM:
  output within 1e-5 of its largest magnitude, each gradient within 1e-4 of
  its norm;
- a LayerScale ViT (``init_values``, ``attn_impl="fused"``, drop-path 0) in
  training: its blocks take the attention module's fused route, #7 and #8 in
  both packages; loss within 1e-5 relative, every gradient within 1e-4 of
  its norm;
- ``DropPath``'s masks from a fixed generator, the identity when not
  training, the stack's linspace rates and the block routes they pick,
  the same masks under remat and on a resumed step;
- dropout is refused by name and never reaches ``fused_qkv_attention``;
- a LayerScale train state saves and resumes, its names map to the JAX
  ``ls1/ls1`` paths and back, and the optimizer's masks on those paths are
  the JAX package's.
f32 throughout; both sides differ in f32 summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import vit as jvit
from openvision_tpu.ops.fused_attention import fused_qkv_attention as jqkv
from openvision_tpu.parallel import unbox
from openvision_tpu.utils import make_mask_trees
from openvision_tpu_torch import optim
from openvision_tpu_torch.convert.openclip import (
    flax_paths,
    jax_params_to_state_dict,
    jax_to_openclip,
    openclip_to_jax,
    tree_flatten_with_names,
)
from openvision_tpu_torch.models import attention_module
from openvision_tpu_torch.models import clip as tclip
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.models.encoder import Encoder, EncoderBlock
from openvision_tpu_torch.models.layers import DropPath
from openvision_tpu_torch.ops import fused_attention as fa
from openvision_tpu_torch.train import checkpoint as ckpt
from openvision_tpu_torch.train import step as tstep

D, HEADS = 64, 4


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("causal,prefix", [(False, 0), (True, 0), (True, 6)])
def test_fused_qkv_attention_matches_jax(causal, prefix):
    rng = np.random.default_rng(11 + prefix + causal)
    y, g = (rng.standard_normal((2, 19, D)).astype(np.float32) for _ in range(2))
    ws = [(rng.standard_normal((D, D)) * 0.3).astype(np.float32) for _ in range(3)]
    bs = [(rng.standard_normal(D) * 0.1).astype(np.float32) for _ in range(3)]
    kw = dict(num_heads=HEADS, causal=causal, prefix_len=prefix)

    def f(y, wq, wk, wv, bq, bk, bv):
        return jqkv(y, wq, wk, wv, bq, bk, bv, interpret=True, **kw)

    want = np.asarray(jax.jit(f)(y, *ws, *bs))
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * g), argnums=tuple(range(7))))(
        y, *ws, *bs)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (y, *ws, *bs)]
    w_qkv = torch.cat([w.t() for w in leaves[1:4]])
    b_qkv = torch.cat(leaves[4:])
    out = fa.fused_qkv_attention(leaves[0], w_qkv, b_qkv, **kw)
    assert np.abs(out.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    # the key bias's gradient is zero in exact arithmetic (a shift shared by
    # every key of a row): held beside the query bias's norm
    scale = {5: np.linalg.norm(np.asarray(jgrads[4]))}
    for i, (a, w) in enumerate(zip(got, jgrads)):
        err = np.linalg.norm(a.numpy() - np.asarray(w))
        assert err <= 1e-4 * scale.get(i, np.linalg.norm(np.asarray(w))), (i, err)


def _random_params(jmodel, rng):
    """The model's param tree (shapes from ``jax.eval_shape`` of its init,
    which compiles nothing) filled with seeded N(0, 0.1**2) numbers."""
    shapes = jax.eval_shape(lambda: unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


def _vit_cfg(impl, **kw):
    return dict(patch_size=(8, 8), width=D, depth=2, mlp_dim=4 * D, num_heads=HEADS,
                posemb="learn", pool_type="gap", emb_head_bias=False, fast_gelu=True,
                attn_impl=impl, **kw)


def test_layerscale_vit_training_matches_jax(monkeypatch):
    """LayerScale makes both packages' blocks drop whole-sub-block fusion and
    run the attention module's fused route, #7/#8 (interpret-mode Pallas on
    the JAX side, the plain twins here); loss and every gradient, the
    LayerScale gains' included, against the JAX ViT in training."""
    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 16)).astype(np.float32)
    cfg = _vit_cfg("fused", init_values=0.5)
    params = _random_params(jvit.Model(16, **cfg), rng)
    jmodel = jvit.Model(16, **cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum((jmodel.apply({"params": p}, images, train=True) + cot) ** 2)))(params)

    port = tvit.Model(16, image_size=32, **cfg)
    port.load_state_dict({k.removeprefix("visual."): v
                          for k, v in jax_params_to_state_dict({"img": params}).items()})
    calls = []
    real = attention_module.fused_qkv_attention
    monkeypatch.setattr(attention_module, "fused_qkv_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = port(torch.from_numpy(images), train=True, rng=torch.Generator().manual_seed(0))
    tloss = ((out + torch.from_numpy(cot)) ** 2).sum()
    tloss.backward()
    assert len(calls) == 2  # one per block
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {k.removeprefix("visual."): v.numpy()
            for k, v in jax_params_to_state_dict({"img": jax.device_get(jgrads)}).items()}
    assert {n for n, _ in port.named_parameters()} == set(want)
    for name, p in port.named_parameters():
        assert _norm_rel(p.grad.numpy(), want[name]) <= 1e-4, (name, _norm_rel(p.grad, want[name]))


def test_drop_path_masks_from_the_generator():
    x = torch.randn(6, 3, 4, generator=torch.Generator().manual_seed(1))
    dp = DropPath(0.4)
    assert dp(x) is x  # not training: no generator
    assert DropPath(0.0)(x, torch.Generator().manual_seed(0)) is x
    got = dp(x, torch.Generator().manual_seed(7))
    u = torch.rand(6, 1, 1, generator=torch.Generator().manual_seed(7))
    mask = torch.floor(0.6 + u)
    torch.testing.assert_close(got, x / 0.6 * mask)
    assert 0 < int(mask.sum()) < 6  # some samples dropped, some kept at this seed
    # bf16 branches come out f32, as the JAX module's product with its f32 mask
    assert dp(x.bfloat16(), torch.Generator().manual_seed(7)).dtype == torch.float32


def test_drop_path_rates_routes_and_remat():
    """linspace(0, rate, depth) per block: in training block 0 keeps the
    whole-sub-block path and the others take #7/#8; the masks are the same
    under remat=full, whose recompute draws them again."""
    torch.manual_seed(0)
    stacks = {}
    for policy in ("none", "full"):
        enc = Encoder(D, 3, HEADS, 4 * D, attn_impl="fused", fast_gelu=True, drop_path=0.3,
                      remat_policy=policy)
        if stacks:
            enc.load_state_dict(stacks["none"][0].state_dict())
        else:
            with torch.no_grad():
                for p in enc.parameters():
                    p.add_(torch.randn(p.shape) * 0.1)
        stacks[policy] = (enc,)
    assert stacks["none"][0].drop_rates == pytest.approx([0.0, 0.15, 0.3])
    x = torch.randn(4, 9, D)
    grads = {}
    for policy, (enc,) in stacks.items():
        routes = []
        for i, block in enumerate(enc.resblocks):
            block._fused_attn_subblock = (lambda f, i=i: lambda *a: routes.append(i) or f(*a))(
                block._fused_attn_subblock)
        out = enc(x, train=True, rng=torch.Generator().manual_seed(3))
        out.sum().backward()
        grads[policy] = [p.grad.clone() for p in enc.parameters()]
        assert set(routes) == {0}  # only block 0 fuses the whole sub-block
        # not training: no masks, every block fused
        with torch.no_grad():
            routes.clear()
            enc(x)
            assert routes == [0, 1, 2]
    for a, b in zip(grads["none"], grads["full"]):
        torch.testing.assert_close(a, b)


def test_dropout_is_refused_by_name_and_never_reaches_kernel_7(monkeypatch):
    """Active dropout turns off both fused paths in the JAX package
    (openvision_tpu/models/encoder.py:141, models/attention_module.py:103);
    the port refuses it by name before any block runs."""
    monkeypatch.setattr(attention_module, "fused_qkv_attention",
                        lambda *a, **k: pytest.fail("dropout reached fused_qkv_attention"))
    with pytest.raises(NotImplementedError, match="dropout=0.1"):
        Encoder(D, 2, HEADS, attn_impl="fused", dropout=0.1, drop_path=0.1, init_values=1e-5)
    with pytest.raises(NotImplementedError, match="dropout=0.1"):
        EncoderBlock(D, HEADS, attn_impl="fused", dropout=0.1, init_values=1e-5)
    with pytest.raises(NotImplementedError, match="dropout=0.1"):
        tvit.Model(16, image_size=32, **_vit_cfg("fused", dropout=0.1))


def test_step_generator_redraws_the_same_masks_on_resume():
    """The step's generator depends on (seed, step) only: a resumed run's
    step 5 draws an uninterrupted run's step-5 masks."""
    dp = DropPath(0.5)
    x = torch.ones(16, 2)
    a = dp(x, tstep.step_generator(0, 5))
    torch.testing.assert_close(a, dp(x, tstep.step_generator(0, 5)))
    assert not torch.equal(a, dp(x, tstep.step_generator(0, 6)))
    assert not torch.equal(a, dp(x, tstep.step_generator(1, 5)))


def _ls_clip():
    return tclip.CLIPModel(
        out_dim=16, image=dict(_vit_cfg("fused", init_values=1e-5, drop_path=0.1),
                               image_size=32),
        text=dict(width=D, depth=1, mlp_dim=4 * D, num_heads=HEADS, vocab_size=64,
                  context_length=8))


OPT_CONFIG = {"schedule": [(".*", {"decay_type": "cosine", "warmup_steps": 1})], "lr": 1e-2,
              "wd": 0.2, "optax_name": "scale_by_adam", "optax": {"b1": 0.9, "b2": 0.95}}


def test_layerscale_state_saves_resumes_and_maps_to_jax(tmp_path):
    model = _ls_clip()
    tstep.init_params(model, 0)
    sd = model.state_dict()
    ls = [k for k in sd if ".ls_" in k]
    assert len(ls) == 4 and all(torch.equal(sd[k], torch.full((D,), 1e-5)) for k in ls)
    # the flax checkpoint quirk: module ls1 holds the param ls1
    jtree = openclip_to_jax({k.removeprefix("text."): v.numpy() for k, v in sd.items()},
                            num_heads_vision=HEADS, num_heads_text=HEADS)
    flat = tree_flatten_with_names(jtree)
    assert flax_paths("visual.transformer.resblocks.1.ls_2.gamma") == [
        "img/Transformer/encoderblock_1/ls2/ls2"]
    back = jax_to_openclip(jtree)
    for k in ls:
        np.testing.assert_array_equal(flat[flax_paths(k)[0]], sd[k].numpy())
        np.testing.assert_array_equal(back[k], sd[k].numpy())
    # the optimizer's weight-decay and schedule masks on the ls paths are JAX's
    patterns = [".*/kernel$", ".*/ls1/.*", "img/.*", ".*"]
    groups = optim.mask_groups(list(sd), patterns)
    jmasks = [tree_flatten_with_names(jax.device_get(m))
              for m in make_mask_trees(jax.tree.map(jnp.asarray, jtree), patterns)]
    for k in ls:
        assert [k in g for g in groups] == [bool(m[flax_paths(k)[0]]) for m in jmasks], k
    opt = optim.Optimizer(OPT_CONFIG, dict(model.named_parameters()),
                          sched_kw=dict(total_steps=4, batch_size=2))
    assert not any(k in g for k in ls for g, _ in opt.decays)  # no weight decay, as JAX
    # a LayerScale train state saves and resumes
    opt.step({n: torch.ones_like(p) for n, p in model.named_parameters()})
    ckpt.save_train_state(str(tmp_path), 1, model, opt, data_position=3)
    fresh = _ls_clip()
    opt2 = optim.Optimizer(OPT_CONFIG, dict(fresh.named_parameters()),
                           sched_kw=dict(total_steps=4, batch_size=2))
    assert ckpt.restore_train_state(str(tmp_path), 1, fresh, opt2) == 3
    for k in ls:
        torch.testing.assert_close(fresh.state_dict()[k], model.state_dict()[k])
        torch.testing.assert_close(opt2.state["nu"][k], opt.state["nu"][k])
