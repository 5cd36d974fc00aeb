"""Training on the fused_t sub-blocks: the port against jax.grad through the
JAX package's Pallas backwards ``_mhsa_t_bwd_kernel`` and ``_mlp_t_bwd_kernel``.

Same inputs, made with seeded numpy, go through ``jax.grad`` of the JAX
package's ``fused_encoder_tblock`` (its custom VJPs ``_mhsa_t`` / ``_mlp_t``
run the Pallas backward kernels in interpret mode, as the JAX package's own
tests run them) and through the port's autograd Functions around
``mhsa_block`` / ``mlp_block``, which on the CPU run the plain twins
``mhsa_block_bwd_plain`` / ``mlp_block_bwd_plain``; then a whole ``fused_t``
ViT's training loss and gradients against the JAX ``fused_t`` ViT. f32
throughout, widths D=64 over 4 heads.

Tolerances: the loss within 1e-5 relative; each gradient within 1e-4 of its
norm (||port - jax|| <= 1e-4 ||jax||). Both sides compute in f32 and differ
in summation order, in the LayerNorm variance (the Pallas kernels take
E[x^2] - mean^2) and, in the JAX ViT, in the cls row's XLA side path. The
CUDA kernels are held against the plain twins on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.models import vit as jvit
from openvision_tpu.ops.fused_encoder import (
    from_transposed_stream,
    fused_encoder_tblock,
    to_transposed_stream,
)
from openvision_tpu.parallel import unbox
from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.ops import fused_encoder as fe

D, HEADS, P = 64, 4, 16
NAMES = ("x", "wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "w1", "b1", "w2", "b2", "ln2s", "ln2b")


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(x=n(2, 1 + P, D), wqkv=n(D, 3 * D, s=0.2), bqkv=n(3 * D, s=0.05),
                wo=n(D, D, s=0.2), bo=n(D, s=0.05), ln1s=1 + n(D, s=0.1), ln1b=n(D, s=0.05),
                w1=n(D, 4 * D, s=0.2), b1=n(4 * D, s=0.05), w2=n(4 * D, D, s=0.2),
                b2=n(D, s=0.05), ln2s=1 + n(D, s=0.1), ln2b=n(D, s=0.05),
                g=n(2, 1 + P, D))


def _jax_grads(a, nomax):
    """jax.grad of sum(block(x) * g) through the transposed stream."""
    def f(x, *params):
        xT, cls, valid = to_transposed_stream(x)
        oT, ocls = fused_encoder_tblock(xT, cls, *params, num_heads=HEADS, valid=valid,
                                        nomax=nomax, interpret=True)
        return jnp.sum(from_transposed_stream(oT, ocls, valid) * a["g"])

    return jax.jit(jax.grad(f, argnums=tuple(range(13))))(*(jnp.asarray(a[k]) for k in NAMES))


def _port_grads(a, nomax):
    """The same gradients through the port's two autograd Functions, weights
    in torch's (out, in) layout (transposed back for the comparison)."""
    t = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in NAMES}
    x = fe.mhsa_block(t["x"], t["ln1s"], t["ln1b"], t["wqkv"].t(), t["bqkv"], t["wo"].t(),
                      t["bo"], num_heads=HEADS, nomax=nomax)
    out = fe.mlp_block(x, t["ln2s"], t["ln2b"], t["w1"].t(), t["b1"], t["w2"].t(), t["b2"])
    (out * torch.from_numpy(a["g"])).sum().backward()
    return [t[k].grad.numpy() for k in NAMES]


@pytest.mark.parametrize("nomax", [False, True])
def test_fused_t_subblock_grads_match_jax_tblock(nomax):
    a = _inputs(seed=1 + nomax)
    want = _jax_grads(a, nomax)
    got = _port_grads(a, nomax)
    for name, g, w in zip(NAMES, got, want):
        assert _norm_rel(g, w) <= 1e-4, (name, _norm_rel(g, w))


def test_mlp_block_bwd_plain_returns_pallas_dtypes():
    """dx in x's dtype, the weight grads in their weights' dtype, the
    LayerNorm and bias grads f32 (``_mlp_t_vjp``'s casts, :710-716)."""
    a = _inputs(seed=3)
    bf = torch.bfloat16
    t = lambda k, dt=torch.float32: torch.from_numpy(a[k]).to(dt)
    grads = fe.mlp_block_bwd_plain(t("x", bf), t("ln2s"), t("ln2b"), t("w1", bf).T,
                                   t("b1"), t("w2", bf).T, t("b2"), t("g", bf))
    assert [g.dtype for g in grads] == [bf, torch.float32, torch.float32, bf, torch.float32, bf,
                                        torch.float32]


def _random_params(jmodel, rng):
    """The model's param tree (shapes from ``jax.eval_shape`` of its init,
    which compiles nothing) filled with seeded N(0, 0.1**2) numbers."""
    shapes = jax.eval_shape(lambda: unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


def _vit_cfg(impl):
    return dict(patch_size=(8, 8), width=D, depth=2, mlp_dim=4 * D, num_heads=HEADS,
                posemb="learn", pool_type="gap", emb_head_bias=False, fast_gelu=True,
                attn_impl=impl)


def test_fused_t_vit_training_grads_match_jax():
    """A fused_t ViT (both towers' eligible path: tanh GELU, no LayerScale, no
    drop-path) in training: the port's loss and every parameter gradient
    against the JAX fused_t ViT's (the Pallas _mhsa_t / _mlp_t VJPs)."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 16)).astype(np.float32)
    jmodel = jvit.Model(16, **_vit_cfg("fused_t"))
    params = _random_params(jvit.Model(16, **_vit_cfg("fused_t")), rng)

    def loss(p):
        return jnp.sum((jmodel.apply({"params": p}, images, train=True) + cot) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    port = tvit.Model(16, image_size=32, **_vit_cfg("fused_t"))
    port.load_state_dict({k.removeprefix("visual."): v
                          for k, v in jax_params_to_state_dict({"img": params}).items()})
    assert port.transformer._fused_t_eligible(torch.zeros(2, 17, D), 0, train=True)
    tloss = ((port(torch.from_numpy(images), train=True) + torch.from_numpy(cot)) ** 2).sum()
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = {k.removeprefix("visual."): v.numpy()
            for k, v in jax_params_to_state_dict({"img": jax.device_get(jgrads)}).items()}
    for name, p in port.named_parameters():
        assert _norm_rel(p.grad.numpy(), want[name]) <= 1e-4, (name, _norm_rel(p.grad, want[name]))
