"""The port's backward passes against jax.grad through the JAX Pallas kernels.

Same inputs, made with seeded numpy, go through ``jax.grad`` of the JAX
package's ``fused_mhsa_block`` (its ``jax.custom_vjp`` runs the Pallas
backward ``_block_bwd_kernel``) and ``flash_attention`` (``_dq_kernel`` and
``_dkv_kernel``), both in interpret mode as the JAX package's own tests run
them, and through the port's backward: its plain versions
(``fused_mhsa_block_bwd_plain``, ``attention_bwd_plain``) and the autograd
Functions that call them for CPU tensors.

Tolerances, relative to the largest magnitude of each JAX gradient:
- f32: 1e-4. Both sides compute in f32 and differ in summation order and in
  where the softmax scale is applied.
- bf16 (the fused block): 2**-5. Both sides round q, k, v, do, the
  probabilities, ds and dq/dk/dv to bf16 at the same places, so the
  difference is f32 summation order flipping bf16 roundings, compounded
  through the products that follow; the weight gradients come back rounded
  to bf16 once.
The key bias's gradient is zero in exact arithmetic (the softmax ignores
a shift shared by every key of a row), so both sides hold rounding noise:
it is held to the same tolerance relative to the largest query-bias
gradient instead. The CUDA kernels are held against these plain versions
on the card by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.flash_attention import flash_attention as jflash
from openvision_tpu.ops.fused_attention import fused_mhsa_block as jblock
from openvision_tpu_torch.ops import fused_attention as tfa
from openvision_tpu_torch.ops.flash_attention import flash_attention

D, HEADS = 32, 2
MODES = [(False, 0), (True, 0), (True, 7)]  # unmasked, causal, prefix-LM


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() if scale is None else scale))


def _check_block(got, want, tol):
    scale = {"dbk": float(np.abs(np.asarray(want[NAMES.index("dbq")])).max())}
    for name, a, b in zip(NAMES, got, want):
        assert _rel(a, b, scale.get(name)) <= tol, name


def _block_inputs(l, seed, b=2):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(x=n(b, l, D), w={k: n(D, D, s=0.3) for k in "qkvo"},
                bias={k: n(D, s=0.1) for k in "qkvo"}, ln=(1 + n(D, s=0.1), n(D, s=0.1)),
                g=n(b, l, D))


def _jax_block_grads(inp, causal, prefix, dtype):
    """jax.grad of sum(out * g) w.r.t. x, wq, wk, wv, wo, ln scale/bias and
    the four biases, with the weights cast to the compute dtype as the
    encoder casts them (openvision_tpu/models/encoder.py:217-223)."""
    w, b = inp["w"], inp["bias"]

    def f(x, wq, wk, wv, wo, ln_s, ln_b, bq, bk, bv, bo):
        out = jblock(x.astype(dtype), ln_s, ln_b, wq.astype(dtype), bq, wk.astype(dtype), bk,
                     wv.astype(dtype), bv, wo.astype(dtype), bo, num_heads=HEADS,
                     causal=causal, prefix_len=prefix, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * inp["g"])

    args = (inp["x"], w["q"], w["k"], w["v"], w["o"], *inp["ln"], b["q"], b["k"], b["v"], b["o"])
    return jax.grad(f, argnums=tuple(range(11)))(*args)


def _port_block_grads(inp, causal, prefix, dtype):
    """The same gradients through the port's autograd Function (f32 master
    weights, cast to `dtype` as the port's encoder casts them)."""
    t = lambda a: torch.from_numpy(a).requires_grad_(True)
    x = t(inp["x"])
    ws = {k: t(v) for k, v in inp["w"].items()}
    bs = {k: t(v) for k, v in inp["bias"].items()}
    ln_s, ln_b = t(inp["ln"][0]), t(inp["ln"][1])
    w_qkv = torch.cat([ws[k].t() for k in "qkv"]).to(dtype)
    b_qkv = torch.cat([bs[k] for k in "qkv"])
    out = tfa.fused_mhsa_block(x.to(dtype), ln_s, ln_b, w_qkv, b_qkv, ws["o"].t().to(dtype),
                               bs["o"], num_heads=HEADS, causal=causal, prefix_len=prefix)
    (out.float() * torch.from_numpy(inp["g"])).sum().backward()
    leaves = (x, ws["q"], ws["k"], ws["v"], ws["o"], ln_s, ln_b, bs["q"], bs["k"], bs["v"],
              bs["o"])
    return [p.grad.numpy() for p in leaves]


NAMES = ("dx", "dwq", "dwk", "dwv", "dwo", "dln_scale", "dln_bias", "dbq", "dbk", "dbv", "dbo")


@pytest.mark.parametrize("causal,prefix", MODES)
def test_fused_block_backward_matches_jax_block_bwd_kernel(causal, prefix):
    inp = _block_inputs(19, seed=1)
    want = _jax_block_grads(inp, causal, prefix, jnp.float32)
    got = _port_block_grads(inp, causal, prefix, torch.float32)
    _check_block(got, want, 1e-4)


@pytest.mark.parametrize("causal,prefix", [(True, 7)])
def test_fused_block_backward_bf16_matches_jax_block_bwd_kernel(causal, prefix):
    inp = _block_inputs(19, seed=2)
    want = _jax_block_grads(inp, causal, prefix, jnp.bfloat16)
    got = _port_block_grads(inp, causal, prefix, torch.bfloat16)
    _check_block(got, want, 2**-5)


def test_fused_block_plain_backward_returns_pallas_dtypes():
    """dx in x's dtype, dW in the weights' dtype, the vector grads f32 (the
    Pallas wrapper's casts, openvision_tpu/ops/fused_attention.py:905-907)."""
    inp = _block_inputs(9, seed=3, b=1)
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)
    bf = torch.bfloat16
    w_qkv = torch.cat([t(inp["w"][k]).T for k in "qkv"]).to(bf)
    grads = tfa.fused_mhsa_block_bwd_plain(
        t(inp["x"], bf), t(inp["ln"][0]), t(inp["ln"][1]), w_qkv,
        torch.cat([t(inp["bias"][k]) for k in "qkv"]), t(inp["w"]["o"]).T.to(bf),
        t(inp["bias"]["o"]), t(inp["g"], bf), num_heads=HEADS)
    assert [g.dtype for g in grads] == [bf, torch.float32, torch.float32, bf, torch.float32, bf,
                                        torch.float32]


FLASH_CASES = [
    (2, 20, 20, False, 0),
    (2, 24, 24, True, 0),
    (2, 24, 24, True, 9),   # prefix-LM
    (2, 12, 37, False, 0),  # cross-attention, Lq != Lk
    (1, 40, 17, True, 0),   # causal with Lq > Lk
]


@pytest.mark.parametrize("b,lq,lk,causal,prefix", FLASH_CASES)
def test_flash_backward_matches_jax_dq_dkv_kernels(b, lq, lk, causal, prefix):
    rng = np.random.default_rng(lq * lk + prefix)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((b, lq, HEADS, 16), (b, lk, HEADS, 16), (b, lk, HEADS, 16),
                            (b, lq, HEADS, 16)))

    def f(q, k, v):
        o = jflash(q, k, v, causal=causal, prefix_len=prefix, interpret=True)
        return jnp.sum(o * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, prefix_len=prefix)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a.numpy(), w) <= 1e-4, name
