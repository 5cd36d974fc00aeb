"""The port's row LayerNorm and its backward against the JAX package's,
and the LayerNorm wrappers' width checks.

Same inputs, made with seeded numpy, go through the JAX fused encoder's LN
prologue (``openvision_tpu/ops/fused_encoder.py:_ln_rows``, f32, two-pass
``jnp.var``) and the port's ``layernorm_plain``, which the CUDA kernel
(``csrc/layernorm.cu``) is held against on the card
(tests/test_torch_kernels_gpu.py). The inputs are bf16 values (what the
kernel takes), the arithmetic f32; the bound is 1e-5 of the largest |output|
(f32 sums in another order). The large-offset input (x * 0.05 + 40) is where
a two-pass variance and E[x^2] - mean^2 part; there the two f32 means
differ by up to an ulp of 40 (they agree where d is a power of two, and
differ by an ulp at the other widths: the sum scaled by 1/d rounds
otherwise), and that ulp times rstd * |gamma| adds to the bound: ~1.5e-5
of the largest |output| at these widths.

The backward: ``gk.layernorm_bwd_plain`` (what ``csrc/layernorm.cu``'s
``layernorm_bwd`` is held against on the card) against ``jax.vjp`` of the
same ``_ln_rows``, for dx (with and without the residual's gradient g
added), dgamma and dbeta, on the same bf16-valued inputs: within 1e-6 of
each output's largest |value| (f32 sums in another order). On the offset
rows the two f32 means may differ by an ulp of 40 (delta); that moves every
xhat of a row by eps = delta * rstd, and so, to first order, dgamma by
sum_rows |dy| eps, and dx = rstd (dxhat - s1 - xhat s2) (s1 = mean(dxhat),
s2 = mean(dxhat xhat)) by rstd eps (|s2| + |xhat| |s1|); those terms add to
the bound, element by element, where the largest value may be 0 (one row of
d = 8 whose bf16 values are all 40).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.fused_encoder import _ln_rows
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 514])
@pytest.mark.parametrize("d", [8, 192, 768, 1024, 1152, 1792])
def test_layernorm_plain_matches_jax_ln_rows(d, rows, offset):
    rng = np.random.default_rng(d * 1000 + rows)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x = x * 0.05 + 40 if offset else x * 3 + 1
    x = torch.from_numpy(x).bfloat16().float().numpy()
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    ref = np.asarray(_ln_rows(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6))
    got = fe.layernorm_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    assert got.dtype == torch.float32
    bound = 1e-5 * np.abs(ref).max()
    if offset:  # an ulp of the mean, through rstd and gamma
        rstd = 1 / np.sqrt(x.astype(np.float64).var(-1, keepdims=True) + 1e-6)
        bound = bound + np.spacing(np.float32(40)) * rstd * np.abs(w)
    err = np.abs(got.numpy() - ref)
    assert (err <= bound).all(), (err / bound).max()


@functools.lru_cache(maxsize=None)
def _ln_bwd_inputs(d, rows, offset):
    """Seeded bf16-valued x, gamma, dy and g, and jax.vjp of _ln_rows at dy."""
    rng = np.random.default_rng(d * 1000 + rows + 7)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x = x * 0.05 + 40 if offset else x * 3 + 1
    x = torch.from_numpy(x).bfloat16().float().numpy()
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).bfloat16().float()
    _, vjp = jax.vjp(lambda x_, w_, b_: _ln_rows(x_, w_, b_, 1e-6), jnp.asarray(x),
                     jnp.asarray(w), jnp.zeros(d, jnp.float32))
    ref = tuple(np.asarray(r) for r in vjp(jnp.asarray(dy)))
    return x, w, dy, g.numpy(), ref


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 514])
@pytest.mark.parametrize("d", [8, 192, 768, 1024, 1152, 1792])
def test_layernorm_bwd_plain_matches_jax_vjp(d, rows, offset, residual):
    x, w, dy, g, (ref_dx, ref_dw, ref_db) = _ln_bwd_inputs(d, rows, offset)
    dx, dvec = gk.layernorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(dy),
                                      torch.from_numpy(g) if residual else None, eps=1e-6)
    assert dx.dtype == torch.float32 and dvec.shape == (2, d)
    if residual:
        ref_dx = ref_dx + g
    bound = {name: 1e-6 * np.abs(r).max() for name, r in (("dx", ref_dx), ("dw", ref_dw),
                                                           ("db", ref_db))}
    if offset:  # an ulp of the mean through xhat (see the module's docstring)
        x64, dy64 = x.astype(np.float64), dy.astype(np.float64)
        mean = x64.mean(-1, keepdims=True)
        rstd = 1 / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
        xhat = (x64 - mean) * rstd
        dxhat = dy64 * w
        s1, s2 = dxhat.mean(-1, keepdims=True), (dxhat * xhat).mean(-1, keepdims=True)
        eps = np.spacing(np.float32(40)) * rstd
        bound["dx"] = bound["dx"] + rstd * eps * (np.abs(s2) + np.abs(xhat) * np.abs(s1))
        bound["dw"] = bound["dw"] + (np.abs(dy64) * eps).sum(0)
    for name, got, ref in (("dx", dx.numpy(), ref_dx), ("dw", dvec[0].numpy(), ref_dw),
                           ("db", dvec[1].numpy(), ref_db)):
        err = np.abs(got - ref)
        assert (err <= bound[name]).all(), (name, (err / bound[name]).max())


def _call_wrapper(wrapper, x, w):
    if wrapper is gk.layernorm_bwd:
        return wrapper(x, w, torch.empty(x.shape, device="meta"), eps=1e-6)
    return wrapper(x, w, w, 1e-6)


@pytest.mark.parametrize("d,match", [(12, "divisible by 8"), (2056, "at most 2048")])
@pytest.mark.parametrize("wrapper", [fe.layernorm, fe8.layernorm_quant, gk.layernorm_bwd])
def test_layernorm_wrappers_refuse_widths_before_any_build(monkeypatch, wrapper, d, match):
    # meta tensors stand for CUDA ones: the width check comes before the
    # operand checks, the build and the launch
    monkeypatch.setattr(kernels, "on_cpu", lambda *tensors: False)

    def no_build():
        raise AssertionError("the kernels were built for a width the kernel does not take")

    monkeypatch.setattr(kernels, "lib", no_build)
    monkeypatch.setattr(kernels, "build", no_build)
    x = torch.empty(4, d, dtype=torch.bfloat16, device="meta")
    w = torch.empty(d, device="meta")
    with pytest.raises(ValueError, match=match):
        _call_wrapper(wrapper, x, w)
