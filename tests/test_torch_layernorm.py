"""The port's row LayerNorm against the JAX package's, and the LayerNorm
wrappers' width checks.

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.fused_encoder import _ln_rows
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
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


@pytest.mark.parametrize("d,match", [(12, "divisible by 8"), (2056, "at most 2048")])
@pytest.mark.parametrize("wrapper", [fe.layernorm, fe8.layernorm_quant])
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
        wrapper(x, w, w, 1e-6)
