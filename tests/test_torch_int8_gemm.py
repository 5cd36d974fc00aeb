"""The port's int8 product and quantise routes against the JAX package on the CPU.

``gemm_int8`` and ``quant_rows`` take their plain versions on CPU tensors;
these hold them against the JAX package's int8 product
(``openvision_tpu/serving/quant.py:_qdense``) and per-row quantiser
(``_quant_a``) on the same int8 operands, made with numpy from a seed.
Bounds:
- the int32 sums are exact on both sides, and both round them to f32 once
  (round to nearest even): with unit scales and no bias the outputs are
  bit-equal, also where the sums pass 2**24 and the rounding shows;
- with scales, JAX dequantises as acc * a_scale * w_scale and the port as
  acc * w_scale * a_scale (the Pallas kernels' order): two f32 roundings in
  another order, within 2**-21 of |acc * w_scale * a_scale|, plus one f32
  ulp of the sum (each side rounds its bias add);
- the GELU hidden's row max, taken with the product, and the quantise that
  takes it: bit-equal to the quantise that reads the hidden for its max, and
  to JAX's ``_quant_a`` (max is exact in any order);
- the MLP sub-block on that route: bit-equal to the route without it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.serving import quant as jquant
from openvision_tpu_torch.ops import fused_encoder_int8 as tfe8


def _operands(rng, m, n, k, saturated=False):
    """int8 a (m, k), w (n, k), f32 per-row and per-channel scales, f32 bias.
    `saturated`: every value +-127, with some rows of a and of w all +127
    or all -127, so that their sums pass 2**24."""
    if saturated:
        a = rng.choice(np.array([-127, 127], np.int8), (m, k))
        w = rng.choice(np.array([-127, 127], np.int8), (n, k))
        a[: m // 4] = 127
        w[: n // 8] = 127
        w[n // 8: n // 4] = -127
    else:
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    a_s = (rng.random(m, dtype=np.float32) * 0.05 + 1e-3).astype(np.float32)
    w_s = (rng.random(n, dtype=np.float32) * k**-0.5 / 127 + 1e-5).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return a, w, a_s, w_s, bias


def _jax_qdense(a, w, a_s, w_s, bias=None):
    return np.asarray(jquant._qdense(jnp.asarray(a), jnp.asarray(a_s)[:, None],
                                     jnp.asarray(w.T), jnp.asarray(w_s),
                                     None if bias is None else jnp.asarray(bias)))


def _torch_plain(a, w, a_s, w_s, bias=None, **kw):
    t = torch.from_numpy
    return tfe8.gemm_int8(t(a), t(a_s), t(w), t(w_s), None if bias is None else t(bias),
                          out_dtype=torch.float32, **kw)


@pytest.mark.parametrize("m,n,k,saturated", [
    (64, 768, 1024, False),   # the head: M = batch
    (32, 1024, 4096, True),   # fc2's N and K, saturated operands
])
def test_gemm_int8_plain_matches_jax_int8_product(m, n, k, saturated):
    a, w, a_s, w_s, bias = _operands(np.random.default_rng(m + n + k), m, n, k, saturated)
    acc = a.astype(np.int64) @ w.astype(np.int64).T
    if saturated:
        assert np.abs(acc).max() > 2**24  # the int-to-f32 rounding is exercised
    ones_m, ones_n = np.ones(m, np.float32), np.ones(n, np.float32)
    # unit scales: both sides are the f32 rounding of the exact int32 sums
    got = _torch_plain(a, w, ones_m, ones_n).numpy()
    np.testing.assert_array_equal(got, _jax_qdense(a, w, ones_m, ones_n))
    np.testing.assert_array_equal(got, acc.astype(np.float32))
    # scales and bias: the two dequant orders
    got = _torch_plain(a, w, a_s, w_s, bias).numpy()
    want = _jax_qdense(a, w, a_s, w_s, bias)
    scaled = np.abs(acc * w_s.astype(np.float64) * a_s.astype(np.float64)[:, None])
    bound = 2**-21 * scaled + np.spacing(np.abs(want))
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_row_amax_and_quantise_route_are_bit_equal_to_reading_the_hidden():
    m, n, k = 48, 512, 256
    a, w, a_s, w_s, bias = _operands(np.random.default_rng(7), m, n, k)
    h, hmax = _torch_plain(a, w, a_s, w_s, bias, gelu=True, row_amax=True)
    assert hmax.dtype == torch.float32 and hmax.shape == (m,)
    assert torch.equal(hmax, h.abs().amax(-1))
    h[3] = 0  # an all-zero row: amax 0, scale 1
    hmax[3] = 0
    q, scale = tfe8.quant_rows(h, hmax)
    q_ref, scale_ref = tfe8.quant_plain(h)
    assert torch.equal(q, q_ref) and torch.equal(scale, scale_ref)
    assert scale[3].item() == 1.0 and q[3].abs().max().item() == 0
    jq, js = jquant._quant_a(jnp.asarray(h.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js)[:, 0])
    with pytest.raises(ValueError, match="f32 GELU output"):
        tfe8.gemm_int8(torch.from_numpy(a), torch.from_numpy(a_s), torch.from_numpy(w),
                       torch.from_numpy(w_s), row_amax=True)
    with pytest.raises(ValueError, match="tile_n"):
        tfe8._gemm_int8(torch.from_numpy(a), torch.from_numpy(a_s), torch.from_numpy(w),
                        torch.from_numpy(w_s), tile_n=64)


def test_mlp_t_int8_plain_row_max_route_is_bit_equal_to_two_reads():
    rng = np.random.default_rng(11)
    b, l, d, hidden = 2, 17, 64, 256
    x = torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32)).bfloat16()
    ln_w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    ln_b = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))
    from openvision_tpu_torch.serving.quant import quant_w

    w1 = quant_w(torch.from_numpy(rng.standard_normal((hidden, d)).astype(np.float32) * d**-0.5))
    w2 = quant_w(torch.from_numpy(rng.standard_normal((d, hidden)).astype(np.float32)
                                  * hidden**-0.5))
    b1, b2 = (torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
              for n in (hidden, d))
    got = tfe8.mlp_t_int8(x, ln_w, ln_b, *w1, b1, *w2, b2)
    yq, ys = tfe8.layernorm_quant_plain(x, ln_w, ln_b, 1e-6)
    h = tfe8.gemm_int8_plain(yq, ys, *w1, b1, gelu=True, out_dtype=torch.float32)
    hq, hs = tfe8.quant_plain(h)
    want = tfe8.gemm_int8_plain(hq, hs, *w2, b2, residual=x)
    assert torch.equal(got, want)
