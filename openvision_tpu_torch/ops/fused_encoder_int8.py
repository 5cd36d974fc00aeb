"""The int8 (W8A8) encoder sub-blocks on hand-written Hopper kernels.

Counterpart of ``openvision_tpu/ops/fused_encoder_int8.py``, whose two
Pallas kernels compute one pre-LN ViT block of the int8 serving encode:

- ``_mhsa_t_int8_kernel`` (:39, via ``mhsa_t_int8`` :166): LN1 in f32 with
  var = E[x^2] - mean^2 (:58-62) -> per-token int8 quantise (``_quant_cols``
  :31) -> int8 . int8 QKV with int32 sums, dequant ``acc * w_scale * a_scale
  + b`` rounded to bf16 (:65-69) -> attention, ``nomax`` by default, q * scale
  rounded to bf16, an f32 output o / l (:112-118) -> per-token quantise of
  that f32 output (:126) -> int8 out-proj, dequant + bo rounded to bf16, +
  residual (:127-134);
- ``_mlp_t_int8_kernel`` (:138, via ``mlp_t_int8`` :220): LN2 (the same
  form) -> quantise -> int8 fc1, dequant + b1 in f32 -> tanh-GELU in f32 ->
  per-token quantise of the f32 hidden -> int8 fc2, dequant + b2 rounded to
  bf16, + residual (:144-163).

Here they run in the natural ``(B, 1+P, D)`` layout with the cls row first,
as ``ops/fused_encoder.py`` runs the bf16 pair; the transposed stream, the
cls row computed apart in XLA (openvision_tpu/serving/quant.py:386-403) and
the 128-lane padding are TPU layout and are not carried over. The cls row
goes through the same kernels as the patch rows, so it differs from the JAX
package's in rounding order only: there its attention output is rounded to
bf16 before its quantise, b2 is added after the bf16 rounding and its LN is
two-pass. Four CUDA kernels (``csrc/``) do the work:

- :func:`layernorm_quant` (``csrc/layernorm.cu``): LN with E[x^2] - mean^2
  and the per-row quantise of its f32 output, never rounded to bf16;
- :func:`gemm_int8` (``csrc/gemm_int8.cu``, on the Hopper mainloop of
  ``csrc/hopper.cuh`` with s8 wgmma): the four int8 products with the
  dequant epilogue, out in f32 (fc1 + GELU, with each row's max |GELU|),
  bf16 (QKV) or bf16 + residual (out-proj, fc2); it serves the int8 head as
  well;
- :func:`quant_rows` (``csrc/layernorm.cu``): the per-row quantise of the
  f32 attention output and of the GELU hidden (read once, its row max from
  fc1);
- the attention kernel of ``ops/fused_encoder.py`` with its f32 output.

Quantising is ``scale = amax / 127`` (1 where amax is 0) and
``clip(rint(y / scale), -127, 127)``: a division, not a multiply by the
reciprocal, with round-half-to-even. The serving path is always ``nomax``
softmax and tanh-GELU, whatever the model's flags (the JAX package forces
both: :154, quant.py:390), and its weights are quantised from the f32
weights as loaded (``serving/quant.py``), never from bf16 copies.

Bound on the H100 at ViT-L/14, b=64 (M = 16448 rows): the four products
need 2 * 16448 * 12 * 1024**2 int8 ops a block, about 0.21 ms at 1979 TOPS;
QKV and fc2 are bound by the tensor cores, out-proj (its residual read) and
fc1 (its f32 output) by device memory (3.35 TB/s), as are the LN +
quantise and quantise passes. Each kernel has a plain PyTorch version beside it (``*_plain``,
f32 math in the Pallas order, exact int32 sums through f64) and a launch
counter in ``kernels.LAUNCHES``; a wrapper takes the plain version only when
every tensor lies on the CPU, and for CUDA tensors launches its kernel or
raises. The f32 GELU hidden (4D wide) goes through device memory here, where
the Pallas kernel keeps it in VMEM; max is exact in any order, so taking its
row max in fc1's epilogue gives quant_rows the scales of a read of the
hidden, bit for bit. Inference only: no backward.
"""

from __future__ import annotations

import torch

from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import kernels


# ---------------------------------------------------------------------------
# Quantise
# ---------------------------------------------------------------------------


def quant_plain(y: torch.Tensor, amax=None, static_scale=None):
    """Per-row symmetric int8 of an f32 (..., N) tensor: (int8, (...) f32
    scale). `amax`, when given, is each row's max |y| (as the fc1 launch
    gives it), else it is taken from y. With `static_scale` (one f32, the
    calibrated per-tensor scale) every row takes that scale instead."""
    if static_scale is not None:
        scale = static_scale.float().reshape(1).expand(*y.shape[:-1], 1)
    else:
        amax = y.abs().amax(-1, keepdim=True) if amax is None else amax[..., None]
        scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1).contiguous()


def layernorm_quant_plain(x, weight, bias, eps: float, static_scale=None):
    """LN in f32 with var = E[x^2] - mean^2, then :func:`quant_plain`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return quant_plain(y * weight.float() + bias.float(), static_scale=static_scale)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_static(name: str, static_scale) -> None:
    if static_scale is not None:
        kernels.check_operand(f"{name} static_scale", static_scale, torch.float32, (1,))


def _quant_out(x, n: int):
    q = torch.empty(*x.shape[:-1], n, dtype=torch.int8, device=x.device)
    return q, torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)


def layernorm_quant(x, weight, bias, eps: float, static_scale=None):
    """Kernel ``ovt_layernorm_quant``: bf16 x (..., D), f32 weight and bias ->
    (int8 (..., D), f32 per-row scale (...)); with `static_scale` (one f32
    on the device) the f32 LN output is quantised by that scale, which every
    row's scale repeats (``openvision_tpu/serving/quant.py:38-50``).

    Replaces the LN prologue and ``_quant_cols`` of ``_mhsa_t_int8_kernel``
    and ``_mlp_t_int8_kernel`` (openvision_tpu/ops/fused_encoder_int8.py
    :58-64, :144-149). Bound by device memory (x read once, int8 written):
    the bf16 layernorm's row stream (tiles of 16 rows brought into a
    shared-memory ring by bulk copies, one warp a row), the row held in
    registers between its passes, 8-byte int8 stores a lane.
    """
    if kernels.on_cpu(x, weight, bias, static_scale):
        return layernorm_quant_plain(x, weight, bias, eps, static_scale)
    d = x.shape[-1]
    if d % 8 or d > 2048:
        raise ValueError(f"layernorm_quant: the kernel takes a width divisible by 8 and at most "
                         f"2048, got {d}")
    kernels.check_operand("layernorm_quant x", x, torch.bfloat16)
    kernels.check_operand("layernorm_quant weight", weight, torch.float32, (d,))
    kernels.check_operand("layernorm_quant bias", bias, torch.float32, (d,))
    _check_static("layernorm_quant", static_scale)
    q, scale = _quant_out(x, d)
    rc = kernels.lib().ovt_layernorm_quant(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), q.data_ptr(), scale.data_ptr(),
        _ptr(static_scale), x.numel() // d, d, eps, kernels.stream(x))
    kernels.raise_on(rc, "layernorm_quant")
    kernels.count("layernorm_quant")
    return q, scale


def quant_rows(x, amax=None, static_scale=None):
    """Kernel ``ovt_quant_rows``: f32 x (..., N) -> (int8 (..., N), f32
    per-row scale (...)); `amax` (...) f32, when given, is each row's max
    |x| (the fc1 launch's ``row_amax``); with `static_scale` (one f32 on the
    device) every row is quantised by that scale and `amax` is not read.

    Replaces ``_quant_cols`` of the f32 attention output and GELU hidden
    (openvision_tpu/ops/fused_encoder_int8.py:126, :155) and the pooled
    row's ``_quant_a`` before the head (openvision_tpu/serving/quant.py:415).
    Bound by device memory: one warp per row, int8 written once; the row is
    read once with `amax` given, else twice (the second from cache).
    """
    if kernels.on_cpu(x, amax, static_scale):
        return quant_plain(x, amax, static_scale)
    n = x.shape[-1]
    if n % 8:
        raise ValueError(f"quant_rows: the kernel takes a width divisible by 8, got {n}")
    kernels.check_operand("quant_rows x", x, torch.float32)
    if amax is not None:
        kernels.check_operand("quant_rows amax", amax, torch.float32, x.shape[:-1])
    _check_static("quant_rows", static_scale)
    q, scale = _quant_out(x, n)
    rc = kernels.lib().ovt_quant_rows(x.data_ptr(), _ptr(amax), _ptr(static_scale),
                                      q.data_ptr(), scale.data_ptr(), x.numel() // n, n,
                                      kernels.stream(x))
    kernels.raise_on(rc, "quant_rows")
    kernels.count("quant_rows")
    return q, scale


# ---------------------------------------------------------------------------
# gemm_int8
# ---------------------------------------------------------------------------


def gemm_int8_plain(a, a_scale, w, w_scale, bias=None, *, gelu: bool = False,
                    out_dtype=torch.bfloat16, residual=None, row_amax: bool = False):
    """``float(a . w^T) * w_scale * a_scale + bias`` in f32 (the int32 sums
    exact through f64), optional tanh-GELU, in `out_dtype`; with `residual`,
    rounded to bf16 and then ``+ residual`` rounded again. With `row_amax`
    (GELU into f32), ``(out, max |out| of each row)``."""
    acc = (a.double() @ w.double().t()).float()
    y = acc * w_scale.float() * a_scale.float()[..., None]
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = fe._gelu_tanh(y)
    y = y.to(out_dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(out_dtype)
    return (y, y.abs().amax(-1)) if row_amax else y


def gemm_int8(a, a_scale, w, w_scale, bias=None, *, gelu: bool = False,
              out_dtype=torch.bfloat16, residual=None, row_amax: bool = False):
    """Kernel ``csrc/gemm_int8.cu``: the int8 products of both sub-blocks and
    the head.

    a: (..., K) int8 with a_scale (...) f32 per row; w: (N, K) int8 in
    torch's (out, in) layout with w_scale (N,) f32 per output channel;
    bias: (N,) f32 or None; out_dtype f32 or bf16; residual (..., N) bf16
    or None (bf16 out only); row_amax (GELU into f32 only): also return
    each row's max |out| (...) f32, which :func:`quant_rows` takes.
    Replaces the int8 dots and dequant epilogues of
    ``_mhsa_t_int8_kernel`` (QKV :65-69, out-proj :127-134) and
    ``_mlp_t_int8_kernel`` (fc1 + GELU :150-154, fc2 :156-163), and the head
    of ``quantized_encode_fused`` (openvision_tpu/serving/quant.py:415-416,
    dequant order acc * a_scale * w_scale there). Bound by the int8 tensor
    cores at ViT shapes (fc1's f32 hidden and out-proj's residual by device
    memory); the Hopper mainloop of ``csrc/hopper.cuh`` with s8 wgmma into
    s32 accumulators, epilogue fused; the kernel picks the output tile's
    width.
    """
    return _gemm_int8(a, a_scale, w, w_scale, bias, gelu=gelu, out_dtype=out_dtype,
                      residual=residual, row_amax=row_amax, tile_n=0)


def _gemm_int8(a, a_scale, w, w_scale, bias=None, *, gelu: bool = False,
               out_dtype=torch.bfloat16, residual=None, row_amax: bool = False,
               tile_n: int):
    """:func:`gemm_int8` at an output tile width of 128 or 256 (not 256 with
    GELU into bf16), or 0 for the kernel's choice: the tests hold both
    widths, and ``chip_smoke.py --gemm`` times them against that choice."""
    if row_amax and not (gelu and out_dtype == torch.float32):
        raise ValueError("gemm_int8: row_amax takes the f32 GELU output")
    if tile_n not in (0, 128, 256) or (tile_n == 256 and gelu and out_dtype != torch.float32):
        raise ValueError(f"gemm_int8: tile_n must be 0, 128 or 256 (not 256 with GELU into "
                         f"bf16), got {tile_n}")
    if kernels.on_cpu(a, a_scale, w, w_scale, bias, residual):
        return gemm_int8_plain(a, a_scale, w, w_scale, bias, gelu=gelu, out_dtype=out_dtype,
                               residual=residual, row_amax=row_amax)
    n, k = w.shape
    if n % 8 or k % 16:
        raise ValueError(f"gemm_int8: N must be a multiple of 8 and K of 16, got N={n} K={k}")
    if a.shape[-1] != k:
        raise ValueError(f"gemm_int8: a has K={a.shape[-1]}, w has K={k}")
    if out_dtype not in (torch.bfloat16, torch.float32) or (
            residual is not None and out_dtype != torch.bfloat16):
        raise ValueError(f"gemm_int8: out_dtype must be bf16 or f32 (bf16 with a residual), "
                         f"got {out_dtype}")
    m = a.numel() // k
    kernels.check_operand("gemm_int8 a", a, torch.int8)
    kernels.check_operand("gemm_int8 a_scale", a_scale, torch.float32, a.shape[:-1])
    kernels.check_operand("gemm_int8 w", w, torch.int8)
    kernels.check_operand("gemm_int8 w_scale", w_scale, torch.float32, (n,))
    if bias is not None:
        kernels.check_operand("gemm_int8 bias", bias, torch.float32, (n,))
    out = torch.empty(*a.shape[:-1], n, dtype=out_dtype, device=a.device)
    if residual is not None:
        kernels.check_operand("gemm_int8 residual", residual, torch.bfloat16, out.shape)
    amax = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device) if row_amax else None
    rc = kernels.lib().ovt_gemm_int8(
        a.data_ptr(), a_scale.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        None if amax is None else amax.data_ptr(), m, n, k, int(gelu),
        int(out_dtype == torch.float32), tile_n, kernels.stream(a))
    kernels.raise_on(rc, "gemm_int8")
    kernels.count("gemm_int8")
    return (out, amax) if row_amax else out


# ---------------------------------------------------------------------------
# The two sub-blocks
# ---------------------------------------------------------------------------


def mhsa_t_int8_plain(x, ln_w, ln_b, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, *, num_heads: int,
                      eps: float = 1e-6, nomax: bool = True):
    """The ``_mhsa_t_int8_kernel`` sub-block in f32 math, in its order."""
    yq, ys = layernorm_quant_plain(x, ln_w, ln_b, eps)
    qkv = gemm_int8_plain(yq, ys, wqkv_q, wqkv_s, bqkv)
    o = fe.attention_plain(qkv, num_heads, nomax=nomax, out_dtype=torch.float32)
    oq, os_ = quant_plain(o)
    return gemm_int8_plain(oq, os_, wo_q, wo_s, bo, residual=x)


def mlp_t_int8_plain(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, *, eps: float = 1e-6):
    """The ``_mlp_t_int8_kernel`` sub-block in f32 math, in its order."""
    yq, ys = layernorm_quant_plain(x, ln_w, ln_b, eps)
    h, hmax = gemm_int8_plain(yq, ys, w1_q, w1_s, b1, gelu=True, out_dtype=torch.float32,
                              row_amax=True)
    hq, hs = quant_plain(h, hmax)
    return gemm_int8_plain(hq, hs, w2_q, w2_s, b2, residual=x)


def mhsa_t_int8(x, ln_w, ln_b, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo, *, num_heads: int,
                eps: float = 1e-6, nomax: bool = True):
    """x + OutProj_int8(MHA(QKV_int8(LN(x)))) on (B, 1+P, D) bf16 x, weights
    (out, in) int8 with (out,) f32 scales, biases f32: 5 launches
    (layernorm_quant, gemm_int8, attention with f32 out, quant_rows,
    gemm_int8 + residual). On CPU tensors, :func:`mhsa_t_int8_plain`."""
    if kernels.on_cpu(x, wqkv_q, wo_q):
        return mhsa_t_int8_plain(x, ln_w, ln_b, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo,
                                 num_heads=num_heads, eps=eps, nomax=nomax)
    yq, ys = layernorm_quant(x, ln_w, ln_b, eps)
    qkv = gemm_int8(yq, ys, wqkv_q, wqkv_s, bqkv)
    o = fe.attention(qkv, num_heads, nomax=nomax, out_dtype=torch.float32)
    oq, os_ = quant_rows(o)
    return gemm_int8(oq, os_, wo_q, wo_s, bo, residual=x)


def mlp_t_int8(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, *, eps: float = 1e-6):
    """x + fc2_int8(quant(GELU(fc1_int8(LN(x))))): 4 launches
    (layernorm_quant, gemm_int8 + GELU with f32 out and the hidden's row
    max, quant_rows reading the hidden once, gemm_int8 + residual). On CPU
    tensors, :func:`mlp_t_int8_plain`."""
    if kernels.on_cpu(x, w1_q, w2_q):
        return mlp_t_int8_plain(x, ln_w, ln_b, w1_q, w1_s, b1, w2_q, w2_s, b2, eps=eps)
    yq, ys = layernorm_quant(x, ln_w, ln_b, eps)
    h, hmax = gemm_int8(yq, ys, w1_q, w1_s, b1, gelu=True, out_dtype=torch.float32,
                        row_amax=True)
    hq, hs = quant_rows(h, hmax)
    return gemm_int8(hq, hs, w2_q, w2_s, b2, residual=x)
