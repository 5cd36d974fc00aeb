"""The backward passes' hand-written Hopper kernels and their plain versions.

The Pallas backward kernels this serves compute their products and sums in
their own bodies:

- ``_dq_kernel`` and ``_dkv_kernel`` (openvision_tpu/ops/flash_attention.py
  :207, :245): :func:`attention_bwd`, two CUDA kernels
  (``csrc/attention_bwd.cu``) that also serve the attention part of
- ``_block_bwd_kernel`` (openvision_tpu/ops/fused_attention.py:698), whose
  weight and input products are :func:`gemm_nn` (dA = dC . W) and
  :func:`gemm_tn` (dW = dC^T . X, ``csrc/gemm_grad.cu``), whose LayerNorm
  backward is :func:`layernorm_bwd` and whose bias gradients are
  :func:`colsum` (``csrc/layernorm.cu``); the same kernels carry
  ``_mhsa_t_bwd_kernel`` (fused_encoder.py:215, with the ``nomax`` recompute
  of P) and ``_qkv_bwd_kernel`` (fused_attention.py:215);
- ``_mlp_t_bwd_kernel`` (fused_encoder.py:593), which adds
  :func:`mlp_bwd_dual` (the fc1 recompute and dh = (g . W2) * gelu'(h) in
  one kernel with two accumulators, gact and dh in bf16 and column
  partials for db1) to them.

Each wrapper runs its plain PyTorch version (``*_plain``, f32 math with the
kernel's roundings) when every tensor lies on the CPU; for CUDA tensors it
launches its kernel or raises, and counts the launch in
``kernels.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openvision_tpu_torch.ops import kernels

SMS = 132  # H100 SXM streaming multiprocessors: the split-K target
LOG2E = 1.4426950408889634  # the attention backward's exponent base change: exp(x) = exp2(x log2 e)


# ---------------------------------------------------------------------------
# attention backward
# ---------------------------------------------------------------------------


def visible_mask(lq: int, lk: int, causal: bool, prefix_len: int, device) -> torch.Tensor:
    """(Lq, Lk) bool: key j visible to query i (j <= max(i, prefix - 1) when causal)."""
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    if not causal:
        return torch.ones(lq, lk, dtype=torch.bool, device=device)
    return cols <= torch.clamp(rows, min=prefix_len - 1)


def attention_bwd_plain(q, k, v, o, lse, do, *, scale: float, causal: bool = False,
                        prefix_len: int = 0, nomax: bool = False):
    """(dq, dk, dv) of softmax(q k^T * scale) v over (B, L, H, hd) tensors,
    the arithmetic of ``csrc/attention_bwd.cu`` in f32: P = exp(s - lse)
    from the forward's logsumexp lse (B, H, Lq), taken as the kernels take
    it, exp2(q.k * (scale log2 e) - lse log2 e); delta = rowsum(do * o),
    dS = P (dP - delta) scale; dS is rounded to the input dtype for dq = dS k
    and dk = dS^T q, P for dv = P^T do; the outputs are in the input dtype.
    ``nomax`` takes P = exp(min(s, 80) - lse), lse = log(l) of the nomax
    forward (the scaled score clamped at 80 log2 e), with the plain softmax
    backward (no derivative of the clamp), as ``_mhsa_t_bwd_kernel``
    (openvision_tpu/ops/fused_encoder.py:337-338)."""
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s2 = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    if nomax:
        s2 = torch.clamp(s2, max=80.0 * LOG2E)
    keep = visible_mask(q.shape[1], k.shape[1], causal, prefix_len if causal else 0, q.device)
    p = torch.where(keep, torch.exp2(s2 - lse.float()[..., None] * LOG2E), torch.zeros_like(s2))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, Lq)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _attention_bwd_args(q, k, v, lse, tensors):
    """Checks the operands of the two attention backward kernels; returns
    the (batch, row, head) strides of `tensors` (name, tensor, length)."""
    b, lq, h, hd = q.shape
    if hd != 64:
        raise ValueError(f"attention_bwd: the kernels take head_dim 64, got {hd}")
    for name, t, length in tensors:
        kernels.check_operand(f"attention_bwd {name}", t, torch.bfloat16,
                              (b, length, h, hd), contiguous=False)
        if t.shape[1] * t.stride(1) + t.shape[2] * t.stride(2) >= 2**31:
            raise ValueError(f"attention_bwd {name}: offsets inside one batch item must stay "
                             "below 2**31 elements")
    kernels.check_operand("attention_bwd lse", lse, torch.float32, (b, h, lq))


def _strides(q, k, v, o, do, dq, dk, dv):
    return (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))


def attention_bwd_dq(q, k, v, o, lse, do, *, scale: float, causal: bool = False,
                     prefix_len: int = 0, nomax: bool = False, dq=None):
    """Kernel ``attention_bwd_dq``: (dq, delta), delta = rowsum(do * o)
    (B, H, Lq) f32 for :func:`attention_bwd_dkv`. CUDA tensors only."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if dq is None:
        dq = torch.empty(b, lq, h, hd, dtype=torch.bfloat16, device=q.device)
    _attention_bwd_args(q, k, v, lse, (("q", q, lq), ("k", k, lk), ("v", v, lk), ("o", o, lq),
                                       ("do", do, lq), ("dq", dq, lq)))
    delta = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    rc = kernels.lib().ovt_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, o, do, dq, k, v), b, lq, lk, h, hd,
        scale, int(causal), int(prefix_len) if causal else 0, int(nomax), kernels.stream(q))
    kernels.raise_on(rc, "attention_bwd_dq")
    kernels.count("attention_bwd_dq")
    return dq, delta


def attention_bwd_dkv(q, k, v, lse, delta, do, *, scale: float, causal: bool = False,
                      prefix_len: int = 0, nomax: bool = False, dk=None, dv=None):
    """Kernel ``attention_bwd_dkv``: (dk, dv) from the delta of
    :func:`attention_bwd_dq`. CUDA tensors only."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if dk is None:
        dk = torch.empty(b, lk, h, hd, dtype=torch.bfloat16, device=q.device)
    if dv is None:
        dv = torch.empty(b, lk, h, hd, dtype=torch.bfloat16, device=q.device)
    _attention_bwd_args(q, k, v, lse, (("q", q, lq), ("k", k, lk), ("v", v, lk),
                                       ("do", do, lq), ("dk", dk, lk), ("dv", dv, lk)))
    kernels.check_operand("attention_bwd delta", delta, torch.float32, (b, h, lq))
    rc = kernels.lib().ovt_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, q, do, q, dk, dv), b,
        lq, lk, h, hd, scale, int(causal), int(prefix_len) if causal else 0, int(nomax),
        kernels.stream(q))
    kernels.raise_on(rc, "attention_bwd_dkv")
    kernels.count("attention_bwd_dkv")
    return dk, dv


def attention_bwd(q, k, v, o, lse, do, *, scale: float, causal: bool = False,
                  prefix_len: int = 0, nomax: bool = False, dq=None, dk=None, dv=None):
    """Kernels ``attention_bwd_dq`` then ``attention_bwd_dkv``.

    q, o, do: (B, Lq, H, 64); k, v: (B, Lk, H, 64); bf16 with unit stride in
    head_dim and other strides multiples of 8 (views of a QKV buffer work);
    lse: (B, H, Lq) f32 from the forward. dq, dk and dv may be given as such
    views (the fused block writes them into one dqkv buffer); else they are
    allocated. ``nomax`` recomputes P as the nomax forward's (lse = log(l)).
    Returns (dq, dk, dv). On the CPU the plain version runs.
    """
    if kernels.on_cpu(q, k, v, o, lse, do):
        grads = attention_bwd_plain(q, k, v, o, lse, do, scale=scale, causal=causal,
                                    prefix_len=prefix_len, nomax=nomax)
        outs = (dq, dk, dv)
        for out, grad in zip(outs, grads):
            if out is not None:
                out.copy_(grad)
        return tuple(grad if out is None else out for out, grad in zip(outs, grads))
    kw = dict(scale=scale, causal=causal, prefix_len=prefix_len, nomax=nomax)
    dq, delta = attention_bwd_dq(q, k, v, o, lse, do, dq=dq, **kw)
    dk, dv = attention_bwd_dkv(q, k, v, lse, delta, do, dk=dk, dv=dv, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# GEMM layouts of the gradients
# ---------------------------------------------------------------------------


def gemm_nn_plain(a, w, out_dtype=torch.bfloat16):
    """a (..., N) . w (N, K) -> (..., K) in f32, cast to `out_dtype`."""
    return (a.float() @ w.float()).to(out_dtype)


def gemm_tn_plain(dc, x, out_dtype=torch.bfloat16):
    """dc^T . x over every leading row: dc (..., N), x (..., K) -> (N, K)."""
    n, k = dc.shape[-1], x.shape[-1]
    return (dc.reshape(-1, n).float().t() @ x.reshape(-1, k).float()).to(out_dtype)


def _gemm(name: str, a, b, out, m: int, n: int, k: int, a_t: int, b_t: int, splits: int = 1,
          k_split: int = 0):
    work = (torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    rc = kernels.lib().ovt_gemm_grad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
        m, n, k, a_t, b_t, int(out.dtype == torch.float32), splits, k_split, kernels.stream(a))
    kernels.raise_on(rc, name)
    kernels.count(name)
    return out


def gemm_nn(a, w, out_dtype=torch.bfloat16):
    """Kernel ``gemm_nn`` (``csrc/gemm_grad.cu``): a (..., N) . w (N, K),
    the input gradient dA = dC . W of a linear layer whose weight w is in
    torch's (out, in) layout. bf16 operands, f32 sums, bf16 or f32 out."""
    if kernels.on_cpu(a, w):
        return gemm_nn_plain(a, w, out_dtype)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gemm_nn: the kernel writes bf16 or f32, got {out_dtype}")
    n, k = w.shape
    if a.shape[-1] != n or n % 8 or k % 8:
        raise ValueError(f"gemm_nn: a (..., {a.shape[-1]}) . w {tuple(w.shape)}; N and K must "
                         "match and be multiples of 8")
    kernels.check_operand("gemm_nn a", a, torch.bfloat16)
    kernels.check_operand("gemm_nn w", w, torch.bfloat16)
    out = torch.empty(*a.shape[:-1], k, dtype=out_dtype, device=a.device)
    return _gemm("gemm_nn", a, w, out, a.numel() // n, k, n, 0, 1)


GELU_C, GELU_A = 0.7978845608028654, 0.044715  # sqrt(2 / pi), the tanh-GELU cubic


def gelu_tanh_grad(h):
    """d/dh of 0.5 h (1 + tanh(C (h + A h^3))) in f32, in the order of
    ``_mlp_t_bwd_kernel`` (openvision_tpu/ops/fused_encoder.py:628-633)."""
    t = torch.tanh(GELU_C * (h + GELU_A * h * h * h))
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * GELU_C * (1.0 + 3.0 * GELU_A * h * h)


def mlp_bwd_dual_plain(y, w1, b1, g, w2):
    """(gact, dh, col) of :func:`mlp_bwd_dual` in f32 math, in the order of
    ``_mlp_t_bwd_kernel`` (openvision_tpu/ops/fused_encoder.py:612-635):
    h = y . W1^T + b1 and t = tanh(C (h + A h^3)); gact = 0.5 h (1 + t) and
    dh = (g . W2) gelu'(h), both rounded to y's dtype; col (2 ceil(M / 128),
    hidden) f32 the column sums of the unrounded dh over each 64-row slab
    (the kernel's per-warpgroup partials), whose sum over rows is db1."""
    h = y.float() @ w1.float().t() + b1.float()
    gact = 0.5 * h * (1.0 + torch.tanh(GELU_C * (h + GELU_A * h * h * h)))
    dh = (g.float() @ w2.float()) * gelu_tanh_grad(h)
    rows = dh.reshape(-1, dh.shape[-1])
    tiles = 2 * -(-rows.shape[0] // 128)
    padded = torch.nn.functional.pad(rows, (0, 0, 0, 64 * tiles - rows.shape[0]))
    return gact.to(y.dtype), dh.to(y.dtype), padded.reshape(tiles, 64, -1).sum(1)


def mlp_bwd_dual(y, w1, b1, g, w2):
    """Kernel ``mlp_bwd_dual`` (``csrc/gemm_grad.cu``): the hidden of
    ``_mlp_t_bwd_kernel`` (openvision_tpu/ops/fused_encoder.py:593,
    :612-635) kept on chip. y (..., D) bf16 is the LayerNorm output, g
    (..., D) bf16 the output gradient, w1 (hidden, D) and w2 (D, hidden)
    bf16 the fc1 and fc2 weights in torch's (out, in) layout, b1 (hidden,)
    f32. Two products per tile into two f32 accumulators, h = y . W1^T and
    g . W2; the f32 pre-activation never leaves the registers. Returns
    (gact bf16 (..., hidden), dh bf16 (..., hidden), col f32 (P, hidden)):
    col's rows are per-64-row column sums of the unrounded dh, whose sum
    over P (one :func:`colsum` launch) is db1."""
    if kernels.on_cpu(y, w1, b1, g, w2):
        return mlp_bwd_dual_plain(y, w1, b1, g, w2)
    hidden, d = w1.shape
    if hidden % 8 or d % 8 or y.shape[-1] != d or tuple(w2.shape) != (d, hidden):
        raise ValueError(f"mlp_bwd_dual: y (..., {y.shape[-1]}), w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}; widths must match and be multiples of 8")
    kernels.check_operand("mlp_bwd_dual y", y, torch.bfloat16)
    kernels.check_operand("mlp_bwd_dual w1", w1, torch.bfloat16)
    kernels.check_operand("mlp_bwd_dual b1", b1, torch.float32, (hidden,))
    kernels.check_operand("mlp_bwd_dual g", g, torch.bfloat16, y.shape)
    kernels.check_operand("mlp_bwd_dual w2", w2, torch.bfloat16)
    m = y.numel() // d
    gact = torch.empty(*y.shape[:-1], hidden, dtype=torch.bfloat16, device=y.device)
    dh = torch.empty_like(gact)
    col = torch.empty(2 * -(-m // 128), hidden, dtype=torch.float32, device=y.device)
    rc = kernels.lib().ovt_mlp_bwd_dual(
        y.data_ptr(), w1.data_ptr(), b1.data_ptr(), g.data_ptr(), w2.data_ptr(),
        gact.data_ptr(), dh.data_ptr(), col.data_ptr(), m, hidden, d, kernels.stream(y))
    kernels.raise_on(rc, "mlp_bwd_dual")
    kernels.count("mlp_bwd_dual")
    return gact, dh, col


def split_k(m: int, n: int, rows: int) -> tuple[int, int]:
    """(splits, rows per split) for a TN product of an (m, n) output over
    `rows`: enough splits to give two work items per SM, each of at least
    512 rows, rows per split a multiple of the 64-row k-block."""
    tiles = -(-m // 128) * -(-n // 128)
    splits = max(1, min(16, -(-2 * SMS // tiles), rows // 512))
    per = -(-rows // splits)
    per = -(-per // 64) * 64
    return -(-rows // per), per


def gemm_tn(dc, x):
    """Kernel ``gemm_tn`` (``csrc/gemm_grad.cu``): dc^T . x summed over all
    leading rows, dc (..., N) and x (..., K) -> (N, K) bf16, the weight
    gradient dW = dC^T . X in torch's (out, in) layout: bf16 operands, f32
    sums (split over rows when the output is small) rounded once."""
    if kernels.on_cpu(dc, x):
        return gemm_tn_plain(dc, x)
    n, k = dc.shape[-1], x.shape[-1]
    rows = dc.numel() // n
    if x.numel() // k != rows or n % 8 or k % 8:
        raise ValueError(f"gemm_tn: dc {tuple(dc.shape)} and x {tuple(x.shape)} must share their "
                         "rows; N and K must be multiples of 8")
    kernels.check_operand("gemm_tn dc", dc, torch.bfloat16)
    kernels.check_operand("gemm_tn x", x, torch.bfloat16)
    out = torch.empty(n, k, dtype=torch.bfloat16, device=dc.device)
    splits, per = split_k(n, k, rows)
    return _gemm("gemm_tn", dc, x, out, n, k, rows, 1, 1, splits, per)


# ---------------------------------------------------------------------------
# LayerNorm backward and column sums
# ---------------------------------------------------------------------------


def layernorm_bwd_plain(x, gamma, dy, g=None, *, eps: float):
    """(dx, dvec): dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
    with dxhat = dy gamma, in f32 and cast to x.dtype; dvec (2, D) f32 the
    column sums of dy xhat and dy (dgamma, dbeta). Two-pass variance."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    dyf = dy.float()
    dxhat = dyf * gamma.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if g is not None:
        dx = g.float() + dx
    d = x.shape[-1]
    dvec = torch.stack([(dyf * xhat).reshape(-1, d).sum(0), dyf.reshape(-1, d).sum(0)])
    return dx.to(x.dtype), dvec


@functools.lru_cache(maxsize=None)
def _layernorm_bwd_blocks(d: int, has_g: bool) -> int:
    """The most partial rows (blocks of its persistent grid) the LN backward
    writes at width d: the card's SMs times the blocks an SM holds
    (``ovt_layernorm_bwd_blocks``)."""
    blocks = kernels.lib().ovt_layernorm_bwd_blocks(d, int(has_g))
    if blocks < 1:
        raise RuntimeError(f"layernorm_bwd grid query failed: CUDA error {-blocks}")
    return blocks


def layernorm_bwd(x, gamma, dy, g=None, *, eps: float):
    """Kernel ``layernorm_bwd`` (``csrc/layernorm.cu``): x (..., D) bf16,
    gamma (D,) f32, dy (..., D) f32, g (..., D) bf16 (added to dx) or None.
    A persistent row stream writes dx and one partial column sum a block; a
    second launch adds the partials in a fixed order."""
    if kernels.on_cpu(x, gamma, dy, g):
        return layernorm_bwd_plain(x, gamma, dy, g, eps=eps)
    d = x.shape[-1]
    if d % 8 or d > 2048:
        raise ValueError(f"layernorm_bwd: the kernel takes a width divisible by 8 and at most "
                         f"2048, got {d}")
    kernels.check_operand("layernorm_bwd x", x, torch.bfloat16)
    kernels.check_operand("layernorm_bwd gamma", gamma, torch.float32, (d,))
    kernels.check_operand("layernorm_bwd dy", dy, torch.float32, x.shape)
    if g is not None:
        kernels.check_operand("layernorm_bwd g", g, torch.bfloat16, x.shape)
    rows = x.numel() // d
    blocks = _layernorm_bwd_blocks(d, g is not None)
    dx = torch.empty_like(x)
    dvec = torch.empty(2, d, dtype=torch.float32, device=x.device)
    work = torch.empty(blocks, 2, d, dtype=torch.float32, device=x.device)
    rc = kernels.lib().ovt_layernorm_bwd(
        x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), None if g is None else g.data_ptr(),
        dx.data_ptr(), dvec.data_ptr(), work.data_ptr(), rows, d, eps, blocks,
        kernels.stream(x))
    kernels.raise_on(rc, "layernorm_bwd")
    kernels.count("layernorm_bwd")
    return dx, dvec


def colsum_plain(t, seg_len: int | None = None, round_bf16: bool = False):
    """Column sums of t (..., N) in f32; with `seg_len`, per segment of that
    many rows first, each rounded to bf16 when `round_bf16`, then added."""
    n = t.shape[-1]
    rows = t.reshape(-1, n).float()
    seg_len = seg_len or rows.shape[0]
    seg = rows.reshape(-1, seg_len, n).sum(1)
    if round_bf16:
        seg = seg.to(torch.bfloat16).float()
    return seg.sum(0)


def colsum(t, seg_len: int | None = None, round_bf16: bool = False):
    """Kernel ``colsum`` (``csrc/layernorm.cu``): t (..., N) bf16 or f32 ->
    (N,) f32, per segment of `seg_len` rows (rounded to bf16 when
    `round_bf16`), then over the segments."""
    if kernels.on_cpu(t):
        return colsum_plain(t, seg_len, round_bf16)
    n = t.shape[-1]
    rows = t.numel() // n
    seg_len = seg_len or rows
    if rows % seg_len:
        raise ValueError(f"colsum: {rows} rows are not whole segments of {seg_len}")
    kernels.check_operand("colsum t", t, t.dtype if t.dtype == torch.float32 else torch.bfloat16)
    out = torch.empty(n, dtype=torch.float32, device=t.device)
    work = (torch.empty(rows // seg_len, n, dtype=torch.float32, device=t.device)
            if rows > seg_len else None)
    rc = kernels.lib().ovt_colsum(
        t.data_ptr(), int(t.dtype == torch.float32), out.data_ptr(),
        None if work is None else work.data_ptr(), rows, n, seg_len, int(round_bf16),
        kernels.stream(t))
    kernels.raise_on(rc, "colsum")
    kernels.count("colsum")
    return out
