"""The MLP backward's dual kernel on the CPU: its plain twin
``mlp_bwd_dual_plain`` against the JAX package's ``_mlp_t_bwd_kernel``.

``mlp_bwd_dual`` (``csrc/gemm_grad.cu``) keeps the fc1 recompute's f32
pre-activation on chip: one kernel runs h = y . W1^T and g . W2 into two
accumulators and writes gact = bf16(gelu(h + b1)), dh = bf16((g . W2)
gelu'(h + b1)) and per-64-row column sums of the unrounded dh. Its plain
twin is held here, from seeded numpy inputs in f32, against
- the Pallas kernel itself, run in interpret mode as the JAX package's own
  tests run it: its db1 against the twin's column sums, its dW2 = gact^T g
  and dW1 = y^T dh against those products of the twin's gact and dh;
- the jnp reference of the same math (jax.nn.gelu and jax.vjp through it)
  for gact and dh element by element, and the per-slab sums of dh.
f32 throughout; both sides sum in other orders (and the Pallas kernel's
LayerNorm takes E[x^2] - mean^2, so y is fed to both as one array):
within 1e-5 of each output's norm, 1e-5 of max |ref| element-wise. In bf16
the twin rounds gact and dh once from the f32 values and sums the unrounded
dh: exactly the f32 run's values, rounded. ``mlp_block_bwd_plain``, which
now takes gact and dh from the twin, is held against the formula it had
before (the fc1 recompute with its f32 pre-activation, then the dGELU
product): every gradient equal, db1 within 1e-6 (64-row partial sums first).
The CUDA kernel is held against the twin on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.fused_encoder import _mlp_t_bwd_call
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels


def _norm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(seed, rows, d, hidden):
    """y and g (rows, D), w1 (D, hidden), b1, w2 (hidden, D): JAX's layouts."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(y=n(rows, d), g=n(rows, d), w1=n(d, hidden, s=d**-0.5), b1=n(hidden, s=0.1),
                w2=n(hidden, d, s=hidden**-0.5))


def _port(a, dtype=torch.float32):
    """The twin on the port's layouts (weights in torch's (out, in) order)."""
    t = lambda k: torch.from_numpy(a[k])
    return gk.mlp_bwd_dual_plain(t("y").to(dtype), t("w1").t().to(dtype), t("b1"),
                                 t("g").to(dtype), t("w2").t().to(dtype))


def _pallas_y(x, ln_s, ln_b, eps):
    """The Pallas kernel's LayerNorm (fused_encoder.py:614-620) in numpy f32:
    E[x^2] - mean^2 over the width, rows of x (rows, D)."""
    mean = x.mean(-1, keepdims=True, dtype=np.float32)
    var = (x * x).mean(-1, keepdims=True, dtype=np.float32) - mean * mean
    return ((x - mean) / np.sqrt(var + eps) * ln_s + ln_b).astype(np.float32)


@pytest.mark.parametrize("b,lpat,d,hidden", [(2, 16, 32, 128), (3, 24, 64, 256), (1, 40, 16, 64)])
def test_dual_plain_matches_the_pallas_mlp_backward(b, lpat, d, hidden):
    """The twin's gact, dh and column sums against what the Pallas backward
    makes of them: db1 = sum dh, dW2 = gact^T g, dW1 = y^T dh."""
    rng = np.random.default_rng(b * 100 + d)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    xT, g = n(b, d, lpat), n(b, d, lpat)
    w1, b1 = n(d, hidden, sc=d**-0.5), n(hidden, sc=0.1)
    w2 = n(hidden, d, sc=hidden**-0.5)
    ln_s, ln_b = 1 + n(d, sc=0.1), n(d, sc=0.1)
    vecT = np.zeros((d, 8), np.float32)
    vecT[:, 0], vecT[:, 1] = ln_s, ln_b
    _, dw1, dw2, _, db1 = _mlp_t_bwd_call(
        jnp.asarray(xT), jnp.asarray(g), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(vecT),
        jnp.asarray(b1[:, None]), eps=1e-6, interpret=True)

    rows = lambda t: np.ascontiguousarray(t.transpose(0, 2, 1).reshape(-1, d))
    y = _pallas_y(rows(xT), ln_s, ln_b, 1e-6)
    gr = rows(g)
    gact, dh, col = _port(dict(y=y, g=gr, w1=w1, b1=b1, w2=w2))
    assert col.shape == (2 * -(-b * lpat // 128), hidden)
    assert _norm_rel(col.sum(0), np.asarray(db1)[:, 0]) <= 1e-5
    assert _norm_rel(gact.numpy().T @ gr, np.asarray(dw2)) <= 1e-5
    assert _norm_rel(y.T @ dh.numpy(), np.asarray(dw1)) <= 1e-5


@pytest.mark.parametrize("rows", [37, 128, 200, 257])
def test_dual_plain_matches_the_jnp_reference(rows):
    """gact = gelu(y W1 + b1), dh = the vjp of fc2(gelu(.)) at h for g, and
    each 64-row slab's column sums of dh, ragged last slab included."""
    a = _inputs(rows, rows, 48, 192)
    h = jnp.asarray(a["y"]) @ jnp.asarray(a["w1"]) + jnp.asarray(a["b1"])
    _, vjp = jax.vjp(lambda t: jax.nn.gelu(t, approximate=True) @ jnp.asarray(a["w2"]), h)
    want_gact = np.asarray(jax.nn.gelu(h, approximate=True))
    want_dh = np.asarray(vjp(jnp.asarray(a["g"]))[0])
    gact, dh, col = _port(a)
    assert _max_rel(gact, want_gact) <= 1e-5
    assert _max_rel(dh, want_dh) <= 1e-5
    slabs = 2 * -(-rows // 128)
    padded = np.zeros((64 * slabs, want_dh.shape[1]), np.float32)
    padded[:rows] = want_dh
    assert col.shape == (slabs, 192)
    assert _max_rel(col, padded.reshape(slabs, 64, -1).sum(1)) <= 1e-5


def test_dual_plain_rounds_once_to_the_compute_dtype():
    """bf16 inputs: gact and dh are the f32 run's values on the same bf16
    numbers, rounded once; the column sums are of the unrounded dh."""
    a = _inputs(5, 150, 64, 256)
    bf = {k: torch.from_numpy(v).bfloat16().float().numpy() for k, v in a.items()}
    bf["b1"] = a["b1"]
    gact, dh, col = _port(bf, torch.bfloat16)
    gact32, dh32, col32 = _port(bf)
    assert gact.dtype == dh.dtype == torch.bfloat16 and col.dtype == torch.float32
    assert torch.equal(gact, gact32.bfloat16())
    assert torch.equal(dh, dh32.bfloat16())
    assert torch.equal(col, col32)


def _mlp_block_bwd_before(x, ln_w, ln_b, w1, b1, w2, b2, g, eps=1e-6):
    """``mlp_block_bwd_plain`` as it was before the dual kernel: the fc1
    recompute kept its f32 pre-activation h, dh = (g W2) gelu'(h), db1 the
    sum of dh over every row at once."""
    cdt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    y = (xhat * ln_w.float() + ln_b.float()).to(cdt).float()
    h = y @ w1.float().t() + b1.float()
    gact = (0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
            ).to(cdt)
    gf = g.float()
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dw2 = (rows(gf).t() @ rows(gact.float())).to(w2.dtype)
    dh = (gf @ w2.float()) * gk.gelu_tanh_grad(h)
    dhb = dh.to(cdt).float()
    dw1 = (rows(dhb).t() @ rows(y)).to(w1.dtype)
    dy = dhb @ w1.float()
    dxhat = dy * ln_w.float()
    dx = gf + rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                      - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(cdt), rows(dy * xhat).sum(0), rows(dy).sum(0), dw1, rows(dh).sum(0), dw2,
            rows(gf).sum(0))


def _block_args(seed, dtype, b=2, l=101, d=64):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
    x, g = t(b, l, d).to(dtype), t(b, l, d).to(dtype)
    w = (1 + t(d, sc=0.1), t(d, sc=0.1), t(4 * d, d, sc=d**-0.5).to(dtype), t(4 * d, sc=0.1),
         t(d, 4 * d, sc=(4 * d) ** -0.5).to(dtype), t(d, sc=0.1))
    return x, w, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_bwd_plain_is_unchanged(dtype):
    x, w, g = _block_args(11, dtype)
    got = fe.mlp_block_bwd_plain(x, *w, g)
    want = _mlp_block_bwd_before(x, *w, g)
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.dtype == r.dtype, i
        if i == 4:  # db1: the same dh summed per 64-row slab first
            assert _max_rel(a, r) <= 1e-6
        else:
            assert torch.equal(a, r), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_backward_chain_on_the_cpu_runs_the_twins(dtype):
    """``_mlp_backward_kernels`` (the 8-launch chain) with CPU tensors runs
    each wrapper's plain twin, launches nothing, and gives the plain
    backward's gradients (db1 and db2 summed per segment first)."""
    x, w, g = _block_args(12, dtype)
    if dtype != torch.bfloat16:
        with pytest.raises(TypeError, match="bf16 weights"):
            fe._mlp_backward_kernels(x, *w, g, eps=1e-6)
        return
    kernels.reset_launch_counts()
    got = fe._mlp_backward_kernels(x, *w, g, eps=1e-6)
    assert set(kernels.LAUNCHES.values()) == {0}
    want = fe.mlp_block_bwd_plain(x, *w, g)
    for i, (a, r) in enumerate(zip(got, want)):
        assert a.dtype == r.dtype, i
        if i in (4, 6):
            assert _max_rel(a, r) <= 1e-6, i
        else:
            assert torch.equal(a, r), i


def test_mlp_bwd_dual_wrapper_takes_its_twin_on_the_cpu():
    a = _inputs(3, 70, 32, 128)
    t = lambda k: torch.from_numpy(a[k])
    kernels.reset_launch_counts()
    got = gk.mlp_bwd_dual(t("y"), t("w1").t().contiguous(), t("b1"), t("g"),
                          t("w2").t().contiguous())
    assert set(kernels.LAUNCHES.values()) == {0}
    for a_, r in zip(got, _port(a)):
        assert torch.equal(a_, r)


@pytest.mark.parametrize("m,n,rows", [(1024, 1024, 16448), (3072, 1024, 2056),
                                      (768, 768, 3704), (256, 128, 5000)])
def test_split_k_takes_whole_k_blocks(m, n, rows):
    """The TN split: every split but the last is a whole number of the
    kernel's 64-row k-blocks and the splits cover the rows exactly."""
    splits, per = gk.split_k(m, n, rows)
    assert per % 64 == 0 and splits >= 1
    assert (splits - 1) * per < rows <= splits * per
