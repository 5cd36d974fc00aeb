"""The port's attention twins at head_dims 72 and 80 against the JAX kernels.

The Pallas kernels take any head_dim; So400m's towers have 72 (width 1152
over 16 heads) and H/14's 80 (1280 over 16). At those widths the softmax
scale (72**-0.5, 80**-0.5) is not a power of two, so the orders of scaling
and rounding matter: ``_mhsa_t_kernel`` rounds q * scale, ``_block_kernel``
and ``_kernel`` fold the scale into wq, the flash kernels scale q (single
k block) or the f32 scores (several), and the backwards scale q after the
bias and dq after its sum. Same inputs, made with seeded numpy, go through
the JAX package's kernels in interpret mode and through the port's plain
twins (which the CUDA kernels are held against on the card), at 2 heads of
72 or 80, L = 17 and 40, B = 2. f32 throughout: the two sides differ only
in summation order, so forward outputs agree to 1e-5 (1e-4 for the fused_t
sub-block pair, the existing test's bound) and gradients to 1e-4 of their
largest value. The kernels' head_dim rule (a multiple of 8 from 16; the
wrappers pad any other) is checked on CPU tensors too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.flash_attention import flash_attention as jflash
from openvision_tpu.ops.fused_attention import fused_mhsa_block as jblock
from openvision_tpu.ops.fused_attention import fused_qkv_attention as jqkv
from openvision_tpu.ops.fused_encoder import (
    from_transposed_stream,
    fused_encoder_tblock,
    to_transposed_stream,
)
from openvision_tpu_torch.ops import fused_attention as tfa
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.ops.flash_attention import flash_attention

HEADS = 2
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() if scale is None else scale))


def _check_grads(names, got, want):
    """Each gradient within GRAD of its largest value; dbk, zero but for
    rounding (softmax ignores a key bias), within GRAD of max|dbq|."""
    scale = float(np.abs(np.asarray(want[names.index("dbq")])).max())
    for name, a, w in zip(names, got, want):
        assert _rel(a.numpy(), w, scale if name == "dbk" else None) <= GRAD, name


@pytest.mark.parametrize("hd,lq,lk,causal,prefix", [(72, 17, 40, False, 0), (80, 40, 40, True, 9),
                                                    (72, 40, 800, False, 0)])
def test_flash_twins_match_jax_flash_kernels(hd, lq, lk, causal, prefix):
    """#13/#14 forward (single-k order, and multi-k past 768 keys) and
    #15/#16 backward."""
    n = _rng(hd + lq + lk)
    q, k, v, g = n(2, lq, HEADS, hd), n(2, lk, HEADS, hd), n(2, lk, HEADS, hd), n(2, lq, HEADS, hd)

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, prefix_len=prefix, interpret=True)

    want, vjp = jax.vjp(f, q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, vjp(g)):
        assert _rel(a.numpy(), w) <= GRAD, name


def _block_inputs(hd, l, seed):
    n = _rng(seed)
    d = HEADS * hd
    return dict(x=n(2, l, d), w={c: n(d, d, s=d**-0.5) for c in "qkvo"},
                b={c: n(d, s=0.1) for c in "qkvo"}, ln=(1 + n(d, s=0.1), n(d, s=0.1)),
                g=n(2, l, d))


@pytest.mark.parametrize("hd,l,causal,prefix", [(72, 17, False, 0), (80, 40, True, 9)])
def test_fused_block_twin_matches_jax_block_kernels(hd, l, causal, prefix):
    """#9 (the scale folded into wq) and its backward #10 (q scaled after
    the bias, dq's rounded sum times the scale)."""
    inp = _block_inputs(hd, l, seed=hd + l)
    w, b = inp["w"], inp["b"]

    def f(x, wq, wk, wv, wo, ln_s, ln_b, bq, bk, bv, bo):
        return jblock(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, num_heads=HEADS,
                      causal=causal, prefix_len=prefix, interpret=True)

    args = (inp["x"], w["q"], w["k"], w["v"], w["o"], *inp["ln"], b["q"], b["k"], b["v"], b["o"])
    want, vjp = jax.vjp(f, *args)
    want_grads = vjp(inp["g"])
    t = lambda a: torch.from_numpy(a).requires_grad_(True)
    leaves = [t(a) for a in args]
    x, wq, wk, wv, wo, ln_s, ln_b, bq, bk, bv, bo = leaves
    out = tfa.fused_mhsa_block(x, ln_s, ln_b, torch.cat([wq.t(), wk.t(), wv.t()]),
                               torch.cat([bq, bk, bv]), wo.t(), bo, num_heads=HEADS,
                               causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(inp["g"]))
    _check_grads(("dx", "dwq", "dwk", "dwv", "dwo", "dln_s", "dln_b", "dbq", "dbk", "dbv", "dbo"),
                 got, want_grads)


@pytest.mark.parametrize("hd,l", [(80, 17)])
def test_qkv_attention_twin_matches_jax_kernel(hd, l):
    """#7 (``_kernel``: the scale folded) and its backward #8."""
    inp = _block_inputs(hd, l, seed=3)
    w, b = inp["w"], inp["b"]

    def f(y, wq, wk, wv, bq, bk, bv):
        return jqkv(y, wq, wk, wv, bq, bk, bv, num_heads=HEADS, interpret=True)

    args = (inp["x"], w["q"], w["k"], w["v"], b["q"], b["k"], b["v"])
    want, vjp = jax.vjp(f, *args)
    want_grads = vjp(inp["g"])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, wq, wk, wv, bq, bk, bv = leaves
    out = tfa.fused_qkv_attention(y, torch.cat([wq.t(), wk.t(), wv.t()]),
                                  torch.cat([bq, bk, bv]), num_heads=HEADS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(inp["g"]))
    _check_grads(("dy", "dwq", "dwk", "dwv", "dbq", "dbk", "dbv"), got, want_grads)


@pytest.mark.parametrize("hd,nomax", [(72, False), (80, True)])
def test_mhsa_t_twins_match_jax_fused_tblock(hd, nomax):
    """#1 (q * scale rounded before q.k^T) with the MLP sub-block, and the
    backward #3 (its own q and dq orders), on 16 patches and the cls token."""
    n = _rng(hd)
    d = HEADS * hd
    mlp = 2 * d
    x, g = n(2, 17, d), n(2, 17, d)
    a = dict(wqkv=n(d, 3 * d, s=d**-0.5), bqkv=n(3 * d, s=0.05), wo=n(d, d, s=d**-0.5),
             bo=n(d, s=0.05), ln1s=1 + n(d, s=0.1), ln1b=n(d, s=0.05), w1=n(d, mlp, s=d**-0.5),
             b1=n(mlp, s=0.05), w2=n(mlp, d, s=mlp**-0.5), b2=n(d, s=0.05),
             ln2s=1 + n(d, s=0.1), ln2b=n(d, s=0.05))
    names = ("wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "w1", "b1", "w2", "b2", "ln2s", "ln2b")

    def f(x, wqkv, wo):
        xT, cls, valid = to_transposed_stream(x)
        args = [{"wqkv": wqkv, "wo": wo}.get(k, jnp.asarray(a[k])) for k in names]
        oT, ocls = fused_encoder_tblock(xT, cls, *args, num_heads=HEADS, valid=valid,
                                        nomax=nomax, interpret=True)
        return from_transposed_stream(oT, ocls, valid)

    want, vjp = jax.vjp(f, x, a["wqkv"], a["wo"])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, a["wqkv"], a["wo"])]
    y = fe.mhsa_block(leaves[0], t["ln1s"], t["ln1b"], leaves[1].t(), t["bqkv"], leaves[2].t(),
                      t["bo"], num_heads=HEADS, eps=1e-6, nomax=nomax)
    out = fe.mlp_block(y, t["ln2s"], t["ln2b"], t["w1"].T, t["b1"], t["w2"].T, t["b2"], eps=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a_, w_ in zip(("dx", "dwqkv", "dwo"), got, vjp(g)):
        assert _rel(a_.numpy(), w_) <= GRAD, name


def test_attention_plain_rounds_q_by_the_bf16_scale():
    """``_mhsa_t_kernel`` multiplies its bf16 q by the Python scale, which JAX
    casts to bf16: the twin's q is bf16(q * bf16(72**-0.5)), not q times the
    f32 scale, and its scores are those of that q."""
    n = _rng(5)
    qkv = torch.from_numpy(n(1, 9, 3 * HEADS * 72)).bfloat16()
    got = fe.attention_plain(qkv, HEADS)
    q, k, v = (t.reshape(1, 9, HEADS, 72) for t in qkv.split(HEADS * 72, dim=-1))
    s_bf16 = kernels.cast_scalar(72**-0.5, torch.bfloat16)
    assert s_bf16 != 72**-0.5
    want, _ = fe.attend_plain(q, k, v, scale=s_bf16)
    torch.testing.assert_close(got, want.reshape(1, 9, -1), atol=0, rtol=0)


@pytest.mark.parametrize("hd", [12, 136, 36])
def test_head_dim_rule_names_the_limit(hd):
    """The kernels take a multiple of 8 from 16 (rows of whole 16-byte
    units for TMA; above 128 in two column parts, above 256 in 128-column
    slabs); the kernel-level check names that rule for any other head_dim,
    which the wrappers zero-pad to the next multiple of 8 (at least 16)."""
    if hd % 8:
        with pytest.raises(ValueError, match="multiple of 8, at least 16"):
            kernels.check_head_dim("attention", hd)
    else:
        kernels.check_head_dim("attention", hd)
    assert kernels.kernel_head_dim("attention", hd) == max(16, -(-hd // 8) * 8)
    for ok in (16, 72, 80, 88, 104, 128, 192, 256, 264, 512, 1024):
        kernels.check_head_dim("attention", ok)
    for bad in (8, 260):
        with pytest.raises(ValueError, match="multiple of 8, at least 16"):
            kernels.check_head_dim("attention", bad)
    assert kernels.kernel_head_dim("attention", 260) == 264
