"""The attention twins at the head_dims the kernels take only padded or in
column parts, against the JAX kernels.

The Pallas kernels take any head_dim. The port's CUDA kernels take a
multiple of 8 from 16 (up to 256 in whole tiles, above in slabs): the wrappers (``fused_encoder.attention``,
``flash_attention``, ``grad_kernels.attention_bwd``) zero-pad any other
head_dim to the next multiple of 8 (at least 16) at the true head_dim's
softmax scale and slice the outputs back, on the CPU as on the card, so the
plain versions here run on the padded operands the kernels get. Above 128
the kernels split the output columns into two parts (``csrc/attention.cuh``
``Part``), which the card's checks cover; here 136 and 192 run the plain
route at those widths. Same inputs, made with seeded numpy, go through the
JAX package's Pallas kernels in interpret mode and through the port, at 2
heads of 12, 36, 100, 136 and 192, L = 17 or 24, B = 2. f32 throughout:
forward outputs agree to 1e-5 (1e-4 for the fused_t sub-block pair),
gradients to 1e-4 of their largest value, as at 72 and 80
(``test_torch_head_dims.py``). Padding itself is held exact against the
unpadded plain versions. Past 256 (264, 320, 512) the wrappers take the
head_dim as any other (the kernels stream it in 128-column slabs) and are
held against the JAX flash kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.flash_attention import flash_attention as jflash
from openvision_tpu.ops.fused_attention import fused_mhsa_block as jblock
from openvision_tpu.ops.fused_encoder import (
    from_transposed_stream,
    fused_encoder_tblock,
    to_transposed_stream,
)
from openvision_tpu_torch.ops import flash_attention as fl
from openvision_tpu_torch.ops import fused_attention as tfa
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels

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


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("hd,lq,lk,causal,prefix", [
    (12, 17, 24, False, 0), (36, 24, 24, True, 5), (100, 17, 24, False, 0),
    (136, 24, 24, True, 0), (192, 17, 24, False, 0)])
def test_flash_twins_match_jax_at_padded_head_dims(hd, lq, lk, causal, prefix):
    """#13/#14 forward and #15/#16 backward through the padded wrappers."""
    n = _rng(hd + lq)
    q, k, v, g = n(2, lq, HEADS, hd), n(2, lk, HEADS, hd), n(2, lk, HEADS, hd), n(2, lq, HEADS, hd)

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, prefix_len=prefix, interpret=True)

    want, vjp = jax.vjp(f, q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fl.flash_attention(*leaves, causal=causal, prefix_len=prefix)
    assert out.shape == (2, lq, HEADS, hd)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, vjp(g)):
        assert a.shape == w.shape
        assert _rel(a.numpy(), w) <= GRAD, name


@pytest.mark.parametrize("hd,l,causal,prefix", [(12, 17, False, 0), (100, 24, True, 7),
                                                (136, 17, False, 0)])
def test_fused_block_twin_matches_jax_at_padded_head_dims(hd, l, causal, prefix):
    """#9 (``_block_kernel``, the scale folded into wq) and its backward #10."""
    n = _rng(hd + l)
    d = HEADS * hd
    w = {c: n(d, d, s=d**-0.5) for c in "qkvo"}
    b = {c: n(d, s=0.1) for c in "qkvo"}
    args = (n(2, l, d), w["q"], w["k"], w["v"], w["o"], 1 + n(d, s=0.1), n(d, s=0.1),
            b["q"], b["k"], b["v"], b["o"])
    g = n(2, l, d)

    def f(x, wq, wk, wv, wo, ln_s, ln_b, bq, bk, bv, bo):
        return jblock(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, num_heads=HEADS,
                      causal=causal, prefix_len=prefix, interpret=True)

    want, vjp = jax.vjp(f, *args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    x, wq, wk, wv, wo, ln_s, ln_b, bq, bk, bv, bo = leaves
    out = tfa.fused_mhsa_block(x, ln_s, ln_b, torch.cat([wq.t(), wk.t(), wv.t()]),
                               torch.cat([bq, bk, bv]), wo.t(), bo, num_heads=HEADS,
                               causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dln_s", "dln_b", "dbq", "dbk", "dbv", "dbo")
    want_grads = vjp(g)
    dbq = float(np.abs(np.asarray(want_grads[names.index("dbq")])).max())
    for name, a, wg in zip(names, got, want_grads):
        # dbk is zero but for rounding (softmax ignores a key bias): held on max|dbq|
        scale = dbq if name == "dbk" else float(np.abs(np.asarray(wg)).max())
        assert float(np.abs(a.numpy() - np.asarray(wg)).max()) <= GRAD * scale, name


@pytest.mark.parametrize("hd,nomax", [(100, True)])
def test_mhsa_t_twins_match_jax_tblock_at_padded_head_dims(hd, nomax):
    """#1 (q * scale rounded before q.k^T) with the MLP sub-block and the
    backward #3, on 16 patches and the cls token."""
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


@pytest.mark.parametrize("hd", [1, 12, 36, 100, 130])
def test_padding_is_exact_against_the_unpadded_plain_versions(hd):
    """The padded wrappers (packed attention and its f32 output, flash with
    its lse, the backward pair into given views) against the plain versions
    on the unpadded operands: zero columns change no sum, so the results
    agree to f32 summation order (1e-6 of max), and the pad never leaks."""
    n = _rng(hd)
    qkv = torch.from_numpy(n(2, 9, 3 * HEADS * hd))
    assert kernels.kernel_head_dim("attention", hd) == max(16, -(-hd // 8) * 8)
    for kw in (dict(), dict(causal=True, prefix_len=3), dict(nomax=True, out_dtype=torch.float32)):
        got, want = fe.attention(qkv, HEADS, **kw), fe.attention_plain(qkv, HEADS, **kw)
        assert got.shape == want.shape == (2, 9, HEADS * hd)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    q, k, v, do = (torch.from_numpy(n(2, 9, HEADS, hd)) for _ in range(4))
    o, lse = fl._forward(q, k, v, causal=True, prefix_len=0, sm_scale=None, return_lse=True)
    o_ref, lse_ref = fl.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o, o_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-6, rtol=1e-6)
    dqkv = torch.zeros(2, 9, 3, HEADS, hd)
    outs = gk.attention_bwd(q, k, v, o, lse, do, scale=hd**-0.5, causal=True, dq=dqkv[:, :, 0],
                            dk=dqkv[:, :, 1], dv=dqkv[:, :, 2])
    want = gk.attention_bwd_plain(q, k, v, o, lse, do, scale=hd**-0.5, causal=True)
    for got_, want_, view in zip(outs, want, dqkv.unbind(2)):
        assert got_.data_ptr() == view.data_ptr()
        torch.testing.assert_close(got_, want_, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hd,causal,prefix", [(264, False, 0), (320, True, 5), (512, False, 0)])
def test_wrappers_past_256_match_jax(hd, causal, prefix):
    """Above 256 the kernels stream the head_dim in 128-column slabs
    (``csrc/attention.cuh``) and the wrappers take it as any other: the
    packed attention (``fe.attention``, the core of #1/#5/#7/#9/#11), flash
    (#13/#14) with its LSE, and the backward pair (#15/#16, through
    ``grad_kernels.attention_bwd``) against the JAX flash kernel and its
    VJP in interpret mode, L = 17 (queries) by 24 (keys) for flash, 24 for
    the packed buffer."""
    n = _rng(hd)
    d = HEADS * hd
    qkv = n(2, 24, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(2, 24, HEADS, hd) for i in range(3))

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, prefix_len=prefix, interpret=True)

    got = fe.attention(torch.from_numpy(qkv), HEADS, causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy().reshape(2, 24, HEADS, hd), np.asarray(f(q, k, v)),
                               **FWD)
    qf, kf, vf, g = n(2, 17, HEADS, hd), n(2, 24, HEADS, hd), n(2, 24, HEADS, hd), n(2, 17, HEADS,
                                                                                       hd)
    want, vjp = jax.vjp(f, qf, kf, vf)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qf, kf, vf)]
    out = fl.flash_attention(*leaves, causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    o, lse = fl._forward(*(t.detach() for t in leaves), causal=causal, prefix_len=prefix,
                         sm_scale=None, return_lse=True)
    direct = gk.attention_bwd(*(t.detach() for t in leaves), o, lse, torch.from_numpy(g),
                              scale=hd**-0.5, causal=causal, prefix_len=prefix)
    for name, a, b_, w in zip(("dq", "dk", "dv"), grads, direct, vjp(g)):
        assert a.shape == b_.shape == w.shape
        assert _rel(a.numpy(), w) <= GRAD, name
        assert _rel(b_.numpy(), w) <= GRAD, name
