"""The port's natural-layout block and flash attention against the JAX kernels.

Same inputs, made with seeded numpy, go through the JAX package's Pallas
kernels in interpret mode (``fused_mhsa_block`` -- ``_block_kernel`` -- and
``flash_attention`` -- ``_fwd_kernel`` / ``_fwd_kernel_single_k_nolse``) and
its jnp ``_block_reference``, and through the port's plain versions and
kernel wrappers (which take the plain versions for CPU tensors). f32
throughout, at ragged lengths. Tolerance atol = rtol = 1e-5: both sides
compute in f32 and differ only in summation order and in where the softmax
scale is applied (folded into wq in the kernels, after the bias add in the
jnp reference). The plain attention over a (B, L, 3D) QKV buffer is held
against the JAX flash kernel on the same q, k and v (1e-5), and its nomax
softmax past the clamp at 80 against the JAX fused_t block (1e-4, the JAX
test's own bound for that block). The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_kernels_gpu.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.flash_attention import flash_attention as jflash
from openvision_tpu.ops.fused_attention import _block_reference, fused_mhsa_block as jblock
from openvision_tpu_torch.ops import fused_attention as tfa
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    single_k,
)

TOL = dict(atol=1e-5, rtol=1e-5)
D, HEADS = 32, 2


def _block_inputs(l, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = n(2, l, D)
    w = {k: n(D, D, s=0.3) for k in ("q", "k", "v", "o")}
    b = {k: n(D, s=0.1) for k in ("q", "k", "v", "o")}
    ln = (1 + n(D, s=0.1), n(D, s=0.1))
    return x, w, b, ln


def _port_block(fn, x, w, b, ln, causal, prefix):
    t = lambda a: torch.from_numpy(a)
    w_qkv = torch.cat([t(w[k]).T for k in "qkv"])
    b_qkv = torch.cat([t(b[k]) for k in "qkv"])
    return fn(t(x), t(ln[0]), t(ln[1]), w_qkv, b_qkv, t(w["o"]).T, t(b["o"]),
              num_heads=HEADS, causal=causal, prefix_len=prefix).numpy()


MODES = [(False, 0), (True, 0), (True, 7)]  # unmasked, causal, prefix-LM


@pytest.mark.parametrize("causal,prefix", MODES)
def test_block_plain_matches_jax_block_kernel(causal, prefix):
    x, w, b, ln = _block_inputs(19, seed=0)
    want = np.asarray(jblock(
        jnp.asarray(x), jnp.asarray(ln[0]), jnp.asarray(ln[1]),
        *(jnp.asarray(a) for k in "qkvo" for a in (w[k], b[k])),
        num_heads=HEADS, causal=causal, prefix_len=prefix, interpret=True))
    got = _port_block(tfa.fused_mhsa_block_plain, x, w, b, ln, causal, prefix)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal,prefix", MODES)
def test_block_plain_matches_jax_block_reference(causal, prefix):
    x, w, b, ln = _block_inputs(23, seed=1)
    vec = np.stack([ln[0], ln[1], b["q"], b["k"], b["v"], b["o"]] + [np.zeros(D, np.float32)] * 2)
    want = np.asarray(_block_reference(
        jnp.asarray(x), *(jnp.asarray(w[k]) for k in "qkvo"), jnp.asarray(vec), HEADS,
        (D // HEADS) ** -0.5, causal, 1e-6, prefix))
    got = _port_block(tfa.fused_mhsa_block_plain, x, w, b, ln, causal, prefix)
    np.testing.assert_allclose(got, want, **TOL)


def test_block_wrapper_takes_the_plain_version_on_cpu():
    x, w, b, ln = _block_inputs(11, seed=2)
    kernels.reset_launch_counts()
    got = _port_block(tfa.fused_mhsa_block, x, w, b, ln, True, 5)
    np.testing.assert_array_equal(
        got, _port_block(tfa.fused_mhsa_block_plain, x, w, b, ln, True, 5))
    assert set(kernels.LAUNCHES.values()) == {0}


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, lk, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("lq,lk,causal,prefix", [
    (37, 37, False, 0),    # one k block: q pre-scaled
    (37, 53, False, 0),    # cross-attention, Lq != Lk
    (45, 45, True, 0),     # causal
    (45, 45, True, 13),    # prefix-LM
    (50, 900, False, 0),   # several k blocks (Lk > 768): f32 scores scaled
    (780, 780, True, 340),  # several q and k blocks, prefix-LM, dead blocks skipped
    # ragged key tails (the CUDA kernel's last key tile of 1..63 keys)
    (70, 65, False, 0),
    (79, 79, True, 0),
    (100, 257, True, 40),
    (128, 335, False, 0),
])
def test_flash_plain_matches_jax_flash(lq, lk, causal, prefix):
    q, k, v = _qkv(2, lq, lk, 2, 16, seed=lq + lk)
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                             prefix_len=prefix, interpret=True))
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                   prefix_len=prefix)
    np.testing.assert_allclose(o.numpy(), want, **TOL)
    assert lse.shape == (2, 2, lq) and torch.isfinite(lse).all()


def _qkv_buffer(b, l, seed, scale=1.0):
    """A (B, L, 3D) f32 QKV buffer and its q, k, v as (B, L, H, hd) arrays."""
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((b, l, 3 * D)) * scale).astype(np.float32)
    return qkv, [qkv[..., i * D:(i + 1) * D].reshape(b, l, HEADS, D // HEADS) for i in range(3)]


@pytest.mark.parametrize("l,causal,prefix", [
    (65, False, 0), (79, True, 0), (257, False, 0), (335, True, 100), (257, True, 300),
])
def test_attention_plain_on_qkv_buffer_matches_jax_flash(l, causal, prefix):
    """fe.attention_plain over the QKV buffer (the encoder blocks' attention,
    ragged key tails, the causal and prefix-LM masks) against the JAX flash
    kernel in interpret mode on the same q, k and v."""
    qkv, (q, k, v) = _qkv_buffer(2, l, seed=l + prefix)
    want = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                             prefix_len=prefix, interpret=True))
    got = fe.attention_plain(torch.from_numpy(qkv), HEADS, causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), want.reshape(2, l, D), **TOL)


@pytest.mark.parametrize("patches", [64, 78, 256])
def test_attention_plain_nomax_matches_jax_mhsa_t_past_the_clamp(patches):
    """The nomax softmax exp(min(s, 80)) with scores far past 80: the port's
    attention half of the block (attention_plain over its QKV buffer)
    against the JAX fused_t block in interpret mode, its MLP weights zero so
    that the block is its attention half (MLP(y) = GELU(0) . 0 + 0)."""
    from openvision_tpu.ops.fused_encoder import (
        from_transposed_stream,
        fused_encoder_tblock,
        to_transposed_stream,
    )

    rng = np.random.default_rng(patches)
    x = rng.standard_normal((2, 1 + patches, D)).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) * 2.0).astype(np.float32)  # scores ~ +-60
    bqkv, wo, bo = (rng.standard_normal(n).astype(np.float32) * s
                    for n, s in (((3 * D,), 0.05), ((D, D), 0.3), ((D,), 0.05)))
    ln_s, ln_b = 1 + 0.1 * rng.standard_normal(D).astype(np.float32), np.zeros(D, np.float32)
    zeros = dict(w1=np.zeros((D, 4 * D), np.float32), b1=np.zeros(4 * D, np.float32),
                 w2=np.zeros((4 * D, D), np.float32), b2=np.zeros(D, np.float32))
    xT, cls, valid = to_transposed_stream(jnp.asarray(x))
    oT, ocls = fused_encoder_tblock(
        xT, cls, *map(jnp.asarray, (wqkv, bqkv, wo, bo, ln_s, ln_b, zeros["w1"], zeros["b1"],
                                    zeros["w2"], zeros["b2"], ln_s, ln_b)),
        num_heads=HEADS, valid=valid, nomax=True, interpret=True)
    want = np.asarray(from_transposed_stream(oT, ocls, valid))

    t = torch.from_numpy
    y = fe.layernorm_plain(t(x), t(ln_s), t(ln_b), 1e-6)
    qkv = fe.linear_plain(y, t(wqkv).T, t(bqkv))
    hd = D // HEADS
    scores = torch.einsum("bqhd,bkhd->bhqk", *(qkv[..., i * D:(i + 1) * D].reshape(
        2, 1 + patches, HEADS, hd) for i in range(2))) * hd ** -0.5
    assert scores.max().item() > 80  # the clamp is hit
    got = fe.linear_plain(fe.attention_plain(qkv, HEADS, nomax=True), t(wo).T, t(bo),
                          residual=t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_flash_lse_is_the_logsumexp_of_the_scores():
    q, k, v = _qkv(1, 9, 14, 2, 16, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = flash_attention(tq, tk, tv, causal=True, prefix_len=4, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * 16 ** -0.5
    rows, cols = torch.arange(9)[:, None], torch.arange(14)[None]
    s = s.masked_fill(cols > torch.clamp(rows, min=3), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)


def test_flash_plan_follows_the_pallas_plan():
    assert single_k(1) and single_k(335) and single_k(463) and single_k(768)
    assert not single_k(769) and not single_k(900)
