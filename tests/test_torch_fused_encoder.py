"""The port's encoder sub-blocks against the JAX fused_t kernels.

Same inputs, made with seeded numpy, go through the JAX package's
``fused_encoder_tblock`` (its Pallas kernels in interpret mode) and
``_tblock_reference``, and through the port's ``mhsa_block_plain`` +
``mlp_block_plain`` and the kernel wrappers (which take the plain versions
for CPU tensors). f32 throughout; atol = rtol = 1e-4, the JAX test's own
bound (tests/test_fused_encoder.py). The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_kernels_gpu.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.fused_encoder import (
    _tblock_reference,
    from_transposed_stream,
    fused_encoder_tblock,
    to_transposed_stream,
)
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import kernels

D, HEADS, P = 16, 2, 9  # 9 patches: the JAX side pads them to 128 lanes


def _inputs(batch, seed=0, d=D, mlp=4 * D):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = n(batch, 1 + P, d)
    jargs = dict(
        wqkv=n(d, 3 * d, s=0.2), bqkv=n(3 * d, s=0.05), wo=n(d, d, s=0.2),
        bo=n(d, s=0.05), ln1s=1 + n(d, s=0.1), ln1b=n(d, s=0.05),
        w1=n(d, mlp, s=0.2), b1=n(mlp, s=0.05), w2=n(mlp, d, s=0.2),
        b2=n(d, s=0.05), ln2s=1 + n(d, s=0.1), ln2b=n(d, s=0.05),
    )
    return x, jargs


def _jax_block(x, a, nomax, interpret_kernel):
    xT, cls, valid = to_transposed_stream(jnp.asarray(x))
    args = [jnp.asarray(a[k]) for k in (
        "wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "w1", "b1", "w2", "b2", "ln2s", "ln2b")]
    if interpret_kernel:
        oT, ocls = fused_encoder_tblock(
            xT, cls, *args, num_heads=HEADS, valid=valid, nomax=nomax, interpret=True)
    else:
        oT, ocls = _tblock_reference(xT, cls, *args, num_heads=HEADS, valid=valid, eps=1e-6)
    return np.asarray(from_transposed_stream(oT, ocls, valid))


def _port_block(x, a, nomax, plain):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    mhsa, mlp = (fe.mhsa_block_plain, fe.mlp_block_plain) if plain else (fe.mhsa_block, fe.mlp_block)
    y = mhsa(torch.from_numpy(x), t["ln1s"], t["ln1b"], t["wqkv"].T, t["bqkv"],
             t["wo"].T, t["bo"], num_heads=HEADS, eps=1e-6, nomax=nomax)
    y = mlp(y, t["ln2s"], t["ln2b"], t["w1"].T, t["b1"], t["w2"].T, t["b2"], eps=1e-6)
    return y.numpy()


@pytest.mark.parametrize("batch,nomax", [(2, False), (3, False), (2, True), (3, True)])
def test_block_plain_matches_jax_fused_tblock(batch, nomax):
    x, a = _inputs(batch)
    want = _jax_block(x, a, nomax, interpret_kernel=True)
    np.testing.assert_allclose(_port_block(x, a, nomax, plain=True), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batch,nomax", [(2, False), (3, True)])
def test_block_plain_matches_jax_tblock_reference(batch, nomax):
    # _tblock_reference has no nomax switch: exp(min(s, 80)) / sum equals the
    # max-subtracted softmax whenever no score passes 80, as here
    x, a = _inputs(batch, seed=1)
    want = _jax_block(x, a, nomax, interpret_kernel=False)
    np.testing.assert_allclose(_port_block(x, a, nomax, plain=True), want, atol=1e-4, rtol=1e-4)


def test_block_wrappers_take_plain_versions_on_cpu():
    x, a = _inputs(2, seed=2)
    kernels.reset_launch_counts()
    got = _port_block(x, a, nomax=False, plain=False)
    np.testing.assert_array_equal(got, _port_block(x, a, nomax=False, plain=True))
    assert set(kernels.LAUNCHES.values()) == {0}


def test_mlp_geometry_not_a_multiple_of_width():
    # So400m-style: mlp_dim 56 is not 4 * width (24), head_dim 8
    d, heads = 24, 3
    x, a = _inputs(2, seed=3, d=d, mlp=56)
    xT, cls, valid = to_transposed_stream(jnp.asarray(x))
    args = [jnp.asarray(a[k]) for k in (
        "wqkv", "bqkv", "wo", "bo", "ln1s", "ln1b", "w1", "b1", "w2", "b2", "ln2s", "ln2b")]
    oT, ocls = fused_encoder_tblock(xT, cls, *args, num_heads=heads, valid=valid, interpret=True)
    want = np.asarray(from_transposed_stream(oT, ocls, valid))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y = fe.mhsa_block_plain(torch.from_numpy(x), t["ln1s"], t["ln1b"], t["wqkv"].T, t["bqkv"],
                            t["wo"].T, t["bo"], num_heads=heads)
    y = fe.mlp_block_plain(y, t["ln2s"], t["ln2b"], t["w1"].T, t["b1"], t["w2"].T, t["b2"])
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)


def test_attention_plain_nomax_clamps_at_80():
    # scores far above 80: the max path stays finite, nomax clamps exp at 80
    qkv = torch.zeros(1, 3, 3 * 8)
    qkv[..., :8] = 100.0
    qkv[..., 8:16] = 100.0
    qkv[..., 16:] = torch.arange(3.0)[:, None]
    for nomax in (False, True):
        o = fe.attention_plain(qkv, 1, nomax=nomax)
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, torch.full_like(o, 1.0))


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        fe.layernorm(x, torch.ones(8, device="meta"), torch.zeros(8), 1e-6)
