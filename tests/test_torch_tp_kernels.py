"""The tensor-parallel block kernels' plain twins against the JAX Pallas kernels.

One process, no process group. Seeded numpy inputs go through the JAX
package's ``_block_partial_fwd_impl`` (#11) and ``_block_partial_bwd_impl``
(#12) in interpret mode, as its own tests run them, through
``_block_partial_reference`` and ``jax.grad`` of it, and through the port's
``block_partial_plain`` / ``block_partial_bwd_plain`` (the plain twins the
CPU path runs; chip_smoke.py holds the CUDA chains to them on the card),
unmasked, causal and prefix-LM (prefix 7, odd L), at tensor 2 and 4: in
bf16 against the interpret-mode kernels, in f32 against the jitted jnp
reference and its jax.grad (whose bf16 roundings XLA may fuse away, and
whose compiles cost the most: two cases each). Then
the shard identity in the port alone: the shards' partials summed, plus bo
and x, are the whole block's #9 twin, and #12's dx summed over the shards
plus g, with its weight grads joined, are #10's twin.

Tolerances, relative to the largest magnitude of each reference output:
- f32: 1e-5 for values, 1e-4 for gradients (both sides compute in f32 and
  fold the softmax scale into wq; the gradients add summation order over
  the products that follow);
- bf16: 2**-6 for #11's output (one bf16 rounding of the out-projection,
  after roundings of y, q, k, v, p and o at the same places on both sides:
  f32 summation order flips some of them), 2**-5 for #12's gradients (as
  tests/test_torch_grads.py: the flips compound through ds, dq/dk/dv and
  the products after them). The key bias's gradient is zero in exact
  arithmetic, so it is held relative to the query bias's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops import fused_attention as jfa
from openvision_tpu_torch.convert.openclip import shard_tensor, unshard_tensor
from openvision_tpu_torch.ops import fused_attention as tfa

D, HEADS, L = 128, 4, 21
MODES = [(False, 0), (True, 0), (True, 7)]  # unmasked, causal, prefix-LM
CASES = [(t, c, p) for t in (2, 4) for c, p in MODES]
F32_CASES = [(2, True, 7), (4, False, 0)]
BF16, F32 = torch.bfloat16, torch.float32


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() if scale is None else scale))


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return dict(x=n(b, L, D), w_qkv=n(3 * D, D, s=0.15), b_qkv=n(3 * D, s=0.1),
                w_o=n(D, D, s=0.15), b_o=n(D, s=0.1), ln=np.stack([1 + n(D, s=0.1), n(D, s=0.1)]),
                g=n(b, L, D))


def _shard(inp, rank, t):
    return (shard_tensor(inp["w_qkv"], "qkv", rank, t), shard_tensor(inp["b_qkv"], "qkv", rank, t),
            shard_tensor(inp["w_o"], "cols", rank, t))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax_args(inp, rank, t, dtype):
    """The JAX kernels' operands for one shard: (D, D/t) kernels, (2, D) ln,
    (3, D/t) biases."""
    w_qkv, b_qkv, w_o = _shard(inp, rank, t)
    dl = D // t
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    wq, wk, wv = (jnp.asarray(w_qkv[i * dl:(i + 1) * dl].T, jd) for i in range(3))
    return (jnp.asarray(inp["x"], jd), wq, wk, wv, jnp.asarray(w_o.T, jd),
            jnp.asarray(inp["ln"]), jnp.asarray(b_qkv.reshape(3, dl)))


def _port_args(inp, rank, t, dtype):
    w_qkv, b_qkv, w_o = _shard(inp, rank, t)
    return (_torch(inp["x"], dtype), _torch(inp["ln"][0], torch.float32),
            _torch(inp["ln"][1], torch.float32), _torch(w_qkv, dtype),
            _torch(b_qkv, torch.float32), _torch(w_o, dtype))


def _kw(t, causal, prefix):
    return dict(num_heads=HEADS // t, sm_scale=(D // HEADS) ** -0.5, causal=causal,
                prefix_len=prefix)


@pytest.mark.parametrize("t,causal,prefix", CASES)
def test_block_partial_twin_matches_pallas(t, causal, prefix):
    inp = _inputs()
    rank = t - 1
    jargs = _jax_args(inp, rank, t, BF16)
    kw = _kw(t, causal, prefix)
    want = jax.jit(lambda *a: jfa._block_partial_fwd_impl(
        *a, kw["num_heads"], kw["sm_scale"], causal, prefix, 1e-6, True))(*jargs)
    got = tfa.block_partial(*_port_args(inp, rank, t, BF16), **kw)
    assert got.dtype == BF16 and got.shape == (2, L, D)
    assert _rel(got.float(), jnp.asarray(want, jnp.float32)) <= 2**-6


@pytest.mark.parametrize("t,causal,prefix", F32_CASES)
def test_block_partial_twin_matches_reference(t, causal, prefix):
    """In f32 (jit lets XLA skip the jnp reference's bf16 roundings)."""
    inp = _inputs()
    rank = t - 1
    jargs = _jax_args(inp, rank, t, F32)
    kw = _kw(t, causal, prefix)
    ref = jax.jit(lambda *a: jfa._block_partial_reference(
        *a, kw["num_heads"], kw["sm_scale"], causal, 1e-6, prefix=prefix))(*jargs)
    got = tfa.block_partial(*_port_args(inp, rank, t, F32), **kw)
    assert _rel(got, ref) <= 1e-5


def _port_grads_as_jax(grads, t):
    """The port's (dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o) in the Pallas
    kernel's (dx, dwq, dwk, dwv, dwo, dln (2, D), db (3, D/t)) layout."""
    dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o = (g.float().numpy() for g in grads)
    dl = D // t
    return (dx, *(dw_qkv[i * dl:(i + 1) * dl].T for i in range(3)), dw_o.T,
            np.stack([dln_w, dln_b]), db_qkv.reshape(3, dl))


def _check_grads(got, want, tol):
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dln", "db")
    scale_bk = float(np.abs(np.asarray(want[6], np.float32)[0]).max())
    for name, a, b in zip(names, got, want):
        if name == "db":  # the key bias row against the query bias's scale
            b = np.asarray(b, np.float32)
            assert _rel(a[[0, 2]], b[[0, 2]]) <= tol, name
            assert _rel(a[1], b[1], scale_bk) <= tol, "dbk"
        else:
            assert _rel(a, b) <= tol, name


@pytest.mark.parametrize("t,causal,prefix", CASES)
def test_block_partial_bwd_twin_matches_pallas(t, causal, prefix):
    dtype, tol = BF16, 2**-5
    inp = _inputs(seed=1)
    rank = t - 1
    jargs = _jax_args(inp, rank, t, dtype)
    jd = jargs[0].dtype
    kw = _kw(t, causal, prefix)
    want = jax.jit(lambda x, g, *a: jfa._block_partial_bwd_impl(
        x, g, *a, kw["num_heads"], kw["sm_scale"], causal, prefix, 1e-6, True))(
        jargs[0], jnp.asarray(inp["g"], jd), *jargs[1:])
    want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in want]
    # the weight grads the TP block hands on: the f32 sums cast to the weights' dtype
    for i in range(1, 5):
        want[i] = np.asarray(jnp.asarray(jnp.asarray(want[i], jd), jnp.float32))
    grads = tfa.block_partial_bwd(*_port_args(inp, rank, t, dtype), _torch(inp["g"], dtype),
                                  **kw)
    assert grads[0].dtype == dtype and grads[3].dtype == dtype and grads[4].dtype == torch.float32
    _check_grads(_port_grads_as_jax(grads, t), want, tol)


@pytest.mark.parametrize("t,causal,prefix", F32_CASES)
def test_block_partial_bwd_twin_matches_jax_grad(t, causal, prefix):
    inp = _inputs(seed=2)
    rank = 0
    x, wq, wk, wv, wo, ln2, bqkv = _jax_args(inp, rank, t, torch.float32)
    kw = _kw(t, causal, prefix)
    g = jnp.asarray(inp["g"])

    def f(x, wq, wk, wv, wo, ln2, bqkv):
        out = jfa._block_partial_reference(x, wq, wk, wv, wo, ln2, bqkv, kw["num_heads"],
                                           kw["sm_scale"], causal, 1e-6, prefix=prefix)
        return jnp.sum(out * g)

    jg = jax.jit(jax.grad(f, argnums=tuple(range(7))))(x, wq, wk, wv, wo, ln2, bqkv)
    grads = tfa.block_partial_bwd(*_port_args(inp, rank, t, torch.float32),
                                  _torch(inp["g"], torch.float32), **kw)
    _check_grads(_port_grads_as_jax(grads, t), [np.asarray(a) for a in jg], 1e-4)


@pytest.mark.parametrize("dtype,fwd_tol,bwd_tol",
                         [(torch.float32, 1e-5, 1e-4), (torch.bfloat16, 2**-6, 2**-5)])
@pytest.mark.parametrize("t,causal,prefix", CASES)
def test_shards_sum_to_the_whole_block(t, causal, prefix, dtype, fwd_tol, bwd_tol):
    """Sum over the shards of #11, + bo + x, against #9's twin; #12's dx
    summed + g and its grads joined against #10's twin. In bf16 the whole
    block rounds its out-projection once and the shards each round theirs
    before the sum, a difference of one bf16 rounding per shard (held
    relative to the block's out - x, as chip_smoke.py holds #9)."""
    inp = _inputs(seed=3)
    x, g = _torch(inp["x"], dtype), _torch(inp["g"], dtype)
    ln_w, ln_b = _torch(inp["ln"][0], torch.float32), _torch(inp["ln"][1], torch.float32)
    b_o = _torch(inp["b_o"], dtype)
    whole = dict(num_heads=HEADS, causal=causal, prefix_len=prefix)
    want = tfa.fused_mhsa_block_plain(x, ln_w, ln_b, _torch(inp["w_qkv"], dtype),
                                      _torch(inp["b_qkv"], torch.float32),
                                      _torch(inp["w_o"], dtype), b_o, **whole)
    parts = [tfa.block_partial(*_port_args(inp, r, t, dtype), **_kw(t, causal, prefix))
             for r in range(t)]
    got = (x + sum(p.float() for p in parts).to(dtype)) + b_o
    assert _rel((got - x).float(), (want - x).float()) <= fwd_tol

    want_g = tfa.fused_mhsa_block_bwd_plain(x, ln_w, ln_b, _torch(inp["w_qkv"], dtype),
                                            _torch(inp["b_qkv"], torch.float32),
                                            _torch(inp["w_o"], dtype), b_o, g, **whole)
    shards = [tfa.block_partial_bwd(*_port_args(inp, r, t, dtype), g, **_kw(t, causal, prefix))
              for r in range(t)]
    dx = g.float() + sum(s[0].float() for s in shards)
    assert _rel(dx - g.float(), want_g[0].float() - g.float()) <= bwd_tol
    for i in (1, 2):  # the LayerNorm grads: a sum over the shards
        assert _rel(sum(s[i] for s in shards), want_g[i]) <= bwd_tol
    kinds = {3: "qkv", 4: "qkv", 5: "cols"}
    for i, kind in kinds.items():
        joined = unshard_tensor([s[i].float() for s in shards], kind)
        scale = None
        if i == 4:  # the key bias: zero in exact arithmetic
            scale = float(want_g[4][:D].abs().max())
        assert _rel(joined, want_g[i].float(), scale) <= bwd_tol, i
