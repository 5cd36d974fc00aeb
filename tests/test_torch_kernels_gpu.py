"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX, so it runs on a machine that has only PyTorch; the repo's
conftest imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Inputs are bf16, made with a seeded torch.Generator on the CPU; each plain
version runs in f32 from the same bf16 inputs. Tolerances, relative to the
largest magnitude of the reference output:
- layernorm and gemm_bias_act: 2**-7. The kernel rounds its output to bf16
  (at most 2**-9 relative), the residual add rounds once more, and the f32
  sums are taken in another order.
- attention and flash_attention: 2**-6. They also round the probabilities
  to bf16 before p.v. The flash LSE is f32 of the same bf16 scores: within
  1e-3 absolute.
- the composed blocks (several launches): 2**-5.
- the backward kernels against their plain versions, from the same inputs
  (the same o and logsumexp for attention): 2**-6 for the attention
  gradients (dS and P rounded to bf16 where a sum order flips a rounding),
  2**-7 for the bf16 GEMM and LayerNorm outputs, 2**-12 for f32 GEMM
  outputs and 1e-4 for f32 column sums (summation order only); the fused
  block's backward against the plain Pallas-order backward, and every
  autograd gradient against torch.autograd.grad of the plain f32 forward:
  2**-5, dx held on dx - g (what the backward adds to the residual).
The int8 serving kernels (``ops/fused_encoder_int8.py``) against their
plain versions on the same int8 or bf16 inputs: per-row scales within 2**-20
relative; int8 values equal except where an f32 value lies on a rounding
boundary, where they may differ by 1 (at most 0.1% of the values);
gemm_int8 bit-equal to its plain version without GELU (the int32 sums are
exact and the epilogue repeats the plain order), within 2**-12 relative
with GELU (tanh's last bits), its row max bit-equal to that of its own
output, and quant_rows given that max bit-equal to quant_rows alone; the
f32 attention output 2**-8 (summation order,
and a bf16 rounding of p that can flip); the int8 sub-blocks on out - x,
2**-6 of its max plus the residual add's rounding (2**-8 of |out|).
The tensor-parallel block kernels (#11, #12: one shard's rectangular
weights) as the fused block: 2**-6 for #11's partial (no residual), 2**-5
for each output of #12.
Under the causal and prefix-LM masks every query row sees key 0, so no row
is fully masked; the attention backward cases hold the dual instead: keys
that no query sees (causal, Lq < Lk) get exactly zero dk and dv.
"""

import pytest
import torch

from openvision_tpu_torch.ops import fused_attention as fa
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import fused_encoder_int8 as fe8
from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dev)


def _rel_err(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def _launches(**nonzero):
    """The full launch-count dict with the given nonzero entries."""
    return {**dict.fromkeys(kernels.LAUNCHES, 0), **nonzero}


# The row-stream LayerNorm kernels (csrc/layernorm.cu) take tiles of 16 rows,
# at most two blocks an SM: row counts below a tile, not a multiple of it,
# with fewer tiles than SMs, and 16448 / 29632 rows (b=64 at L=257 and the
# decoder's L=463) at every width of the port's tables up to 2048.
LN_ROWS = (1, 7, 37, 2 * 257, 64 * 257, 64 * 463)
LN_WIDTHS = (8, 192, 768, 1024, 1152, 1792, 2048)


def _ln_input(g, dev, rows, d, kind):
    """x for a LayerNorm case: "offset" is x * 0.05 + 40, where a two-pass
    variance and E[x^2] - mean^2 part; "view" is a contiguous view with a
    nonzero (16-byte aligned) storage offset."""
    x = _rand(g, dev, rows + (kind == "view"), d)
    x = x * 0.05 + 40 if kind == "offset" else x * 3 + 1
    return x.bfloat16()[1:] if kind == "view" else x.bfloat16()


def _on_side_stream(fn):
    """fn() launched on a stream other than the default one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,kind", [
    *[(r, d, "normal") for r in LN_ROWS for d in LN_WIDTHS],
    *[(2 * 257, d, "offset") for d in LN_WIDTHS],
    (37, 1024, "stream"), (64 * 257, 1024, "stream"), (37, 768, "view"), (2 * 257, 1024, "view"),
    (7, 2056, "too wide"),
])
def test_layernorm_kernel(dev, rows, d, kind):
    g = torch.Generator().manual_seed(rows + d)
    x = _ln_input(g, dev, rows, d, kind)
    w, b = _rand(g, dev, d) + 1, _rand(g, dev, d)
    with torch.inference_mode():
        if kind == "too wide":
            with pytest.raises(ValueError, match="at most 2048"):
                fe.layernorm(x, w, b, 1e-6)
            return
        if kind == "view":
            assert x.storage_offset() > 0 and x.is_contiguous()
        run = lambda: fe.layernorm(x, w, b, 1e-6)
        y = _on_side_stream(run) if kind == "stream" else run()
        ref = fe.layernorm_plain(x.float(), w, b, 1e-6)
        assert _rel_err(y, ref) <= 2**-7


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,gelu,res", [
    (2 * 257, 3 * 1024, 1024, False, False),  # QKV
    (2 * 257, 1024, 1024, False, True),       # out-proj + residual
    (2 * 257, 4096, 1024, True, False),       # fc1 + GELU
    (2 * 257, 1024, 4096, False, True),       # fc2 + residual
    (101, 4304, 1152, True, True),            # So400m MLP width: ragged N tile
    (5, 8, 40, False, False),                 # ragged K
])
def test_gemm_bias_act_kernel(dev, m, n, k, gelu, res):
    g = torch.Generator().manual_seed(m + n + k)
    x = _rand(g, dev, m, k).bfloat16()
    w = _rand(g, dev, n, k, scale=k**-0.5).bfloat16()
    b = _rand(g, dev, n, scale=0.1)
    r = _rand(g, dev, m, n).bfloat16() if res else None
    with torch.inference_mode():
        ref = fe.linear_plain(x.float(), w.float(), b, gelu=gelu,
                              residual=None if r is None else r.float())
        assert _rel_err(fe.gemm_bias_act(x, w, b, gelu=gelu, residual=r), ref) <= 2**-7


# Key tails of L mod 64 in {1, 8, 9, 15, 63}: the last key tile runs at
# wgmma N = 8, 8, 16, 16 and 64 (TMA's zero rows and the Lk mask pad it).
KEY_TAILS = [1, 8, 9, 15, 63]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(2, 257, 16), (3, 50, 4), (1, 1, 2), (1, 577, 4),
                                   *[(2, 128 + t, 4) for t in KEY_TAILS]])
@pytest.mark.parametrize("nomax", [False, True])
def test_attention_kernel(dev, b, l, h, nomax):
    g = torch.Generator().manual_seed(b * l * h)
    qkv = _rand(g, dev, b, l, 3 * h * 64).bfloat16()
    with torch.inference_mode():
        ref = fe.attention_plain(qkv.float(), h, nomax=nomax)
        assert _rel_err(fe.attention(qkv, h, nomax=nomax), ref) <= 2**-6


@pytest.mark.gpu
def test_sub_blocks_count_launches(dev):
    g = torch.Generator().manual_seed(0)
    d, h = 256, 4
    x = _rand(g, dev, 2, 257, d).bfloat16()
    ln_w, ln_b = _rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1
    w_qkv, b_qkv = _rand(g, dev, 3 * d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, 3 * d, scale=0.1)
    w_o, b_o = _rand(g, dev, d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, d, scale=0.1)
    w1, b1 = _rand(g, dev, 4 * d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, 4 * d, scale=0.1)
    w2, b2 = _rand(g, dev, d, 4 * d, scale=(4 * d)**-0.5).bfloat16(), _rand(g, dev, d, scale=0.1)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        y = fe.mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads=h)
        y = fe.mlp_block(y, ln_w, ln_b, w1, b1, w2, b2)
        ref = fe.mhsa_block_plain(x.float(), ln_w, ln_b, w_qkv.float(), b_qkv, w_o.float(), b_o,
                                  num_heads=h)
        ref = fe.mlp_block_plain(ref, ln_w, ln_b, w1.float(), b1, w2.float(), b2)
    assert kernels.LAUNCHES == _launches(layernorm=2, gemm_bias_act=4, attention=1)
    # two sub-blocks compound the per-kernel roundings
    assert _rel_err(y, ref) <= 2**-5


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fe.gemm_bias_act(x, torch.zeros(12, 16, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        fe.gemm_bias_act(x.float(), torch.zeros(8, 16, device=dev))
    with pytest.raises(ValueError, match="head_dim 64"):
        fe.attention(torch.zeros(1, 4, 3 * 96, device=dev, dtype=torch.bfloat16), 3)
    w = torch.ones(16, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fe.layernorm(x, w, torch.zeros(16, device=dev), 1e-6)
    d, f32 = 128, dict(device=dev)
    with pytest.raises(ValueError, match="power-of-two"):
        fa.fused_mhsa_block(
            torch.zeros(1, 4, d, device=dev, dtype=torch.bfloat16), torch.ones(d, **f32),
            torch.zeros(d, **f32), torch.zeros(3 * d, d, device=dev, dtype=torch.bfloat16),
            torch.zeros(3 * d, **f32), torch.zeros(d, d, device=dev, dtype=torch.bfloat16),
            torch.zeros(d, **f32), num_heads=2, sm_scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h,prefix", [
    (2, 463, 12, 335),  # concat decoder: prefix-LM
    (2, 128, 12, 0),    # cross_attn decoder self-attention: causal
    (3, 101, 4, 37),    # ragged, prefix inside a key tile
    (1, 70, 2, 200),    # prefix past L: every key visible
    (1, 1, 2, 0),
    *[(2, 128 + t, 4, 70) for t in KEY_TAILS],
])
def test_attention_kernel_causal_and_prefix_masks(dev, b, l, h, prefix):
    g = torch.Generator().manual_seed(b * l + prefix)
    qkv = _rand(g, dev, b, l, 3 * h * 64).bfloat16()
    with torch.inference_mode():
        ref = fe.attention_plain(qkv.float(), h, causal=True, prefix_len=prefix)
        got = fe.attention(qkv, h, causal=True, prefix_len=prefix)
    assert _rel_err(got, ref) <= 2**-6


@pytest.mark.gpu
@pytest.mark.parametrize("l,d,h,causal,prefix", [
    (257, 1024, 16, False, 0), (463, 768, 12, True, 335), (128, 768, 12, True, 0),
])
def test_fused_mhsa_block_counts_launches(dev, l, d, h, causal, prefix):
    g = torch.Generator().manual_seed(l)
    x = _rand(g, dev, 2, l, d).bfloat16()
    ln_w, ln_b = _rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1
    w_qkv = _rand(g, dev, 3 * d, d, scale=d**-0.5).bfloat16()
    b_qkv = _rand(g, dev, 3 * d, scale=0.1)
    w_o, b_o = _rand(g, dev, d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, d, scale=0.1)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        y = fa.fused_mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads=h,
                                causal=causal, prefix_len=prefix)
        ref = fa.fused_mhsa_block_plain(x.float(), ln_w, ln_b, w_qkv.float(), b_qkv,
                                        w_o.float(), b_o, num_heads=h, causal=causal,
                                        prefix_len=prefix)
    assert kernels.LAUNCHES == _launches(layernorm=1, gemm_bias_act=2, attention=1)
    assert _rel_err(y, ref) <= 2**-5


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h,causal,prefix", [
    (2, 128, 335, 12, False, 0),   # cross-attention, Lq != Lk
    (2, 463, 463, 12, True, 335),  # concat decoder, prefix-LM
    (2, 128, 128, 12, True, 0),    # causal self-attention
    (3, 101, 101, 4, True, 37),    # ragged
    (2, 80, 40, 2, True, 0),       # causal with Lq > Lk
    (1, 780, 780, 2, True, 340),   # multi-k rounding order (Lk > 768), prefix-LM
    (2, 50, 900, 2, False, 0),     # multi-k, cross-attention
    *[(2, 70, 64 + t, 3, False, 0) for t in KEY_TAILS],
    *[(2, 200, 128 + t, 2, True, 0) for t in KEY_TAILS],  # Lq > Lk causal
    (2, 150, 40, 2, True, 17),    # Lq > Lk, prefix-LM
    (2, 90, 90, 2, True, 300),    # a prefix past L: every key visible
    (3, 1, 1, 2, False, 0),       # L = 1
    (2, 1, 900, 2, False, 0),     # one query, multi-k order
    (2, 129, 1, 2, True, 0),      # one key
])
def test_flash_attention_kernel(dev, b, lq, lk, h, causal, prefix):
    g = torch.Generator().manual_seed(lq * lk + prefix)
    q = _rand(g, dev, b, lq, h, 64).bfloat16()
    kv = _rand(g, dev, b, lk, 2, h, 64).bfloat16()  # k and v as strided views
    k, v = kv[:, :, 0], kv[:, :, 1]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        o, lse = flash_attention(q, k, v, causal=causal, prefix_len=prefix, return_lse=True)
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                             prefix_len=prefix)
    assert kernels.LAUNCHES["flash_attention"] == 1
    assert _rel_err(o, ref) <= 2**-6
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 73, 257])
def test_attention_kernel_nomax_clamp(dev, l):
    """Scores above 80 (inputs scaled by 8: |q.k| / 8 reaches a few
    hundred), so exp(min(s, 80)) clamps, on both entry points; the LSE is
    then log(l)."""
    g = torch.Generator().manual_seed(l + 80)
    qkv = (_rand(g, dev, 2, l, 3 * 2 * 64) * 8).bfloat16()
    with torch.inference_mode():
        ref = fe.attention_plain(qkv.float(), 2, nomax=True)
        got = fe.attention(qkv, 2, nomax=True)
        q, k, v = (t.reshape(2, l, 2, 64) for t in qkv.split(128, dim=-1))
        assert (torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8).max().item() > 80
        from openvision_tpu_torch.ops import flash_attention as fl

        o, lse = fl._forward(q, k, v, causal=False, prefix_len=0, sm_scale=None,
                             return_lse=True, nomax=True)
        ref_o, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), nomax=True)
    assert _rel_err(got, ref) <= 2**-6
    assert _rel_err(o, ref_o) <= 2**-6
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_attention_kernels_at_a_scale_that_is_no_power_of_two(dev, causal):
    """A power-of-two scale (head_dim 64's 2**-3) goes into the exponent;
    any other takes the single-k order's pass over Q (q * scale rounded to
    bf16), on both entry points. The plain versions get the bf16 tensors,
    so that they round q * scale to bf16 too (in f32 they would not, and
    the LSE would move by ~2**-9 of the scores)."""
    g = torch.Generator().manual_seed(10)
    qkv = _rand(g, dev, 2, 150, 3 * 2 * 64).bfloat16()
    q, k, v = (t.reshape(2, 150, 2, 64) for t in qkv.split(128, dim=-1))
    with torch.inference_mode():
        got = fe.attention(qkv, 2, causal=causal, prefix_len=20, scale=0.1)
        ref = fe.attention_plain(qkv, 2, causal=causal, prefix_len=20, scale=0.1,
                                 out_dtype=torch.float32)
        o, lse = flash_attention(q, k, v, causal=causal, prefix_len=20, sm_scale=0.1,
                                 return_lse=True)
        ref_o, ref_lse = flash_attention_plain(q, k, v, causal=causal, prefix_len=20,
                                               sm_scale=0.1)
        ref_o = ref_o.float()
    assert _rel_err(got, ref) <= 2**-6
    assert _rel_err(o, ref_o) <= 2**-6
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_forward_attention_kernels_are_deterministic(dev):
    g = torch.Generator().manual_seed(9)
    qkv = _rand(g, dev, 2, 257, 3 * 4 * 64).bfloat16()
    q = _rand(g, dev, 2, 128, 4, 64).bfloat16()
    kv = _rand(g, dev, 2, 335, 2, 4, 64).bfloat16()
    with torch.inference_mode():
        runs = [(fe.attention(qkv, 4), fe.attention(qkv, 4, nomax=True, out_dtype=torch.float32),
                 fe.attention(qkv, 4, causal=True, prefix_len=100),
                 *flash_attention(q, kv[:, :, 0], kv[:, :, 1], return_lse=True))
                for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        flash_attention(*(torch.zeros(1, 8, 2, 96, device=dev, dtype=torch.bfloat16),) * 3)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(q, q.transpose(-1, -2).contiguous().transpose(-1, -2), q)
    with pytest.raises(ValueError, match="return_lse"):
        flash_attention(q, q, q.clone().requires_grad_(True), return_lse=True)


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------


ATTN_BWD_CASES = [
    (2, 128, 335, 12, False, 0),   # cross-attention, Lq != Lk
    (2, 463, 463, 12, True, 335),  # concat decoder, prefix-LM
    (2, 128, 128, 12, True, 0),    # causal self-attention
    (3, 101, 101, 4, True, 37),    # ragged, prefix inside a key tile
    (2, 70, 70, 2, False, 0),      # Lk not a multiple of 64
    (2, 64, 200, 2, True, 0),      # causal with Lq < Lk: keys 64.. seen by no query
    (2, 50, 900, 2, False, 0),     # multi-k
    (2, 257, 257, 16, False, 0),   # the image tower: a one-row tail tile (N = 8) on both axes
    (2, 129, 129, 4, True, 0),     # causal with a one-row tail tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h,causal,prefix", ATTN_BWD_CASES)
def test_attention_bwd_kernels(dev, b, lq, lk, h, causal, prefix):
    g = torch.Generator().manual_seed(lq * lk + prefix + 1)
    q = _rand(g, dev, b, lq, h, 64).bfloat16()
    kv = _rand(g, dev, b, lk, 2, h, 64).bfloat16()
    k, v = kv[:, :, 0], kv[:, :, 1]
    do = _rand(g, dev, b, lq, h, 64).bfloat16()
    with torch.inference_mode():
        o, lse = flash_attention(q, k, v, causal=causal, prefix_len=prefix, return_lse=True)
        kernels.reset_launch_counts()
        got = gk.attention_bwd(q, k, v, o, lse, do, scale=0.125, causal=causal,
                               prefix_len=prefix)
        torch.cuda.synchronize()
        ref = gk.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), scale=0.125, causal=causal, prefix_len=prefix)
    assert kernels.LAUNCHES == _launches(attention_bwd_dq=1, attention_bwd_dkv=1)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, r) <= 2**-6, name
    if causal and lk > lq:  # keys no query sees get no gradient
        assert not got[1][:, lq:].any() and not got[2][:, lq:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h,causal,prefix", [ATTN_BWD_CASES[i] for i in (0, 1, 7, 8)])
def test_attention_bwd_kernels_are_deterministic(dev, b, lq, lk, h, causal, prefix):
    """Two calls on the same inputs give bit-equal dq, dk and dv: no atomics,
    each output row summed by one warpgroup in a fixed order."""
    g = torch.Generator().manual_seed(lq + lk + h)
    q, k, v, do = (_rand(g, dev, b, n, h, 64).bfloat16() for n in (lq, lk, lk, lq))
    with torch.inference_mode():
        o, lse = flash_attention(q, k, v, causal=causal, prefix_len=prefix, return_lse=True)
        kw = dict(scale=0.125, causal=causal, prefix_len=prefix)
        first = gk.attention_bwd(q, k, v, o, lse, do, **kw)
        second = gk.attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,heads", [(2, 257, 16), (3, 80, 12)])
def test_attention_bwd_kernels_on_qkv_views_nomax(dev, b, l, heads):
    """The fused blocks' layout under nomax: q, k and v strided views of one
    (B, L, 3D) QKV buffer, dq, dk and dv written into views of one dqkv
    buffer (as ``_backward_kernels`` passes them), against the plain version
    on the same views; the dqkv buffer's other bytes are left alone."""
    from openvision_tpu_torch.ops import flash_attention as fl

    d = heads * 64
    g = torch.Generator().manual_seed(l + heads)
    qkv = _rand(g, dev, b, l, 3 * d, scale=3.0).bfloat16()
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, l, heads, 64) for i in range(3))
    do = _rand(g, dev, b, l, heads, 64).bfloat16()
    with torch.inference_mode():
        o, lse = fl._forward(q, k, v, causal=False, prefix_len=0, sm_scale=None,
                             return_lse=True, nomax=True)
        dqkv = torch.full((b, l, 3 * d + 64), 7.0, dtype=torch.bfloat16, device=dev)
        outs = [dqkv[..., i * d:(i + 1) * d].view(b, l, heads, 64) for i in range(3)]
        kernels.reset_launch_counts()
        got = gk.attention_bwd(q, k, v, o, lse, do, scale=0.125, nomax=True, dq=outs[0],
                               dk=outs[1], dv=outs[2])
        torch.cuda.synchronize()
        ref = gk.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), scale=0.125, nomax=True)
    assert kernels.LAUNCHES == _launches(attention_bwd_dq=1, attention_bwd_dkv=1)
    for name, a, out, r in zip(("dq", "dk", "dv"), got, outs, ref):
        assert a.data_ptr() == out.data_ptr(), name
        assert _rel_err(a, r) <= 2**-6, name
    assert bool((dqkv[..., 3 * d:] == 7.0).all())


@pytest.mark.gpu
def test_tensor_map_kernels_run_first_on_a_fresh_thread(dev):
    """A kernel whose wrapper encodes TMA tensor maps may be a thread's first
    CUDA call (autograd runs a backward, and the backward chains' recompute
    of the forward, on a thread of its own): the forward attention kernel
    through both entry points, the attention backward pair and a GEMM of the
    Hopper family, each called first on a new thread, give what they give on
    this one."""
    import threading

    g = torch.Generator().manual_seed(5)
    q, k, v, do = (_rand(g, dev, 2, 128, 4, 64).bfloat16() for _ in range(4))
    qkv = _rand(g, dev, 2, 77, 3 * 4 * 64).bfloat16()
    a, w = _rand(g, dev, 300, 256).bfloat16(), _rand(g, dev, 256, 512).bfloat16()
    calls = [lambda: flash_attention(q, k, v, return_lse=True),
             lambda: (fe.attention(qkv, 4),),
             lambda: gk.attention_bwd(q, k, v, o, lse, do, scale=0.125),
             lambda: (gk.gemm_nn(a, w),)]
    with torch.inference_mode():
        o, lse = flash_attention(q, k, v, return_lse=True)
        here = [call() for call in calls]
        torch.cuda.synchronize()
    for call, want in zip(calls, here):
        there = []

        def run():
            with torch.inference_mode():
                there.extend(call())
                torch.cuda.synchronize()

        thread = threading.Thread(target=run)  # a new thread: its first CUDA call is `call`
        thread.start()
        thread.join()
        assert len(there) == len(want)
        for x, y in zip(want, there):
            assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,h,causal,prefix", ATTN_BWD_CASES[:4])
def test_flash_function_matches_autograd_of_the_plain_forward(dev, b, lq, lk, h, causal, prefix):
    from openvision_tpu_torch.ops.fused_encoder import attend_plain

    g = torch.Generator().manual_seed(lq + lk + prefix)
    q, k, v = (_rand(g, dev, b, n, h, 64).bfloat16() for n in (lq, lk, lk))
    do = _rand(g, dev, b, lq, h, 64).bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = flash_attention(*leaves, causal=causal, prefix_len=prefix)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _launches(flash_attention=1, attention_bwd_dq=1,
                                         attention_bwd_dkv=1)
    ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref_out, _ = attend_plain(*ref_leaves, scale=0.125, causal=causal, prefix_len=prefix)
    ref = torch.autograd.grad(ref_out, ref_leaves, do.float())
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16
        assert _rel_err(a, r) <= 2**-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(2 * 257, 3 * 256, 256), (101, 256, 768), (37, 40, 24)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_gemm_nn_kernel(dev, m, n, k, out_dtype):
    g = torch.Generator().manual_seed(m + n + k)
    a = _rand(g, dev, m, n).bfloat16()
    w = _rand(g, dev, n, k, scale=n**-0.5).bfloat16()
    with torch.inference_mode():
        got = gk.gemm_nn(a, w, out_dtype)
        ref = gk.gemm_nn_plain(a, w, torch.float32)
    assert got.dtype == out_dtype and got.shape == (m, k)
    assert _rel_err(got, ref) <= (2**-7 if out_dtype == torch.bfloat16 else 2**-12)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", [
    (8 * 257, 3 * 1024, 1024),  # dW_qkv at the image tower's width
    (8 * 463, 768, 768),        # dWo at the decoder's width: split over rows
    (101, 40, 24),              # ragged rows, one split
    (5000, 256, 128),           # many splits, a ragged last split
])
def test_gemm_tn_kernel(dev, rows, n, k):
    g = torch.Generator().manual_seed(rows + n + k)
    dc = _rand(g, dev, rows, n).bfloat16()
    x = _rand(g, dev, rows, k).bfloat16()
    with torch.inference_mode():
        got = gk.gemm_tn(dc, x)
        ref = gk.gemm_tn_plain(dc, x, torch.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (n, k)
    assert _rel_err(got, ref) <= 2**-7


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,residual", [(2 * 257, 1024, True), (37, 768, False), (5, 72, True)])
def test_layernorm_bwd_kernel(dev, rows, d, residual):
    gen = torch.Generator().manual_seed(rows + d)
    x = (_rand(gen, dev, rows, d) * 3 + 1).bfloat16()
    gamma = _rand(gen, dev, d) * 0.1 + 1
    dy = _rand(gen, dev, rows, d)
    g = _rand(gen, dev, rows, d).bfloat16() if residual else None
    with torch.inference_mode():
        kernels.reset_launch_counts()
        dx, dvec = gk.layernorm_bwd(x, gamma, dy, g, eps=1e-6)
        torch.cuda.synchronize()
        ref_dx, ref_dvec = gk.layernorm_bwd_plain(x.float(), gamma, dy, None, eps=1e-6)
    assert kernels.LAUNCHES == _launches(layernorm_bwd=1)
    added = dx.float() - (g.float() if residual else 0)
    assert _rel_err(added, ref_dx) <= 2**-6  # dx rounded once; dx - g once more
    assert _rel_err(dvec, ref_dvec) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,seg,round_bf16,dtype", [
    (8 * 257, 3 * 1024, 257, True, torch.bfloat16),  # dbq/dbk/dbv per image
    (8 * 257, 1024, 257, False, torch.bfloat16),     # dbo
    (300, 40, None, False, torch.float32),
])
def test_colsum_kernel(dev, rows, n, seg, round_bf16, dtype):
    g = torch.Generator().manual_seed(rows + n)
    t = _rand(g, dev, rows, n).to(dtype)
    with torch.inference_mode():
        got = gk.colsum(t, seg, round_bf16)
        ref = gk.colsum_plain(t, seg, round_bf16)
    assert _rel_err(got, ref) <= (2**-7 if round_bf16 else 1e-4)


def _block_inputs(g, dev, b, l, d):
    x = _rand(g, dev, b, l, d).bfloat16()
    w = [_rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1,
         _rand(g, dev, 3 * d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, 3 * d, scale=0.1),
         _rand(g, dev, d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, d, scale=0.1)]
    return x, w, _rand(g, dev, b, l, d).bfloat16()


BLOCK_CASES = [(2, 257, 256, 4, False, 0), (2, 463, 256, 4, True, 335),
               (2, 128, 256, 4, True, 0), (3, 101, 128, 2, True, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,h,causal,prefix", BLOCK_CASES)
def test_fused_block_backward_kernels(dev, b, l, d, h, causal, prefix):
    from openvision_tpu_torch.ops.fused_attention import _backward_kernels

    g = torch.Generator().manual_seed(l + d)
    x, w, dout = _block_inputs(g, dev, b, l, d)
    kw = dict(num_heads=h, sm_scale=None, causal=causal, prefix_len=prefix, eps=1e-6)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = _backward_kernels(x, *w, dout, **kw)
        torch.cuda.synchronize()
        ref = fa.fused_mhsa_block_bwd_plain(x, *w, dout, **kw)
    assert kernels.LAUNCHES == _launches(
        layernorm=1, gemm_bias_act=1, flash_attention=1, gemm_nn=2, attention_bwd_dq=1,
        attention_bwd_dkv=1, gemm_tn=2, layernorm_bwd=1, colsum=2)
    names = ("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o", "db_o")
    for name, a, r in zip(names, got, ref):
        assert a.dtype == r.dtype, name
        if name == "dx":
            a, r = a.float() - dout.float(), r.float() - dout.float()
        assert _rel_err(a, r.float()) <= 2**-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,h,causal,prefix", BLOCK_CASES[:3])
def test_fused_block_function_matches_autograd_of_the_plain_forward(dev, b, l, d, h, causal,
                                                                    prefix):
    g = torch.Generator().manual_seed(l * d)
    x, w, dout = _block_inputs(g, dev, b, l, d)
    kw = dict(num_heads=h, causal=causal, prefix_len=prefix)
    leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
    got = torch.autograd.grad(fa.fused_mhsa_block(*leaves, **kw), leaves, dout)
    ref_leaves = [t.float().requires_grad_(True) for t in (x, *w)]
    ref = torch.autograd.grad(fa.fused_mhsa_block_plain(*ref_leaves, **kw), ref_leaves,
                              dout.float())
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == (x, *w)[i].dtype
        if i == 0:
            a, r = a.float() - dout.float(), r - dout.float()
        assert _rel_err(a, r) <= 2**-5, i


@pytest.mark.gpu
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = torch.zeros(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        gk.gemm_nn(a, torch.zeros(16, 12, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        gk.gemm_tn(a.float(), a.float())
    with pytest.raises(ValueError, match="whole segments"):
        gk.colsum(a, seg_len=3)
    with pytest.raises(ValueError, match="head_dim 64"):
        q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
        gk.attention_bwd(q, q, q, q, torch.zeros(1, 2, 8, device=dev), q, scale=0.125)


# ---------------------------------------------------------------------------
# int8 serving kernels
# ---------------------------------------------------------------------------


def _check_quant(q, scale, q_ref, scale_ref, max_flips=1e-3):
    assert q.dtype == torch.int8 and q.shape == q_ref.shape
    rel = ((scale - scale_ref).abs() / scale_ref.abs()).max().item()
    assert rel <= 2**-20, rel
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1
    assert diff.count_nonzero().item() <= max(1, max_flips * q.numel())


def _int8_rows(g, dev, m, k):
    return torch.randint(-127, 128, (m, k), generator=g).to(torch.int8).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,kind", [
    *[(r, d, "normal") for r in LN_ROWS for d in LN_WIDTHS],
    # At x * 0.05 + 40 the f32 sum of x^2 rounds once it passes 2**20
    # (d >= 768 here), and E[x^2] - mean^2 then moves with the summation
    # order by up to twice the variance: no two orders agree to 2**-20. The
    # offset cases take the widths whose sums are exact and whose mean is a
    # division by a power of two, where the kernel and the plain version
    # must agree and the two-pass variance must not.
    (2 * 257, 256, "offset"), (2 * 257, 512, "offset"),
    (37, 1024, "stream"), (64 * 257, 1024, "stream"), (37, 768, "view"), (2 * 257, 1024, "view"),
    (7, 2056, "too wide"),
])
def test_layernorm_quant_kernel(dev, rows, d, kind):
    g = torch.Generator().manual_seed(rows + d)
    x = _ln_input(g, dev, rows, d, kind)
    w, b = _rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1
    with torch.inference_mode():
        if kind == "too wide":
            with pytest.raises(ValueError, match="at most 2048"):
                fe8.layernorm_quant(x, w, b, 1e-6)
            return
        if kind == "view":
            assert x.storage_offset() > 0 and x.is_contiguous()
        run = lambda: fe8.layernorm_quant(x, w, b, 1e-6)
        q, scale = _on_side_stream(run) if kind == "stream" else run()
        _check_quant(q, scale, *fe8.layernorm_quant_plain(x, w, b, 1e-6))
        if kind == "offset":  # a two-pass variance gives other scales
            _, two_pass = fe8.quant_plain(fe.layernorm_plain(x.float(), w, b, 1e-6))
            assert ((two_pass - scale).abs() / scale).max().item() > 2**-20


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(2 * 257, 1024), (2 * 257, 4096), (3, 8)])
def test_quant_rows_kernel(dev, rows, n):
    g = torch.Generator().manual_seed(rows + n)
    x = _rand(g, dev, rows, n) * 2
    x[0] = 0  # an all-zero row takes scale 1
    with torch.inference_mode():
        q, scale = fe8.quant_rows(x)
        _check_quant(q, scale, *fe8.quant_plain(x))
        # with the row max given, the row is read once: the same bits
        q1, scale1 = fe8.quant_rows(x, x.abs().amax(-1))
    assert scale[0].item() == 1.0 and q[0].abs().max().item() == 0
    assert torch.equal(q1, q) and torch.equal(scale1, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_n", [0, 128, 256])
@pytest.mark.parametrize("m,n,k,gelu,out,res", [
    (1000, 3 * 1024, 1024, False, torch.bfloat16, False),  # QKV
    (1000, 1024, 1024, False, torch.bfloat16, True),       # out-proj + residual
    (1000, 4096, 1024, True, torch.float32, False),        # fc1 + GELU, f32 hidden
    (1000, 1024, 4096, False, torch.bfloat16, True),       # fc2 + residual
    (64, 768, 1024, False, torch.float32, False),          # the head at b=64
    (5, 768, 1024, False, torch.float32, False),           # the head at b=5
    (257, 776, 1040, False, torch.bfloat16, True),         # ragged M, N and K
    (257, 776, 1040, True, torch.float32, False),
    (64, 1024, 4096, False, torch.bfloat16, False),
    (37, 40, 48, False, torch.float32, False),
])
def test_gemm_int8_kernel(dev, m, n, k, gelu, out, res, tile_n):
    """Bit-equal to the plain version without GELU (exact int32 sums, the
    plain epilogue's order); with GELU within 2**-12 (tanh's last bits),
    and the row max bit-equal to that of the kernel's own output."""
    g = torch.Generator().manual_seed(m + n + k)
    a, w = _int8_rows(g, dev, m, k), _int8_rows(g, dev, n, k)
    a_s = (torch.rand(m, generator=g) * 0.05 + 1e-3).to(dev)
    w_s = (torch.rand(n, generator=g) * k**-0.5 / 127 + 1e-5).to(dev)
    b = _rand(g, dev, n, scale=0.1)
    r = _rand(g, dev, m, n).bfloat16() if res else None
    with torch.inference_mode():
        got = fe8._gemm_int8(a, a_s, w, w_s, b, gelu=gelu, out_dtype=out, residual=r,
                             row_amax=gelu, tile_n=tile_n)
        ref = fe8.gemm_int8_plain(a, a_s, w, w_s, b, gelu=gelu, out_dtype=out, residual=r)
    if gelu:
        got, amax = got
        assert torch.equal(amax, got.abs().amax(-1))
        assert _rel_err(got, ref.float()) <= 2**-12
    else:
        assert torch.equal(got, ref)
    assert got.dtype == out


@pytest.mark.gpu
@pytest.mark.parametrize("b,l", [(2, 257), (3, 101), (2, 73), (2, 129), (2, 191)])
def test_attention_kernel_f32_output(dev, b, l):
    g = torch.Generator().manual_seed(b * l)
    qkv = _rand(g, dev, b, l, 3 * 16 * 64).bfloat16()
    with torch.inference_mode():
        got = fe.attention(qkv, 16, nomax=True, out_dtype=torch.float32)
        ref = fe.attention_plain(qkv, 16, nomax=True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel_err(got, ref) <= 2**-8


@pytest.mark.gpu
def test_int8_sub_blocks_count_launches(dev):
    from openvision_tpu_torch.serving.quant import quant_w

    g = torch.Generator().manual_seed(0)
    d, h = 256, 4
    x = _rand(g, dev, 2, 257, d).bfloat16()
    ln_w, ln_b = _rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1
    wqkv, wo = quant_w(_rand(g, dev, 3 * d, d, scale=d**-0.5)), quant_w(_rand(g, dev, d, d))
    w1, w2 = quant_w(_rand(g, dev, 4 * d, d)), quant_w(_rand(g, dev, d, 4 * d, scale=0.1))
    bqkv, bo, b1, b2 = (_rand(g, dev, n, scale=0.1) for n in (3 * d, d, 4 * d, d))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        y = fe8.mhsa_t_int8(x, ln_w, ln_b, *wqkv, bqkv, *wo, bo, num_heads=h)
        assert kernels.LAUNCHES == _launches(layernorm_quant=1, gemm_int8=2, attention=1,
                                             quant_rows=1)
        ref = fe8.mhsa_t_int8_plain(x, ln_w, ln_b, *wqkv, bqkv, *wo, bo, num_heads=h)
        z = fe8.mlp_t_int8(y, ln_w, ln_b, *w1, b1, *w2, b2)
        z_ref = fe8.mlp_t_int8_plain(y, ln_w, ln_b, *w1, b1, *w2, b2)
    assert kernels.LAUNCHES == _launches(layernorm_quant=2, gemm_int8=4, attention=1,
                                         quant_rows=2)
    for got, want, inp in ((y, ref, x), (z, z_ref, y)):
        add = (want.float() - inp.float()).abs().max()
        err = (got.float() - want.float()).abs()
        assert (err <= 2**-6 * add + 2**-8 * want.float().abs()).all()


@pytest.mark.gpu
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    a = torch.zeros(4, 40, device=dev, dtype=torch.int8)
    s4, s8 = torch.ones(4, device=dev), torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="K of 16"):
        fe8.gemm_int8(a, s4, torch.zeros(8, 40, device=dev, dtype=torch.int8), s8)
    w32 = torch.zeros(8, 32, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="f32 GELU output"):
        fe8.gemm_int8(a[:, :32], s4, w32, s8, row_amax=True)
    with pytest.raises(ValueError, match="tile_n"):
        fe8._gemm_int8(a[:, :32], s4, w32, s8, tile_n=64)
    with pytest.raises(ValueError, match="GELU into bf16"):
        fe8._gemm_int8(a[:, :32], s4, w32, s8, gelu=True, tile_n=256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fe8.gemm_int8(torch.zeros(4 * 32 + 8, device=dev, dtype=torch.int8)[8:].view(4, 32), s4,
                      w32, s8)
    with pytest.raises(TypeError, match="int8"):
        fe8.gemm_int8(a[:, :32].float(), s4, torch.zeros(8, 32, device=dev, dtype=torch.int8), s8)
    with pytest.raises(ValueError, match="bf16 with a residual"):
        fe8.gemm_int8(a[:, :32], s4, torch.zeros(8, 32, device=dev, dtype=torch.int8), s8,
                      out_dtype=torch.float32,
                      residual=torch.zeros(4, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="at most 2048"):
        fe8.layernorm_quant(torch.zeros(2, 4096, device=dev, dtype=torch.bfloat16),
                            torch.ones(4096, device=dev), torch.zeros(4096, device=dev), 1e-6)
    with pytest.raises(ValueError, match="f32 unmasked"):
        fe.attention(torch.zeros(1, 4, 3 * 128, device=dev, dtype=torch.bfloat16), 2,
                     causal=True, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Training on fused_t (#3, #4) and on LayerScale / drop-path blocks (#7, #8)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(2, 257, 4), (3, 80, 12), (2, 101, 2)])
def test_attention_bwd_kernels_nomax(dev, b, l, h):
    """The nomax flash forward (lse = log l) and the backward's recompute of
    P as exp(min(s, 80) - lse), against the plain versions."""
    from openvision_tpu_torch.ops import flash_attention as fl

    g = torch.Generator().manual_seed(l + h)
    q, k, v, do = (_rand(g, dev, b, l, h, 64, scale=3.0).bfloat16() for _ in range(4))
    with torch.inference_mode():
        o, lse = fl._forward(q, k, v, causal=False, prefix_len=0, sm_scale=None,
                             return_lse=True, nomax=True)
        o_ref, lse_ref = fl.flash_attention_plain(q.float(), k.float(), v.float(), nomax=True)
        assert _rel_err(o, o_ref) <= 2**-6
        assert (lse - lse_ref).abs().max().item() <= 1e-3
        kernels.reset_launch_counts()
        got = gk.attention_bwd(q, k, v, o, lse, do, scale=0.125, nomax=True)
        torch.cuda.synchronize()
        ref = gk.attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), scale=0.125, nomax=True)
    assert kernels.LAUNCHES == _launches(attention_bwd_dq=1, attention_bwd_dkv=1)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel_err(a, r) <= 2**-6, name


# The Hopper GEMM family (csrc/hopper.cuh) at ragged shapes: M of 1000 and
# 16448 + 1 (a partial 128-row tile), every N and K the callers use from
# 256 to 4096 in each role; each layout and epilogue against its plain twin.
WIDTHS = [(256, 4096), (768, 1536), (1024, 1024), (1536, 768), (3072, 256), (4096, 3072)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1000, 16449])
@pytest.mark.parametrize("i,nk", list(enumerate(WIDTHS)))
def test_gemm_family_forward_layout(dev, m, i, nk):
    """A . W^T: bias, GELU and the residual in turn (both K-major)."""
    n, k = nk
    gelu, res, bias = i % 2 == 0, i % 3 == 0, i != 5
    g = torch.Generator().manual_seed(m + i)
    x = _rand(g, dev, m, k).bfloat16()
    w = _rand(g, dev, n, k, scale=k**-0.5).bfloat16()
    b = _rand(g, dev, n, scale=0.1) if bias else None
    r = _rand(g, dev, m, n).bfloat16() if res else None
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = fe.gemm_bias_act(x, w, b, gelu=gelu, residual=r)
        torch.cuda.synchronize()
        ref = fe.linear_plain(x.float(), w.float(), b, gelu=gelu,
                              residual=None if r is None else r.float())
    assert kernels.LAUNCHES == _launches(gemm_bias_act=1)
    assert _rel_err(got, ref) <= 2**-7


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1000, 16449])
@pytest.mark.parametrize("i,nk", list(enumerate(WIDTHS)))
def test_gemm_family_nn_layout(dev, m, i, nk):
    """dC . W with W (K, N) MN-major, bf16 and f32 out in turn."""
    n, k = nk
    out_dtype = torch.float32 if i % 2 else torch.bfloat16
    g = torch.Generator().manual_seed(2 * m + i)
    a = _rand(g, dev, m, n).bfloat16()
    w = _rand(g, dev, n, k, scale=n**-0.5).bfloat16()
    with torch.inference_mode():
        got = gk.gemm_nn(a, w, out_dtype)
        ref = gk.gemm_nn_plain(a, w, torch.float32)
    assert got.dtype == out_dtype
    assert _rel_err(got, ref) <= (2**-7 if out_dtype == torch.bfloat16 else 2**-12)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1000, 16449])
@pytest.mark.parametrize("i,nk", list(enumerate(WIDTHS)))
def test_gemm_family_tn_layout(dev, rows, i, nk):
    """dC^T . X, both MN-major: 16449 rows split into 4-6 ranges for every
    output here but 4096 x 3072 (gk.split_k); 1000 rows are not split."""
    n, k = nk
    g = torch.Generator().manual_seed(3 * rows + i)
    dc = _rand(g, dev, rows, n).bfloat16()
    x = _rand(g, dev, rows, k).bfloat16()
    with torch.inference_mode():
        got = gk.gemm_tn(dc, x)
        ref = gk.gemm_tn_plain(dc, x, torch.float32)
    assert _rel_err(got, ref) <= 2**-7


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(1000, 1024), (16449, 768), (16449, 1024), (101, 256), (37, 64)])
def test_mlp_bwd_dual_kernel(dev, m, d):
    """The dual kernel: bf16 gact and dh, and the f32 per-64-row column
    partials of the unrounded dh (every row of partials written)."""
    hidden = 4 * d
    g = torch.Generator().manual_seed(m + d)
    y, gg = _rand(g, dev, m, d).bfloat16(), _rand(g, dev, m, d).bfloat16()
    w1 = _rand(g, dev, hidden, d, scale=d**-0.5).bfloat16()
    b1 = _rand(g, dev, hidden, scale=0.1)
    w2 = _rand(g, dev, d, hidden, scale=hidden**-0.5).bfloat16()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        gact, dh, col = gk.mlp_bwd_dual(y, w1, b1, gg, w2)
        torch.cuda.synchronize()
        refs = gk.mlp_bwd_dual_plain(y.float(), w1.float(), b1, gg.float(), w2.float())
    assert kernels.LAUNCHES == _launches(mlp_bwd_dual=1)
    assert gact.dtype == dh.dtype == torch.bfloat16 and col.shape == (2 * -(-m // 128), hidden)
    assert _rel_err(gact, refs[0].float()) <= 2**-7
    assert _rel_err(dh, refs[1].float()) <= 2**-7
    assert _rel_err(col, refs[2]) <= 1e-4 and _rel_err(col.sum(0), refs[2].sum(0)) <= 1e-4


@pytest.mark.gpu
def test_gemm_family_refuses_a_misaligned_operand(dev):
    """TMA takes 16-byte aligned bases (and row pitches: N, K % 8 == 0): a
    view one element into its buffer is refused, never run another way."""
    buf = torch.zeros(64 * 16 + 8, device=dev, dtype=torch.bfloat16)
    x = buf[1:1 + 64 * 16].view(64, 16)
    w = torch.zeros(16, 16, device=dev, dtype=torch.bfloat16)
    for call in (lambda: fe.gemm_bias_act(x, w), lambda: gk.gemm_nn(x, w),
                 lambda: gk.gemm_tn(x, x),
                 lambda: gk.mlp_bwd_dual(x, w, torch.zeros(16, device=dev), x, w)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()


MHSA_T_CASES = [(2, 257, 256, 4), (3, 80, 768, 12), (2, 101, 128, 2)]
MHSA_T_LAUNCHES = dict(layernorm=1, gemm_bias_act=1, flash_attention=1, gemm_nn=2,
                       attention_bwd_dq=1, attention_bwd_dkv=1, gemm_tn=2, layernorm_bwd=1,
                       colsum=2)
MLP_T_LAUNCHES = dict(layernorm=1, mlp_bwd_dual=1, gemm_tn=2, gemm_nn=1, layernorm_bwd=1,
                      colsum=2)


def _mlp_inputs(g, dev, b, l, d):
    x = _rand(g, dev, b, l, d).bfloat16()
    w = [_rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1,
         _rand(g, dev, 4 * d, d, scale=d**-0.5).bfloat16(), _rand(g, dev, 4 * d, scale=0.1),
         _rand(g, dev, d, 4 * d, scale=(4 * d)**-0.5).bfloat16(), _rand(g, dev, d, scale=0.1)]
    return x, w, _rand(g, dev, b, l, d).bfloat16()


def _check_grads(got, ref, dout, tol=2**-5):
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == r.dtype, i
        if i == 0:  # dx held on dx - g
            a, r = a.float() - dout.float(), r.float() - dout.float()
        assert _rel_err(a, r.float()) <= tol, i


@pytest.mark.gpu
@pytest.mark.parametrize("nomax", [False, True])
@pytest.mark.parametrize("b,l,d,h", MHSA_T_CASES)
def test_mhsa_t_backward_kernels(dev, b, l, d, h, nomax):
    from openvision_tpu_torch.ops.fused_attention import _backward_kernels

    g = torch.Generator().manual_seed(l + d + nomax)
    x, w, dout = _block_inputs(g, dev, b, l, d)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = _backward_kernels(x, *w, dout, num_heads=h, sm_scale=None, causal=False,
                                prefix_len=0, eps=1e-6, nomax=nomax, bias_sum_per_image=False)
        torch.cuda.synchronize()
        ref = fe.mhsa_block_bwd_plain(x, *w, dout, num_heads=h, nomax=nomax)
    assert kernels.LAUNCHES == _launches(**MHSA_T_LAUNCHES)
    _check_grads(got, ref, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d", [(2, 257, 256), (3, 80, 192), (2, 37, 64)])
def test_mlp_t_backward_kernels(dev, b, l, d):
    g = torch.Generator().manual_seed(l * d)
    x, w, dout = _mlp_inputs(g, dev, b, l, d)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = fe._mlp_backward_kernels(x, *w, dout, eps=1e-6)
        torch.cuda.synchronize()
        ref = fe.mlp_block_bwd_plain(x, *w, dout)
    assert kernels.LAUNCHES == _launches(**MLP_T_LAUNCHES)
    _check_grads(got, ref, dout)


@pytest.mark.gpu
@pytest.mark.parametrize("nomax", [False, True])
def test_fused_t_functions_match_autograd_of_the_plain_forward(dev, nomax):
    g = torch.Generator().manual_seed(7 + nomax)
    x, w, dout = _block_inputs(g, dev, 2, 101, 256)
    _, w2, _ = _mlp_inputs(g, dev, 2, 101, 256)
    leaves = [t.clone().requires_grad_(True) for t in (x, *w, *w2)]
    kernels.reset_launch_counts()
    y = fe.mhsa_block(*leaves[:7], num_heads=4, nomax=nomax)
    out = fe.mlp_block(y, *leaves[7:])
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    fwd = _launches(layernorm=2, gemm_bias_act=4, attention=1)
    want = {k: fwd[k] + MHSA_T_LAUNCHES.get(k, 0) + MLP_T_LAUNCHES.get(k, 0) for k in fwd}
    assert kernels.LAUNCHES == want
    ref_leaves = [t.float().requires_grad_(True) for t in (x, *w, *w2)]
    ref_y = fe.mhsa_block_plain(*ref_leaves[:7], num_heads=4, nomax=nomax)
    ref = torch.autograd.grad(fe.mlp_block_plain(ref_y, *ref_leaves[7:]), ref_leaves,
                              dout.float())
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == (x, *w, *w2)[i].dtype
        if i == 0:
            a, r = a.float() - dout.float(), r - dout.float()
        assert _rel_err(a, r) <= 2**-5, i


QKV_CASES = [(2, 257, 256, 4, False, 0), (2, 128, 256, 4, True, 0), (3, 101, 128, 2, True, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,h,causal,prefix", QKV_CASES)
def test_fused_qkv_attention_kernels(dev, b, l, d, h, causal, prefix):
    """#7 forward (2 launches) and #8 backward (7 launches) against the
    plain twins of _kernel and _qkv_bwd_kernel."""
    g = torch.Generator().manual_seed(l * h + prefix)
    y, dout = _rand(g, dev, b, l, d).bfloat16(), _rand(g, dev, b, l, d).bfloat16()
    w_qkv = _rand(g, dev, 3 * d, d, scale=d**-0.5).bfloat16()
    b_qkv = _rand(g, dev, 3 * d, scale=0.1)
    kw = dict(num_heads=h, sm_scale=None, causal=causal, prefix_len=prefix)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = fa.fused_qkv_attention(y, w_qkv, b_qkv, num_heads=h, causal=causal,
                                     prefix_len=prefix)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == _launches(gemm_bias_act=1, attention=1)
        assert _rel_err(out, fa.fused_qkv_attention_plain(y.float(), w_qkv.float(), b_qkv,
                                                          **kw)) <= 2**-6
        kernels.reset_launch_counts()
        got = fa._qkv_backward_kernels(y, w_qkv, b_qkv, dout, **kw)
        torch.cuda.synchronize()
        ref = fa.fused_qkv_attention_bwd_plain(y, w_qkv, b_qkv, dout, **kw)
    assert kernels.LAUNCHES == _launches(gemm_bias_act=1, flash_attention=1,
                                         attention_bwd_dq=1, attention_bwd_dkv=1, gemm_tn=1,
                                         gemm_nn=1, colsum=1)
    for name, a, r in zip(("dy", "dw_qkv", "db_qkv"), got, ref):
        assert a.dtype == r.dtype, name
        assert _rel_err(a, r.float()) <= 2**-5, name


TP_CASES = [(2, 257, 1024, 16, False, 0, 2), (2, 257, 1024, 16, False, 0, 4),
            (2, 463, 768, 12, True, 335, 2), (2, 101, 768, 12, True, 0, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,h,causal,prefix,t", TP_CASES)
def test_tensor_parallel_block_kernels(dev, b, l, d, h, causal, prefix, t):
    """#11 (4 launches) and #12 (11 launches) on the last shard's weights
    against the plain twins of _block_partial_kernel and
    _block_partial_bwd_kernel."""
    from openvision_tpu_torch.convert.openclip import shard_tensor

    g = torch.Generator().manual_seed(l * t + prefix)
    x, dout = _rand(g, dev, b, l, d).bfloat16(), _rand(g, dev, b, l, d).bfloat16()
    ln_w, ln_b = _rand(g, dev, d) * 0.1 + 1, _rand(g, dev, d) * 0.1
    w_qkv = shard_tensor(_rand(g, dev, 3 * d, d, scale=d**-0.5), "qkv", t - 1, t)
    b_qkv = shard_tensor(_rand(g, dev, 3 * d, scale=0.1), "qkv", t - 1, t).contiguous()
    w_o = shard_tensor(_rand(g, dev, d, d, scale=d**-0.5), "cols", t - 1, t)
    w_qkv, w_o = w_qkv.bfloat16().contiguous(), w_o.bfloat16().contiguous()
    kw = dict(num_heads=h // t, sm_scale=0.125, causal=causal, prefix_len=prefix)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = fa.block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == _launches(layernorm=1, gemm_bias_act=2, attention=1)
        ref = fa.block_partial_plain(x.float(), ln_w, ln_b, w_qkv.float(), b_qkv,
                                     w_o.float(), **kw)
        assert _rel_err(out, ref) <= 2**-6
        kernels.reset_launch_counts()
        got = fa.block_partial_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, dout, **kw)
        torch.cuda.synchronize()
        want = fa.block_partial_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, dout, **kw)
    assert kernels.LAUNCHES == _launches(layernorm=1, gemm_bias_act=1, flash_attention=1,
                                         gemm_nn=2, attention_bwd_dq=1, attention_bwd_dkv=1,
                                         gemm_tn=2, layernorm_bwd=1, colsum=1)
    for name, a, r in zip(("dx", "dln_w", "dln_b", "dw_qkv", "db_qkv", "dw_o"), got, want):
        assert a.dtype == r.dtype, name
        assert _rel_err(a, r.float()) <= 2**-5, name
