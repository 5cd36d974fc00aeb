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
- attention: 2**-6. It also rounds the probabilities to bf16 before p.v.
"""

import pytest
import torch

from openvision_tpu_torch.ops import fused_encoder as fe


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(g, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).to(dev)


def _rel_err(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(2 * 257, 1024), (37, 1152), (1, 8)])
def test_layernorm_kernel(dev, rows, d):
    g = torch.Generator().manual_seed(rows)
    x = (_rand(g, dev, rows, d) * 3 + 1).bfloat16()
    w, b = _rand(g, dev, d) + 1, _rand(g, dev, d)
    with torch.inference_mode():
        ref = fe.layernorm_plain(x.float(), w, b, 1e-6)
        assert _rel_err(fe.layernorm(x, w, b, 1e-6), ref) <= 2**-7


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


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,h", [(2, 257, 16), (3, 50, 4), (1, 1, 2), (1, 577, 4)])
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
    fe.reset_launch_counts()
    with torch.inference_mode():
        y = fe.mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads=h)
        y = fe.mlp_block(y, ln_w, ln_b, w1, b1, w2, b2)
        ref = fe.mhsa_block_plain(x.float(), ln_w, ln_b, w_qkv.float(), b_qkv, w_o.float(), b_o,
                                  num_heads=h)
        ref = fe.mlp_block_plain(ref, ln_w, ln_b, w1.float(), b1, w2.float(), b2)
    assert fe.LAUNCHES == {"layernorm": 2, "gemm_bias_act": 4, "attention": 1}
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
    with pytest.raises(RuntimeError, match="forward only"):
        fe.layernorm(x, w, torch.zeros(16, device=dev), 1e-6)
