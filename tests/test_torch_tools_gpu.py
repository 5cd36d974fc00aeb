"""The interpretability tools' kernel route on the card.

Every test here needs an NVIDIA GPU and skips without one. This file
imports no JAX (run it with ``--noconftest``, as
tests/test_torch_kernels_gpu.py says):

    python -m pytest --noconftest -m gpu tests/test_torch_tools_gpu.py

A 2-block ViT at the L/14 widths (1024 wide, 16 heads, 257 tokens) with
seeded random weights, frozen, in bf16: on ``fused`` the input gradient
goes through the block kernels' autograd Function (#9 forward, #10's 12
launches backward). Against the plain bf16 (``xla``) tower on the same
weights and input: input-gradient cosine >= 0.999 (the bar of the training
gradients), GELU captures cosine >= 0.999 per layer, and the capture on the
kernel MLP routes raises by name.
"""

import pytest
import torch

from openvision_tpu_torch.models.encoder import cast_block_matrices
from openvision_tpu_torch.models.vit import ViT
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.tools.capture import GeluCaptureError, gelu_hooks

DEPTH = 2
BLOCK_FWD = {"layernorm": 1, "gemm_bias_act": 2, "attention": 1}
BLOCK_BWD = {"layernorm": 1, "gemm_bias_act": 1, "flash_attention": 1, "gemm_nn": 2,
             "attention_bwd_dq": 1, "attention_bwd_dkv": 1, "gemm_tn": 2, "layernorm_bwd": 1,
             "colsum": 2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tower(dev, attn_impl: str, fast_gelu: bool = False):
    """The same seeded weights for every route, frozen, matrices in bf16."""
    vit = ViT(num_classes=768, patch_size=(14, 14), width=1024, depth=DEPTH, mlp_dim=4096,
              num_heads=16, attn_impl=attn_impl, fast_gelu=fast_gelu, emb_head_bias=False,
              image_size=224, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in vit.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02
                    + (1.0 if ".ln_" in name and name.endswith("weight") else 0.0))
    vit = vit.to(dev).eval().requires_grad_(False)
    cast_block_matrices(vit, torch.bfloat16)
    return vit


def _image(dev):
    return torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(1)).to(dev)


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _input_grad(vit, x):
    x = x.clone().requires_grad_(True)
    vit(x).float().pow(2).sum().backward()
    return x.grad


@pytest.mark.gpu
def test_fused_input_gradient_with_frozen_weights(dev):
    plain, fused = _tower(dev, "xla"), _tower(dev, "fused")
    x = _image(dev)
    want = _input_grad(plain, x)
    kernels.reset_launch_counts()
    got = _input_grad(fused, x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    expect = {k: DEPTH * (BLOCK_FWD.get(k, 0) + BLOCK_BWD.get(k, 0))
              for k in {**BLOCK_FWD, **BLOCK_BWD}}
    assert launches == expect
    assert torch.isfinite(got).all()
    assert _cos(got, want) >= 0.999
    assert all(p.grad is None for p in fused.parameters())


@pytest.mark.gpu
def test_fused_gelu_capture_matches_plain(dev):
    plain, fused = _tower(dev, "xla"), _tower(dev, "fused")
    x = _image(dev)
    caps = []
    for vit in (plain, fused):
        with torch.no_grad(), gelu_hooks(vit, range(DEPTH)) as acts:
            vit(x)
            caps.append([acts[i] for i in range(DEPTH)])
    for i in range(DEPTH):
        assert caps[1][i].shape == (2, 257, 4096)
        assert _cos(caps[1][i], caps[0][i]) >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("impl,route", [("fused_t", "fused_t"), ("fused", "tanh GELU")])
def test_capture_on_the_kernel_mlp_raises_by_name(dev, impl, route):
    vit = _tower(dev, impl, fast_gelu=True)
    with pytest.raises(GeluCaptureError, match=route):
        with torch.no_grad(), gelu_hooks(vit, [0]):
            vit(_image(dev))
