#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each prints as it goes; any failure raises and exits non-zero):
1. torch / CUDA versions, the card's name and power limit, and the nvcc
   build of the kernels in openvision_tpu_torch/csrc (timed).
2. Each kernel against its plain PyTorch version at ViT-L/14 shapes
   (B=8, L=257, D=1024, 16 heads, MLP 4096) and at a ragged L=101, with
   nomax on and off for attention. Inputs are bf16; the plain version runs
   in f32 from the same bf16 inputs.
2b. The masked attention and flash kernels against their plain versions at
   the caption path's shapes (B=8): unmasked L=257 over 16 heads, prefix-LM
   L=463 with prefix 335, causal L=128, a ragged causal L=101 with prefix 37
   (12 heads), flash cross-attention Lq=128 over Lk=335, and flash with the
   single-k and, at Lk > 768, the multi-k Pallas rounding order; the
   composed fused block (layernorm, QKV, attention, out-proj) against its
   plain version, held on what it adds to its input.
3. The zero-shot path at full width, with random weights made from a seed:
   a ViT-L/14-224 + text-L export in OpenCLIP layout is written to a temp
   dir, loaded with load_model(dtype=bfloat16, attn_impl="fused_t",
   fast_gelu=True, device="cuda"), the testcat images are encoded through
   serving/encode.py and ranked against the nine zero-shot labels through
   tools/zero_shot.py. Checks: every kernel was launched the expected
   number of times, the embeddings are finite and unit-norm, and zimg has
   cosine >= 0.999 with the port's f32 plain (xla) path on the same card.
4. Encode throughput at batch 64 (CUDA events), kernels against the plain
   eager bf16 path, and each kernel's time against its plain version.
5. The caption path at full width (the caption tool's default model:
   ViT-L/14-224, text L, decoder L, vocab 32000, bf16): random weights from
   seed 0 drawn as a port state dict, mapped to the JAX flat names and
   written with the port's save_npz, loaded with tools/caption.py's
   build_captioner(device="cuda"); the testcat images captioned greedily and
   with top_k 40 at temperature 0.7, under dec_fusion concat and cross_attn
   with dec_attn_impl fused and flash. Checks: each kernel launched as the
   block counts give, finite logits, per-image logit cosine >= 0.999 with
   the port's f32 plain (xla) path on the same card, ids masked after the
   first eos; the share of greedy ids that agree with the f32 path is
   printed, not gated.
6. Captions/s at batch 64, kernels against the plain eager bf16 path (CUDA
   events), the device's idle share and top kernels under torch.profiler,
   where the caption time goes (image tower, text tower, decoder, head),
   and each kernel's time at the caption shapes beside its bound, its plain
   version and one PyTorch library call computing the same function (its
   library_ms, a yardstick the port never calls).
The last lines are the card's name and power limit, one JSON object of
per-kernel results, and {"ok": true, "device": {...}}.

It needs no network and imports no JAX. It decodes the testcat PNGs with
zlib (the card's machine may lack Pillow).
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# ViT-L/14-224 image tower + text tower L, embed 768: the published widths
# (openvision_tpu/models/vit.py:42, convert/export.py:41,141).
L14_CONFIG = {
    "model_cfg": {
        "embed_dim": 768,
        "vision_cfg": {"layers": 24, "width": 1024, "head_width": 64, "patch_size": 14,
                       "image_size": 224, "pool_type": "avg", "final_ln_after_pool": True,
                       "no_ln_pre": True},
        "text_cfg": {"layers": 12, "width": 768, "heads": 12, "context_length": 80,
                     "vocab_size": 30522, "pool_type": "last", "no_causal_mask": True,
                     "act_kwargs": {"approximate": "tanh"}},
    },
    "preprocess_cfg": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
}

# Per encoder block on the kernels (fused_t, or fused with tanh GELU):
# 2 LayerNorms, 4 projections, 1 attention.
LAUNCHES_PER_BLOCK = {"layernorm": 2, "gemm_bias_act": 4, "attention": 1, "flash_attention": 0}

# Kernel-vs-plain bounds, relative to the largest |plain output|: the kernels
# round their outputs to bf16 (<= 2**-9 relative), the residual add rounds
# once more and f32 sums run in another order -> 2**-7; attention also rounds
# the probabilities to bf16 before p.v -> 2**-6. The composed fused block is
# held on what its four launches add to x, out - x, whose largest value is
# far below the residual's: 2**-6 of max|out - x| (the attention bound),
# plus per element the bf16 rounding of the residual add, 2**-8 of |out|.
REL_TOL = {"layernorm": 2**-7, "gemm_bias_act": 2**-7, "attention": 2**-6,
           "flash_attention": 2**-6}
CASE_REL_TOL = {**REL_TOL, "fused block": 2**-6}
RESIDUAL_ROUNDING = 2**-8  # half a bf16 ulp, relative to the value, at most

# Source and the Pallas kernels each serves, as file:line; the JSON line's
# "replaces" is the first of them, "serves" all of them.
_FE, _FA, _FL = ("openvision_tpu/ops/fused_encoder.py", "openvision_tpu/ops/fused_attention.py",
                 "openvision_tpu/ops/flash_attention.py")
KERNEL_INFO = {
    "layernorm": ("openvision_tpu_torch/csrc/layernorm.cu",
                  [f"{_FE}:71", f"{_FE}:502", f"{_FA}:440"]),
    "gemm_bias_act": ("openvision_tpu_torch/csrc/gemm_bias_act.cu",
                      [f"{_FE}:71", f"{_FE}:502", f"{_FA}:440"]),
    "attention": ("openvision_tpu_torch/csrc/attention.cu", [f"{_FE}:71", f"{_FA}:440"]),
    "flash_attention": ("openvision_tpu_torch/csrc/attention.cu",
                        [f"{_FL}:133", f"{_FL}:76", f"{_FL}:85"]),
}

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
F32_PEAK_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# The caption tool's default model (tools/caption.py --config), bf16 for the
# kernels: ViT-L/14-224, text L, decoder L, vocab 32000, 80 text tokens and
# 128 queries.
CAPTION_ARG = "res=224,img=L/14,txt_name=L,txt_decoder_name=L"
RES, TOKEN_LEN, QUERIES, VOCAB, DEC_BLOCKS, IMG_BLOCKS = 224, 80, 128, 32000, 12, 24


def vit_l14_flops_per_image(res: int = 224) -> float:
    """Forward FLOPs of one ViT-L/14 image (as bench.py counts them)."""
    l = (res // 14) ** 2 + 1
    d, depth, mlp = 1024, 24, 4096
    per_block = 4 * l * d * d + 2 * l * l * d + 2 * l * d * mlp
    stem = l * d * (3 * 14 * 14)
    return 2.0 * (depth * per_block + stem)


# ---------------------------------------------------------------------------
# PNG decoding (8-bit, non-interlaced RGB / RGBA) with the standard library
# ---------------------------------------------------------------------------


def read_png(path: str) -> np.ndarray:
    """Decodes a PNG to (H, W, 3) uint8, dropping alpha like PIL's convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in (2, 6):
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are decoded")
    bpp = 3 if color == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        start = y * (stride + 1)
        ftype, cur = raw[start], bytearray(raw[start + 1:start + 1 + stride])
        if ftype == 1:  # sub
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 255
        elif ftype == 2:  # up
            for i in range(stride):
                cur[i] = (cur[i] + prev[i]) & 255
        elif ftype == 3:  # average
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 255
        elif ftype == 4:  # paeth
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
        elif ftype != 0:
            raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y * stride:(y + 1) * stride] = cur
        prev = cur
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)[..., :3].copy()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def phase(title: str) -> None:
    print(f"\n== {title} ==", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean time of fn() replayed from one CUDA graph of `iters` calls: the
    device time with no host time between launches. cuda_ms of back-to-back
    calls measures the host instead when a launch is shorter than its Python
    wrapper."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # off the capture: lazy module loads and first allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=3, warmup=1) / iters
    del graph
    return ms


def kernel_ms(fn, iters: int) -> dict:
    """{CUDA kernel name: its device time per fn() call in ms}, from
    torch.profiler over `iters` calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / iters / 1e3
    return per_kernel


def export_random_model(out_dir: str, cfg: dict, seed: int) -> None:
    """Writes a random-init OpenCLIP export (config + .bin) of `cfg`.

    Block matrices ~ N(0, 0.02) (the flax "vit" init's scale), LayerNorm
    scales 1 + N(0, 0.02), biases and embeddings N(0, 0.02), heads and the
    patch conv N(0, fan_in**-0.5), logit scale log(1/0.07).
    """
    import torch

    from openvision_tpu_torch.convert.openclip import state_dict_to_openclip
    from openvision_tpu_torch.models.clip import CLIPModel

    mcfg = cfg["model_cfg"]
    v, t = mcfg["vision_cfg"], mcfg["text_cfg"]
    shapes = CLIPModel(
        out_dim=mcfg["embed_dim"],
        image=dict(patch_size=(v["patch_size"],) * 2, width=v["width"], depth=v["layers"],
                   mlp_dim=4 * v["width"], num_heads=v["width"] // v["head_width"],
                   emb_head_bias=False, image_size=v["image_size"]),
        text=dict(width=t["width"], depth=t["layers"], mlp_dim=4 * t["width"],
                  num_heads=t["heads"], vocab_size=t["vocab_size"],
                  context_length=t["context_length"]),
    ).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in shapes.items():
        shape = tuple(p.shape)
        if name == "logit_scale":
            arr = np.full(shape, np.log(1 / 0.07), np.float32)
        elif name.endswith(("proj", "projection", "conv1.weight")):
            fan_in = int(np.prod(shape[1:])) if name.endswith("conv1.weight") else shape[0]
            arr = rng.standard_normal(shape, dtype=np.float32) * fan_in**-0.5
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            if ".ln_" in name and name.endswith("weight"):
                arr += 1.0
        sd[name] = torch.from_numpy(arr)
    torch.save(state_dict_to_openclip(sd), os.path.join(out_dir, "open_clip_pytorch_model.bin"))
    with open(os.path.join(out_dir, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


class Case:
    """One kernel call at fixed inputs: the kernel, its plain version, one
    PyTorch library call computing the same function (or None), the bytes
    and operations the function needs (for its bound), and for a residual
    block its input x (the check then holds the block on out - x)."""

    def __init__(self, name, label, kern, plain, lib, nbytes, flops, f32_ops=0, residual=None):
        self.name, self.label, self.kern, self.plain, self.lib = name, label, kern, plain, lib
        self.nbytes, self.flops, self.f32_ops = nbytes, flops, f32_ops
        self.residual = residual

    def bound(self):
        """(ms, "bytes" | "operations"): the least time the card could take,
        each input read once and each output written once."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        t_ops = self.flops / BF16_PEAK_FLOPS + self.f32_ops / F32_PEAK_FLOPS
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def visible_pairs(lq: int, lk: int, causal: bool, prefix: int) -> int:
    """(query, key) pairs the mask lets through: key j is visible to query i
    iff j <= max(i, prefix - 1) when causal."""
    if not causal:
        return lq * lk
    i = np.arange(lq)
    return int(np.minimum(lk, np.maximum(i, prefix - 1) + 1).sum())


def _sdpa_kwargs(lq: int, lk: int, causal: bool, prefix: int, device) -> dict:
    """The mask arguments of torch's scaled_dot_product_attention."""
    import torch

    if causal and prefix > 0:
        rows = torch.arange(lq, device=device)[:, None]
        cols = torch.arange(lk, device=device)[None, :]
        return {"attn_mask": cols <= torch.clamp(rows, min=prefix - 1)}
    return {"is_causal": causal}


def _sdpa(q, k, v, causal: bool, prefix: int):
    """The library call: torch's scaled_dot_product_attention on (B, H, L, hd)."""
    import torch.nn.functional as F

    kw = _sdpa_kwargs(q.shape[2], k.shape[2], causal, prefix, q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def _library_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, sdpa_kw: dict):
    """The block as a sequence of library calls: F.layer_norm, F.linear,
    scaled_dot_product_attention, F.linear and the residual add."""
    import torch.nn.functional as F

    b, l, d = x.shape
    y = F.layer_norm(x, (d,), ln_w, ln_b, 1e-6)
    q, k, v = F.linear(y, w_qkv, b_qkv).view(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, **sdpa_kw)
    return x + F.linear(o.transpose(1, 2).reshape(b, l, d), w_o, b_o)


def attention_case(fe, qkv, heads: int, *, causal=False, prefix=0, nomax=False) -> Case:
    b, l, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(b, l, heads, 64).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    mask = f" prefix={prefix}" if prefix else " causal" if causal else ""
    return Case(
        "attention", f"attn b={b} L={l} H={heads}{mask}{' nomax' if nomax else ''}",
        lambda: fe.attention(qkv, heads, nomax=nomax, causal=causal, prefix_len=prefix),
        lambda: fe.attention_plain(qkv.float(), heads, nomax=nomax, causal=causal,
                                   prefix_len=prefix),
        _sdpa(q, k, v, causal, prefix),
        (3 * b * l * d + b * l * d) * 2, 4 * b * heads * 64 * visible_pairs(l, l, causal, prefix))


def flash_case(fl, q, k, v, label, *, causal=False, prefix=0) -> Case:
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return Case(
        "flash_attention", f"flash {label} b={b} Lq={lq} Lk={lk} H={h}",
        lambda: fl.flash_attention(q, k, v, causal=causal, prefix_len=prefix),
        lambda: fl.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                         prefix_len=prefix)[0],
        _sdpa(qt, kt, vt, causal, prefix),
        (2 * b * lq * h * hd + 2 * b * lk * h * hd) * 2,
        4 * b * h * hd * visible_pairs(lq, lk, causal, prefix))


def kernel_cases(fe, device, gen, b: int, l: int, d: int = 1024, heads: int = 16,
                 mlp: int = 4096):
    """Cases of one ViT block's launches (the zero-shot path's shapes)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    m = b * l
    x = rnd(b, l, d).bfloat16()
    ln_w, ln_b = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)
    ln_w16, ln_b16 = ln_w.bfloat16(), ln_b.bfloat16()
    proj = {
        "qkv": (rnd(3 * d, d, scale=d**-0.5).bfloat16(), rnd(3 * d, scale=0.1), False, False, d),
        "out+res": (rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, d),
        "fc1+gelu": (rnd(mlp, d, scale=d**-0.5).bfloat16(), rnd(mlp, scale=0.1), True, False, d),
        "fc2+res": (rnd(d, mlp, scale=mlp**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, mlp),
    }
    inputs = {d: x, mlp: rnd(b, l, mlp).bfloat16()}
    qkv = rnd(b, l, 3 * d).bfloat16()
    cases = [Case("layernorm", f"LN ({m}x{d})",
                  lambda: fe.layernorm(x, ln_w, ln_b, 1e-6),
                  lambda: fe.layernorm_plain(x.float(), ln_w, ln_b, 1e-6),
                  lambda: F.layer_norm(x, (d,), ln_w16, ln_b16, 1e-6),
                  2 * m * d * 2 + 2 * d * 4, 0, 8 * m * d)]
    for label, (w, bias, gelu, res, k) in proj.items():
        a = inputs[k]
        r = x if res else None
        n = w.shape[0]
        cases.append(Case(
            "gemm_bias_act", f"{label} ({m}x{n}x{k})",
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.gemm_bias_act(a, w, bias, gelu=gelu,
                                                                          residual=r),
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.linear_plain(
                a.float(), w.float(), bias, gelu=gelu, residual=None if r is None else r.float()),
            lambda a=a, w=w, b16=bias.bfloat16(): F.linear(a, w, b16),
            (m * k + n * k + m * n * (2 if res else 1)) * 2 + n * 4, 2 * m * n * k))
    for nomax in (False, True):
        cases.append(attention_case(fe, qkv, heads, nomax=nomax))
    return cases


def caption_attention_cases(fe, fl, device, gen, b: int):
    """The masked attention and flash cases at the caption path's shapes."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).bfloat16()

    cases = []
    for l, heads, causal, prefix in ((257, 16, False, 0), (463, 12, True, 335),
                                     (128, 12, True, 0), (101, 12, True, 37)):
        cases.append(attention_case(fe, rnd(b, l, 3 * heads * 64), heads, causal=causal,
                                    prefix=prefix))
    for label, lq, lk, causal, prefix in (
            ("cross", 128, 335, False, 0), ("prefix=335", 463, 463, True, 335),
            ("causal", 128, 128, True, 0), ("prefix=37", 101, 101, True, 37),
            ("multi-k", 64, 900, False, 0), ("multi-k prefix=340", 780, 780, True, 340)):
        q = rnd(b, lq, 12, 64)
        kv = rnd(b, lk, 2, 12, 64)  # k and v as strided views, as the model slices them
        cases.append(flash_case(fl, q, kv[:, :, 0], kv[:, :, 1], label, causal=causal,
                                prefix=prefix))
    return cases


def block_cases(fa, device, gen, b: int):
    """The composed fused block (#9) at the caption path's three shapes: the
    image tower, the concat decoder and the cross_attn decoder's
    self-attention. Its bound counts x, the weights and the output once (the
    Pallas kernel keeps every intermediate on chip); its library time is the
    sequence of library calls of :func:`_library_block`."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    out = []
    for l, d, heads, causal, prefix in ((257, 1024, 16, False, 0), (463, 768, 12, True, 335),
                                        (128, 768, 12, True, 0)):
        x = rnd(b, l, d).bfloat16()
        w = (rnd(d, scale=0.1) + 1, rnd(d, scale=0.1), rnd(3 * d, d, scale=d**-0.5).bfloat16(),
             rnd(3 * d, scale=0.1), rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1))
        w16 = tuple(t.bfloat16() for t in w)
        kw = dict(num_heads=heads, causal=causal, prefix_len=prefix)
        sdpa_kw = _sdpa_kwargs(l, l, causal, prefix, device)
        out.append(Case(
            "fused block", f"block b={b} L={l} D={d} H={heads}"
            + (f" prefix={prefix}" if prefix else " causal" if causal else ""),
            lambda x=x, w=w, kw=kw: fa.fused_mhsa_block(x, *w, **kw),
            lambda x=x, w=w, kw=kw: fa.fused_mhsa_block_plain(
                x.float(), w[0], w[1], w[2].float(), w[3], w[4].float(), w[5], **kw),
            lambda x=x, w16=w16, h=heads, skw=sdpa_kw: _library_block(x, *w16, h, skw),
            (2 * b * l * d + 4 * d * d) * 2 + 6 * d * 4,
            2 * b * l * 4 * d * d + 4 * b * heads * 64 * visible_pairs(l, l, causal, prefix),
            residual=x))
    return out


def check_cases(cases, worst: dict) -> None:
    """Each case's kernel within its bound of its plain version; a residual
    block is held on what it adds to its input (see CASE_REL_TOL)."""
    import torch

    for c in cases:
        got, ref = c.kern(), c.plain()
        torch.cuda.synchronize()
        err = (got.float() - ref).abs()
        if c.residual is None:
            scale = ref.abs().max().item()
            bound = torch.full_like(ref, CASE_REL_TOL[c.name] * scale)
            note = ""
        else:
            scale = (ref - c.residual.float()).abs().max().item()
            bound = CASE_REL_TOL[c.name] * scale + RESIDUAL_ROUNDING * ref.abs()
            note = f" max|out-x|={scale:.3e}"
        ratio = (err / bound).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        print(f"  {c.name:15s} {c.label:46s} max|err|={err.max().item():.3e}  "
              f"bound={CASE_REL_TOL[c.name] * scale:.3e}{note}  err/bound<={ratio:.3f}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{c.name} {c.label}: max|err|/bound {ratio} > 1")
        worst[c.name] = max(worst.get(c.name, 0.0), err.max().item())


def time_case(c: Case) -> dict:
    """CUDA-event times of the kernel, its plain version and the library
    call over back-to-back calls, and the kernel's and the library call's
    time replayed from a CUDA graph (no host time between launches)."""
    k_ms, p_ms = cuda_ms(c.kern, 20), cuda_ms(c.plain, 3, warmup=1)
    l_ms = cuda_ms(c.lib, 20) if c.lib is not None else None
    k_graph = graph_ms(c.kern)
    l_graph = graph_ms(c.lib) if c.lib is not None else None
    b_ms, b_by = c.bound()

    def us(ms):
        return "n/a" if ms is None else f"{ms * 1e3:.1f}"

    print(f"  {c.name:15s} {c.label:46s} kernel {us(k_ms)} us (graph {us(k_graph)})  bound "
          f"{us(b_ms)} us ({b_by})  plain {us(p_ms)} us  library {us(l_ms)} us "
          f"(graph {us(l_graph)})")
    return {"ms": k_ms, "graph_ms": k_graph, "plain_ms": p_ms, "library_ms": l_ms,
            "library_graph_ms": l_graph, "bound_ms": b_ms, "bound_by": b_by}


def time_kernels(fe, device, batch: int = 64) -> dict:
    """Phase 4b: one ViT encoder block's launches of each kernel at `batch`,
    summed per kernel (time, bound, plain version and library call)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times, largest = {}, {}
    for c in kernel_cases(fe, device, gen, batch, 257):
        if "nomax" in c.label:
            continue  # the encode path runs the max-subtracted softmax
        t = time_case(c)
        keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")
        acc = times.setdefault(c.name, dict.fromkeys(keys, 0.0))
        for key in keys:
            acc[key] += t[key] or 0.0
        if t["bound_ms"] >= largest.get(c.name, 0.0):  # the largest launch names the bound
            largest[c.name] = t["bound_ms"]
            acc["bound_by"] = t["bound_by"]
    return times


# ---------------------------------------------------------------------------
# The caption path (phases 5 and 6)
# ---------------------------------------------------------------------------


def caption_arg(fusion: str, dec_impl: str, dtype: str = "bfloat16", plain: bool = False) -> str:
    arg = f"{CAPTION_ARG},dtype={dtype},dec_fusion={fusion},dec_attn_impl={dec_impl}"
    return arg + ",attn_impl=xla" if plain else arg


def write_random_caption_checkpoint(path: str, fusion: str, seed: int) -> int:
    """Random CoCa weights drawn as a port state dict, mapped to the JAX flat
    names with the port's inverse map and written with the port's save_npz.

    Block matrices, biases and embeddings ~ N(0, 0.02), LayerNorm scales
    1 + N(0, 0.02), the learnable queries N(0, 1), heads, projections and the
    patch conv N(0, fan_in**-0.5), logit scale log(1/0.07). Returns the
    parameter count.
    """
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.convert.openclip import state_dict_to_jax_params
    from openvision_tpu_torch.tools.caption import build_model
    from openvision_tpu_torch.train.checkpoint import save_npz

    model = build_model(get_config(caption_arg(fusion, "xla", "float32", True)))
    heads = {"vision": model.visual.transformer.resblocks[0].num_heads,
             "text": model.text.transformer.resblocks[0].num_heads,
             "decoder": model.txt_decoder.transformer.resblocks[0].num_heads}
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in shapes.items():
        if name == "logit_scale":
            arr = np.full(shape, np.log(1 / 0.07), np.float32)
        elif name.endswith("learnable_tokens"):
            arr = rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith(("visual.proj", "text_projection", "conv1.weight")):
            fan_in = int(np.prod(shape[1:])) if name.endswith("conv1.weight") else shape[0]
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in**-0.5)
        elif name.endswith(("projection_layer.weight", "txt_decoder.head.weight")):
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(shape[1]**-0.5)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            if (".ln_" in name or "decoder_norm" in name) and name.endswith("weight"):
                arr += 1.0
        sd[name] = torch.from_numpy(arr)
    params = state_dict_to_jax_params(sd, num_heads_vision=heads["vision"],
                                      num_heads_text=heads["text"],
                                      num_heads_decoder=heads["decoder"])
    save_npz(path, {"params": params})
    return sum(int(np.prod(s)) for s in shapes.values())


def expected_caption_launches(fusion: str, dec_impl: str) -> dict:
    """Launches of one caption forward: the image tower's 24 fused blocks,
    the text tower on xla (none), and the decoder's blocks."""
    want = {k: IMG_BLOCKS * v for k, v in LAUNCHES_PER_BLOCK.items()}
    if dec_impl == "fused":  # concat: 12 masked fused blocks; cross_attn: 6 causal ones
        n = DEC_BLOCKS if fusion == "concat" else DEC_BLOCKS // 2
        for k, v in LAUNCHES_PER_BLOCK.items():
            want[k] += n * v
    else:  # flash: 12 self-attentions, or 6 causal self- and 6 cross-attentions
        want["flash_attention"] += DEC_BLOCKS
    return want


def check_eos_masking(ids, eos: int, pad: int) -> None:
    rows = ids.cpu().tolist()
    for row in rows:
        if eos in row:
            tail = row[row.index(eos) + 1:]
            if any(t != pad for t in tail):
                raise AssertionError(f"ids after the first eos are not pad: {row}")


def cosine_rows(a, b):
    import torch

    a, b = a.flatten(1).double(), b.flatten(1).double()
    return (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1))


def caption_phase(device, tmp: str, batch: np.ndarray, names, totals: dict) -> dict:
    """Phase 5: drives the caption path and checks it. Returns the loaded
    kernel captioners by (fusion, dec_impl) and the checkpoint paths."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.models.decoder import mask_after_eos
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.tools.caption import build_captioner

    loaded, ckpts = {}, {}
    for fusion in ("concat", "cross_attn"):
        ckpts[fusion] = os.path.join(tmp, f"caption_{fusion}.npz")
        t0 = time.perf_counter()
        n_params = write_random_caption_checkpoint(ckpts[fusion], fusion, SEED)
        print(f"\n[{fusion}] wrote {n_params / 1e6:.1f}M random params as "
              f"{os.path.getsize(ckpts[fusion]) / 1e9:.2f} GB npz in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ref, _ = build_captioner(get_config(caption_arg(fusion, "xla", "float32", True)),
                                 ckpts[fusion], device=device)
        ref_logits = ref.logits(batch)
        ref_ids = mask_after_eos(ref_logits.argmax(-1), ref.eos, ref.pad)
        del ref
        print(f"[{fusion}] f32 plain (xla) reference in {time.perf_counter() - t0:.1f} s")
        for dec_impl in ("fused", "flash"):
            tag = f"[{fusion} / dec_attn_impl={dec_impl}]"
            t0 = time.perf_counter()
            cap, tok = build_captioner(get_config(caption_arg(fusion, dec_impl)), ckpts[fusion],
                                       device=device)
            print(f"{tag} build_captioner(bf16) in {time.perf_counter() - t0:.1f} s")
            want = expected_caption_launches(fusion, dec_impl)
            gen = torch.Generator(device=device).manual_seed(SEED)
            runs = {}
            for run, kw in (("greedy", {}),
                            ("top_k 40, temperature 0.7",
                             dict(temperature=0.7, top_k=40, generator=gen))):
                kernels.reset_launch_counts()
                ids = cap(batch, **kw)
                torch.cuda.synchronize()
                got = dict(kernels.LAUNCHES)
                print(f"{tag} {run}: launches {got}")
                if got != want:
                    raise AssertionError(f"{tag} {run}: launches {got}, expected {want}")
                for k, v in got.items():
                    totals[k] += v
                if (tuple(ids.shape) != (len(batch), QUERIES) or int(ids.min()) < 0
                        or int(ids.max()) >= VOCAB):
                    raise AssertionError(f"{tag} {run}: ids of shape {tuple(ids.shape)} "
                                         f"in [{int(ids.min())}, {int(ids.max())}]")
                check_eos_masking(ids, cap.eos, cap.pad)
                runs[run] = ids
            logits = cap.logits(batch)
            if logits.shape != ref_logits.shape or not torch.isfinite(logits).all():
                raise AssertionError(f"{tag}: logits {tuple(logits.shape)} are not finite")
            cos = cosine_rows(logits, ref_logits)
            agree = (runs["greedy"] == ref_ids).float().mean().item()
            print(f"{tag} logit cosine vs f32 plain: min {cos.min().item():.6f}  per image "
                  f"{[round(c, 6) for c in cos.tolist()]}; greedy ids agreeing with the f32 "
                  f"path: {100 * agree:.1f}% (not gated)")
            if cos.min().item() < 0.999:
                raise AssertionError(f"{tag}: logit cosine against the f32 plain path < 0.999")
            sampled = runs["top_k 40, temperature 0.7"]
            top40 = (logits / 0.7).topk(40, dim=-1).indices
            live = sampled != cap.pad
            if not (top40 == sampled[..., None]).any(-1)[live].all():
                raise AssertionError(f"{tag}: a sampled id lies outside the top 40")
            forced = runs["greedy"].clone()
            forced[:, 5] = cap.eos
            masked = mask_after_eos(forced, cap.eos, cap.pad)
            if not (masked[:, 6:] == cap.pad).all() or not (masked[:, 5] == cap.eos).all():
                raise AssertionError(f"{tag}: ids after a forced eos are not masked")
            for name, row in list(zip(names, runs["greedy"].tolist()))[:2]:
                print(f"{tag} {name}\tgreedy: {tok.decode(row)[:70]!r}")
            loaded[(fusion, dec_impl)] = cap
    return loaded, ckpts


def device_profile(fn, event_ms: float, iters: int = 3) -> str:
    """Device time of one fn() summed over its CUDA kernels, its raw ratio to
    `event_ms` (the CUDA-event time of one call, taken without the
    profiler), the idle share 1 - ratio, and the kernels that take the most
    of it. A ratio above 1 or below 0.5 is flagged SUSPECT: the profiler
    then over- or under-counts kernel time, and the shares are not read."""
    per_kernel = kernel_ms(fn, iters)
    busy = sum(per_kernel.values())
    if busy <= 0:
        return "device time not measured (the profiler recorded no CUDA kernel)"
    ratio = busy / event_ms
    flag = "" if 0.5 <= ratio <= 1.0 else " SUSPECT"
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {busy:.2f} of {event_ms:.2f} ms, busy/event {ratio:.4f}{flag} "
            f"(idle {100 * (1 - ratio):.1f}%); top kernels: "
            + "; ".join(f"{k[:60]} {100 * v / busy:.1f}%" for k, v in top))


def caption_throughput(device, loaded: dict, ckpts: dict, batch: int = 64) -> dict:
    """Phase 6a: captions/s at `batch`, kernels against the plain eager bf16
    path, the device's busy time under torch.profiler, and where the time of
    one caption forward goes."""
    import torch

    from openvision_tpu_torch.configs.openvision import get_config
    from openvision_tpu_torch.tools.caption import build_captioner

    x = torch.randn(batch, RES, RES, 3, generator=torch.Generator(device=device).manual_seed(2),
                    device=device)
    rates = {}
    for fusion in ("concat", "cross_attn"):
        plain, _ = build_captioner(get_config(caption_arg(fusion, "xla", plain=True)),
                                   ckpts[fusion], device=device)
        order = [("plain", plain)] + [(f"kernels {d}", loaded[(fusion, d)])
                                      for d in ("fused", "flash")]
        event_ms = {}
        for which, cap in order + order[::-1]:
            ms = cuda_ms(lambda: cap(x), iters=5, warmup=1)
            event_ms.setdefault(which, []).append(ms)
            rates.setdefault(f"{fusion} {which}", []).append(batch / (ms / 1e3))
            print(f"  {fusion:10s} {which:14s} b={batch}: {ms:8.2f} ms/batch  "
                  f"{batch / (ms / 1e3):8.1f} captions/s")
        for which, cap in order:
            print(f"  {fusion:10s} {which:14s} profile b={batch}: "
                  f"{device_profile(lambda: cap(x), min(event_ms[which]))}")
        for which, cap in (("kernels fused", loaded[(fusion, "fused")]), ("plain", plain)):
            m = cap.model
            text = torch.full((batch, TOKEN_LEN), cap.pad, dtype=torch.long, device=device)
            text[:, 0] = cap.bos
            img_tok, txt_tok = cap.tokens(x)
            with torch.inference_mode():
                h = torch.randn(batch, QUERIES, m.txt_decoder.head.weight.shape[1],
                                device=device)
            parts = {"image tower": lambda: m.visual(x), "text tower": lambda: m.text(text),
                     "decoder (with head)": lambda: m.txt_decoder(img_tok, txt_tok),
                     "head (f32)": lambda: h @ m.txt_decoder.head.weight.t()}
            line = "  ".join(f"{k} {cuda_ms(f, iters=5, warmup=1):.2f} ms" for k, f in parts.items())
            print(f"  {fusion:10s} {which:14s} breakdown b={batch}: {line}")
        del plain
    return rates


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from openvision_tpu_torch.ops import flash_attention as fl
    from openvision_tpu_torch.ops import fused_attention as fa
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving.encode import build_encode_fn
    from openvision_tpu_torch.tools import caption as tcap
    from openvision_tpu_torch.tools import zero_shot
    from openvision_tpu_torch.tools.model_io import load_model

    t_start = time.perf_counter()
    device = torch.device("cuda")
    # f32 references in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. versions, card, kernel build")
    smi = smi_line()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.lib()
    print(f"built {os.path.relpath(lib_path, REPO)} with {kernels.nvcc()} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    worst = {}
    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    with torch.inference_mode():
        phase("2. kernels against their plain versions (bf16 in, plain in f32)")
        gen = torch.Generator(device=device).manual_seed(SEED)
        for b, l in ((8, 257), (3, 101)):
            check_cases(kernel_cases(fe, device, gen, b, l), worst)

        phase("2b. masked attention and flash kernels at the caption shapes (B=8)")
        check_cases(caption_attention_cases(fe, fl, device, gen, 8) + block_cases(fa, device, gen, 8),
                    worst)

        phase("3. zero-shot path: ViT-L/14-224 + text-L, random weights (seed 0)")
        names = sorted(f for f in os.listdir(os.path.join(REPO, "testcat")) if f.endswith(".png"))
        images = [read_png(os.path.join(REPO, "testcat", f)) for f in names]
        print(f"decoded {len(images)} testcat images {images[0].shape} {images[0].dtype}")
        with tempfile.TemporaryDirectory() as model_dir:
            t0 = time.perf_counter()
            export_random_model(model_dir, L14_CONFIG, SEED)
            print(f"wrote random-init export in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            model = load_model(model_dir, dtype=torch.bfloat16, attn_impl="fused_t",
                               fast_gelu=True, device=device)
            print(f"load_model(bf16, fused_t, fast_gelu) in {time.perf_counter() - t0:.1f} s")
            depth = len(model.vision.transformer.resblocks)
            per_encode = {k: v * depth for k, v in LAUNCHES_PER_BLOCK.items()}

            encode = build_encode_fn(model, int8=False)
            batch = np.stack([model.preprocess(im) for im in images]).astype(np.float32)
            padded = np.pad(batch, ((0, 8 - len(batch)), (0, 0), (0, 0), (0, 0)))

            kernels.reset_launch_counts()
            z = encode(torch.from_numpy(padded).to(device, torch.bfloat16))[:len(images)]
            torch.cuda.synchronize()
            after_encode = dict(kernels.LAUNCHES)
            results = zero_shot.rank(model, names, images)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            print(f"\nlaunches after one batch encode: {after_encode} (expected {per_encode})")
            print(f"launches after the zero-shot ranking ({len(images)} single-image encodes): "
                  f"{launches}")
            if after_encode != per_encode:
                raise AssertionError("the encode did not launch each kernel the expected times")
            if launches != {k: v * (1 + len(images)) for k, v in per_encode.items()}:
                raise AssertionError("the ranking did not run every encode through the kernels")

            norms = torch.linalg.norm(z, dim=-1)
            print(f"zimg {tuple(z.shape)} finite={bool(torch.isfinite(z).all())} "
                  f"norms in [{norms.min().item():.6f}, {norms.max().item():.6f}]")
            if z.shape != (len(images), 768) or not torch.isfinite(z).all():
                raise AssertionError("embeddings are not finite or have the wrong shape")
            if (norms - 1).abs().max().item() > 1e-3:
                raise AssertionError("embeddings are not unit-norm")
            if len(results) != len(images):
                raise AssertionError("zero-shot ranking did not cover every image")

            cos = {}
            for gelu_name, fast in (("exact GELU", False), ("tanh GELU", True)):
                ref = load_model(model_dir, dtype=torch.float32, attn_impl="xla",
                                 fast_gelu=fast, device=device)
                z_ref = ref.encode_image(torch.from_numpy(batch).to(device))
                cos[gelu_name] = (z * z_ref).sum(-1)
                print(f"zimg cosine, kernels bf16 vs plain f32 xla ({gelu_name}): "
                      f"min {cos[gelu_name].min().item():.6f}  "
                      f"per image {[round(c, 6) for c in cos[gelu_name].tolist()]}")
                del ref
            if cos["exact GELU"].min().item() < 0.999:
                raise AssertionError("zimg cosine against the f32 plain path is below 0.999")

            phase("4. encode throughput at batch 64 and per-kernel time")
            plain = load_model(model_dir, dtype=torch.bfloat16, attn_impl="xla",
                               fast_gelu=True, device=device)
        flops = vit_l14_flops_per_image()
        x64 = torch.randn(64, 224, 224, 3, generator=torch.Generator(device=device).manual_seed(1),
                          device=device).bfloat16()
        rates = {"kernels": [], "plain": []}
        for which in ("kernels", "plain", "kernels", "plain"):
            tower = model.vision if which == "kernels" else plain.vision
            ms = cuda_ms(lambda: tower(x64), iters=10)
            rates[which].append(64 / (ms / 1e3))
            print(f"  {which:8s} encode b=64: {ms:8.2f} ms/batch  {rates[which][-1]:8.1f} img/s  "
                  f"{rates[which][-1] * flops / 1e12:6.1f} TFLOP/s "
                  f"({100 * rates[which][-1] * flops / BF16_PEAK_FLOPS:.1f}% of 989 bf16 peak)")
        del plain, model
        times = time_kernels(fe, device)

    phase("5. caption path: ViT-L/14-224 + text-L + decoder-L, bf16, random weights (seed 0)")
    cap_batch = np.stack([tcap.preprocess(im, RES) for im in images]).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        loaded, ckpts = caption_phase(device, tmp, cap_batch, names, totals)

        phase("6. caption throughput at batch 64, and the new kernels' time at caption shapes")
        cap_rates = caption_throughput(device, loaded, ckpts)
    del loaded
    torch.cuda.empty_cache()
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        caption_times = {}
        for c in caption_attention_cases(fe, fl, device, gen, 64):
            caption_times[c.label] = (c.name, time_case(c))
        for c in block_cases(fa, device, gen, 64):
            time_case(c)
    flash_row = next(t for name, t in caption_times.values() if name == "flash_attention")
    times["flash_attention"] = flash_row  # the cross-attention case (first flash case)

    phase("summary")
    print(f"card: {smi}")
    print(f"encode b=64 img/s: kernels {rates['kernels']}  plain eager bf16 {rates['plain']}")
    for k, v in cap_rates.items():
        print(f"captions/s b=64 {k}: {[round(r, 1) for r in v]}")
    print(f"main-path launches (zero-shot + caption runs): {totals}")
    missing = [k for k, v in totals.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels the main path never launched: {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1][0], "serves": KERNEL_INFO[name][1],
         "launches": totals[name],
         "max_abs_err": worst[name], "ms": times[name]["ms"],
         "graph_ms": times[name]["graph_ms"],
         "library_graph_ms": times[name]["library_graph_ms"],
         "plain_ms": times[name]["plain_ms"], "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": times[name]["library_ms"]}
        for name in REL_TOL
    ]}
    print(smi_line())
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
