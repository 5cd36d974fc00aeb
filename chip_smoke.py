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
3. The main path at full width, with random weights made from a seed: a
   ViT-L/14-224 + text-L export in OpenCLIP layout is written to a temp
   dir, loaded with load_model(dtype=bfloat16, attn_impl="fused_t",
   fast_gelu=True, device="cuda"), the testcat images are encoded through
   serving/encode.py and ranked against the nine zero-shot labels through
   tools/zero_shot.py. Checks: every kernel was launched the expected
   number of times, the embeddings are finite and unit-norm, and zimg has
   cosine >= 0.999 with the port's f32 plain (xla) path on the same card.
4. Encode throughput at batch 64 (CUDA events), kernels against the plain
   eager bf16 path, and each kernel's time against its plain version.
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

# Per encoder block: 2 LayerNorms, 4 projections, 1 attention.
LAUNCHES_PER_BLOCK = {"layernorm": 2, "gemm_bias_act": 4, "attention": 1}

# Kernel-vs-plain bounds, relative to the largest |plain output|: the kernels
# round their outputs to bf16 (<= 2**-9 relative), the residual add rounds
# once more and f32 sums run in another order -> 2**-7; attention also rounds
# the probabilities to bf16 before p.v -> 2**-6.
REL_TOL = {"layernorm": 2**-7, "gemm_bias_act": 2**-7, "attention": 2**-6}

# Source and the Pallas kernel each replaces, as one file:line. layernorm and
# gemm_bias_act serve both sub-blocks (_mhsa_t_kernel at :71 and
# _mlp_t_kernel at :502): gemm_bias_act names the MLP kernel, where most of
# its time goes, and layernorm (one launch in each) the first.
KERNEL_INFO = {
    "layernorm": ("openvision_tpu_torch/csrc/layernorm.cu",
                  "openvision_tpu/ops/fused_encoder.py:71"),
    "gemm_bias_act": ("openvision_tpu_torch/csrc/gemm_bias_act.cu",
                      "openvision_tpu/ops/fused_encoder.py:502"),
    "attention": ("openvision_tpu_torch/csrc/attention.cu",
                  "openvision_tpu/ops/fused_encoder.py:71"),
}

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


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


def kernel_cases(fe, device, gen, b: int, l: int, d: int = 1024, heads: int = 16,
                 mlp: int = 4096):
    """(kernel name, label, kernel thunk, plain thunk) at one block's shapes."""
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    m = b * l
    x = rnd(b, l, d).bfloat16()
    ln_w, ln_b = rnd(d, scale=0.1) + 1, rnd(d, scale=0.1)
    proj = {
        "qkv": (rnd(3 * d, d, scale=d**-0.5).bfloat16(), rnd(3 * d, scale=0.1), False, False, d),
        "out+res": (rnd(d, d, scale=d**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, d),
        "fc1+gelu": (rnd(mlp, d, scale=d**-0.5).bfloat16(), rnd(mlp, scale=0.1), True, False, d),
        "fc2+res": (rnd(d, mlp, scale=mlp**-0.5).bfloat16(), rnd(d, scale=0.1), False, True, mlp),
    }
    inputs = {d: x, mlp: rnd(b, l, mlp).bfloat16()}
    qkv = rnd(b, l, 3 * d).bfloat16()
    cases = [("layernorm", f"LN ({m}x{d})",
              lambda: fe.layernorm(x, ln_w, ln_b, 1e-6),
              lambda: fe.layernorm_plain(x.float(), ln_w, ln_b, 1e-6))]
    for label, (w, bias, gelu, res, k) in proj.items():
        a = inputs[k]
        r = x if res else None
        cases.append((
            "gemm_bias_act", f"{label} ({m}x{w.shape[0]}x{k})",
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.gemm_bias_act(a, w, bias, gelu=gelu,
                                                                          residual=r),
            lambda a=a, w=w, bias=bias, gelu=gelu, r=r: fe.linear_plain(
                a.float(), w.float(), bias, gelu=gelu, residual=None if r is None else r.float())))
    for nomax in (False, True):
        cases.append((
            "attention", f"attn b={b} L={l} H={heads} nomax={nomax}",
            lambda nomax=nomax: fe.attention(qkv, heads, nomax=nomax),
            lambda nomax=nomax: fe.attention_plain(qkv.float(), heads, nomax=nomax)))
    return cases


def check_kernels(fe, device) -> dict:
    """Phase 2: every kernel within its bound of its plain version."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {name: 0.0 for name in REL_TOL}
    for b, l in ((8, 257), (3, 101)):
        for name, label, kern, plain in kernel_cases(fe, device, gen, b, l):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            bound = REL_TOL[name] * ref.abs().max().item()
            ok = err <= bound and bool(torch.isfinite(got).all())
            print(f"  {name:14s} {label:42s} max|err|={err:.3e}  bound={bound:.3e}  "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {label}: max|err| {err} > bound {bound}")
            worst[name] = max(worst[name], err)
    return worst


def time_kernels(fe, device, batch: int = 64) -> dict:
    """Phase 4b: one encoder block's launches of each kernel at `batch`, ms."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    times = {name: {"ms": 0.0, "plain_ms": 0.0} for name in REL_TOL}
    for name, label, kern, plain in kernel_cases(fe, device, gen, batch, 257):
        if "nomax=True" in label:
            continue  # the encode path runs the max-subtracted softmax
        k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
        print(f"  {name:14s} {label:42s} kernel {k_ms * 1e3:9.1f} us   plain {p_ms * 1e3:9.1f} us")
        times[name]["ms"] += k_ms
        times[name]["plain_ms"] += p_ms
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from openvision_tpu_torch.ops import fused_encoder as fe
    from openvision_tpu_torch.ops import kernels
    from openvision_tpu_torch.serving.encode import build_encode_fn
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

    with torch.inference_mode():
        phase("2. kernels against their plain versions (bf16 in, plain in f32)")
        worst = check_kernels(fe, device)

        phase("3. main path: ViT-L/14-224 + text-L, random weights (seed 0)")
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

            fe.reset_launch_counts()
            z = encode(torch.from_numpy(padded).to(device, torch.bfloat16))[:len(images)]
            torch.cuda.synchronize()
            after_encode = dict(fe.LAUNCHES)
            results = zero_shot.rank(model, names, images)
            torch.cuda.synchronize()
            launches = dict(fe.LAUNCHES)
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
        del plain
        times = time_kernels(fe, device)

    phase("summary")
    print(f"card: {smi}")
    print(f"encode b=64 img/s: kernels {rates['kernels']}  plain eager bf16 {rates['plain']}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"]}
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
