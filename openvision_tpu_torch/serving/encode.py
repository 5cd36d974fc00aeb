"""Batch image-encode serving CLI.

Counterpart of ``openvision_tpu/serving/encode.py``: loads a converted
OpenVision checkpoint directory, encodes a folder of images at a chosen
batch size and writes L2-normalized embeddings + filenames to an npz. On
CUDA it runs bf16 on the ``fused_t`` kernels with tanh GELU; the last batch
is padded to the batch size. ``--int8`` runs the W8A8 encode on the int8
kernels (``serving/quant.py``; serving accuracy: output cosine >= 0.995
against the float tower).

Usage:
  python -m openvision_tpu_torch.serving.encode --use_model <dir> \
      --img_folder images/ [--batch 256] [--int8] [--out embeddings.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def build_encode_fn(model, *, int8: bool, uint8_input: bool = False):
    """Returns (N, H, W, 3) images -> L2-normalized f32 embeddings on
    `model.device`, without waiting for the device.

    The images are normalized, or with `uint8_input` raw uint8 pixels that
    are normalized on the device as ``(x / 255 - mean) / std`` in f32
    (openvision_tpu/serving/encode.py:44-49). `int8` runs
    ``serving/quant.quantized_encode_fused`` on the weights that
    ``load_model(..., int8=True)`` quantised from the f32 tower.
    """
    vision, device = model.vision, model.device
    if uint8_input:
        mean = torch.tensor(model.mean, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)
        std = torch.tensor(model.std, dtype=torch.float32, device=device).reshape(1, 1, 1, 3)

        def norm(x):
            return (x.float() / 255.0 - mean) / std
    else:
        def norm(x):
            return x

    if not int8:
        @torch.inference_mode()
        def encode(images):
            z = vision(norm(torch.as_tensor(images, device=device))).float()
            return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)

        return encode

    from openvision_tpu_torch.serving.quant import quantized_encode_fused

    if model.int8 is None:
        raise ValueError("int8 encode needs the int8 weights, which are quantised from the f32 "
                         "tower as loaded: load the model with load_model(..., int8=True)")
    qparams, patch = model.int8, vision.conv1.stride[0]

    @torch.inference_mode()
    def encode_q(images):
        return quantized_encode_fused(qparams, norm(torch.as_tensor(images, device=device)),
                                      patch_size=patch, posemb=vision.posemb)

    return encode_q


def main(argv=None):
    from openvision_tpu_torch.data.ops_image import _to_image_array
    from openvision_tpu_torch.tools.model_io import load_model

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--img_folder", required=True)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--int8", action="store_true",
                        help="fused W8A8 kernels (serving accuracy mode)")
    parser.add_argument("--out", default="embeddings.npz")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--attn_impl", default=None,
                        help="attention backend; defaults to the fused_t kernels "
                             "on CUDA, xla elsewhere")
    parser.add_argument("--exact_gelu", action="store_true",
                        help="disable tanh-approx GELU (runs only with attn_impl xla)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    attn_impl = args.attn_impl or ("fused_t" if device.type == "cuda" else "xla")
    dtype = getattr(torch, args.dtype)
    model = load_model(args.use_model, dtype=dtype, attn_impl=attn_impl,
                       fast_gelu=not args.exact_gelu and attn_impl == "fused_t",
                       device=device, int8=args.int8)
    encode = build_encode_fn(model, int8=args.int8)

    files = sorted(f for f in os.listdir(args.img_folder) if f.lower().endswith(IMG_EXTS))
    if not files:
        raise SystemExit(f"no images in {args.img_folder}")

    embeds, times = [], []
    for i in range(0, len(files), args.batch):
        chunk = files[i:i + args.batch]
        imgs = []
        for f in chunk:
            with open(os.path.join(args.img_folder, f), "rb") as fh:
                imgs.append(model.preprocess(_to_image_array(fh.read())))
        imgs = np.stack(imgs).astype(np.float32)
        pad = args.batch - len(chunk)
        if pad:
            imgs = np.pad(imgs, ((0, pad), (0, 0), (0, 0), (0, 0)))
        x = torch.from_numpy(imgs).to(device=device, dtype=dtype)
        t0 = time.perf_counter()
        z = encode(x).cpu().numpy()  # the copy to the host waits for the device
        times.append(time.perf_counter() - t0)
        embeds.append(z[:len(chunk)])

    z = np.concatenate(embeds).astype(np.float32)
    np.savez(args.out, embeddings=z, files=np.asarray(files))
    steady = times[1:] or times  # the first batch includes the kernel build
    print(f"encoded {len(files)} images -> {args.out} "
          f"(dim {z.shape[1]}, {'int8' if args.int8 else args.dtype})")
    print(f"throughput: {args.batch * len(steady) / sum(steady):.1f} img/s "
          f"({'steady-state' if times[1:] else 'incl. first call'})")


if __name__ == "__main__":
    main()
