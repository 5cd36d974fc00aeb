"""Image captioning CLI over the CoCa caption decoder.

Counterpart of ``openvision_tpu/tools/caption.py``: the decoder's fixed
learnable query tokens condition on [image tokens ++ text tokens], so the
caption logits for every position come from one forward pass; the text
prefix is [bos] + pads, so the caption is read off the image alone. Greedy
(temperature 0) or temperature sampling with optional top-k / top-p, drawn
from a ``torch.Generator`` seeded by ``--seed``; ids after the first eos
become pad. Images get the eval preprocessing (``resize_small`` bilinear
with antialias, ``central_crop``, ``vgg_value_range``).

Usage:
  python -m openvision_tpu_torch.tools.caption --checkpoint ckpt.npz \
      --config "res=224,img=L/14,txt_name=L,txt_decoder_name=L,dtype=bfloat16" \
      --image_folder testcat [--temperature 0.7 --top_k 40] [--device cuda]

The checkpoint is a flat npz (the JAX package's ``save_npz``, or the port
trainer's own train state: one process or a process mesh, the save gathers
it whole), an Orbax train-state directory (the newest committed step, or
``--step``) or a legacy tensorstore one (``train/checkpoint.py``). With
``--device cuda`` the ``fused``, ``fused_t`` and ``flash`` attention picks run
the hand-written kernels, which take bf16: a float32 config with such a pick
on CUDA raises rather than running the plain path. ``--device cpu`` runs the
plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from openvision_tpu_torch.configs import openvision as cfg_mod
from openvision_tpu_torch.data import ops_image
from openvision_tpu_torch.data.tokenizer import get_tokenizer
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.models.decoder import generate
from openvision_tpu_torch.models.encoder import cast_block_matrices
from openvision_tpu_torch.tools.model_io import DEFAULT_VOCAB, resolve_device
from openvision_tpu_torch.train.checkpoint import load_state_dict
from openvision_tpu_torch.train.step import DTYPES, build_model

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
KERNEL_IMPLS = ("fused", "fused_t", "flash", "scan")


def preprocess(image, res: int) -> np.ndarray:
    """HWC uint8 (or encoded bytes) -> the eval-time (res, res, 3) f32 image."""
    image = ops_image.resize_small(image, res, method="bilinear", antialias=True)
    return ops_image.vgg_value_range(ops_image.central_crop(image, res))


def load_image(path: str, res: int) -> np.ndarray:
    with open(path, "rb") as f:
        return preprocess(f.read(), res)


class Captioner:
    """caption(images) -> ids, over a loaded CLIP/CoCa model."""

    def __init__(self, model: CLIPModel, token_len: int, tok, device: torch.device):
        self.model = model
        self.token_len = token_len
        self.device = device
        self.bos = tok.bos_id if tok.bos_id is not None else tok.cls_id
        self.eos = tok.eos_id if tok.eos_id is not None else tok.sep_id
        self.pad = tok.pad_id

    @torch.inference_mode()
    def tokens(self, images):
        """The decoder's inputs for (N, res, res, 3) preprocessed images: the
        image tower's patch tokens and the text tower's pre-norm tokens of
        the [bos] + pads prefix (what ``CLIPModel`` hands its decoder)."""
        images = torch.as_tensor(images, device=self.device)
        text = torch.full((images.shape[0], self.token_len), self.pad, dtype=torch.long,
                          device=self.device)
        text[:, 0] = self.bos
        _, image_tokens = self.model.visual(images)
        _, text_tokens = self.model.text(text)
        return image_tokens, text_tokens

    @torch.inference_mode()
    def logits(self, images) -> torch.Tensor:
        """(N, res, res, 3) preprocessed images -> (N, queries, vocab) f32."""
        return self.model.txt_decoder(*self.tokens(images))

    @torch.inference_mode()
    def __call__(self, images, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        return generate(self.model.txt_decoder, *self.tokens(images), temperature=temperature,
                        top_k=top_k, top_p=top_p, generator=generator, eos_id=self.eos,
                        pad_id=self.pad)


def build_captioner(config: dict, checkpoint: str, vocab_path: str = DEFAULT_VOCAB, *,
                    device="cuda", step: int | None = None):
    """Returns (Captioner, tokenizer) for `checkpoint` (an npz, or an Orbax
    directory at `step`, the newest by default, or a legacy one)."""
    m = config["model"]
    dtype = DTYPES[m["image"]["dtype"]]
    impls = {m["image"]["attn_impl"], m["text"]["attn_impl"],
             m["text_decoder_config"]["attn_impl"]}
    if (torch.device(device).type == "cuda" and dtype != torch.bfloat16
            and impls & set(KERNEL_IMPLS)):
        raise ValueError(
            f"attention impls {sorted(impls & set(KERNEL_IMPLS))} run the CUDA kernels, "
            f"which take bfloat16, but the config's dtype is {m['image']['dtype']}: add "
            "dtype=bfloat16, or attn_impl=xla,dec_attn_impl=xla for the plain path")
    device = resolve_device(device)
    with device:  # its zero parameters allocated on the device, where the checkpoint fills them
        model = build_model(config)
    model.load_state_dict(load_state_dict(checkpoint, step))
    model = model.to(device).eval().requires_grad_(False)
    cast_block_matrices(model, dtype)
    tok = get_tokenizer(vocab_path)
    return Captioner(model, config["input"]["txt_token_length"], tok, device), tok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="npz file, Orbax checkpoint directory or legacy tensorstore directory")
    p.add_argument("--config", default="res=224,img=L/14,txt_name=L,txt_decoder_name=L",
                   help="config arg string (configs/openvision.py)")
    p.add_argument("--image", action="append", default=[])
    p.add_argument("--image_folder", default=None)
    p.add_argument("--step", type=int, default=None,
                   help="step of an Orbax checkpoint directory (default: the newest)")
    p.add_argument("--temperature", type=float, default=0.0, help="0 = greedy; >0 = sampled")
    p.add_argument("--top_k", type=int, default=0,
                   help="sample from the k most probable tokens (0 = off; implies "
                   "--temperature 1.0 when temperature is unset)")
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling (0 = off; implies --temperature 1.0 when "
                   "temperature is unset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab", default=DEFAULT_VOCAB)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if (args.top_k or args.top_p) and args.temperature <= 0.0:
        args.temperature = 1.0  # top_k / top_p are sampling warpers

    config = cfg_mod.get_config(args.config)
    paths = list(args.image)
    if args.image_folder:
        paths += sorted(os.path.join(args.image_folder, f) for f in os.listdir(args.image_folder)
                        if f.lower().endswith(IMG_EXTS))
    if not paths:
        p.error("no images given (--image / --image_folder)")

    captioner, tok = build_captioner(config, args.checkpoint, args.vocab, device=args.device,
                                     step=args.step)
    images = np.stack([load_image(f, config["res"]) for f in paths])
    gen = torch.Generator(device=captioner.device).manual_seed(args.seed)
    ids = captioner(images, args.temperature, args.top_k, args.top_p, generator=gen)
    for path, row in zip(paths, ids.cpu().tolist()):
        print(f"{path}\t{tok.decode(row)}")


if __name__ == "__main__":
    main()
