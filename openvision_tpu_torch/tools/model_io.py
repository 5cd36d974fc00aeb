"""Model loading for the zero-shot tool and the encode CLI.

Counterpart of ``openvision_tpu/tools/model_io.py``: loads a converted
OpenVision checkpoint directory (``open_clip_config.json`` +
``open_clip_pytorch_model.bin``) into the port's towers. The weights load
with ``torch.load(weights_only=True)`` onto the CPU, move to `device`, and
the encoder blocks' weight matrices are cast once to the compute `dtype`
(what the flax modules do at every call). With ``int8=True`` the image
tower's int8 serving weights are quantised first, from the f32 weights as
loaded (``serving/quant.py``), and kept beside the float tower. Hub tags (``hf-hub:``) and a
Hugging Face tokenizer in the model dir are not supported yet: tokens come
from the WordPiece vocab.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from openvision_tpu_torch.convert.openclip import openclip_to_state_dict
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.models.encoder import cast_block_matrices

DEFAULT_VOCAB = str(Path(__file__).resolve().parents[2] / "assets" / "bert_base_vocab_bos_eos.txt")
_DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
_DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class LoadedModel:
    vision: Any  # ViT module
    text: Any  # TextTransformer module
    logit_scale: float
    image_size: int
    context_length: int
    vocab_size: int
    mean: tuple
    std: tuple
    vocab_path: str
    device: torch.device
    model_dir: str = ""
    int8: dict | None = None  # serving/quant.quantize_vit_params of the f32 tower

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        """(N, H, W, 3) images (numpy or tensor) -> L2-normalized f32 (N, E)."""
        z = self.vision(torch.as_tensor(images, device=self.device)).float()
        return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)

    @torch.inference_mode()
    def encode_text(self, tokens) -> torch.Tensor:
        """(N, L) token ids -> L2-normalized f32 (N, E)."""
        z = self.text(torch.as_tensor(tokens, device=self.device)).float()
        return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)

    def tokenize(self, texts) -> np.ndarray:
        return tokenize_labels(list(texts), self.vocab_path, self.context_length)

    def preprocess(self, image) -> np.ndarray:
        """resize-small -> center-crop -> normalize, like the torch transform."""
        from openvision_tpu_torch.data.ops_image import _resize, _to_image_array

        img = _to_image_array(image)
        s = self.image_size
        h, w = img.shape[:2]
        ratio = s / min(h, w)
        img = _resize(img, round(h * ratio), round(w * ratio), "bicubic", True)
        h, w = img.shape[:2]
        top, left = (h - s) // 2, (w - s) // 2
        img = img[top:top + s, left:left + s].astype(np.float32) / 255.0
        return (img - np.asarray(self.mean)) / np.asarray(self.std)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def load_model(model_dir: str, *, vocab_path: str = DEFAULT_VOCAB,
               dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
               fast_gelu: bool = False, device="cuda", int8: bool = False) -> LoadedModel:
    """Loads ``open_clip_config.json`` + ``open_clip_pytorch_model.bin``;
    with `int8`, also the image tower's int8 weights (``LoadedModel.int8``)."""
    device = resolve_device(device)
    with open(os.path.join(model_dir, "open_clip_config.json")) as f:
        cfg = json.load(f)
    mcfg = cfg["model_cfg"]
    vcfg, tcfg = mcfg["vision_cfg"], mcfg["text_cfg"]
    pp = cfg.get("preprocess_cfg", {})

    v_width = vcfg["width"]
    v_heads = v_width // vcfg.get("head_width", 64)
    image_size = vcfg.get("image_size", 224)
    context_length = tcfg.get("context_length", 80)
    clip = CLIPModel(
        out_dim=mcfg["embed_dim"],
        image=dict(
            patch_size=(vcfg["patch_size"], vcfg["patch_size"]),
            width=v_width,
            depth=vcfg["layers"],
            mlp_dim=int(v_width * vcfg.get("mlp_ratio", 4.0)),
            num_heads=v_heads,
            posemb="learn",
            pool_type="gap",
            emb_head_bias=False,
            attn_impl=attn_impl,
            fast_gelu=fast_gelu,
            image_size=image_size,
            dtype=dtype,
        ),
        text=dict(
            width=tcfg["width"],
            depth=tcfg["layers"],
            mlp_dim=int(tcfg["width"] * tcfg.get("mlp_ratio", 4.0)),
            num_heads=tcfg["heads"],
            vocab_size=tcfg["vocab_size"],
            context_length=context_length,
            posemb="learn",
            pool_type=tcfg.get("pool_type", "last"),
            causal=not tcfg.get("no_causal_mask", False),
            dtype=dtype,
        ),
    )
    sd = torch.load(os.path.join(model_dir, "open_clip_pytorch_model.bin"),
                    map_location="cpu", weights_only=True)
    clip.load_state_dict(openclip_to_state_dict(sd))
    del sd
    clip = clip.to(device).eval().requires_grad_(False)
    qvision = None
    if int8:  # from the f32 weights, before the cast below
        from openvision_tpu_torch.serving.quant import quantize_vit_params

        qvision = quantize_vit_params(clip.visual)
    cast_block_matrices(clip, dtype)

    # a vocab.txt in the model dir (the JAX exports write one) overrides
    local_vocab = os.path.join(model_dir, "vocab.txt")
    if os.path.exists(local_vocab):
        vocab_path = local_vocab

    return LoadedModel(
        model_dir=model_dir,
        vision=clip.visual,
        text=clip.text,
        logit_scale=float(clip.logit_scale.detach().exp()),
        image_size=image_size,
        context_length=context_length,
        vocab_size=tcfg["vocab_size"],
        mean=tuple(pp.get("mean", _DEFAULT_MEAN)),
        std=tuple(pp.get("std", _DEFAULT_STD)),
        vocab_path=vocab_path,
        device=device,
        int8=qvision,
    )


def tokenize_labels(labels, vocab_path: str, max_len: int) -> np.ndarray:
    """bos + tokens + eos ... CLS-at-end tokenization for a list of strings."""
    from openvision_tpu_torch.data.tokenizer import (
        _encode_special,
        _finalize_clip_tokens,
        get_tokenizer,
    )

    tok = get_tokenizer(vocab_path)
    return np.stack([
        _finalize_clip_tokens(tok, _encode_special(tok, text, True, True), max_len, True)
        for text in labels
    ])
