"""Export CLI: an npz, Orbax or legacy checkpoint -> OpenCLIP artifacts.

Counterpart of ``openvision_tpu/convert/export.py`` (reference
transfer_jax2hf.py): loads a checkpoint's params
(``train/checkpoint.py``), maps them to an OpenCLIP state dict
(``convert/openclip.py:jax_to_openclip``), synthesizes
``open_clip_config.json`` from the same variant tables, materializes the
fixed sincos2d image position embedding when the source has none, saves
``open_clip_pytorch_model.bin`` and ``vocab.txt``, and runs a parity probe:
the port's ViT on the source params against the export reloaded through
``tools/model_io.load_model`` (f32 ``xla``, on the card when there is one),
max |delta| of the image embedding. The Hugging Face upload
(``--repo``/``--token``) needs the network and raises. A tree with the
``map`` pool or the ``stem`` or ``linear`` patch embed raises, as the JAX
export raises on it (its OpenCLIP config has an ``avg`` pool and a conv
patch embed: JAX fails in ``jax_to_openclip`` on a linear embed and in the
parity probe on the other two); the port raises before it writes.

Usage:
  python -m openvision_tpu_torch.convert.export \\
      --checkpoint /path/to/orbax_dir_or.npz --out /path/to/export \\
      --img L/14 --txt L --res 224 --out_dim 768
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict, jax_to_openclip

# OpenCLIP config tables per variant (reference transfer_jax2hf.py:76-92).
VISION_MODEL_CONFIG = {
    "Ti": {"layers": 12, "width": 192, "head_width": 64},
    "S": {"layers": 12, "width": 384, "head_width": 64},
    "B": {"layers": 12, "width": 768, "head_width": 64},
    "L": {"layers": 24, "width": 1024, "head_width": 64},
    "So400m": {"layers": 27, "width": 1152, "head_width": 72, "mlp_ratio": 3.7362},
    "H": {"layers": 32, "width": 1280, "head_width": 80},
}
TEXT_MODEL_CONFIG = {
    "Ti": {"layers": 12, "width": 192, "heads": 3},
    "S": {"layers": 12, "width": 384, "heads": 6},
    "B": {"layers": 12, "width": 512, "heads": 8},
    "L": {"layers": 12, "width": 768, "heads": 12},
    "So400m": {"layers": 27, "width": 1152, "heads": 16, "mlp_ratio": 3.7362},
    "H": {"layers": 24, "width": 1024, "heads": 16},
}


def synthesize_config(img_variant: str, txt_variant: str, *, res: int, out_dim: int,
                      context_length: int = 80, vocab_size: int = 32000) -> dict:
    v = img_variant.split("/")[0]
    patch = int(img_variant.split("/")[1]) if "/" in img_variant else 16
    vision_cfg = dict(VISION_MODEL_CONFIG[v], patch_size=patch, image_size=res, pool_type="avg",
                      final_ln_after_pool=True, no_ln_pre=True)
    text_cfg = dict(TEXT_MODEL_CONFIG[txt_variant.split("/")[0]], context_length=context_length,
                    vocab_size=vocab_size, pool_type="last", no_causal_mask=True,
                    act_kwargs={"approximate": "tanh"})
    return {"model_cfg": {"embed_dim": out_dim, "vision_cfg": vision_cfg, "text_cfg": text_cfg},
            "preprocess_cfg": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}}


def load_params_any(path: str, step: int | None = None):
    """The params of an npz file (its ``params`` subtree if it holds a train
    state), an Orbax directory or a legacy tensorstore one."""
    from openvision_tpu_torch.train.checkpoint import load_checkpoint

    return load_checkpoint(path, step)


def check_exportable(params) -> None:
    """Raises on an image tower the OpenCLIP config cannot describe."""
    img = params["img"]
    kernel = img.get("embedding", {}).get("kernel")
    found = [what for what, hit in (
        ("the map pool (MAPHead_0)", "MAPHead_0" in img),
        ("the stem patch embed (stem_0)", "stem_0" in img),
        ("the linear patch embed (a 2-D embedding kernel)",
         kernel is not None and len(kernel.shape) == 2)) if hit]
    if found:
        raise ValueError(f"the OpenCLIP export takes a conv patch embed and the gap/avg pools; "
                         f"this tree has {' and '.join(found)}")


def parity_probe(params, cfg: dict, out_dir: str, device=None) -> float:
    """Max |delta| between the port's ViT on the source params and the
    export's vision tower loaded by ``tools/model_io.load_model``, f32
    ``xla``, on one grey image."""
    from openvision_tpu_torch.models.vit import ViT
    from openvision_tpu_torch.tools.model_io import load_model

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    vcfg = cfg["model_cfg"]["vision_cfg"]
    posemb = "learn" if "pos_embedding" in params["img"] else "sincos2d"
    src = ViT(num_classes=cfg["model_cfg"]["embed_dim"],
              patch_size=(vcfg["patch_size"], vcfg["patch_size"]), width=vcfg["width"],
              depth=vcfg["layers"], mlp_dim=int(vcfg["width"] * vcfg.get("mlp_ratio", 4.0)),
              num_heads=vcfg["width"] // vcfg["head_width"], posemb=posemb, pool_type="gap",
              emb_head_bias=False, image_size=vcfg["image_size"])
    src.load_state_dict({k.removeprefix("visual."): v for k, v in
                         jax_params_to_state_dict({"img": params["img"]}).items()})
    src = src.to(device).eval()
    exported = load_model(out_dir, device=device).vision
    x = torch.full((1, vcfg["image_size"], vcfg["image_size"], 3), 0.5, device=device)
    with torch.inference_mode():
        return float((src(x) - exported(x)).abs().max())


def export(checkpoint: str, out_dir: str, *, img: str, txt: str, res: int, out_dim: int,
           context_length: int = 80, vocab_size: int = 30522, step: int | None = None,
           repo: str | None = None, token: str | None = None, device=None) -> float:
    """Writes the OpenCLIP artifacts of `checkpoint` to `out_dir`; returns
    the parity probe's max |delta|."""
    if repo or token:
        raise NotImplementedError("--repo/--token upload to the Hugging Face Hub, which needs "
                                  "the network; copy the export directory instead")
    from openvision_tpu_torch.models.layers import posemb_sincos_2d
    from openvision_tpu_torch.tools.model_io import DEFAULT_VOCAB

    params = load_params_any(checkpoint, step)
    check_exportable(params)
    state_np = jax_to_openclip(params)
    cfg = synthesize_config(img, txt, res=res, out_dim=out_dim, context_length=context_length,
                            vocab_size=vocab_size)
    # a fixed sincos2d posemb has no param: materialize it for the torch model
    if "visual.positional_embedding" not in state_np:
        grid = res // cfg["model_cfg"]["vision_cfg"]["patch_size"]
        pe = posemb_sincos_2d(grid, grid, cfg["model_cfg"]["vision_cfg"]["width"],
                              cls_token=True)
        state_np["visual.positional_embedding"] = pe[0].numpy()

    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: torch.tensor(v) for k, v in state_np.items()},
               os.path.join(out_dir, "open_clip_pytorch_model.bin"))
    with open(os.path.join(out_dir, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    shutil.copy(DEFAULT_VOCAB, os.path.join(out_dir, "vocab.txt"))

    gap = parity_probe(params, cfg, out_dir, device)
    print(f"export written to {out_dir}; vision parity max|delta| = {gap:.2e}")
    return gap


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="npz file, Orbax or legacy directory")
    p.add_argument("--out", required=True)
    p.add_argument("--img", default="L/14")
    p.add_argument("--txt", default="L")
    p.add_argument("--res", type=int, default=224)
    p.add_argument("--out_dim", type=int, default=768)
    p.add_argument("--context_length", type=int, default=80)
    p.add_argument("--vocab_size", type=int, default=30522)
    p.add_argument("--step", type=int, default=None, help="Orbax step (default: the newest)")
    p.add_argument("--device", default=None, help="the parity probe's device (default: cuda "
                   "when there is a card, else cpu)")
    p.add_argument("--repo", default=None, help="Hugging Face upload: needs the network")
    p.add_argument("--token", default=None)
    a = p.parse_args(argv)
    return export(a.checkpoint, a.out, img=a.img, txt=a.txt, res=a.res, out_dim=a.out_dim,
                  context_length=a.context_length, vocab_size=a.vocab_size, step=a.step,
                  repo=a.repo, token=a.token, device=a.device)


if __name__ == "__main__":
    main()
