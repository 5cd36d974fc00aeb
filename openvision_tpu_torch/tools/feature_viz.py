"""Feature-activation-maximization visualization.

Counterpart of ``openvision_tpu/tools/feature_viz.py``, with the same CLI,
constants and output: optimizes an input image to maximize one GELU feature
of one encoder block (captured by a forward hook, ``tools/capture.py``),
with a total-variation penalty, differentiable augmentations of a repeated
batch (colour jitter, gaussian noise, pixel jitter) and a clip to [0, 1]
after each step: Adamax lr=1.0 on a cosine decay over 400 steps
(``tools/optimizers.py``, optax's update). The JAX step is one jitted
function; here it is an eager step. The random stream (``torch.Generator``,
seeded 6247423 with ``--deterministic``, else 0) is not JAX's, so images
differ from the JAX tool's; the step on given draws agrees with it.

Saves ``<out>/<model>_L{layer}_F{feature}.png``.

Usage:
  python -m openvision_tpu_torch.tools.feature_viz --use_model <dir> \
      [--layer 0-23] [--feature 5,6,8] [--size 224] [--out ovFeatureViz] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from openvision_tpu_torch.tools import augment, optimizers
from openvision_tpu_torch.tools.capture import gelu_hooks
from openvision_tpu_torch.tools.model_io import load_model

STEPS = 400
LR = 1.0
TV_WEIGHT = 0.0005
REPEAT = 8
DETERMINISTIC_SEED = 6247423


def parse_range(spec: str, upper: int) -> list[int]:
    """Parses "0-23" / "5,6,8" / "7" into a list of ints."""
    out: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return [i for i in out if 0 <= i < upper]


def new_init(gen: torch.Generator, size: int) -> torch.Tensor:
    """Small random image init, (1, size, size, 3) around 0.5."""
    return 0.06 * torch.randn((1, size, size, 3), generator=gen, device=gen.device) + 0.5


def draw_augs(gen: torch.Generator, size: int) -> dict:
    """One step's augmentation draws for the REPEAT-image batch."""
    return {
        "color": augment.color_jitter_draw(gen, REPEAT, brightness=0.1, contrast=0.1),
        "noise": augment.gaussian_noise_draw(gen, (REPEAT, size, size, 3)),
        "shifts": augment.pixel_jitter_draw(gen, REPEAT, lim=max(1, size // 28)),
    }


def build_loss(model, layer: int, feature: int):
    """loss(image01, draws): -mean of `feature` of block `layer`'s GELU over
    the augmented REPEAT-image batch, plus the TV penalty."""
    vision = model.vision
    mean = torch.tensor(model.mean, dtype=torch.float32, device=model.device)
    std = torch.tensor(model.std, dtype=torch.float32, device=model.device)

    def loss_fn(image01, draws):
        imgs = augment.repeat_batch(image01, REPEAT)
        imgs = augment.color_jitter_apply(imgs, *draws["color"])
        imgs = augment.gaussian_noise_apply(imgs, draws["noise"], std=0.01)
        imgs = augment.pixel_jitter_apply(imgs, draws["shifts"])
        with gelu_hooks(vision, [layer]) as acts:
            vision((imgs - mean) / std)
            target = acts[layer][..., feature]
        tv = augment.total_variation(imgs)
        return -target.mean() + TV_WEIGHT * tv

    return loss_fn


def build_step(model, layer: int, feature: int):
    """(step, optimizer): step(image01, opt_state, draws) -> (image01,
    opt_state, loss), one Adamax update of the (1, S, S, 3) image."""
    loss_fn = build_loss(model, layer, feature)
    optimizer = optimizers.adamax(optimizers.cosine_decay_schedule(LR, STEPS))

    def step(image01, opt_state, draws):
        x = image01.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(x, draws)
            (grad,) = torch.autograd.grad(loss, x)
        updates, opt_state = optimizer.update(grad, opt_state)
        image01 = optimizers.apply_updates(image01, updates).clamp(0.0, 1.0)
        return image01, opt_state, loss.detach()

    return step, optimizer


def visualize(model, layer: int, feature: int, size: int, gen: torch.Generator) -> np.ndarray:
    step, optimizer = build_step(model, layer, feature)
    image01 = new_init(gen, size)
    opt_state = optimizer.init(image01)
    for i in range(STEPS):
        image01, opt_state, loss = step(image01, opt_state, draw_augs(gen, size))
        if i % 100 == 0:
            print(f"  L{layer} F{feature} step {i}: act-loss {float(loss):.4f}")
    return image01[0].float().cpu().numpy()


def save_image(img01: np.ndarray, path: str):
    """(H, W, 3) floats in [0, 1] -> an RGB PNG at `path`."""
    from openvision_tpu_torch.data.ops_image import encode_png

    arr = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--layer", default="0")
    parser.add_argument("--feature", default="0")
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--out", default="ovFeatureViz")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model = load_model(args.use_model, device=args.device)
    model_name = os.path.basename(os.path.normpath(args.use_model))
    os.makedirs(args.out, exist_ok=True)

    blocks = model.vision.transformer.resblocks
    depth, mlp_dim = len(blocks), blocks[0].mlp.c_fc.out_features
    gen = torch.Generator(device=model.device).manual_seed(
        DETERMINISTIC_SEED if args.deterministic else 0)

    for layer in parse_range(args.layer, depth):
        for feature in parse_range(args.feature, mlp_dim):
            img = visualize(model, layer, feature, args.size, gen)
            path = os.path.join(args.out, f"{model_name}_L{layer}_F{feature}.png")
            save_image(img, path)
            print(f"saved {path}")


if __name__ == "__main__":
    main()
