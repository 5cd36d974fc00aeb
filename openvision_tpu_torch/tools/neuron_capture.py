"""Top-activating neuron finder (+ optional visualization).

Counterpart of ``openvision_tpu/tools/neuron_capture.py``, with the same CLI
and printout: for an input image, capture every encoder block's GELU
activations in one forward pass (forward hooks, ``tools/capture.py``, where
JAX reads sown intermediates) and report the most activated features per
layer; with ``--visualize``, feature-visualize each layer's top neuron. The
image is decoded by the package's decoder (``data/ops_image.py``), so a
plain PNG needs no Pillow. A model whose MLPs run on the ``mlp_block``
kernels (``fused_t``, or ``fused`` with tanh GELU) has no GELU output to
capture and raises by name.

Usage:
  python -m openvision_tpu_torch.tools.neuron_capture --use_model <dir> \
      --image testcat/catcat.png [--layer 0-23] [--topk 3] [--visualize] \
      [--out ovNeurons] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from openvision_tpu_torch.tools.capture import gelu_hooks
from openvision_tpu_torch.tools.model_io import load_model


def capture_gelu(model, image) -> dict:
    """One forward pass of the image (bytes or HWC uint8); returns
    {layer_idx: (tokens, mlp_dim) f32 activations}."""
    norm = torch.as_tensor(model.preprocess(image)[None], dtype=torch.float32,
                           device=model.device)
    layers = range(len(model.vision.transformer.resblocks))
    with torch.inference_mode(), gelu_hooks(model.vision, layers) as acts:
        model.vision(norm)
        return {i: acts[i][0].float().cpu().numpy() for i in layers}


def top_neurons(acts: dict, topk: int = 1):
    """Per layer: the top-k features by max-over-tokens activation.

    Returns {layer: [(feature, value, token), ...]}.
    """
    result = {}
    for layer, a in acts.items():
        per_feature = a.max(axis=0)  # (mlp_dim,)
        order = np.argsort(per_feature)[::-1][:topk]
        result[layer] = [
            (int(f), float(per_feature[f]), int(a[:, f].argmax()))
            for f in order
        ]
    return result


def main(argv=None):
    from openvision_tpu_torch.data.ops_image import _to_image_array
    from openvision_tpu_torch.tools.feature_viz import DETERMINISTIC_SEED, parse_range

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--layer", default=None,
                        help='layers to report, e.g. "0-23" (default: all)')
    parser.add_argument("--topk", type=int, default=3)
    parser.add_argument("--visualize", action="store_true",
                        help="feature-visualize each layer's top neuron")
    parser.add_argument("--out", default="ovNeurons")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model = load_model(args.use_model, device=args.device)
    with open(args.image, "rb") as f:
        image = _to_image_array(f.read())
    acts = capture_gelu(model, image)
    if args.layer:
        keep = set(parse_range(args.layer, max(acts) + 1))
        acts = {k: v for k, v in acts.items() if k in keep}

    tops = top_neurons(acts, args.topk)
    global_best = (None, -np.inf, None)  # (layer, value, feature)
    for layer, feats in tops.items():
        desc = ", ".join(f"F{f} ({v:.3f} @tok{t})" for f, v, t in feats)
        print(f"layer {layer:>2}: {desc}")
        if feats and feats[0][1] > global_best[1]:
            global_best = (layer, feats[0][1], feats[0][0])
    layer, value, feature = global_best
    print(f"top neuron overall: layer {layer} feature {feature} ({value:.3f})")

    if args.visualize:
        from openvision_tpu_torch.tools.feature_viz import save_image, visualize

        os.makedirs(args.out, exist_ok=True)
        model_name = os.path.basename(os.path.normpath(args.use_model))
        gen = torch.Generator(device=model.device).manual_seed(
            DETERMINISTIC_SEED if args.deterministic else 0)
        for lyr, feats in tops.items():
            f0 = feats[0][0]
            img = visualize(model, lyr, f0, model.image_size, gen)
            path = os.path.join(args.out, f"{model_name}_L{lyr}_F{f0}.png")
            save_image(img, path)
            print(f"saved {path}")


if __name__ == "__main__":
    main()
