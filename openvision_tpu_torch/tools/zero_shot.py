"""Zero-shot classification CLI over a folder of images (testcat set).

Counterpart of ``openvision_tpu/tools/zero_shot.py``, with the same CLI
and output: loads a converted OpenVision checkpoint dir, encodes the 9
fixed probe labels, scores each image in the folder (cosine + softmax with
the model's logit scale), and prints per-image rankings and the best image
per text. :func:`rank` is the ranking step on a loaded model and decoded
images; :func:`run` reads the folder and calls it.

Usage:
  python -m openvision_tpu_torch.tools.zero_shot --use_model <dir> \
      [--img_folder testcat] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from openvision_tpu_torch.tools.model_io import load_model

TEXTS = [
    "a photo of a cat", "a photo of a dog", "a photo of a bat",
    "a photo of a text", "cat", "dog", "bat", "hey", "text",
]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def preprocess_square(model, image) -> np.ndarray:
    """Direct (size, size) resize + normalize (the reference tool's transform)."""
    from openvision_tpu_torch.data.ops_image import _resize, _to_image_array

    img = _to_image_array(image)
    s = model.image_size
    img = _resize(img, s, s, "bilinear", True).astype(np.float32) / 255.0
    return (img - np.asarray(model.mean)) / np.asarray(model.std)


def rank(model, filenames, images, texts=tuple(TEXTS)) -> list:
    """Scores decoded HWC images against `texts`; prints and returns
    [(filename, best text, its prob, all probs)]."""
    tokens = model.tokenize(list(texts))
    text_features = model.encode_text(tokens).cpu().numpy()

    results = []
    print("\n=== Cosine Similarities and Predictions ===")
    for filename, image in zip(filenames, images):
        img = preprocess_square(model, image).astype(np.float32)
        zimg = model.encode_image(img[None]).cpu().numpy()[0]
        cosine = text_features @ zimg
        logits = model.logit_scale * cosine
        probs = np.exp(logits - logits.max())
        probs = probs / probs.sum()

        print(f"\n--- {filename} ---")
        for idx in np.argsort(-cosine):
            print(f"{texts[idx]:<25} cosine: {cosine[idx]:+.4f}  prob: {probs[idx]:.4%}")
        best = int(np.argmax(probs))
        results.append((filename, texts[best], float(probs[best]), probs.tolist()))

    print("\n=== Best Image Per Text ===")
    best_images = [(None, -float("inf"))] * len(texts)
    for filename, _, _, prob_list in results:
        for i, p in enumerate(prob_list):
            if p > best_images[i][1]:
                best_images[i] = (filename, p)
    for i, (fname, p) in enumerate(best_images):
        print(f"{texts[i]:<25} → {fname}  (prob: {p:.4%})")
    return results


def run(model_dir: str, img_folder: str, texts=tuple(TEXTS), *, device="cuda") -> list:
    from openvision_tpu_torch.data.ops_image import _to_image_array

    model = load_model(model_dir, device=device)
    filenames = [f for f in sorted(os.listdir(img_folder)) if f.lower().endswith(IMAGE_EXTS)]
    images = []
    for filename in filenames:
        with open(os.path.join(img_folder, filename), "rb") as f:
            images.append(_to_image_array(f.read()))
    return rank(model, filenames, images, texts)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True, help="converted model dir")
    parser.add_argument("--img_folder", default="testcat")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    run(args.use_model, args.img_folder, device=args.device)


if __name__ == "__main__":
    main()
