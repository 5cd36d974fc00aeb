"""PGD / adversarial probes on the zero-shot classifier.

Counterpart of ``openvision_tpu/tools/adversarial.py``, with the same CLI
and printout:

- :func:`pgd`: L-inf projected gradient ascent on the zero-shot
  classification loss (signed gradient, step 2/255, eps-ball projection,
  [0, 1] clamp). Untargeted maximizes the true label's loss;
  ``targeted=True`` descends on the target label's loss.
- :func:`adv`: the unsigned-gradient variant (lr 0.1).

The loss is the CLIP zero-shot cross-entropy: cosine(image, text
embeddings) x logit_scale against a label index. The JAX attack is one
jitted ``fori_loop``; here it is an eager loop, one input gradient an
iteration with the weights frozen (on ``fused`` that is the block
kernels' backward, ops/fused_attention.py). ``--out`` writes the
adversarial image as a PNG (``data/ops_image.py:encode_png``).

Usage:
  python -m openvision_tpu_torch.tools.adversarial --use_model <dir> \
      --image testcat/catcat.png --labels "a cat,a dog,text" \
      [--target "a dog"] [--eps 0.0314] [--iters 10] [--out adv.png] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from openvision_tpu_torch.tools.model_io import load_model


def _zero_shot_loss(vision, image01, mean, std, ztxt, scale, label):
    """Cross-entropy of the cosine zero-shot logits at `label`."""
    norm = (image01 - mean) / std
    zimg = vision(norm).float()
    zimg = zimg / (torch.linalg.norm(zimg, dim=-1, keepdim=True) + 1e-8)
    logits = scale * zimg @ ztxt.T  # (1, n_labels)
    return -torch.log_softmax(logits, dim=-1)[0, label]


def _attack(model, image01, ztxt, label, *, eps, step_size, iters, targeted, signed):
    dev = model.device
    image01 = torch.as_tensor(image01, dtype=torch.float32, device=dev)
    # encode_text's tensors are inference tensors: autograd cannot save them
    ztxt = torch.as_tensor(ztxt, device=dev).clone()
    mean = torch.tensor(model.mean, dtype=torch.float32, device=dev)
    std = torch.tensor(model.std, dtype=torch.float32, device=dev)
    sign = -1.0 if targeted else 1.0  # descend on the target's loss

    img = image01
    for _ in range(iters):
        x = img.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _zero_shot_loss(model.vision, x, mean, std, ztxt, model.logit_scale, label)
            (g,) = torch.autograd.grad(loss, x)
        g = torch.sign(g) if signed else g
        adv_img = img + sign * step_size * g
        perturb = torch.clamp(adv_img - image01, -eps, eps)
        img = torch.clamp(image01 + perturb, 0.0, 1.0)
    return img


def pgd(model, image01, ztxt, label, *, eps=8 / 255, step_size=2 / 255, iters=10,
        targeted=False):
    """L-inf PGD on the zero-shot loss. image01: (1, H, W, 3) in [0, 1]."""
    return _attack(model, image01, ztxt, label, eps=eps, step_size=step_size, iters=iters,
                   targeted=targeted, signed=True)


def adv(model, image01, ztxt, label, *, eps=8 / 255, lr=0.1, iters=10):
    """Unsigned-gradient attack."""
    return _attack(model, image01, ztxt, label, eps=eps, step_size=lr, iters=iters,
                   targeted=False, signed=False)


def classify(model, image01, ztxt) -> np.ndarray:
    """Softmax over the labels of one (1, H, W, 3) image in [0, 1]."""
    image01 = torch.as_tensor(image01, dtype=torch.float32, device=model.device)
    mean = torch.tensor(model.mean, dtype=torch.float32, device=model.device)
    std = torch.tensor(model.std, dtype=torch.float32, device=model.device)
    zimg = model.encode_image((image01 - mean) / std)
    logits = model.logit_scale * zimg @ torch.as_tensor(ztxt, device=model.device).T
    return torch.softmax(logits, dim=-1)[0].cpu().numpy()


def _load_image01(model, path) -> np.ndarray:
    """resize-small (bicubic, antialiased) -> centre crop -> [0, 1], as
    (1, S, S, 3) f32."""
    from openvision_tpu_torch.data.ops_image import _resize, _to_image_array

    with open(path, "rb") as f:
        arr = _to_image_array(f.read())
    s = model.image_size
    h, w = arr.shape[:2]
    ratio = s / min(h, w)
    arr = _resize(arr, round(h * ratio), round(w * ratio), "bicubic", True)
    h, w = arr.shape[:2]
    top, left = (h - s) // 2, (w - s) // 2
    return arr[top:top + s, left:left + s][None].astype(np.float32) / 255.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--labels", required=True,
                        help="comma-separated candidate texts")
    parser.add_argument("--target", default=None,
                        help="targeted attack towards this label text")
    parser.add_argument("--eps", type=float, default=8 / 255)
    parser.add_argument("--step_size", type=float, default=2 / 255)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--unsigned", action="store_true",
                        help="use the unsigned-gradient variant (make_adv)")
    parser.add_argument("--out", default=None, help="save adversarial png")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    model = load_model(args.use_model, device=args.device)
    labels = [s.strip() for s in args.labels.split(",")]
    ztxt = model.encode_text(model.tokenize(labels))

    image01 = torch.as_tensor(_load_image01(model, args.image), device=model.device)
    probs = classify(model, image01, ztxt)
    pred = int(probs.argmax())
    print("clean prediction:")
    for i, (l, p) in enumerate(zip(labels, probs)):
        print(f"  {'->' if i == pred else '  '} {l}: {p:.4f}")

    if args.target is not None:
        label = labels.index(args.target)
        targeted = True
    else:
        label = pred
        targeted = False

    if args.unsigned:
        adv_img = adv(model, image01, ztxt, label, eps=args.eps, iters=args.iters)
    else:
        adv_img = pgd(model, image01, ztxt, label, eps=args.eps, iters=args.iters,
                      step_size=args.step_size, targeted=targeted)

    probs2 = classify(model, adv_img, ztxt)
    pred2 = int(probs2.argmax())
    mode = f"targeted->{args.target}" if targeted else "untargeted"
    print(f"after {mode} {'adv' if args.unsigned else 'pgd'} "
          f"(eps={args.eps:.4f}, {args.iters} iters):")
    for i, (l, p) in enumerate(zip(labels, probs2)):
        print(f"  {'->' if i == pred2 else '  '} {l}: {p:.4f}")
    linf = float((adv_img - image01).abs().max())
    print(f"L-inf perturbation: {linf:.5f} (eps {args.eps:.5f})")

    if args.out:
        from openvision_tpu_torch.data.ops_image import encode_png

        arr = np.clip(adv_img[0].cpu().numpy() * 255, 0, 255).astype(np.uint8)
        with open(args.out, "wb") as f:
            f.write(encode_png(arr))
        print(f"saved {args.out}")


if __name__ == "__main__":
    main()
