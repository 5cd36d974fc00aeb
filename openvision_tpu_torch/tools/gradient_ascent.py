"""Gradient-ascent "model opinion" text mining.

Counterpart of ``openvision_tpu/tools/gradient_ascent.py``, with the same
CLI, constants and outputs: a learnable [batch, n_tokens, vocab] logit
tensor selects hard tokens by straight-through Gumbel-softmax (tau = 1000);
the soft one-hot sequence [PAD ... PAD, tokens] (the learned tokens last)
goes through the text tower's embedding matrix (``models/text.py``, the
(N, L, V) branch); the loss is -100 x the mean cosine between the text
embedding and the embeddings of affine-augmented copies of the image; Adam
lr=5 (``tools/optimizers.py``, optax's update) for 340 iterations. The JAX
step is one jitted function; here it is an eager step. The image embedding
is taken under ``torch.no_grad()`` on the tower (JAX's ``stop_gradient``),
not through ``LoadedModel.encode_image``, whose inference-mode tensors could
not be saved for the backward.

``--deterministic`` seeds the ``torch.Generator`` with 6247423 (else 0); its
stream is not JAX's, so the mined tokens differ from the JAX tool's; the
step on given draws agrees with it.

Outputs: ``opinion-tokens/tokens_<img>.txt`` with the best decoded unique
tokens, and ``txtembeds/<img>_text_embedding.pt`` holding the best text
embeddings (a CPU f32 tensor, ``torch.save``), in the working directory.

Usage:
  python -m openvision_tpu_torch.tools.gradient_ascent --use_model <dir> \
      --use_image img.png [--deterministic] [--img_folder dir] [--batch_size 8] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from openvision_tpu_torch.tools import augment, optimizers
from openvision_tpu_torch.tools.model_io import load_model

DETERMINISTIC_SEED = 6247423
ITERATIONS = 340
N_TOKENS = 4
GUMBEL_TAU = 1000.0
LR = 5.0
LOSS_SCALE = -100.0
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".gif")


def gumbel_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """-log(-log(u)), u uniform in [tiny, 1) (``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_softmax_hard(gen, logits: torch.Tensor, tau: float, *, noise=None) -> torch.Tensor:
    """Straight-through hard Gumbel-softmax: the one-hot of the argmax in the
    forward, the softmax's gradient in the backward. The noise is drawn from
    `gen`, or given as `noise`."""
    g = gumbel_noise(gen, logits.shape) if noise is None else noise.to(logits.device)
    y_soft = torch.softmax((logits + g) / tau, dim=-1)
    y_hard = F.one_hot(y_soft.argmax(dim=-1), logits.shape[-1]).to(y_soft.dtype)
    return y_hard + y_soft - y_soft.detach()


def draw_step(gen: torch.Generator, batch: int, n_tokens: int, vocab: int) -> dict:
    """One iteration's draws: the Gumbel noise, then the affine augmentation."""
    return {"noise": gumbel_noise(gen, (batch, n_tokens, vocab)),
            "affine": augment.random_affine_draw(gen, batch, degrees=10.0, translate=0.1, p=0.8)}


def build_step(model, context_length: int, n_tokens: int, pad_id: int):
    """(step, optimizer): step(normu, opt_state, image, draws) -> (normu,
    opt_state, loss, per_sample, tx, tokens); `image` is the normalized
    (H, W, 3) image."""
    text, vision = model.text, model.vision
    vocab = model.vocab_size
    n_pad = context_length - n_tokens
    optimizer = optimizers.adam(LR)

    def loss_fn(normu, image, draws):
        soft = gumbel_softmax_hard(None, normu, GUMBEL_TAU, noise=draws["noise"])
        pad = F.one_hot(torch.full((normu.shape[0], n_pad), pad_id, device=normu.device),
                        vocab).to(soft.dtype)
        tokens = torch.cat([pad, soft], dim=1)  # learned tokens LAST

        tx = text(tokens)
        tx_n = tx / (torch.linalg.norm(tx, dim=-1, keepdim=True) + 1e-8)

        imgs = image[None].expand(normu.shape[0], *image.shape)
        imgs = augment.random_affine_apply(imgs, *draws["affine"])
        with torch.no_grad():
            z = vision(imgs).float()
            iii = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)

        cos = tx_n @ iii.T  # (B_text, B_img)
        per_sample = LOSS_SCALE * cos.mean(dim=1)
        return per_sample.mean(), (per_sample, tx, tokens)

    def step(normu, opt_state, image, draws):
        x = normu.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, (per_sample, tx, tokens) = loss_fn(x, image, draws)
            (grad,) = torch.autograd.grad(loss, x)
        updates, opt_state = optimizer.update(grad, opt_state)
        return (optimizers.apply_updates(normu, updates), opt_state, loss.detach(),
                per_sample.detach(), tx.detach(), tokens.detach())

    return step, optimizer


def load_normalized(model, img_path: str) -> torch.Tensor:
    """The image at `img_path` resized to the model's size (bilinear,
    antialiased) and normalized, (S, S, 3) f32 on the model's device."""
    from openvision_tpu_torch.data.ops_image import _resize, _to_image_array

    with open(img_path, "rb") as f:
        raw = _to_image_array(f.read())
    s = model.image_size
    img = _resize(raw, s, s, "bilinear", True).astype(np.float32) / 255.0
    img = (img - np.asarray(model.mean)) / np.asarray(model.std)
    return torch.as_tensor(img, dtype=torch.float32, device=model.device)


def run_for_image(model, img_path, *, batch_size, gen, checkin_step=50):
    from openvision_tpu_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer(model.vocab_path)
    img_name = os.path.splitext(os.path.basename(img_path))[0]
    print(f"\nRunning gradient ascent for {img_name}...")
    image = load_normalized(model, img_path)

    normu = torch.randn((batch_size, N_TOKENS, model.vocab_size), generator=gen,
                        device=gen.device)
    step, optimizer = build_step(model, model.context_length, N_TOKENS, pad_id=0)
    opt_state = optimizer.init(normu)

    best_loss = float("inf")
    best_tx = None
    bests: dict[float, str] = {}

    for j in range(ITERATIONS):
        draws = draw_step(gen, batch_size, N_TOKENS, model.vocab_size)
        normu, opt_state, loss, per_sample, tx, tokens = step(normu, opt_state, image, draws)
        cur = float(loss)
        if cur < best_loss or j % checkin_step == 0:
            ids = tokens.argmax(dim=-1).cpu().numpy()
            per = per_sample.float().cpu().numpy()
            for b in range(batch_size):
                text = tok.decode(ids[b].tolist())
                text = "".join(c if c.isprintable() else " " for c in text)
                bests[float(per[b])] = text
            bests = dict(sorted(bests.items())[:6])
        if cur < best_loss:
            best_loss = cur
            best_tx = tx.float().cpu().clone()
            print(f"New best loss: {best_loss:.3f}")
        if j % checkin_step == 0:
            print(f"Iteration {j}: Average Loss: {cur:.3f}")

    unique_tokens: set[str] = set()
    for text in list(bests.values())[:5]:
        for ch in ".;_-\\'\"^&#(),":
            text = text.replace(ch, "")
        unique_tokens.update(text.split())

    os.makedirs("opinion-tokens", exist_ok=True)
    with open(f"opinion-tokens/tokens_{img_name}.txt", "w", encoding="utf-8") as f:
        f.write(" ".join(sorted(unique_tokens)))

    os.makedirs("txtembeds", exist_ok=True)
    torch.save(best_tx, f"txtembeds/{img_name}_text_embedding.pt")
    print("\nBest text embedding saved to 'txtembeds'. "
          "Tokens (CLIP 'opinion') saved to 'opinion-tokens'.\n")
    return best_tx


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--use_model", required=True)
    parser.add_argument("--use_image", default=None)
    parser.add_argument("--img_folder", default="None")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.img_folder == "None" and not args.use_image:
        parser.error("--use_image or --img_folder required")

    model = load_model(args.use_model, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(
        DETERMINISTIC_SEED if args.deterministic else 0)
    if args.img_folder != "None":
        files = [
            os.path.join(args.img_folder, f)
            for f in sorted(os.listdir(args.img_folder))
            if f.lower().endswith(IMAGE_EXTS)
        ]
        for path in files:
            run_for_image(model, path, batch_size=args.batch_size, gen=gen)
            print(f"Done processing image: {path}")
    else:
        run_for_image(model, args.use_image, batch_size=args.batch_size, gen=gen)
        print(f"Done processing image: {args.use_image}")


if __name__ == "__main__":
    main()
