"""Model construction, the train state and one update step.

Counterpart of ``openvision_tpu/train/step.py`` on one device:
:func:`normalize_uint8` (:53), :func:`build_model` (:59),
:func:`init_train_state` (:73; the model from a seed, and the optimizer of
``optim.py``) and :func:`make_update_fn` at ``grad_accum=1`` (:131-264):
the device-side uint8 normalize, both towers and the caption decoder with
``train=True``, the loss of the config's ``loss_type`` (``coca``: the CLIP
loss over the two caption views plus the head-fused caption cross-entropy,
its chunk capped at ~32Mi f32 logits, :215-229; ``clip``; ``siglip`` needs
a logit bias and is not ported), backward, the optimizer update, and the
measurements: t, t/parameter, nimg, ntxt, the loss terms, and ``l2_grads``
(over the parameters that are not frozen), ``l2_params`` and
``l2_updates`` with f32 accumulation (:39-50, :255-261). ``grad_accum > 1``
raises (not ported yet). The image tower's drop-path masks come from
:func:`step_generator`, seeded from the config seed and the optimizer's step
count, as the JAX step folds the count into its rng (:175-183): a resumed
run draws the masks an uninterrupted one draws.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from openvision_tpu_torch import losses, optim
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.models.init import init_params

# ImageNet mean/std x 255: the device-side uint8 prologue.
IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() - mean) / std


def build_model(config: dict) -> CLIPModel:
    """The CLIP/CoCa model of a config dict (``configs/openvision.py``),
    its parameters zero until initialized or loaded."""
    if config.get("param_dtype", "float32") != "float32":
        raise NotImplementedError("param_dtype other than float32 is not ported yet")
    m = config["model"]

    def typed(cfg):
        return {**cfg, "dtype": DTYPES[cfg["dtype"]]}

    return CLIPModel(
        out_dim=tuple(m["out_dim"]), image=typed(m["image"]), text=typed(m["text"]),
        text_decoder=m.get("text_decoder", "text_decoder"),
        text_decoder_config=typed(m["text_decoder_config"]),
        temperature_init=m.get("temperature_init", 10.0))


def init_train_state(config: dict, model: CLIPModel, *, total_steps: int,
                     data_size: int | None = None, seed: int | None = None) -> optim.Optimizer:
    """Draws the model's parameters from `seed` (default config["seed"]) and
    returns its optimizer (whose state starts at step 0)."""
    init_params(model, config.get("seed", 0) if seed is None else seed)
    return optim.Optimizer(config, dict(model.named_parameters()), sched_kw=dict(
        total_steps=total_steps, batch_size=config["input"]["batch_size"],
        data_size=data_size))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of one step's random draws (drop-path), a function of
    (seed, step) only."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_loss_fn(config: dict, model: CLIPModel) -> Callable:
    """loss_fn(batch on the device, rng=None) -> (loss, measurements),
    differentiable; `rng` draws the drop-path masks."""
    if int(config.get("grad_accum", 1) or 1) > 1:
        raise NotImplementedError("grad_accum > 1 (the embedding-cached microbatched step) is "
                                  "not ported yet")
    loss_type = config.get("loss_type", "coca")
    if loss_type not in ("coca", "clip"):
        raise NotImplementedError(f"loss_type {loss_type!r} is not ported yet (siglip needs the "
                                  "logit bias)")
    mode = "local" if config.get("local_loss", True) else "global"
    clip_w = config.get("clip_loss_weight", 1.0)
    cap_w = config.get("coca_caption_loss_weight", 2.0)
    cap_chunk = config.get("cap_xent_chunk", 16)
    cpu_uint8 = config.get("cpu_unit8", False)

    def loss_fn(batch: dict, rng: torch.Generator | None = None):
        images = normalize_uint8(batch["image"]) if cpu_uint8 else batch["image"].float()
        labels = torch.cat([batch["labels1"], batch["labels2"]], dim=0)
        zimg, ztxt, out = model(images, labels, train=True, rng=rng)
        half = ztxt.shape[0] // 2
        loss, extras = losses.bidirectional_contrastive_loss(
            zimg, [ztxt[:half], ztxt[half:]], out["t"], mode=mode)
        if loss_type == "coca":
            clip_loss = loss
            if out.get("cap_prelogits") is not None:
                kernel = model.txt_decoder.head.weight  # (V, D)
                rows = batch["autoreg_labels"].shape[0]
                chunk = max(1, min(cap_chunk, (32 << 20) // (rows * kernel.shape[0])))
                cap_loss = losses.linear_softmax_xent(
                    prelogits=out["cap_prelogits"], kernel=kernel,
                    labels=batch["autoreg_labels"], mask=batch["cap_loss_mask"], chunk=chunk)
            else:
                cap_loss = losses.softmax_xent(logits=out["logits"],
                                               labels=batch["autoreg_labels"],
                                               mask=batch["cap_loss_mask"])
            extras = dict(extras, clip_loss=clip_loss, caption_loss=cap_loss)
            loss = clip_w * clip_loss + cap_w * cap_loss
        return loss, {"t": out["t"], "t/parameter": out["t/parameter"],
                      "nimg": out["img/norm"].mean(), "ntxt": out["txt/norm"].mean(), **extras}

    return loss_fn


def make_update_fn(config: dict, model: CLIPModel, opt: optim.Optimizer) -> Callable:
    """update_fn(batch) -> measurements: one optimizer step on `batch` (a
    dict of arrays, moved to the model's device). Measurements are 0-d
    tensors on the device."""
    loss_fn = make_loss_fn(config, model)
    params = dict(model.named_parameters())
    seed = config.get("seed", 0)

    def update_fn(batch: dict) -> dict:
        device = next(model.parameters()).device
        for p in params.values():
            p.grad = None
        loss, measurements = loss_fn(to_device(batch, device),
                                     rng=step_generator(seed, opt.state["count"]))
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        updates = opt.step(grads)
        measurements = {k: v.detach().reshape(()) for k, v in measurements.items()}
        measurements["training_loss"] = loss.detach()
        measurements["l2_grads"] = optim.l2_norm(grads[n] for n in opt.live)
        measurements["l2_params"] = optim.l2_norm(p.detach() for p in params.values())
        measurements["l2_updates"] = optim.l2_norm(updates.values())
        return measurements

    return update_fn
