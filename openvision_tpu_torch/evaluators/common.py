"""Evaluator framework: config -> [(name, evaluator, log_steps, prefix)].

Counterpart of ``openvision_tpu/evaluators/common.py``: :func:`from_config`
(:23) builds each entry of ``config["evals"]`` by its type with the model
injected, and each evaluator's ``run(train_state)`` returns
``[(metric_name, value)]``; :func:`device_norm_fn` (:47) normalises uint8
images on the device. Beside them, :class:`Towers` gives the evaluators one
view of the two kinds of model the port has: the trainer's ``CLIPModel``
(``visual`` and ``text``, f32 parameters) and ``tools/model_io.py``'s
``LoadedModel`` (``vision`` and ``text``, block matrices in the compute
dtype, int8 weights when loaded with ``int8=True``). The port's
``train_state`` carries no parameters of its own (they live in the model),
so ``run`` reads the model it was built with; the trainer passes
``{"model", "opt", "step"}``, the optimizer placing the model's leaves on a
process mesh.

On a process mesh every process runs every evaluator, in lockstep (each
collective of the towers, and each of the evaluators' own, is called the
same number of times everywhere): the processes of a tensor group see the
same rows, as in training, and :func:`gather_rows` puts the batch shards'
rows back together (JAX ``local_batch_to_global``). A ``CLIPModel``'s
towers run through its own forward, so FSDP2 gathers the leaves it does
not give a block of their own.
"""

from __future__ import annotations

import contextlib
import importlib
import re
from typing import Any, List, Tuple

import torch

_TYPES = {
    "discriminative_classifier": "openvision_tpu_torch.evaluators.disclf",
    "proj.image_text.discriminative_classifier": "openvision_tpu_torch.evaluators.disclf",
    "retrieval": "openvision_tpu_torch.evaluators.retrieval",
    "proj.image_text.retrieval": "openvision_tpu_torch.evaluators.retrieval",
    "contrastive": "openvision_tpu_torch.evaluators.contrastive",
    "proj.image_text.contrastive": "openvision_tpu_torch.evaluators.contrastive",
}


def from_config(config: dict, model, mesh=None, on_error=None) -> List[Tuple[str, Any, int, str]]:
    """Builds evaluators from config["evals"]. An evaluator whose data or
    config is unavailable is skipped alone (reported through
    ``on_error(name, exc)``) when `on_error` is given, else it raises."""
    evaluators = []
    for name, cfg in (config.get("evals") or {}).items():
        cfg = dict(cfg)
        etype = cfg.pop("type", name)
        log_steps = cfg.pop("log_steps", 1000)
        prefix = cfg.pop("prefix", f"{name}/")
        try:
            module = importlib.import_module(_TYPES.get(etype, etype))
            evaluator = module.Evaluator(model=model, mesh=mesh, **cfg)
        except Exception as e:
            if on_error is not None:
                on_error(name, e)
                continue
            raise
        evaluators.append((name, evaluator, log_steps, prefix))
    return evaluators


def device_norm_fn(spec: str):
    """f(image) -> image on the device for a spec of "" (the identity: the
    pp already normalised on the host), "vgg" (ImageNet mean/std from
    0..255, ``train/step.py:normalize_uint8``) or "value_range(lo,hi)" (a
    linear map from 0..255). Eval batches then cross to the card as uint8."""
    if not spec:
        return lambda image: image
    if spec == "vgg":
        from openvision_tpu_torch.train.step import normalize_uint8

        return normalize_uint8
    m = re.fullmatch(r"value_range\(\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*\)", spec)
    if not m:
        raise ValueError(f"unknown device_norm: {spec!r}")
    lo, hi = float(m.group(1)), float(m.group(2))
    return lambda image: image.float() * ((hi - lo) / 255.0) + lo


def batch_mesh(mesh):
    """`mesh` when it has several batch shards, else None."""
    return mesh if mesh is not None and mesh.batch_shards > 1 else None


def gather_rows(z: torch.Tensor, mesh) -> torch.Tensor:
    """Every batch shard's rows of `z`, in batch order (an all-gather over
    data x fsdp); `z` without a mesh of several batch shards."""
    if batch_mesh(mesh) is None:
        return z
    from openvision_tpu_torch.parallel import gather_batch

    return gather_batch(z.contiguous(), mesh)


def _normalized(z) -> torch.Tensor:
    z = (z[0] if isinstance(z, tuple) else z).float()
    return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)


class Towers:
    """The image and text towers of a ``CLIPModel`` or a ``LoadedModel``:
    L2-normalised f32 embeddings (norm + 1e-8, ``models/clip.py``), the
    device, and :meth:`evaluating`, which runs the towers in eval mode under
    ``torch.no_grad()`` and gives them back in the mode they had."""

    def __init__(self, model):
        self.model = model
        self.vision = model.visual if hasattr(model, "visual") else model.vision
        self.text = model.text
        self.int8 = getattr(model, "int8", None)  # LoadedModel(int8=True)'s int8 tower
        self.device = next(self.vision.parameters()).device

    def embed_images(self, images: torch.Tensor) -> torch.Tensor:
        if hasattr(self.model, "visual"):  # the CLIPModel's forward: the same normalisation
            return self.model(images, None)[0]
        return _normalized(self.vision(images))

    def embed_texts(self, tokens: torch.Tensor) -> torch.Tensor:
        if hasattr(self.model, "visual"):
            return self.model(None, tokens)[1]
        return _normalized(self.text(tokens))

    def temperature(self) -> torch.Tensor:
        """The exp'd logit scale, (1,) f32 on the device (``out["t"]``)."""
        t = self.model.logit_scale
        if isinstance(t, torch.Tensor):
            return t.detach().float().exp().reshape(1)
        return torch.tensor([t], dtype=torch.float32, device=self.device)

    @contextlib.contextmanager
    def evaluating(self):
        modes = [(m, m.training) for m in (self.vision, self.text)]
        try:
            for m, _ in modes:
                m.eval()
            with torch.no_grad():
                yield self
        finally:
            for m, was in modes:
                m.train(was)
