"""Model construction, the train state and one update step.

Counterpart of ``openvision_tpu/train/step.py``:
:func:`normalize_uint8` (:53), :func:`build_model` (:59),
:func:`init_train_state` (:73; the model from a seed, placed on the process
mesh, and the optimizer of ``optim.py``) and :func:`make_update_fn` at
``grad_accum=1`` (:131-264):
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

On a process mesh (``parallel/mesh.py``; the JAX ``sharding.mesh``
(data, fsdp, tensor), one process per rank):

- placement (:func:`shard_model`): every process draws the whole model from
  the seed, then keeps its tensor shard of each attention whose heads divide
  by tensor (the q, k, v rows of its heads and the matching out-projection
  columns) and of each MLP whose hidden width does (its fc1 rows and fc2
  columns); every other leaf is replicated over tensor. With fsdp > 1,
  FSDP2 ``fully_shard`` shards every leaf's rows over fsdp, each encoder
  and cross-attention block its own unit, HSDP over the 2-D (data, fsdp)
  mesh (replicated over data);
- each process runs the model on its batch rows (``Mesh.batch_rows``; the
  processes of one tensor group share them); its loss is its share of the
  global mean (the contrastive loss's local rows over the shard count, the
  caption cross-entropy's masked sum over the global mask count), so the
  shares of the data x fsdp processes sum to the loss;
- the gradients of every leaf are summed over data x fsdp once, as the
  JAX step's psum of one global-mean loss: FSDP2's reduce-scatter and
  all-reduce with a divide factor of 1 for the leaves it chunks, one
  all-reduce of the other leaves' flattened gradients. The tensor axis's
  sums are the blocks' own (``parallel.copy_to_tensor``, the TP block's
  backward), so replicated leaves come out the same on every tensor rank;
- the measurements are the global ones: the loss terms summed over the
  batch shards, the embedding norms averaged, and the l2 norms of
  ``Optimizer.global_norm``.

Under one process (no mesh, or a mesh of one) the step is the one-device
step. The one-device assumptions it checks: the global batch divides by
data x fsdp; ``grad_accum`` 1; ``loss_type`` coca or clip.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from openvision_tpu_torch import losses, optim
from openvision_tpu_torch.convert.openclip import shard_tensor
from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.models.decoder import CrossAttnBlock
from openvision_tpu_torch.models.encoder import EncoderBlock
from openvision_tpu_torch.models.init import init_params
from openvision_tpu_torch.models.layers import MlpBlock
from openvision_tpu_torch.parallel import Mesh, active_mesh, all_reduce

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


def tensor_plan(model: torch.nn.Module, size: int) -> dict:
    """The leaves a tensor axis of `size` shards (name -> kind, see
    ``convert/openclip.py``): each attention whose heads divide by it (the
    JAX ``_tp_info`` rule) and each MLP whose hidden width does."""
    plan = {}
    if size == 1:
        return plan
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention) and m.num_heads % size == 0:
            plan.update({f"{name}.in_proj_weight": "qkv", f"{name}.in_proj_bias": "qkv",
                         f"{name}.out_proj.weight": "cols"})
        elif isinstance(m, MlpBlock) and m.c_fc.out_features % size == 0:
            plan.update({f"{name}.c_fc.weight": "rows", f"{name}.c_fc.bias": "rows",
                         f"{name}.c_proj.weight": "cols"})
    return plan


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh) -> dict:
    """Keeps this process's tensor shard of every leaf :func:`tensor_plan`
    names (the model holds the whole leaves, the same on every process) and
    marks their modules; returns the plan."""
    plan = tensor_plan(model, mesh.tensor)
    rank = mesh.coords["tensor"]
    for name, kind in plan.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        setattr(module, leaf, torch.nn.Parameter(
            shard_tensor(p.data, kind, rank, mesh.tensor).clone(), requires_grad=p.requires_grad))
    for name, m in model.named_modules():
        if f"{name}.in_proj_weight" in plan or f"{name}.c_fc.weight" in plan:
            m.tensor_parallel = mesh.tensor
    return plan


def apply_fsdp(model: torch.nn.Module, mesh: Mesh) -> set:
    """FSDP2 over the (data, fsdp) mesh (HSDP: rows sharded over fsdp,
    replicated over data): each encoder and cross-attention block a unit,
    the model the root; gradients summed, not averaged. Returns the names
    of the leaves it chunks (all but the 0-d temperature, which FSDP2 does
    not take: it stays replicated, its gradient summed by the step)."""
    from torch.distributed.fsdp import fully_shard

    dp_mesh = mesh.device_mesh["data", "fsdp"]
    units = [m for m in model.modules() if isinstance(m, (EncoderBlock, CrossAttnBlock))]
    scalars = {p for p in model.parameters() if p.ndim == 0}
    for m in units + [model]:
        fully_shard(m, mesh=dp_mesh, ignored_params=scalars if m is model else None)
        m.set_gradient_divide_factor(1.0)
        m.set_force_sum_reduction_for_comms(True)  # plain sums (gloo has no PREMUL_SUM)
    return {n for n, p in model.named_parameters() if hasattr(p, "device_mesh")}


def local(t: torch.Tensor) -> torch.Tensor:
    """This process's piece of a leaf (the local chunk of an FSDP2 DTensor,
    a view that in-place updates write through)."""
    return t.to_local() if hasattr(t, "to_local") else t


def init_train_state(config: dict, model: CLIPModel, *, total_steps: int,
                     data_size: int | None = None, seed: int | None = None,
                     mesh: Mesh | None = None, params: dict | None = None) -> optim.Optimizer:
    """Draws the model's parameters from `seed` (default config["seed"]) or
    loads the whole state dict `params`, places them on `mesh` (tensor
    shards, FSDP2 with fsdp > 1) and returns the optimizer over this
    process's pieces (whose state starts at step 0)."""
    init_params(model, config.get("seed", 0) if seed is None else seed)
    if params is not None:
        model.load_state_dict(params)
    plan, chunked = {}, set()
    if mesh is not None:
        plan = shard_model(model, mesh)
        if mesh.shape["fsdp"] > 1:
            chunked = apply_fsdp(model, mesh)
    named = {n: local(p) for n, p in model.named_parameters()}
    return optim.Optimizer(config, named, sched_kw=dict(
        total_steps=total_steps, batch_size=config["input"]["batch_size"],
        data_size=data_size), mesh=mesh, tensor_plan=plan, fsdp_chunked=chunked)


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
        """This process's share of the loss (the loss itself in one process)."""
        mesh = active_mesh()
        if mode == "global" and mesh is not None and mesh.batch_shards > 1:
            raise NotImplementedError("local_loss=False (the global contrastive mode) runs on one "
                                      "process only; the mesh takes the local mode")
        images = normalize_uint8(batch["image"]) if cpu_uint8 else batch["image"].float()
        labels = torch.cat([batch["labels1"], batch["labels2"]], dim=0)
        zimg, ztxt, out = model(images, labels, train=True, rng=rng)
        half = ztxt.shape[0] // 2
        loss, extras = losses.bidirectional_contrastive_loss(
            zimg, [ztxt[:half], ztxt[half:]], out["t"], mode=mode, mesh=mesh)
        if loss_type == "coca":
            clip_loss = loss
            mask = batch["cap_loss_mask"]
            # the global batch's mask count (JAX normalizes the whole batch)
            count = mask.float().sum() if mesh is None else all_reduce(
                mask.float().sum(), mesh.batch_group)
            if out.get("cap_prelogits") is not None:
                kernel = model.txt_decoder.head.weight  # (V, D)
                rows = batch["autoreg_labels"].shape[0]
                chunk = max(1, min(cap_chunk, (32 << 20) // (rows * kernel.shape[0])))
                cap_loss = losses.linear_softmax_xent(
                    prelogits=out["cap_prelogits"], kernel=kernel,
                    labels=batch["autoreg_labels"], mask=mask, chunk=chunk, normalize=False)
            else:
                cap_loss = (losses.softmax_xent(logits=out["logits"],
                                                labels=batch["autoreg_labels"],
                                                reduction=False) * mask).sum()
            cap_loss = cap_loss / (count + 1e-8)
            extras = dict(extras, clip_loss=clip_loss, caption_loss=cap_loss)
            loss = clip_w * clip_loss + cap_w * cap_loss
        return loss, {"t": out["t"], "t/parameter": out["t/parameter"],
                      "nimg": out["img/norm"].mean(), "ntxt": out["txt/norm"].mean(), **extras}

    return loss_fn


SHARES = ("training_loss", "clip_loss", "caption_loss")  # summed over the batch shards


def sum_over_batch(grads: dict, mesh: Mesh) -> None:
    """Sums the gradients over data x fsdp in place: one all-reduce of
    them flattened."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]), mesh.batch_group)
    offset = 0
    for g in grads.values():
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_grad_fn(config: dict, model: CLIPModel, opt: optim.Optimizer) -> Callable:
    """grad_fn(batch, rng=None) -> (measurements, grads): the loss and its
    gradients on `batch` (on the device; this process's rows), the
    gradients summed over data x fsdp, as this process's pieces (name ->
    tensor, laid out as ``opt.params``); the measurements (0-d tensors)
    the global ones, ``training_loss`` the loss."""
    loss_fn = make_loss_fn(config, model)
    params = dict(model.named_parameters())

    def grad_fn(batch: dict, rng: torch.Generator | None = None):
        mesh = opt.mesh
        for p in params.values():
            p.grad = None
        loss, measurements = loss_fn(batch, rng=rng)
        loss.backward()
        grads = {n: (local(p.grad) if p.grad is not None else torch.zeros_like(opt.params[n]))
                 for n, p in params.items()}
        measurements = {k: v.detach().reshape(()) for k, v in measurements.items()}
        measurements["training_loss"] = loss.detach()
        if mesh is not None and mesh.batch_shards > 1:
            # FSDP2 summed the leaves it chunks
            sum_over_batch({n: g for n, g in grads.items() if n not in opt.fsdp_chunked}, mesh)
            for k in measurements:  # loss shares sum; per-shard means average
                total = all_reduce(measurements[k], mesh.batch_group)
                measurements[k] = total if k in SHARES else total / mesh.batch_shards
        return measurements, grads

    return grad_fn


def make_update_fn(config: dict, model: CLIPModel, opt: optim.Optimizer) -> Callable:
    """update_fn(batch) -> measurements: one optimizer step on `batch` (a
    dict of arrays, moved to the model's device). Measurements are 0-d
    tensors on the device."""
    grad_fn = make_grad_fn(config, model, opt)
    seed = config.get("seed", 0)

    def update_fn(batch: dict) -> dict:
        device = next(model.parameters()).device
        measurements, grads = grad_fn(to_device(batch, device),
                                      rng=step_generator(seed, opt.state["count"]))
        updates = opt.step(grads)
        measurements["l2_grads"] = opt.global_norm({n: grads[n] for n in opt.live})
        measurements["l2_params"] = opt.global_norm(
            {n: p.detach() for n, p in opt.params.items()})
        measurements["l2_updates"] = opt.global_norm(updates)
        return measurements

    return update_fn
