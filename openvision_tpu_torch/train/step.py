"""Model construction, the train state and one update step.

Counterpart of ``openvision_tpu/train/step.py``:
:func:`normalize_uint8` (:53), :func:`build_model` (:59),
:func:`init_train_state` (:73; the model from a seed, placed on the process
mesh, and the optimizer of ``optim.py``) and :func:`make_update_fn`
(:131-264):
the device-side uint8 normalize, both towers and the caption decoder with
``train=True``, the loss of the config's ``loss_type`` (``coca``: the CLIP
loss over the two caption views plus the head-fused caption cross-entropy,
its chunk capped at ~32Mi f32 logits, :215-229; ``clip``; ``siglip``, the
sigmoid pairing loss with the model's logit bias, the mean over the two
views), backward, the optimizer update, and the
measurements: t, t/parameter, nimg, ntxt, the loss terms, and ``l2_grads``
(over the parameters that are not frozen), ``l2_params`` and
``l2_updates`` with f32 accumulation (:39-50, :255-261). ``grad_accum > 1``
takes :func:`make_accum_grad_fn`, the GradCache step (:267-515), exact to
the big-batch one. The dropout, token-masking and drop-path masks come from
:func:`step_generator`, seeded from the config seed and the optimizer's step
count, as the JAX step folds the count into its rng (:175-183): a resumed
run draws the masks an uninterrupted one draws.

On a process mesh (``parallel/mesh.py``; the JAX ``sharding.mesh``
(data, fsdp, tensor, seq, pipe), one process per rank):

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
- the seq and pipe ranks hold every parameter and the same batch rows. A
  stack that kept its tokens sharded over ``seq`` (``ring``,
  ``models/encoder.py``) leaves each seq rank the gradients of its own
  tokens, so its blocks' gradients are summed over ``seq`` once a step
  (:func:`reduce_over_seq`, beside the pipe sum, in one order on every
  rank); the embeddings before its entry and the pool and heads after its
  exit see whole tokens and hold whole, equal gradients. A pipelined
  stack's stage holds its own layers' gradients only, so the gradients of
  the blocks of every stack that ran the pipeline are summed over ``pipe``
  once a step (:func:`reduce_over_pipe`, before the batch sum, in one order
  on every rank); the input gradient of the stack reached every stage in
  its backward. Every rank's parameters stay the same bits after a step;
- the measurements are the global ones: the loss terms summed over the
  batch shards, the embedding norms averaged, and the l2 norms of
  ``Optimizer.global_norm``.

Every loss type and mode runs on a mesh: siglip and the global
contrastive mode return this process's share too (``losses.py``), and
``grad_accum > 1`` is GradCache over the batch shards
(:func:`make_accum_grad_fn`). The per-sample draws (token masking,
drop-path) are drawn for the global batch, each process keeping its rows,
so a mesh step draws for a row what one process draws for it; dropout's
per-element draws fold in the batch shard (``models/layers.py``). Under
one process (no mesh, or a mesh of one) the step is the one-device step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from openvision_tpu_torch import losses, optim
from openvision_tpu_torch.convert.openclip import shard_tensor
from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.clip import CLIPModel
from openvision_tpu_torch.models.decoder import CrossAttnBlock, TextDecoder
from openvision_tpu_torch.models.encoder import Encoder, EncoderBlock
from openvision_tpu_torch.models.init import init_params
from openvision_tpu_torch.models.layers import MlpBlock
from openvision_tpu_torch.models.text import TextTransformer
from openvision_tpu_torch.models.vit import ViT
from openvision_tpu_torch.parallel import Mesh, active_mesh, all_reduce, sharded_mesh

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
    m = config["model"]
    out_dim = m["out_dim"]
    return CLIPModel(  # the towers' factories take the string dtypes (models/compat.py)
        out_dim=tuple(out_dim) if isinstance(out_dim, (list, tuple)) else out_dim,
        image=m["image"], text=m["text"],
        text_decoder=m.get("text_decoder", "text_decoder"),
        text_decoder_config=m["text_decoder_config"],
        temperature_init=m.get("temperature_init", 10.0),
        init_logit_bias=m.get("init_logit_bias"))


def _divides(name: str, n: int, size: int, what: str) -> None:
    if n % size:
        raise ValueError(f"{name}: its {what} ({n}) does not divide over tensor={size} (the "
                         "JAX rules shard it over tensor and refuse it too)")


def tensor_plan(model: torch.nn.Module, size: int) -> dict:
    """The leaves a tensor axis of `size` shards (name -> kind, see
    ``convert/openclip.py``): each attention whose heads divide by it (the
    JAX ``_tp_info`` rule), each MLP whose hidden width does, and the
    ``vocab`` axis of the JAX rules: the text tower's token embedding and
    the decoder's head by vocab rows, the two towers' heads by output
    features (one that the axis does not divide raises, as in JAX)."""
    plan = {}
    if size == 1:
        return plan
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, MultiHeadAttention) and m.num_heads % size == 0:
            plan.update({f"{pre}in_proj_weight": "qkv", f"{pre}in_proj_bias": "qkv",
                         f"{pre}out_proj.weight": "cols"})
        elif isinstance(m, MlpBlock) and m.c_fc.out_features % size == 0:
            plan.update({f"{pre}c_fc.weight": "rows", f"{pre}c_fc.bias": "rows",
                         f"{pre}c_proj.weight": "cols"})
        elif isinstance(m, TextTransformer):
            _divides(f"{pre}token_embedding", m.token_embedding.num_embeddings, size, "vocab")
            plan[f"{pre}token_embedding.weight"] = "rows"
            if m.num_classes:
                _divides(f"{pre}text_projection", m.num_classes, size, "output width")
                plan[f"{pre}text_projection"] = "cols"
        elif isinstance(m, ViT) and m.num_classes:
            _divides(f"{pre}proj", m.num_classes, size, "output width")
            plan[f"{pre}proj"] = "cols"
            if m.proj_bias is not None:
                plan[f"{pre}proj_bias"] = "rows"
        elif isinstance(m, TextDecoder):
            _divides(f"{pre}head", m.head.out_features, size, "vocab")
            plan[f"{pre}head.weight"] = "rows"
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
        pre = f"{name}." if name else ""
        if f"{pre}in_proj_weight" in plan or f"{pre}c_fc.weight" in plan:
            m.tensor_parallel = mesh.tensor
        if f"{pre}token_embedding.weight" in plan or f"{pre}head.weight" in plan:
            m.vocab_parallel = mesh.tensor
        if f"{pre}text_projection" in plan or f"{pre}proj" in plan:
            m.head_parallel = mesh.tensor
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
        data_size=data_size), mesh=mesh, tensor_plan=plan, fsdp_chunked=chunked,
        jax_layout=jax_layout(model))


def jax_layout(model: CLIPModel):
    """The port's names -> the JAX param tree (``partial_state_dict_to_jax_params``
    with the model's shapes and head counts): the leaf layout
    ``scale_by_factored_rms`` needs."""
    from openvision_tpu_torch.convert.openclip import partial_state_dict_to_jax_params
    from openvision_tpu_torch.train.checkpoint import jax_heads

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    heads = jax_heads(model)
    return lambda named: partial_state_dict_to_jax_params(named, shapes, **heads)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of one step's random draws (dropout, token masking,
    drop-path), a function of (seed, step) only."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def micro_seeds(rng: torch.Generator | None, accum: int) -> list:
    """One seed a microbatch, drawn from the step's `rng` (the JAX step
    folds the microbatch index into its key); Nones without one."""
    if rng is None:
        return [None] * accum
    return torch.randint(0, 2**62, (accum,), generator=rng, device=rng.device).tolist()


def micro_generator(seed: int | None) -> torch.Generator | None:
    """A fresh generator of one microbatch's draws. Both GradCache passes
    build their own from the same seed, so pass 2 replays pass 1's masking,
    dropout and drop-path draws (the towers draw before the decoder)."""
    return None if seed is None else torch.Generator().manual_seed(seed)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _loss_type(config: dict) -> str:
    loss_type = config.get("loss_type", "coca")
    if loss_type not in ("coca", "clip", "siglip"):
        raise ValueError(f"Unknown loss_type: {loss_type!r}")
    if loss_type == "siglip" and config["model"].get("init_logit_bias") is None:
        raise ValueError("loss_type siglip needs model.init_logit_bias")
    return loss_type


def contrastive_loss(loss_type: str, zimg, views, t, b, *, mode: str, mesh=None):
    """The image-text loss of `loss_type` over the text views (the mean
    over views): (this process's share of the loss, extras)."""
    if loss_type == "siglip":
        return sum(losses.siglip_loss(zimg, v, t, b, mode=mode, mesh=mesh)[0]
                   for v in views) / len(views), {}
    return losses.bidirectional_contrastive_loss(zimg, views, t, mode=mode, mesh=mesh)


def caption_sum(config: dict, model: CLIPModel, out: dict, batch: dict) -> torch.Tensor:
    """The masked sum of the caption cross-entropy over `batch`'s rows
    (head-fused, its chunk capped at ~32Mi f32 logits, when the decoder
    returns prelogits)."""
    mask = batch["cap_loss_mask"]
    if out.get("cap_prelogits") is not None:
        kernel = model.txt_decoder.head.weight  # (V, D), or this tensor rank's (V / t, D)
        rows = batch["autoreg_labels"].shape[0]
        chunk = max(1, min(config.get("cap_xent_chunk", 16), (32 << 20) // (rows * kernel.shape[0])))
        return losses.linear_softmax_xent(prelogits=out["cap_prelogits"], kernel=kernel,
                                          labels=batch["autoreg_labels"], mask=mask, chunk=chunk,
                                          normalize=False,
                                          mesh=sharded_mesh(model.txt_decoder.vocab_parallel))
    return (losses.softmax_xent(logits=out["logits"], labels=batch["autoreg_labels"],
                                reduction=False) * mask).sum()


def forward(config: dict, model: CLIPModel, batch: dict, rng=None, caption: bool = True):
    """The training forward on `batch` (on the device): (zimg, ztxt, out),
    ztxt the two caption views stacked."""
    images = normalize_uint8(batch["image"]) if config.get("cpu_unit8", False) \
        else batch["image"].float()
    labels = torch.cat([batch["labels1"], batch["labels2"]], dim=0)
    return model(images, labels, train=True, rng=rng, caption=caption)


def _aux(out: dict) -> dict:
    return {"t": out["t"], "t/parameter": out["t/parameter"], "nimg": out["img/norm"].mean(),
            "ntxt": out["txt/norm"].mean()}


def mask_count(batch: dict, mesh) -> torch.Tensor:
    """The global batch's caption mask count (JAX normalizes the whole
    batch): this process's, summed over data x fsdp on a mesh."""
    count = batch["cap_loss_mask"].float().sum()
    return count if mesh is None else all_reduce(count, mesh.batch_group)


def make_loss_fn(config: dict, model: CLIPModel) -> Callable:
    """loss_fn(batch on the device, rng=None) -> (loss, measurements),
    differentiable; `rng` draws the dropout, masking and drop-path masks."""
    loss_type = _loss_type(config)
    mode = "local" if config.get("local_loss", True) else "global"
    clip_w = config.get("clip_loss_weight", 1.0)
    cap_w = config.get("coca_caption_loss_weight", 2.0)

    def loss_fn(batch: dict, rng: torch.Generator | None = None):
        """This process's share of the loss (the loss itself in one process)."""
        mesh = active_mesh()
        zimg, ztxt, out = forward(config, model, batch, rng, caption=loss_type == "coca")
        half = ztxt.shape[0] // 2
        loss, extras = contrastive_loss(loss_type, zimg, [ztxt[:half], ztxt[half:]], out["t"],
                                        out.get("b"), mode=mode, mesh=mesh)
        if loss_type == "coca":
            clip_loss = loss
            count = mask_count(batch, mesh)
            cap_loss = caption_sum(config, model, out, batch) / (count + 1e-8)
            extras = dict(extras, clip_loss=clip_loss, caption_loss=cap_loss)
            loss = clip_w * clip_loss + cap_w * cap_loss
        return loss, {**_aux(out), **extras}

    return loss_fn


SHARES = ("training_loss", "clip_loss", "caption_loss")  # summed over the batch shards


def sum_over(grads: dict, group) -> None:
    """Sums the gradients over `group` in place: one all-reduce of them
    flattened."""
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads.values()]), group)
    offset = 0
    for g in grads.values():
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _stack_grads(grads: dict, model: torch.nn.Module, flag: str) -> dict:
    """The gradients of the blocks of every Encoder whose last call set
    `flag` (``pipelined`` or ``seq_sharded``), in the model's order."""
    prefixes = tuple(f"{name}.resblocks." if name else "resblocks."
                     for name, m in model.named_modules()
                     if isinstance(m, Encoder) and getattr(m, flag))
    return {n: g for n, g in grads.items() if prefixes and n.startswith(prefixes)}


def reduce_over_seq(grads: dict, model: torch.nn.Module, opt: optim.Optimizer) -> None:
    """On a mesh with seq > 1, in place: the gradients of the blocks of
    every stack whose last call kept its tokens sharded over ``seq`` (each
    rank holds its tokens' share) summed over ``seq``, one all-reduce of
    them flattened; an FSDP2-chunked leaf's piece is summed as it is (the
    ranks of a seq group hold the same chunk)."""
    mesh = opt.mesh
    if mesh is None or mesh.seq == 1:
        return
    partial = _stack_grads(grads, model, "seq_sharded")
    if partial:
        sum_over(partial, mesh.seq_group)


def reduce_over_pipe(grads: dict, model: torch.nn.Module, opt: optim.Optimizer) -> None:
    """On a mesh with pipe > 1, in place: the gradients of the blocks of
    every stack whose last call ran the pipeline (each stage holds its own
    layers' share, zeros elsewhere) summed over ``pipe``, one all-reduce of
    them flattened; an FSDP2-chunked leaf's piece is summed as it is (the
    ranks of a pipe group hold the same chunk)."""
    mesh = opt.mesh
    if mesh is None or mesh.pipe == 1:
        return
    partial = _stack_grads(grads, model, "pipelined")
    if partial:
        sum_over(partial, mesh.pipe_group)


def reduce_over_batch(measurements: dict, grads: dict, opt: optim.Optimizer) -> None:
    """On a mesh of several batch shards, in place: the gradients summed over
    data x fsdp (FSDP2 summed the leaves it chunks), the loss shares summed
    and the per-shard means averaged."""
    mesh = opt.mesh
    if mesh is None or mesh.batch_shards == 1:
        return
    sum_over({n: g for n, g in grads.items() if n not in opt.fsdp_chunked}, mesh.batch_group)
    for k in measurements:
        total = all_reduce(measurements[k], mesh.batch_group)
        measurements[k] = total if k in SHARES else total / mesh.batch_shards


def _grads(params: dict, opt: optim.Optimizer) -> dict:
    return {n: (local(p.grad) if p.grad is not None else torch.zeros_like(opt.params[n]))
            for n, p in params.items()}


def make_grad_fn(config: dict, model: CLIPModel, opt: optim.Optimizer) -> Callable:
    """grad_fn(batch, rng=None) -> (measurements, grads): the loss and its
    gradients on `batch` (on the device; this process's rows), the
    gradients summed over data x fsdp, as this process's pieces (name ->
    tensor, laid out as ``opt.params``); the measurements (0-d tensors)
    the global ones, ``training_loss`` the loss. With ``grad_accum > 1``,
    :func:`make_accum_grad_fn`."""
    accum = int(config.get("grad_accum", 1) or 1)
    if accum > 1:
        return make_accum_grad_fn(config, model, opt, accum)
    loss_fn = make_loss_fn(config, model)
    params = dict(model.named_parameters())

    def grad_fn(batch: dict, rng: torch.Generator | None = None):
        for p in params.values():
            p.grad = None
        loss, measurements = loss_fn(batch, rng=rng)
        loss.backward()
        grads = _grads(params, opt)
        measurements = {k: v.detach().reshape(()) for k, v in measurements.items()}
        measurements["training_loss"] = loss.detach()
        reduce_over_pipe(grads, model, opt)
        reduce_over_seq(grads, model, opt)
        reduce_over_batch(measurements, grads, opt)
        return measurements, grads

    return grad_fn


def make_accum_grad_fn(config: dict, model: CLIPModel, opt: optim.Optimizer,
                       accum: int) -> Callable:
    """The ``grad_accum > 1`` gradient, exact to the big-batch one
    (GradCache, arXiv:2101.06983; JAX ``_make_update_fn_accum`` :267-515).

    The batch splits into `accum` strided microbatches (microbatch i holds
    rows i::accum, JAX ``_microbatch`` :117-129), each with a seed of its
    own (:func:`micro_seeds`), from which both passes build a fresh
    generator, so the embeddings pass 2 differentiates are pass 1's:

    - pass 1: the towers forward only, without autograd, the normalized
      embeddings kept (the decoder does not run);
    - the bridge: the contrastive (or SigLIP) loss of the whole batch on
      those embeddings, and its gradient with respect to them, to the
      log-temperature and to the logit bias;
    - pass 2: per microbatch, the forward again with autograd (towers,
      decoder and the caption cross-entropy's masked sum), then one
      backward with the bridge's embedding gradients (times the CLIP
      weight) and cap_w / (the global mask count) as the cotangents,
      accumulating into the parameters' f32 gradients.

    The caption sum splits exactly and the contrastive term factors through
    the embeddings, so the gradients are the accum=1 step's up to summation
    order.

    On a process mesh `batch` is this process's rows and microbatch i its
    rows i::accum: the JAX strided global microbatch, sharded over (data,
    fsdp), gives each shard exactly those rows when `accum` divides the
    local batch (else this raises). The microbatch seeds are the same on
    every process, and the towers draw a microbatch's masks for the global
    microbatch (``models/layers.py:global_rows``). The bridge runs the local
    or global loss on the local embeddings through ``parallel.gather_batch``,
    so its gradients with respect to them are the whole loss's; the mask
    count is the global one. Pass 2's backwards leave FSDP2's reduce-scatter
    to the last microbatch, and the other leaves' gradients (the bridge's
    temperature and bias terms included) are summed over data x fsdp once a
    step, as in :func:`make_grad_fn`.
    """
    loss_type = _loss_type(config)
    mode = "local" if config.get("local_loss", True) else "global"
    clip_w = config.get("clip_loss_weight", 1.0)
    cap_w = config.get("coca_caption_loss_weight", 2.0)
    coca = loss_type == "coca"
    w_clip = clip_w if coca else 1.0
    params = dict(model.named_parameters())
    mesh = opt.mesh
    batch_mesh = mesh if mesh is not None and mesh.batch_shards > 1 else None
    fsdp = bool(opt.fsdp_chunked)

    def grad_fn(batch: dict, rng: torch.Generator | None = None):
        b = batch["image"].shape[0]
        if b % accum:
            raise ValueError(f"grad_accum={accum} must divide the batch {b}" + (
                "" if batch_mesh is None else
                f" that this process holds (the global batch over {mesh.batch_shards} shards)"))
        m = b // accum
        keys = ["image", "labels1", "labels2"] + (["autoreg_labels", "cap_loss_mask"] if coca
                                                  else [])
        micro = [{k: batch[k][i::accum] for k in keys} for i in range(accum)]
        seeds = micro_seeds(rng, accum)

        # pass 1: the embeddings, no autograd, no decoder
        zimgs, v1s, v2s, auxs = [], [], [], []
        with torch.no_grad():
            for mb, seed in zip(micro, seeds):
                zimg, ztxt, out = forward(config, model, mb, micro_generator(seed), caption=False)
                zimgs.append(zimg)
                v1s.append(ztxt[:m])
                v2s.append(ztxt[m:])
                auxs.append(_aux(out))
        measurements = {k: torch.stack([a[k].detach().reshape(()) for a in auxs]).mean()
                        for k in auxs[0]}

        # the bridge: the whole batch's loss on the embeddings
        leaves = [torch.cat(z).requires_grad_(True) for z in (zimgs, v1s, v2s)]
        t_param = model.logit_scale.detach().float().reshape(1).requires_grad_(True)
        b_param = None if model.logit_bias is None else \
            model.logit_bias.detach().float().reshape(1).requires_grad_(True)
        with torch.enable_grad():
            l_clip, extras = contrastive_loss(loss_type, leaves[0], leaves[1:], t_param.exp(),
                                              b_param, mode=mode, mesh=batch_mesh)
            wrt = leaves + [t_param] + ([b_param] if b_param is not None else [])
            g_zi, g_v1, g_v2, g_t, *g_b = torch.autograd.grad(l_clip, wrt)
        mask_sum = mask_count(batch, batch_mesh) + 1e-8 if coca else None

        # pass 2: per microbatch, the backward of the forward with the bridge's cotangents
        for p in params.values():
            p.grad = None
        cap_sums = []
        for i, (mb, seed) in enumerate(zip(micro, seeds)):
            if fsdp:  # FSDP2 reduce-scatters the accumulated gradients once, after the last
                model.set_requires_gradient_sync(i == accum - 1)
            rows = slice(i * m, (i + 1) * m)
            zimg, ztxt, out = forward(config, model, mb, micro_generator(seed), caption=coca)
            outs = [zimg, ztxt]
            cots = [w_clip * g_zi[rows], w_clip * torch.cat([g_v1[rows], g_v2[rows]])]
            if coca:
                cap = caption_sum(config, model, out, mb)
                outs.append(cap)
                cots.append((cap_w / mask_sum).to(cap.dtype))
                cap_sums.append(cap.detach())
            torch.autograd.backward(outs, cots)
        grads = _grads(params, opt)
        # the temperature's and the bias's gradients come through the bridge
        grads["logit_scale"] = grads["logit_scale"] + w_clip * g_t.reshape(())
        if g_b:
            grads["logit_bias"] = grads["logit_bias"] + w_clip * g_b[0].reshape(())

        measurements.update({k: v.detach().reshape(()) for k, v in extras.items()})
        if coca:
            cap_l = torch.stack(cap_sums).sum() / mask_sum
            measurements.update(clip_loss=l_clip.detach(), caption_loss=cap_l)
            measurements["training_loss"] = clip_w * l_clip.detach() + cap_w * cap_l
        else:
            measurements["training_loss"] = l_clip.detach()
        reduce_over_pipe(grads, model, opt)
        reduce_over_seq(grads, model, opt)
        reduce_over_batch(measurements, grads, opt)
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
