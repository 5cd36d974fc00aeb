"""Losses: bidirectional contrastive (CLIP), SigLIP and the caption cross-entropy.

Counterpart of ``openvision_tpu/losses.py``:

- :func:`bidirectional_contrastive_loss` in the ``global``, ``efficient``
  and ``local`` modes, over one or two text views per image (the loss is the
  mean over views). ``global`` (:69-78) and ``efficient`` form the whole
  batch's B x B logits: on a process mesh both sides are gathered first, as
  the JAX modes run over the global arrays, and the loss returned is the
  whole batch's over the shard count, this process's share. ``local``
  (:93-124) takes a process's rows against the columns of every batch shard, gathered over the mesh's (data, fsdp) axes
  with a gather that carries gradients (``parallel.gather_batch``), the
  positives on the diagonal shifted by the shard's offset in the global
  batch (its (data, fsdp) coordinate, not its global rank). It returns
  this process's share of the global mean, its rows' mean over the shard
  count: the shares of the batch shards sum to the loss, and their
  gradients, summed over data x fsdp by the train step, are the loss's (the
  JAX psum of one global-mean loss). In one process that is the global math
  with the positives on the diagonal;
- :func:`siglip_loss` (:129-175): ``local`` takes a process's image rows
  against the text rows of every batch shard (only the text side is
  gathered), the positives on the diagonal shifted by the shard's offset;
  ``global`` gathers both sides; each returns this process's share, and in
  one process both are the global math;
- :func:`softmax_xent` (:177) and :func:`linear_softmax_xent` (:200-253),
  the caption cross-entropy fused with the vocab head: the f32 head product
  and log-softmax run per chunk of `chunk` positions under
  ``torch.utils.checkpoint``, so the (B, L, V) f32 logits never exist and the
  backward recomputes each chunk's logits; ``normalize=False`` returns the
  masked sum.

Inputs are f32 tensors; temperatures arrive exp'd, as the model's ``out["t"]``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from openvision_tpu_torch.parallel import (Mesh, all_reduce_max, copy_to_tensor, gather_batch,
                                           reduce_from_tensor)


def _pair_loss_global(zimg, ztxt, t):
    """Full-matrix bidirectional NLL: (per-example loss, logits)."""
    logits = (zimg @ ztxt.t()) * t
    l_i2t = -torch.diagonal(F.log_softmax(logits, dim=1))
    l_t2i = -torch.diagonal(F.log_softmax(logits, dim=0))
    return 0.5 * (l_i2t + l_t2i), logits


def bidirectional_contrastive_loss(zimg, ztxt, t, *, mode: str = "local",
                                   mesh: Mesh | None = None):
    """Bidirectional contrastive loss over L2-normalized embeddings.

    zimg: (B, D); ztxt: (B, D) or a list of per-view (B, D); t: the exp'd
    temperature; `mesh`: the process mesh whose batch shard these rows are
    (None: one process). Returns (loss, extras), extras holding "ncorrect"
    (the global mode's top-1 accuracy over the whole batch, zero in the
    others, as in the JAX package); the loss is this shard's share.
    """
    views = list(ztxt) if isinstance(ztxt, (list, tuple)) else [ztxt]
    shards, index, gather = _batch_axes(mesh)
    if mode == "global":  # the whole batch's logits on every process
        gimg = gather(zimg)
        per_view = [_pair_loss_global(gimg, gather(z), t) for z in views]
        loss = sum(pl for pl, _ in per_view) / len(per_view)
        logits = per_view[0][1]
        ncorrect = (logits.argmax(1) == torch.arange(logits.shape[0], device=logits.device)
                    ).float().mean()
        return loss.mean() / shards, {"ncorrect": ncorrect}
    if mode == "efficient":
        gimg = gather(zimg)

        def one(z):
            logits = (gimg @ z.t()) * t
            pos = (gimg * z).sum(-1) * t
            return 0.5 * ((torch.logsumexp(logits, -1) - pos).mean()
                          + (torch.logsumexp(logits, 0) - pos).mean())

        loss = sum(one(gather(z)) for z in views) / len(views)
        return loss / shards, {"ncorrect": zimg.new_zeros(())}
    if mode == "local":  # this shard's rows against every shard's columns
        bl = zimg.shape[0]
        diag = index * bl + torch.arange(bl, device=zimg.device)[:, None]
        gimg = gather(zimg)

        def view_loss(z):
            lp_img = F.log_softmax((zimg @ gather(z).t()) * t, dim=1)
            lp_txt = F.log_softmax((z @ gimg.t()) * t, dim=1)
            return 0.5 * (-lp_img.gather(1, diag)[:, 0] - lp_txt.gather(1, diag)[:, 0])

        loss = sum(view_loss(z) for z in views) / len(views)
        return loss.mean() / shards, {"ncorrect": zimg.new_zeros(())}
    raise ValueError(f"Unknown contrastive mode: {mode!r}")


def _batch_axes(mesh: Mesh | None):
    """(shard count, this shard's index, a gather of every shard's rows that
    carries gradients) of the mesh's batch axes; one shard without one."""
    if mesh is None:
        return 1, 0, lambda z: z
    return mesh.batch_shards, mesh.batch_index, lambda z: gather_batch(z, mesh)


def siglip_loss(zimg, ztxt, t, b, *, mode: str = "local", mesh: Mesh | None = None):
    """Pairwise sigmoid contrastive loss (SigLIP): every (image, text) pair
    is classified matched or not; (loss, {}). `mesh`: the process mesh whose
    batch shard these rows are (None: one process); the loss is this
    shard's share of the global one."""
    if mode not in ("local", "global"):
        raise ValueError(f"Unknown siglip mode: {mode!r}")
    shards, index, gather = _batch_axes(mesh)
    if mode == "global":
        zimg, ztxt, offset = gather(zimg), gather(ztxt), 0
    else:  # this shard's images against every shard's texts
        ztxt, offset = gather(ztxt), index * zimg.shape[0]
    logits = (zimg @ ztxt.t()) * t + b
    n, m = logits.shape
    rows = torch.arange(n, device=logits.device)[:, None] + offset
    z = torch.where(rows == torch.arange(m, device=logits.device), logits, -logits)
    return -F.logsigmoid(z).sum() / n / shards, {}


def softmax_xent(*, logits, labels, mask=None, reduction: bool = True):
    """Categorical cross-entropy over integer labels along the last axis (the
    JAX ``kl`` option adds 0 for one-hot targets and is left out)."""
    log_p = F.log_softmax(logits, dim=-1)
    nll = -log_p.gather(-1, labels.long()[..., None])[..., 0]
    if reduction:
        if mask is not None:
            return (nll * mask).sum() / (mask.sum() + 1e-8)
        return nll.mean()
    return nll


def _chunk_nll(h, kernel_t, labels, mask):
    logits = h.float() @ kernel_t
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return (nll * mask).sum()


def _chunk_nll_vocab(h, kernel_t, labels, mask, mesh: Mesh, offset: int):
    """:func:`_chunk_nll` over this tensor rank's vocab columns
    ``[offset, offset + V_r)``: the row max and the sum of exponentials are
    combined over ``tensor``, and the target's logit is its owner's."""
    logits = h.float() @ kernel_t  # (B, chunk, V_r)
    m = all_reduce_max(logits.max(dim=-1).values, mesh.tensor_group)
    sumexp = reduce_from_tensor((logits - m[..., None]).exp().sum(dim=-1), mesh)
    local = labels - offset
    inside = (local >= 0) & (local < logits.shape[-1])
    target = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    target = reduce_from_tensor(torch.where(inside, target, torch.zeros_like(target)), mesh)
    nll = torch.log(sumexp) + m - target
    return (nll * mask).sum()


def linear_softmax_xent(*, prelogits, kernel, labels, mask=None, chunk: int = 16,
                        normalize: bool = True, mesh: Mesh | None = None):
    """Caption cross-entropy fused with the vocab head.

    prelogits: (B, L, D) decoder_norm output; kernel: the head weight in
    torch's (V, D) layout (the JAX (D, V) kernel transposed), used in f32;
    labels: (B, L) int; mask: (B, L). Equal to ``softmax_xent`` of the f32
    logits up to summation order, with at most (B, chunk, V) logits alive.

    `mesh`: the kernel is this tensor rank's block of vocab rows (the JAX
    rules' ``vocab`` over ``tensor``): the row max, the sum of exponentials
    and the target logit (on the rank that owns it) are combined over
    ``tensor``, each rank's head gradient is its own rows', the prelogits'
    gradient sums the ranks' parts, and at most (B, chunk, V / tensor)
    logits are alive on each rank. The loss is the same on every tensor rank.
    """
    b, l, _ = prelogits.shape
    if mask is None:
        mask = prelogits.new_ones(b, l)
    kernel_t = kernel.float().t()
    labels = labels.long()
    nll = _chunk_nll
    if mesh is not None:
        prelogits = copy_to_tensor(prelogits, mesh)
        nll = functools.partial(_chunk_nll_vocab, mesh=mesh,
                                offset=mesh.coords["tensor"] * kernel.shape[0])
    total = prelogits.new_zeros((), dtype=torch.float32)
    for s in range(0, l, chunk):
        sl = slice(s, s + chunk)
        part = (prelogits[:, sl], kernel_t, labels[:, sl], mask[:, sl].float())
        if torch.is_grad_enabled():
            total = total + checkpoint(nll, *part, use_reentrant=False)
        else:
            total = total + nll(*part)
    if not normalize:
        return total
    return total / (mask.sum() + 1e-8)
