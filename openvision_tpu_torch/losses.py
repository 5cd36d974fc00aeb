"""Losses: bidirectional contrastive (CLIP), SigLIP and the caption cross-entropy.

Counterpart of ``openvision_tpu/losses.py``:

- :func:`bidirectional_contrastive_loss` in the ``global``, ``efficient``
  and ``local`` modes, over one or two text views per image (the loss is the
  mean over views). ``local`` (:93-124) takes a process's rows against the
  columns of every batch shard, gathered over the mesh's (data, fsdp) axes
  with a gather that carries gradients (``parallel.gather_batch``), the
  positives on the diagonal shifted by the shard's offset in the global
  batch (its (data, fsdp) coordinate, not its global rank). It returns
  this process's share of the global mean, its rows' mean over the shard
  count: the shares of the batch shards sum to the loss, and their
  gradients, summed over data x fsdp by the train step, are the loss's (the
  JAX psum of one global-mean loss). In one process that is the global math
  with the positives on the diagonal;
- :func:`siglip_loss` (:129), its ``local`` mode likewise the global math;
- :func:`softmax_xent` (:177) and :func:`linear_softmax_xent` (:200-253),
  the caption cross-entropy fused with the vocab head: the f32 head product
  and log-softmax run per chunk of `chunk` positions under
  ``torch.utils.checkpoint``, so the (B, L, V) f32 logits never exist and the
  backward recomputes each chunk's logits; ``normalize=False`` returns the
  masked sum.

Inputs are f32 tensors; temperatures arrive exp'd, as the model's ``out["t"]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from openvision_tpu_torch.parallel import Mesh, gather_batch


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
    temperature; `mesh` (``local`` mode): the process mesh whose batch
    shard these rows are (None: one process). Returns (loss, extras), extras
    holding "ncorrect" (the global mode's top-1 accuracy, zero in the
    others, as in the JAX package); ``local``'s loss is this shard's share.
    """
    views = list(ztxt) if isinstance(ztxt, (list, tuple)) else [ztxt]
    if mode == "global":
        per_view = [_pair_loss_global(zimg, z, t) for z in views]
        loss = sum(pl for pl, _ in per_view) / len(per_view)
        logits = per_view[0][1]
        ncorrect = (logits.argmax(1) == torch.arange(logits.shape[0], device=logits.device)
                    ).float().mean()
        return loss.mean(), {"ncorrect": ncorrect}
    if mode == "efficient":
        def one(z):
            logits = (zimg @ z.t()) * t
            pos = (zimg * z).sum(-1) * t
            return 0.5 * ((torch.logsumexp(logits, -1) - pos).mean()
                          + (torch.logsumexp(logits, 0) - pos).mean())

        return sum(one(z) for z in views) / len(views), {"ncorrect": zimg.new_zeros(())}
    if mode == "local":  # this shard's rows against every shard's columns
        shards, index = (1, 0) if mesh is None else (mesh.batch_shards, mesh.batch_index)
        gather = (lambda z: z) if mesh is None else (lambda z: gather_batch(z, mesh))
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


def siglip_loss(zimg, ztxt, t, b, *, mode: str = "local"):
    """Pairwise sigmoid contrastive loss (SigLIP): every (image, text) pair
    is classified matched or not; (loss, {})."""
    if mode not in ("local", "global"):
        raise ValueError(f"Unknown siglip mode: {mode!r}")
    logits = (zimg @ ztxt.t()) * t + b
    n, m = logits.shape
    labels = torch.arange(n, device=logits.device)[:, None] == torch.arange(m, device=logits.device)
    z = torch.where(labels, logits, -logits)
    return -F.logsigmoid(z).sum() / n, {}


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


def linear_softmax_xent(*, prelogits, kernel, labels, mask=None, chunk: int = 16,
                        normalize: bool = True):
    """Caption cross-entropy fused with the vocab head.

    prelogits: (B, L, D) decoder_norm output; kernel: the head weight in
    torch's (V, D) layout (the JAX (D, V) kernel transposed), used in f32;
    labels: (B, L) int; mask: (B, L). Equal to ``softmax_xent`` of the f32
    logits up to summation order, with at most (B, chunk, V) logits alive.
    """
    b, l, _ = prelogits.shape
    if mask is None:
        mask = prelogits.new_ones(b, l)
    kernel_t = kernel.float().t()
    labels = labels.long()
    total = prelogits.new_zeros((), dtype=torch.float32)
    for s in range(0, l, chunk):
        sl = slice(s, s + chunk)
        part = (prelogits[:, sl], kernel_t, labels[:, sl], mask[:, sl].float())
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *part, use_reentrant=False)
        else:
            total = total + _chunk_nll(*part)
    if not normalize:
        return total
    return total / (mask.sum() + 1e-8)
