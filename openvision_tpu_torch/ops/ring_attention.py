"""Ring attention: sequence-parallel attention over a process group.

Counterpart of ``openvision_tpu/ops/ring_attention.py``. Each rank of the
ring holds a (B, L/n, H, D) slice of the sequence; the key/value blocks
rotate around the ring (:func:`parallel.ring_shift`, JAX's ``ppermute``)
while a running online softmax accumulates, so no rank computes the scores
of the whole sequence.

:func:`ring_attention` is the per-rank function, step for step the JAX
scan (:26-91) in f32: ``q * sm_scale`` cast to f32, ``NEG_INF = -1e30``,
the causal mask on global positions, ``valid`` masking the pad keys, the
masked probabilities zeroed and an empty row's sum taken as 1. The JAX
scan rotates the block after each of its n steps, and its last rotation
feeds nothing; here every rank makes the n - 1 rotations that are used.
The K and V blocks travel as one tensor, one shift a step, so every rank's
shifts (and their backwards, the opposite shifts) pair up in one order.
The per-step products are plain ``torch.einsum``: JAX computes them in jnp
outside any Pallas kernel, and neither function reaches one.

:func:`ring_attention_sharded` (:94-128) is the call of a stack whose
tokens stay sharded over ``seq`` (``models/encoder.py``, as JAX's GSPMD
keeps them by its ``activation_length`` rule): q, k and v are this rank's
chunks of a sequence padded to a multiple of n, and the output is this
rank's chunk; no scatter or gather inside. Each seq rank then holds the
gradients of its own tokens, so the parameters of such a stack's blocks
get a partial gradient on each seq rank, summed over ``seq`` once a step
(``train/step.py:reduce_over_seq``). :func:`ring_attention_whole` takes
global (B, L, H, D) tensors, the same on every rank of the ring (an
attention outside such a stack): it zero-pads L, keeps this rank's chunk
(:func:`parallel.scatter_to_seq`), runs the ring and joins the chunks
(:func:`parallel.gather_from_seq`), so every seq rank holds the same
output and the same gradients of q, k and v. The batch is this process's
rows already: the JAX wrapper's ``batch_axes`` shard the batch that the
port's mesh splits before the model runs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from openvision_tpu_torch.parallel.mesh import Mesh, gather_from_seq, ring_shift, scatter_to_seq

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   valid: Optional[int] = None) -> torch.Tensor:
    """Per-rank ring attention. q, k, v: (B, chunk, H, D), this rank's slice
    of the sequence (rank i holds positions [i * chunk, (i + 1) * chunk)).

    `valid`: the global number of real tokens; keys at positions >= valid
    are masked out (a length that does not divide the ring is padded by
    the wrapper). `group` None is a ring of one.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n = dist.get_world_size(group) if group is not None else 1
    my = dist.get_rank(group) if group is not None else 0
    b, chunk, h, d = q.shape
    dev = q.device
    qf = (q * sm_scale).float()
    q_pos = my * chunk + torch.arange(chunk, device=dev)
    acc = torch.zeros(b, chunk, h, d, dtype=torch.float32, device=dev)
    row_max = torch.full((b, h, chunk, 1), NEG_INF, dtype=torch.float32, device=dev)
    row_sum = torch.zeros(b, h, chunk, 1, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for i in range(n):
        k_i, v_i = kv[0], kv[1]
        src = (my - i) % n  # whose block this rank holds at step i
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_i.float())
        k_pos = src * chunk + torch.arange(chunk, device=dev)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if valid is not None:
            kmask = (k_pos < valid)[None, :].expand(chunk, chunk)
            mask = kmask if mask is None else (mask & kmask)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        new_max = torch.maximum(row_max, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(row_max - new_max)
        p = torch.exp(s - new_max)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        acc = acc * alpha.transpose(1, 2) + torch.einsum("bhqk,bkhd->bqhd", p, v_i.float())
        row_sum = row_sum * alpha + p.sum(dim=-1, keepdim=True)
        row_max = new_max
        if i < n - 1:  # the block to the next rank (JAX's last rotation feeds nothing)
            kv = ring_shift(kv, group, 1)
    row_sum = torch.where(row_sum == 0.0, 1.0, row_sum)
    return (acc / row_sum.transpose(1, 2)).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                           length: int, seq_axis: str = "seq", causal: bool = False,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the `seq_axis` group of `mesh` on this rank's
    chunks: q, k, v (B, chunk, H, D) hold positions [rank * chunk, (rank + 1)
    * chunk) of a sequence of `length` real tokens zero-padded to chunk * n
    (the 257/577-token cls + patches sequences); the pad keys are masked.
    Returns this rank's chunk of the output."""
    n = mesh.shape[seq_axis]
    valid = length if q.shape[1] * n != length else None
    return ring_attention(q, k, v, group=mesh.group(seq_axis), causal=causal, sm_scale=sm_scale,
                          valid=valid)


def ring_attention_whole(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                         seq_axis: str = "tensor", causal: bool = False,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over the `seq_axis` group of `mesh` (the JAX default
    axis, ``tensor``; the attention dispatcher passes ``seq``) on global
    (B, L, H, D) inputs, the same on every rank of the group: zero-padded
    to a multiple of the axis size, scattered, :func:`ring_attention_sharded`,
    gathered and cut. The JAX wrapper's form (:94-128)."""
    n = mesh.shape[seq_axis]
    length = q.shape[1]
    lpad = -(-length // n) * n
    if lpad != length:
        pad = (0, 0, 0, 0, 0, lpad - length)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    q, k, v = (scatter_to_seq(t, mesh, seq_axis) for t in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, length=length, seq_axis=seq_axis, causal=causal,
                                 sm_scale=sm_scale)
    out = gather_from_seq(out, mesh, seq_axis)
    return out[:, :length] if lpad != length else out
