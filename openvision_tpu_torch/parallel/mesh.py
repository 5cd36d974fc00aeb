"""The (data, fsdp, tensor, seq, pipe) process mesh, its groups and collectives.

Counterpart of ``openvision_tpu/parallel/mesh.py``: :func:`create_mesh`
(:71) with the same five axes in the same order (``MESH_AXES``, :32), the
same ``data=-1`` inference and the same assertion, over
``torch.distributed.device_mesh.init_device_mesh``; :func:`active_mesh` /
:func:`use_mesh` (:155-160), the registry through which the model's blocks
find the mesh without threading it through every module; and the batch
rows a process loads (``local_batch_to_global``, :127). The JAX
``activation_batch`` rule (:41) shards activations over (data, fsdp) only,
so the processes of one tensor, seq or pipe group see the same rows: batch
shard ``data_index * fsdp + fsdp_index`` of ``data * fsdp``.

One process per rank, as ``torchrun`` launches them: ranks are row-major
over ``(data, fsdp, tensor, seq, pipe)`` (the order of
``init_device_mesh``), so with seq = pipe = 1 rank ``(data_index * fsdp +
fsdp_index) * tensor + tensor_index``. The mesh holds the group of each of
the tensor, seq and pipe axes and the batch group: the ``data * fsdp``
processes that share this one's (tensor, seq, pipe) coordinates.
:func:`maybe_distributed_init` (the JAX trainer's, :82) joins the process
group that torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` describe; the backend follows from the
topology: NCCL when each process of a node has a GPU of its own, gloo when
processes share a card or run on the CPU.

The collectives the model runs under autograd are explicit, as the JAX
package's shard_maps make them: :func:`copy_to_tensor` (identity forward,
sum of the input gradients over ``tensor`` backward), :func:`reduce_from_tensor`
(sum over ``tensor`` forward, identity backward), :func:`gather_from_tensor`
(the shards' last axes joined forward, this rank's slice of the gradient
backward: a product split by output features, whose consumer is the same
on every tensor rank), :func:`vocab_parallel_embedding` (a lookup in this
rank's vocab rows, ids outside them masked to zero, summed over
``tensor``) and :func:`gather_batch` (the rows of every batch shard, its
backward summing each rank's gradients into the owner's rows). For the
seq and pipe axes (``ops/ring_attention.py``, ``ops/pipeline_parallel.py``):
:func:`ring_shift` (JAX's ``ppermute`` by a fixed shift; its backward the
opposite shift, the ppermute's transpose), :func:`scatter_to_seq` /
:func:`gather_from_seq` (this rank's sequence chunk of a replicated
tensor, and the chunks joined again; each one's backward is the other, as
the activations outside attention, and so their gradients, are the same on
every seq rank) and :func:`broadcast_from_stage` (a stage's tensor given to
every rank of the group; the backward passes this rank's cotangent, the
same on every rank, to the source alone). Under gloo a point-to-point send
of a CUDA tensor goes through a host copy (gloo's send and recv take CPU
tensors); the compute stays on the card. A group of one process skips its
collective. With ``COMM["timing"]`` on, each collective
synchronizes the device before and after itself and adds its host time to
``COMM["seconds"]`` (the step's collective share; off by default, as it
costs two synchronizations a call).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

MESH_AXES = ("data", "fsdp", "tensor", "seq", "pipe")


@dataclass
class Mesh:
    """This process's place on the mesh: the axis sizes, its coordinates,
    the ``DeviceMesh`` (None in a single process), the groups of its
    tensor, seq and pipe axes, and the group of the ``data * fsdp``
    processes that share its (tensor, seq, pipe) coordinates (the batch
    axes, flattened)."""

    shape: dict
    coords: dict
    device_mesh: Optional[object] = None
    tensor_group: Optional[object] = None
    batch_group: Optional[object] = None
    seq_group: Optional[object] = None
    pipe_group: Optional[object] = None

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

    @property
    def seq(self) -> int:
        return self.shape.get("seq", 1)

    @property
    def pipe(self) -> int:
        return self.shape.get("pipe", 1)

    def group(self, axis: str):
        """The process group of the tensor, seq or pipe axis."""
        return getattr(self, f"{axis}_group")

    @property
    def batch_shards(self) -> int:
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        return self.coords["data"] * self.shape["fsdp"] + self.coords["fsdp"]

    def batch_rows(self, global_batch: int) -> slice:
        """The rows of a global batch that this process loads and computes."""
        if global_batch % self.batch_shards:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"data x fsdp = {self.batch_shards}")
        n = global_batch // self.batch_shards
        return slice(self.batch_index * n, (self.batch_index + 1) * n)


def create_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, seq: int = 1, pipe: int = 1,
                device_type: str = "cpu") -> Mesh:
    """The (data, fsdp, tensor, seq, pipe) mesh over the processes of the
    default group (one process without one). `data=-1` absorbs the
    remainder."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rest = fsdp * tensor * seq * pipe
    if data == -1:
        assert n % rest == 0, (n, fsdp, tensor, seq, pipe)
        data = n // rest
    assert data * rest == n, f"mesh {data}x{fsdp}x{tensor}x{seq}x{pipe} != {n} processes"
    dims = (data, fsdp, tensor, seq, pipe)
    shape = dict(zip(MESH_AXES, dims))
    if n == 1:
        return Mesh(shape, dict.fromkeys(MESH_AXES, 0))
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, dims, mesh_dim_names=MESH_AXES)
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(dist.get_rank(), dims))))
    # every process makes every group, in one order
    inner = tensor * seq * pipe
    batch_groups = [dist.new_group([b * inner + i for b in range(data * fsdp)])
                    for i in range(inner)]
    own = (coords["tensor"] * seq + coords["seq"]) * pipe + coords["pipe"]
    return Mesh(shape, coords, device_mesh, device_mesh.get_group("tensor"), batch_groups[own],
                device_mesh.get_group("seq"), device_mesh.get_group("pipe"))


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Mesh] = None


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Marks `mesh` active for the scope (the blocks shard over its tensor axis)."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def tensor_size() -> int:
    """The active mesh's tensor axis size (1 without a mesh)."""
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.tensor


def sharded_mesh(tensor_parallel: int) -> Optional[Mesh]:
    """The active mesh for a module whose weights are sharded over a tensor
    axis of `tensor_parallel` (None for 1); raises outside such a mesh."""
    if tensor_parallel == 1:
        return None
    if _ACTIVE_MESH is None or _ACTIVE_MESH.tensor != tensor_parallel:
        raise RuntimeError(f"a module sharded over tensor={tensor_parallel} runs outside its mesh "
                           f"(active: {None if _ACTIVE_MESH is None else _ACTIVE_MESH.shape})")
    return _ACTIVE_MESH


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def backend_for(device_type: str) -> str:
    """NCCL when each process of this node has a GPU of its own; gloo when
    processes share a card, or run on the CPU."""
    if device_type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def maybe_distributed_init(device="cuda") -> torch.device:
    """Joins the process group torchrun's environment describes (once) and
    returns this process's device: ``cuda:{LOCAL_RANK % device_count}`` for
    CUDA (raising without a card), else `device`."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                               "pass --device cpu to run the plain PyTorch path on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        backend = backend_for(device.type)
        rank = int(os.environ["RANK"])
        if rank == 0:
            print(f"NOTE: {world} processes, backend {backend} (devices: "
                  f"{torch.cuda.device_count() if device.type == 'cuda' else 'cpu'})", flush=True)
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def sync(name: str) -> None:
    """A rendezvous of every process at `name` (the JAX trainer's ``sync``,
    :90); a no-op in one process."""
    del name  # the name labels the call site, as the JAX barrier's does
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


COMM = {"timing": False, "seconds": 0.0, "calls": 0}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _timed(fn, t: torch.Tensor) -> None:
    if not COMM["timing"]:
        fn()
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COMM["seconds"] += time.perf_counter() - t0
    COMM["calls"] += 1


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over `group`, in t's dtype (a bf16 partial sums in bf16,
    as the JAX psum of a bf16 array); a new tensor."""
    out = t.contiguous().clone()
    if _size(group) > 1:
        _timed(lambda: dist.all_reduce(out, group=group), out)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over `group` (no gradient); a new tensor."""
    out = t.detach().contiguous().clone()
    if _size(group) > 1:
        _timed(lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group), out)
    return out


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x unchanged; its gradient summed over the tensor axis (the input of a
    tensor-sharded product, whose every shard adds to dx)."""
    return _CopyToTensor.apply(x, mesh.tensor_group)


def reduce_from_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the tensor axis's partials; the gradient passes unchanged."""
    return _ReduceFromTensor.apply(x, mesh.tensor_group)


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        _timed(lambda: dist.all_gather(parts, x.contiguous(), group=group), x)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.index * ctx.width:(ctx.index + 1) * ctx.width], None, None


def gather_from_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The last axes of every tensor rank's `x`, joined in rank order; the
    gradient of the whole (the same on every rank) back to this rank's
    slice."""
    return _GatherFromTensor.apply(x, mesh.tensor_group, mesh.coords["tensor"])


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of the whole embedding that `ids` name, from `weight`, this
    rank's contiguous block of the vocab: ids outside it look up zeros and
    the ranks' lookups are summed over ``tensor`` (one rank holds each
    row, so the sum is exact); each rank's weight gradient lands in its own
    rows."""
    rows = weight.shape[0]
    local = ids.long() - mesh.coords["tensor"] * rows
    inside = (local >= 0) & (local < rows)
    emb = F.embedding(torch.where(inside, local, 0), weight)
    return reduce_from_tensor(emb * inside[..., None].to(emb.dtype), mesh)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        _timed(lambda: dist.all_gather(parts, x.contiguous(), group=group), x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # every rank's gradient of the gathered rows, summed; this rank's part
        g = all_reduce(g, ctx.group)
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of every batch shard, in batch order (a tiled all_gather over
    data x fsdp), differentiable: the backward sums every process's gradient
    of a shard's rows into its owner's gradient."""
    if _size(mesh.batch_group) == 1:
        return x
    return _GatherBatch.apply(x, mesh.batch_group, mesh.batch_index)


# ---------------------------------------------------------------------------
# the seq and pipe axes
# ---------------------------------------------------------------------------


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether a point-to-point transfer of `t` goes through a host copy:
    a CUDA tensor over gloo, whose send and recv take CPU tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """`x` sent to the rank `offset` places on around `group` and the
    tensor of the rank `offset` places back received (no autograd): one
    ``batch_isend_irecv`` pair a rank."""
    n = _size(group)
    if n == 1 or offset % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % n)
    src = dist.get_global_rank(group, (me - offset) % n)
    staged = _via_host(x, group)
    send = x.detach().contiguous()
    if staged:  # gloo takes host tensors: the compute stays on the card
        send = send.cpu()
    recv = torch.empty_like(send)

    def run():
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                            dist.P2POp(dist.irecv, recv, src, group)]):
            work.wait()

    _timed(run, x)
    return recv.to(x.device, non_blocking=True) if staged else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.offset), None, None


def ring_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """Rank i's `x` at rank (i + offset) mod n of `group` (JAX's ``ppermute``
    with the permutation ``[(j, (j + offset) % n)]``); the backward sends
    each gradient the opposite way, the ppermute's transpose. Every rank of
    the group must call it, in the same order."""
    return _RingShift.apply(x, group, offset)


def _all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    _timed(lambda: dist.all_gather(parts, x.contiguous(), group=group), x)
    return torch.cat(parts, dim=dim)


class _ScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(_size(group), dim=dim)[index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.group, ctx.dim), None, None, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.group, ctx.index, ctx.dim = group, index, dim
        return _all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(_size(ctx.group), dim=ctx.dim)[ctx.index].contiguous(), None, None, None


def scatter_to_seq(x: torch.Tensor, mesh: Mesh, axis: str = "seq", dim: int = 1) -> torch.Tensor:
    """This rank's chunk of `x` (the same on every rank of the `axis`
    group) along `dim`; the backward gathers the chunks' gradients, so the
    input's gradient is whole and the same on every rank."""
    group = mesh.group(axis)
    if _size(group) == 1:
        return x
    return _ScatterToSeq.apply(x, group, mesh.coords[axis], dim)


def gather_from_seq(x: torch.Tensor, mesh: Mesh, axis: str = "seq", dim: int = 1) -> torch.Tensor:
    """The chunks of every rank of the `axis` group joined along `dim`, in
    rank order; the backward keeps this rank's chunk of the gradient (the
    consumers are the same on every rank, so each holds the whole
    gradient)."""
    group = mesh.group(axis)
    if _size(group) == 1:
        return x
    return _GatherFromSeq.apply(x, group, mesh.coords[axis], dim)


@dataclass(frozen=True)
class SeqChunk:
    """This rank's chunk of a sequence-sharded stack's tokens: rank `index`
    of the `n` ranks of the seq axis holds positions [index * size, (index
    + 1) * size) of the `length` real tokens, zero-padded to n * size."""

    index: int
    n: int
    length: int

    @property
    def size(self) -> int:
        return -(-self.length // self.n)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of `x`, whole along dim 1 (`length` tokens),
        padded first (what is drawn there is never seen)."""
        pad = self.size * self.n - self.length
        if pad:
            x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
        return x[:, self.index * self.size:(self.index + 1) * self.size]


def enter_seq(x: torch.Tensor, mesh: Mesh) -> tuple:
    """(this rank's chunk of `x`, its SeqChunk): `x` (B, L, ...), the same
    on every rank of the seq group, zero-padded along L to a multiple of
    seq and scattered (:func:`scatter_to_seq`: the backward gathers the
    chunks' gradients, so the input's gradient is whole on every rank)."""
    chunk = SeqChunk(mesh.coords["seq"], mesh.seq, x.shape[1])
    pad = chunk.size * chunk.n - chunk.length
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return scatter_to_seq(x, mesh), chunk


def exit_seq(x: torch.Tensor, mesh: Mesh, chunk: SeqChunk) -> torch.Tensor:
    """The chunks of the seq group joined (:func:`gather_from_seq`) and the
    pad cut: whole tokens again, the same on every rank."""
    return gather_from_seq(x, mesh)[:, :chunk.length]


class _BroadcastFromStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.own = dist.get_rank(group) == src
        out = x.detach().contiguous().clone()
        _timed(lambda: dist.broadcast(out, dist.get_global_rank(group, src), group=group), out)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.own else torch.zeros_like(g)), None, None


def broadcast_from_stage(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Rank `src`'s `x` (a rank of `group`) on every rank of the group (the
    pipeline's output from its last stage); the backward passes this rank's
    cotangent, the same on every rank, to the source alone."""
    if _size(group) == 1:
        return x
    return _BroadcastFromStage.apply(x, group, src)
