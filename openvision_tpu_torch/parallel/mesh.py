"""The (data, fsdp, tensor) process mesh, its groups and collectives.

Counterpart of ``openvision_tpu/parallel/mesh.py``: :func:`create_mesh`
(:71) with the same axis names, the same ``data=-1`` inference and the
same assertion, over ``torch.distributed.device_mesh.init_device_mesh``;
:func:`active_mesh` / :func:`use_mesh` (:155-160), the registry through
which the model's blocks find the mesh without threading it through every
module; and the batch rows a process loads (``local_batch_to_global``,
:127). The JAX ``activation_batch`` rule (:41) shards activations over
(data, fsdp) only, so the processes of one tensor group see the same rows:
batch shard ``data_index * fsdp + fsdp_index`` of ``data * fsdp``.

One process per rank, as ``torchrun`` launches them: rank
``(data_index * fsdp + fsdp_index) * tensor + tensor_index`` (the row-major
order of ``init_device_mesh``). :func:`maybe_distributed_init` (the JAX
trainer's, :82) joins the process
group that torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``MASTER_ADDR`` / ``MASTER_PORT`` describe; the backend follows from the
topology: NCCL when each process of a node has a GPU of its own, gloo when
processes share a card or run on the CPU. The ``seq`` and ``pipe`` axes
(ring attention, pipeline stages) are not ported yet and raise by name.

The collectives the model runs under autograd are explicit, as the JAX
package's shard_maps make them: :func:`copy_to_tensor` (identity forward,
sum of the input gradients over ``tensor`` backward), :func:`reduce_from_tensor`
(sum over ``tensor`` forward, identity backward) and
:func:`gather_batch` (the rows of every batch shard, its backward summing
each rank's gradients into the owner's rows). A group of one process
skips its collective. With ``COMM["timing"]`` on, each collective
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

MESH_AXES = ("data", "fsdp", "tensor")


@dataclass
class Mesh:
    """This process's place on the mesh: the axis sizes, its coordinates,
    the ``DeviceMesh`` (None in a single process), the group of its tensor
    axis and the group of the ``data * fsdp`` processes that share its
    tensor coordinate (the batch axes, flattened)."""

    shape: dict
    coords: dict
    device_mesh: Optional[object] = None
    tensor_group: Optional[object] = None
    batch_group: Optional[object] = None

    @property
    def tensor(self) -> int:
        return self.shape["tensor"]

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
    """The (data, fsdp, tensor) mesh over the processes of the default
    group (one process without one). `data=-1` absorbs the remainder."""
    for name, size in (("seq", seq), ("pipe", pipe)):
        if size not in (1, -1):
            raise NotImplementedError(
                f"the {name!r} mesh axis ({name}={size}) is not ported yet: ring attention "
                "and pipeline parallelism wait for their own slice")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        assert n % (fsdp * tensor) == 0, (n, fsdp, tensor)
        data = n // (fsdp * tensor)
    assert data * fsdp * tensor == n, f"mesh {data}x{fsdp}x{tensor} != {n} processes"
    shape = dict(data=data, fsdp=fsdp, tensor=tensor)
    if n == 1:
        return Mesh(shape, dict(data=0, fsdp=0, tensor=0))
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, (data, fsdp, tensor), mesh_dim_names=MESH_AXES)
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(dist.get_rank(),
                                                                   (data, fsdp, tensor)))))
    # every process makes every group, in one order
    batch_groups = [dist.new_group([b * tensor + t for b in range(data * fsdp)])
                    for t in range(tensor)]
    return Mesh(shape, coords, device_mesh, device_mesh.get_group("tensor"),
                batch_groups[coords["tensor"]])


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
