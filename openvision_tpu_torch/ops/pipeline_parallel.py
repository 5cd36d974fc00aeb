"""Pipeline parallelism over the ``pipe`` process group: GPipe and interleaved.

Counterpart of ``openvision_tpu/ops/pipeline_parallel.py``. The depth of a
block stack splits over P stages; M microbatches flow through them, one
:func:`parallel.mesh.shift` over ``pipe`` a tick carrying each stage's
output to the next. Neither this module nor its JAX counterpart reaches a
Pallas kernel: the blocks inside the stages run whatever their attention
impl runs (``flash``: the hand-written kernels #13-#16).

The schedule is JAX's (:59-163), selected by ``interleave`` (v):

- stage p's chunk j holds the global layers [(j P + p) c, (j P + p + 1) c),
  c = depth / (P v); v = 1 is GPipe's fill and drain;
- stage 0 injects microbatches in waves of P (ticks with t mod vP < P):
  microbatch k enters at ``in_ticks[k] = (k // P) vP + k mod P`` and leaves
  stage P - 1 at ``exit_ticks[k] = in_ticks[k] + vP - 1``;
- at tick t stage p applies its chunk r = ((t - p) mod vP) // P;
- the last stage's outputs at the exit ticks, in microbatch order, go to
  every rank of the group (:func:`parallel.broadcast_from_stage`).

JAX computes every tick on every stage, on zeros where the stage holds no
real microbatch (a bubble, or the clamped duplicate of a partial last
wave's injection). The port skips those ticks' compute; every rank still
makes the same n_ticks - 1 shifts in the same order (JAX's last ppermute
feeds nothing and is dropped on every rank alike).

Autograd: the whole schedule is one ``torch.autograd.Function``
(:class:`_Pipeline`). Its forward records each real tick's chunk under
autograd on a detached input; its backward walks the ticks in reverse,
receiving each output's gradient from the next stage by the opposite shift,
running the chunk's backward (the layers' parameter gradients accumulate
into their ``.grad``, as a reentrant checkpoint's do) and sending the
input's gradient to the previous stage. So every rank makes its
point-to-point transfers in one fixed order, which the autograd engine's
own ordering of separate shift nodes would not promise. The microbatches'
input gradient, which stage 0 alone computes, is summed over ``pipe`` so
that every rank holds it (everything outside the stack stays replicated).
A stage's parameter gradients cover the layers it owns (zeros for the
others, whose ``.grad`` stays None); ``train/step.py`` sums them over
``pipe`` once a step.

Every pipe rank holds every layer, as JAX replicates the per-layer trees
over ``pipe`` and stacks them per step, so parameter names and checkpoints
do not change with P. Each rank's batch is its own rows: the JAX
microbatches shard over the data axes, the port's are slices of the rows
this process holds.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from openvision_tpu_torch.parallel.mesh import Mesh, all_reduce, broadcast_from_stage, shift


def stack_layer_params(params: dict, depth: int, prefix: str = "encoderblock_") -> list:
    """``{"<prefix>i": layer}`` -> the ordered list of the `depth` layers
    (JAX stacks their leaves on a leading axis; the port keeps a list)."""
    return [params[f"{prefix}{i}"] for i in range(depth)]


def pipeline_sharding(depth: int, n_stages: int, stage: int, interleave: int = 1) -> list:
    """The global layers stage `stage` owns, in the order it applies them
    (its chunk j: [(j P + p) c, (j P + p + 1) c)); JAX's
    ``pipeline_sharding`` places the stacked layers by the same rule."""
    v = int(interleave)
    if depth % (n_stages * v):
        raise ValueError(f"depth {depth} does not split into {n_stages} stages x {v} chunks")
    c = depth // (n_stages * v)
    return [(j * n_stages + stage) * c + i for j in range(v) for i in range(c)]


class _Plan:
    """The static schedule of one call on one stage."""

    def __init__(self, block_fn, layers, group, n_stages, stage, v, m):
        self.block_fn, self.group = block_fn, group
        self.n_stages, self.stage, self.v, self.m = n_stages, stage, v, m
        vp = v * n_stages
        c = len(layers) // vp
        owned = pipeline_sharding(len(layers), n_stages, stage, v)
        self.chunks = [[layers[i] for i in owned[j * c:(j + 1) * c]] for j in range(v)]
        self.in_ticks = [(k // n_stages) * vp + k % n_stages for k in range(m)]
        self.n_ticks = self.in_ticks[-1] + vp
        # (tick, stage) -> (microbatch, chunk) of every real microbatch's pass
        self.real = {}
        for k, t0 in enumerate(self.in_ticks):
            for j in range(vp):
                self.real[t0 + j, j % n_stages] = (k, j // n_stages)

    def run_chunk(self, j: int, h: torch.Tensor) -> torch.Tensor:
        for layer in self.chunks[j]:
            h = self.block_fn(layer, h)
        return h

    def forward(self, mbs: list, record: bool):
        """The forward schedule: (outputs of the last stage by microbatch,
        zeros on the other stages; the recorded ticks {t: (input leaf,
        output)})."""
        p, n_stages, vp = self.stage, self.n_stages, self.v * self.n_stages
        outs = [torch.zeros_like(mbs[0]) for _ in range(self.m)]
        saved = {}
        buf = torch.zeros_like(mbs[0])
        for t in range(self.n_ticks):
            y = torch.zeros_like(mbs[0])
            if (t, p) in self.real:
                k, r = self.real[t, p]
                x_in = mbs[k] if p == 0 and t % vp < n_stages else buf
                if record:
                    leaf = x_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self.run_chunk(r, leaf)
                    saved[t] = (leaf, y)
                    y = y.detach()
                else:
                    y = self.run_chunk(r, x_in)
                if p == n_stages - 1 and r == self.v - 1:
                    outs[k] = y
            if t < self.n_ticks - 1:
                buf = shift(y, self.group, 1)
        return outs, saved

    def backward(self, saved: dict, g_outs: list, like: torch.Tensor) -> list:
        """The reverse schedule: the gradients of the injected microbatches
        (stage 0's; zeros elsewhere). The layers' gradients accumulate
        into their ``.grad``."""
        p, n_stages, vp = self.stage, self.n_stages, self.v * self.n_stages
        dmbs = [torch.zeros_like(like) for _ in range(self.m)]
        back = torch.zeros_like(like)  # d(input at tick t + 1), for the previous stage
        for t in reversed(range(self.n_ticks)):
            g_y = shift(back, self.group, -1) if t < self.n_ticks - 1 else torch.zeros_like(like)
            back = torch.zeros_like(like)
            if (t, p) not in self.real:
                continue
            k, r = self.real[t, p]
            if p == n_stages - 1 and r == self.v - 1:
                g_y = g_y + g_outs[k]
            leaf, y = saved.pop(t)
            with torch.enable_grad():
                torch.autograd.backward(y, g_y.to(y.dtype))
            dx = leaf.grad if leaf.grad is not None else torch.zeros_like(like)
            if p == 0 and t % vp < n_stages:
                dmbs[k] = dx
            else:
                back = dx
        return dmbs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, anchor):
        mbs = list(x.chunk(plan.m))
        outs, ctx.saved = plan.forward(mbs, record=True)
        ctx.plan = plan
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        dmbs = plan.backward(ctx.saved, list(g.chunk(plan.m)), g.chunk(plan.m)[0])
        # stage 0 alone computed the input's gradient: every stage gets it
        return None, all_reduce(torch.cat(dmbs), plan.group), None


def _requires_grad(layers) -> bool:
    for layer in layers:
        tensors = layer.parameters() if isinstance(layer, torch.nn.Module) else layer.values()
        if any(t.requires_grad for t in tensors):
            return True
    return False


def pipeline_apply(block_fn: Callable, layers: Sequence, x: torch.Tensor, mesh: Mesh, *,
                   num_microbatches: int, axis_name: str = "pipe",
                   interleave: int = 1) -> torch.Tensor:
    """Runs the layers ``block_fn(layer, h)`` of `layers` (in order) as a
    P-stage pipeline over the `axis_name` group of `mesh`.

    x: (B, ...) this process's rows, the same on every rank of the group;
    B must divide by `num_microbatches`. The depth must divide by
    P * `interleave` (v: the chunks a stage; 1 = GPipe). The result is the
    sequential loop's, on every rank of the group.
    """
    group = mesh.group(axis_name)
    n_stages = mesh.shape[axis_name]
    v, m = int(interleave), int(num_microbatches)
    assert v >= 1, v
    assert len(layers) % (n_stages * v) == 0, (len(layers), n_stages, v)
    assert x.shape[0] % m == 0, (x.shape[0], m)
    stage = dist.get_rank(group) if n_stages > 1 else 0
    plan = _Plan(block_fn, list(layers), group, n_stages, stage, v, m)
    if torch.is_grad_enabled() and (x.requires_grad or _requires_grad(layers)):
        anchor = torch.empty(0, requires_grad=True)  # the Function's backward runs on every rank
        out = _Pipeline.apply(plan, x, anchor)
    else:
        with torch.no_grad():
            out = torch.cat(plan.forward(list(x.chunk(m)), record=False)[0])
    return broadcast_from_stage(out, group, n_stages - 1)
