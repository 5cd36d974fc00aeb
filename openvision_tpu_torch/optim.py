"""Optimizer: the JAX package's masked optax chain as one function over tensors.

Counterpart of ``openvision_tpu/optim.py``: duration parsing (:22-47),
warmup + linear / cosine / rsqrt / stair schedules with cooldown (:50-98),
regex masks with first-match claims and freeze-by-None (:101-138), and the
chain of ``make`` (:156-228), applied in its order to every parameter:

    clip by global norm -> Adam (mu stored in bf16, nu f32, bias correction,
    eps 1e-8) -> + wd * mult * param on the ``wd_mults`` masks -> * lr ->
    * lr_mults / lwd -> * schedule(count) -> * -1, then param + update.

The JAX configs' regexes match flax paths (``.*/kernel$``, ``img/.*``);
every port parameter is masked by the flax path(s) it holds
(``convert/openclip.py:flax_paths``), so the configs keep their meaning. A
parameter holding several flax leaves (``in_proj_weight``: the query, key and
value kernels) must get one answer from all of them, or the mask raises.
The first-moment update scales the bf16-stored mu by b1 in bf16 (b1 itself
rounded to bf16, as JAX's weak-typed scalar is), adds the f32 gradient term
in f32 and rounds to bf16 only when it stores mu (optax's
``scale_by_adam`` with ``mu_dtype``). Updates are computed in f32 as optax does; parameters are
updated in place.

Under a process mesh the optimizer holds this process's pieces of the
parameters (their tensor shards, and under FSDP2 their fsdp chunks): Adam
and the decays are elementwise, so each piece updates alone, and the global
norm of ``clip_by_global_norm`` (JAX :182) and of the telemetry (JAX
``train/step.py:39-50``, f32 accumulation) sums each tensor-sharded leaf's
squares over the tensor axis and every chunk's over fsdp, counting each
replicated leaf once (:meth:`Optimizer.global_norm`): the one-process norm
up to f32 summation order.

The optimizer state crosses to and from the JAX train state's ``opt``
subtree, the optax chain state that Orbax stores (:func:`chain_layout`,
:func:`chain_to_state_dict`, :func:`state_dict_to_chain`): a dict keyed by
the chain's indices ("0", "1", ...), the masked Adam at index 1 as
``{"inner_state": {"count", "mu", "nu"}}``, each schedule's
``ScaleByScheduleState`` as ``{"inner_state": {"count"}}``, and ``None``
for every state without arrays (``EmptyState``, and ``optax.MaskedNode``
where a frozen parameter's moments would be), which Orbax keeps as a leaf
of value type ``None`` that it never reads. The step is the schedules'
count, which must be one value (JAX :146-154).
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from openvision_tpu_torch.convert.openclip import flax_paths
from openvision_tpu_torch.parallel import Mesh, all_reduce


def steps(prefix: str, config: dict, data_size: Optional[int] = None,
          batch_size: Optional[int] = None, total_steps: Optional[int] = None,
          default=ValueError) -> int:
    """Resolves ``<prefix>_{steps,examples,epochs,percent}`` in config to steps."""
    found = [s for s in ("steps", "examples", "epochs", "percent")
             if config.get(f"{prefix}_{s}") is not None]
    if len(found) > 1:
        raise ValueError(f"Only one duration unit for {prefix!r}, got {found}")
    if config.get(f"{prefix}_steps") is not None:
        return config[f"{prefix}_steps"]
    if batch_size and config.get(f"{prefix}_examples") is not None:
        return max(round(config[f"{prefix}_examples"] / batch_size), 1)
    if batch_size and data_size and config.get(f"{prefix}_epochs") is not None:
        return max(round(config[f"{prefix}_epochs"] * data_size / batch_size), 1)
    if total_steps and config.get(f"{prefix}_percent") is not None:
        pct = config[f"{prefix}_percent"]
        if not 0.0 <= pct <= 1.0:
            raise ValueError(f"{prefix}_percent must be in [0,1], got {pct}")
        return max(round(pct * total_steps), 1)
    if default is ValueError:
        raise ValueError(f"Cannot resolve duration {prefix!r} to steps")
    return default


def create_learning_rate_schedule(total_steps: int, batch_size: Optional[int] = None,
                                  data_size: Optional[int] = None, base: float = 1.0,
                                  decay_type: str = "cosine", scale_with_batchsize: bool = False,
                                  **kw) -> Callable[[int], float]:
    """lr(step): warmup -> {linear, cosine, rsqrt, stair} -> cooldown, in f32
    arithmetic as the jnp schedule."""
    warmup = steps("warmup", kw, data_size, batch_size, total_steps, default=0)
    cooldown = steps("cooldown", kw, data_size, batch_size, total_steps, default=0)
    if total_steps > 1 and warmup >= total_steps:
        raise ValueError("warmup >= total_steps")
    f32 = np.float32

    def sched(step: int) -> float:
        step = f32(step)
        lr = f32(base)
        if scale_with_batchsize:
            lr = lr * f32(batch_size) / f32(256.0)
        progress = np.clip((step - f32(warmup)) / f32(max(total_steps - warmup, 1)), f32(0),
                           f32(1))
        if decay_type in ("linear", "polynomial"):
            power = kw.get("power", 1)
            end = f32(kw.get("end", kw.get("linear_end", 0)))
            lr = end + (lr - end) * (f32(1) - progress) ** f32(power)
        elif decay_type == "cosine":
            cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * progress, dtype=f32))
            if kw.get("min_lr"):
                floor = f32(kw["min_lr"] / kw["max_lr"])
                lr = floor + (lr - floor) * cos
            else:
                lr = lr * cos
        elif decay_type == "rsqrt":
            timescale = kw.get("timescale", 10_000)
            shift = timescale - warmup
            if warmup < step:
                lr = lr / np.sqrt((step + f32(shift)) / f32(timescale), dtype=f32)
        elif decay_type == "stair":
            i = int(np.searchsorted(np.asarray(kw.get("steps", [])), step + 1))
            lr = lr * f32(([1.0] + list(kw.get("mults", [])))[i])
        else:
            raise ValueError(f"Unknown decay_type: {decay_type!r}")
        if warmup:
            lr = lr * min(f32(1), step / f32(warmup))
        if cooldown:
            lr = lr * min(f32(1), (f32(total_steps) - step) / f32(cooldown))
        return float(f32(lr))

    return sched


def mask_groups(names: Sequence[str], patterns: Sequence[str]) -> list[set]:
    """For each regex, the parameter names it claims: each flax path goes to
    the FIRST pattern that fullmatches it, and a parameter's paths must agree."""
    compiled = [re.compile(p) for p in patterns]
    groups = [set() for _ in compiled]
    for name in names:
        claims = {next((i for i, c in enumerate(compiled) if c.fullmatch(path)), -1)
                  for path in flax_paths(name)}
        if len(claims) > 1:
            raise ValueError(f"the flax paths of {name!r} ({flax_paths(name)}) fall under "
                             f"different patterns of {list(patterns)}")
        claim = claims.pop()
        if claim >= 0:
            groups[claim].add(name)
    return groups


class Optimizer:
    """The ``make`` chain over named parameters (a dict name -> Parameter).

    config keys: schedule (list of (regex, schedule dict or None)), lr,
    optax_name (only ``scale_by_adam``), optax (b1, b2, eps, mu_dtype),
    grad_clip_norm, lr_mults, lwd with lwd_depth, wd, wd_mults.
    """

    def __init__(self, config: dict, params: dict, *, sched_kw: dict, mesh: Mesh | None = None,
                 tensor_plan: Optional[dict] = None, fsdp_chunked=frozenset()):
        """`params` this process's pieces (name -> tensor updated in place);
        `mesh` the process mesh, `tensor_plan` the leaves sharded over its
        tensor axis (name -> kind, ``train/step.py:tensor_plan``),
        `fsdp_chunked` the leaves FSDP2 chunks over its fsdp axis."""
        self.params = params
        self.mesh, self.tensor_plan = mesh, dict(tensor_plan or {})
        self.fsdp_chunked = set(fsdp_chunked)
        names = list(params)
        schedule = config.get("schedule")
        if not isinstance(schedule, (list, tuple)):
            schedule = [(".*", schedule)]
        groups = mask_groups(names, [p for p, _ in schedule])
        uncovered = set(names).difference(*groups)
        if uncovered:
            raise ValueError("params not covered by config.schedule (use None to freeze): "
                             f"{sorted(uncovered)}")
        self.frozen = set().union(*(g for g, (_, s) in zip(groups, schedule) if s is None))
        self.live = [n for n in names if n not in self.frozen]
        self.schedules = [
            (g, create_learning_rate_schedule(
                base=s.get("mult", 1.0), **sched_kw, **{k: v for k, v in s.items() if k != "mult"}))
            for g, (_, s) in zip(groups, schedule) if s is not None]

        if config.get("optax_name", "scale_by_adam") != "scale_by_adam":
            raise NotImplementedError(f"optax_name={config['optax_name']!r} is not ported "
                                      "(only scale_by_adam)")
        opt = dict(config.get("optax", {}))
        self.b1, self.b2 = opt.get("b1", 0.9), opt.get("b2", 0.999)
        self.eps, self.eps_root = opt.get("eps", 1e-8), opt.get("eps_root", 0.0)
        mu_dtype = opt.get("mu_dtype")
        self.mu_dtype = getattr(torch, mu_dtype) if isinstance(mu_dtype, str) else (
            mu_dtype or torch.float32)
        self.clip_norm = config.get("grad_clip_norm")
        self.lr = config.get("lr", 1.0)
        self.chain = chain_layout(config)

        self.scales = []  # (names, multiplier): lr_mults, then lwd
        if config.get("lr_mults"):
            pats, mults = zip(*config["lr_mults"])
            if not all(m > 0 for m in mults):
                raise ValueError("freeze with schedule=None, not lr_mults")
            self.scales += list(zip(mask_groups(names, pats), mults))
        if config.get("lwd"):
            depth, lwd = config.get("lwd_depth"), config["lwd"]
            if not depth:
                raise ValueError("config.lwd needs config.lwd_depth (encoder depth)")
            rules = [(f".*encoderblock_{i}/.*", lwd ** (depth - i)) for i in range(depth)]
            rules += [("head.*", 1.0), ("encoder_norm.*", 1.0), ("embedding.*", lwd ** (depth + 1)),
                      ("pos_embedding.*", lwd ** (depth + 1)), ("cls.*", lwd ** (depth + 1))]
            pats, mults = zip(*rules)
            self.scales += list(zip(mask_groups(names, pats), mults))
        self.decays = []  # (names, wd * mult)
        if config.get("wd", 0.0):
            pats, mults = zip(*config.get("wd_mults", [(r".*/kernel$", 1.0)]))
            self.decays = [(g, config["wd"] * m) for g, m in zip(mask_groups(names, pats), mults)]
        self.state = self.init_state()

    def init_state(self) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(self.params[n], dtype=self.mu_dtype) for n in self.live},
                "nu": {n: torch.zeros_like(self.params[n], dtype=torch.float32)
                       for n in self.live}}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update from `grads` (name -> f32 tensor) in place;
        returns the updates (name -> tensor; zero for frozen parameters)."""
        st = self.state
        count = st["count"]
        g = {n: grads[n].float() for n in self.live}
        if self.clip_norm:
            norm = self.global_norm(g)
            if not bool(norm < self.clip_norm):
                g = {n: t / norm * self.clip_norm for n, t in g.items()}
        c = count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(c))
        updates = {}
        for n, t in g.items():
            # b1 * mu in mu's dtype, b1 rounded to it first (JAX's weak-typed
            # scalar), as optax's update_moment on a bf16 mu
            mu_prev = st["mu"][n]
            mu = (1 - self.b1) * t + (mu_prev * torch.tensor(self.b1, dtype=mu_prev.dtype)).float()
            nu = (1 - self.b2) * (t * t) + self.b2 * st["nu"][n]
            updates[n] = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            st["mu"][n] = mu.to(self.mu_dtype)
            st["nu"][n] = nu
        for names, wd in self.decays:
            for n in names & updates.keys():
                updates[n] = updates[n] + wd * self.params[n].float()
        for n in updates:
            updates[n] = updates[n] * self.lr
        for names, mult in self.scales:
            for n in names & updates.keys():
                updates[n] = updates[n] * mult
        for names, fn in self.schedules:
            lr = fn(count)
            for n in names & updates.keys():
                updates[n] = updates[n] * lr
        for n in self.frozen:
            updates[n] = torch.zeros_like(self.params[n], dtype=torch.float32)
        for n, u in updates.items():
            u = -u
            updates[n] = u
            p = self.params[n]
            p.copy_((p.float() + u).to(p.dtype))
        st["count"] = c
        return updates

    def global_norm(self, named: dict) -> torch.Tensor:
        """The l2 norm (f32 accumulation) of the whole leaves whose pieces
        `named` (name -> tensor) holds, the same on every process."""
        if self.mesh is None:
            return l2_norm(named.values())
        zero = next(iter(named.values())).new_zeros((), dtype=torch.float32)
        sq = {}  # (tensor-sharded, fsdp-chunked) -> the squares of such pieces
        for n, t in named.items():
            key = (n in self.tensor_plan, n in self.fsdp_chunked)
            sq[key] = sq.get(key, zero) + (t.float() ** 2).sum()
        tp = self.mesh.tensor_group
        chunked = all_reduce(sq.get((True, True), zero), tp) + sq.get((False, True), zero)
        if self.fsdp_chunked:
            chunked = all_reduce(chunked, self.mesh.device_mesh.get_group("fsdp"))
        return torch.sqrt(chunked + all_reduce(sq.get((True, False), zero), tp)
                          + sq.get((False, False), zero))

    def state_dict(self) -> dict:
        return {"count": self.state["count"], "mu": dict(self.state["mu"]),
                "nu": dict(self.state["nu"])}

    def load_state_dict(self, state: dict) -> None:
        dev = {n: p.device for n, p in self.params.items()}
        self.state = {
            "count": int(state["count"]),
            "mu": {n: torch.as_tensor(state["mu"][n]).to(dev[n], self.mu_dtype) for n in self.live},
            "nu": {n: torch.as_tensor(state["nu"][n]).to(dev[n], torch.float32) for n in self.live},
        }


def chain_layout(config: dict) -> list[str]:
    """The state of each transformation of ``make``'s chain (JAX :206-208),
    in order: ``empty`` (an ``EmptyState``), ``masked`` (a ``MaskedState``
    of one), ``adam`` (the masked ``ScaleByAdamState``) or ``schedule`` (a
    masked ``ScaleByScheduleState``)."""
    schedule = config.get("schedule")
    if not isinstance(schedule, (list, tuple)):
        schedule = [(".*", schedule)]
    layout = ["masked" if config.get("grad_clip_norm") else "empty", "adam"]
    if config.get("wd", 0.0):
        layout += ["masked"] * len(config.get("wd_mults", [(r".*/kernel$", 1.0)]))
    layout += ["empty"] + ["masked"] * len(config.get("lr_mults") or ())
    if config.get("lwd"):
        layout += ["masked"] * (config["lwd_depth"] + 5)
    layout += ["schedule"] * sum(s is not None for _, s in schedule)
    return layout + ["masked", "empty"]


def chain_count(chain: dict, layout: Sequence[str]) -> int:
    """The step of a chain state: the one value of its schedules' counts
    (``optim.get_count``); counts that disagree raise."""
    counts = {int(np.asarray(chain[str(i)]["inner_state"]["count"]))
              for i, kind in enumerate(layout) if kind == "schedule"}
    if len(counts) != 1:
        raise ValueError(f"the optimizer chain's schedule counts disagree: {sorted(counts)} "
                         "(one step count expected)")
    return counts.pop()


def chain_to_state_dict(chain: dict, layout: Sequence[str], from_jax: Callable) -> dict:
    """The port's :meth:`Optimizer.state_dict` of a JAX chain state.

    `chain` as Orbax restores it (its ``None`` leaves absent or ``None``),
    `from_jax` a JAX param tree (leaves of frozen params absent) -> the
    port's names. The chain's indices must be the config's `layout`."""
    arrays = {k for k, v in chain.items() if _has_array(v)}
    want = {str(i) for i, kind in enumerate(layout) if kind in ("adam", "schedule")}
    if arrays != want:
        raise ValueError(f"the optimizer chain holds state at indices {sorted(arrays)}, this "
                         f"config's chain at {sorted(want)} ({list(layout)})")
    adam = chain[str(layout.index("adam"))]["inner_state"]
    count = chain_count(chain, layout)
    if int(np.asarray(adam["count"])) != count:
        raise ValueError(f"the optimizer chain's Adam count {int(np.asarray(adam['count']))} "
                         f"is not its schedules' {count}")
    return {"count": count, "mu": from_jax(adam["mu"]), "nu": from_jax(adam["nu"])}


def _has_array(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_array(v) for v in tree.values())
    return tree is not None


def state_dict_to_chain(state: dict, layout: Sequence[str], to_jax: Callable) -> dict:
    """The JAX chain state of the port's :meth:`Optimizer.state_dict`, the
    inverse of :func:`chain_to_state_dict`: `to_jax` the port's names (the
    live params') -> a JAX param tree with ``None`` at the frozen params'
    leaves. Counts are int32, as optax keeps them."""
    count = np.asarray(state["count"], np.int32)
    chain = {}
    for i, kind in enumerate(layout):
        if kind == "adam":
            chain[str(i)] = {"inner_state": {"count": count, "mu": to_jax(state["mu"]),
                                             "nu": to_jax(state["nu"])}}
        elif kind == "schedule":
            chain[str(i)] = {"inner_state": {"count": count}}
        else:
            chain[str(i)] = None if kind == "empty" else {"inner_state": None}
    return chain


def l2_norm(tensors) -> torch.Tensor:
    """Global l2 norm with f32 accumulation (``train/step.py:_l2_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))

