"""Optimizer: the JAX package's masked optax chain as one function over tensors.

Counterpart of ``openvision_tpu/optim.py``: duration parsing (:22-47),
warmup + linear / cosine / rsqrt / stair schedules with cooldown (:50-98),
regex masks with first-match claims and freeze-by-None (:101-138), and the
chain of ``make`` (:156-228), applied in its order to every parameter:

    clip by global norm -> the optax transformation ``optax_name`` (Adam:
    mu stored in bf16, nu f32, bias correction, eps 1e-8) -> + wd * mult *
    param on the ``wd_mults`` masks -> * lr -> * lr_mults / lwd ->
    * schedule(count) -> * -1, then param + update.

``optax_name`` (JAX takes any optax attribute, :187) is one of
:data:`OPTAX_NAMES`, with optax's keyword arguments in ``optax``:
``scale_by_adam``, ``scale_by_lion`` (sign of the b1 blend; mu, an EMA at
b2, in ``mu_dtype``), ``scale_by_rms`` (nu an EMA of g**2 from
``initial_scale``; rsqrt(nu + eps), or 1 / (sqrt(nu) + eps); optional bias
correction), ``trace`` (momentum: t = g + decay * t, Nesterov optional,
``accumulator_dtype``) and ``scale_by_factored_rms`` (Adafactor's core:
per leaf of two dims of at least ``min_dim_size_to_factor``, the row and
column means of g**2 + epsilon as EMAs at the 1 - (t + 1)**-decay_rate
schedule; else the full EMA). The factored estimate depends on the JAX
leaf's shape (a flax kernel is (in, out), (D, heads, head_dim) for the
attention's; the port's in_proj_weight stacks three of them), so that
transformation runs on each JAX leaf, gathered from the port's parameter
by an index map built once from ``convert/openclip.py``'s layout
(``jax_layout``), one process only. Any other name raises, listing these.

The arithmetic follows optax's dtypes: with f32 parameters (JAX's default)
the gradients and updates are f32; with ``param_dtype=bfloat16`` the
gradients, the moments (but a ``mu_dtype`` or ``accumulator_dtype`` given)
and every update step are in bf16, each Python scalar cast to the array's
dtype first as JAX casts a weak-typed scalar, and the parameters are
updated in bf16 (``optax.apply_updates``).

The JAX configs' regexes match flax paths (``.*/kernel$``, ``img/.*``);
every port parameter is masked by the flax path(s) it holds
(``convert/openclip.py:flax_paths``), so the configs keep their meaning. A
parameter holding several flax leaves (``in_proj_weight``: the query, key and
value kernels) must get one answer from all of them, or the mask raises.
The first-moment update scales the bf16-stored mu by b1 in bf16 (b1 itself
rounded to bf16, as JAX's weak-typed scalar is), adds the f32 gradient term
in f32 and rounds to bf16 only when it stores mu (optax's
``scale_by_adam`` with ``mu_dtype``). Updates are computed in the
parameters' dtype as optax does; parameters are updated in place.

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
the chain's indices ("0", "1", ...), the masked transformation at index 1
as ``{"inner_state": {...}}`` with its state's fields (Adam's ``count``,
``mu``, ``nu``; :data:`SLOTS`), each schedule's
``ScaleByScheduleState`` as ``{"inner_state": {"count"}}``, and ``None``
for every state without arrays (``EmptyState``, and ``optax.MaskedNode``
where a frozen parameter's moments would be), which Orbax keeps as a leaf
of value type ``None`` that it never reads. The step is the schedules'
count, which must be one value (JAX :146-154).
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from openvision_tpu_torch.convert.openclip import flax_paths
from openvision_tpu_torch.parallel import Mesh, all_reduce

# optax_name -> its state's slot in the chain layout
OPTAX_NAMES = {"scale_by_adam": "adam", "scale_by_lion": "lion", "scale_by_rms": "rms",
               "trace": "trace", "scale_by_factored_rms": "factored_rms"}
# slot -> (the state's per-leaf fields, whether it holds a count); "rms_count"
# is scale_by_rms with bias_correction. factored_rms's fields are per JAX leaf.
SLOTS = {"adam": (("mu", "nu"), True), "lion": (("mu",), True), "rms": (("nu",), False),
         "rms_count": (("nu",), True), "trace": (("trace",), False),
         "factored_rms": (("v_row", "v_col", "v"), True)}


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
    optax_name (:data:`OPTAX_NAMES`), optax (its keyword arguments),
    grad_clip_norm, lr_mults, lwd with lwd_depth, wd, wd_mults.
    """

    def __init__(self, config: dict, params: dict, *, sched_kw: dict, mesh: Mesh | None = None,
                 tensor_plan: Optional[dict] = None, fsdp_chunked=frozenset(),
                 jax_layout: Optional[Callable] = None):
        """`params` this process's pieces (name -> tensor updated in place);
        `mesh` the process mesh, `tensor_plan` the leaves sharded over its
        tensor axis (name -> kind, ``train/step.py:tensor_plan``),
        `fsdp_chunked` the leaves FSDP2 chunks over its fsdp axis;
        `jax_layout` (``scale_by_factored_rms`` only) maps a dict of the
        port's names to numpy arrays to the JAX param tree
        (``convert/openclip.py:partial_state_dict_to_jax_params``)."""
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

        self.optax_name = config.get("optax_name", "scale_by_adam")
        self.opt_kw = dict(config.get("optax", {}))
        self.chain = chain_layout(config)
        self.slot = self.chain[1]
        self.fields, self.has_count = SLOTS[self.slot]
        self.clip_norm = config.get("grad_clip_norm")
        self.lr = config.get("lr", 1.0)
        self._leaves = None  # factored_rms: name -> [(JAX path, index map)]
        if self.slot == "factored_rms":
            if mesh is not None and (tensor_plan or fsdp_chunked):
                raise NotImplementedError("scale_by_factored_rms over tensor- or fsdp-sharded "
                                          "parameters is not ported (one process, or data "
                                          "parallel only)")
            if jax_layout is None:
                raise ValueError("scale_by_factored_rms needs jax_layout: its factored moments "
                                 "are those of the JAX leaves' shapes")
            self._leaves = leaf_index_maps(
                {n: params[n] for n in self.live}, jax_layout,
                self.opt_kw.get("min_dim_size_to_factor", 128) if self.opt_kw.get(
                    "factored", True) else None)

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

    def field_dtype(self, field: str, param_dtype: torch.dtype) -> torch.dtype:
        """The dtype a state field is stored in: ``mu_dtype`` or
        ``accumulator_dtype`` when given, else the parameter's (Adam's nu and
        the rest: optax's zeros_like(params))."""
        name = {"mu": "mu_dtype", "trace": "accumulator_dtype"}.get(field)
        dt = self.opt_kw.get(name) if name else None
        return getattr(torch, dt) if isinstance(dt, str) else (dt or param_dtype)

    @property
    def mu_dtype(self) -> Optional[torch.dtype]:
        """The configured first-moment dtype (Adam's, Lion's), or None: each
        parameter's own."""
        dt = self.opt_kw.get("mu_dtype")
        return getattr(torch, dt) if isinstance(dt, str) else dt

    def init_state(self) -> dict:
        state = {"count": 0}
        if self.slot == "factored_rms":
            for f in self.fields:
                state[f] = {}
            for n, leaves in self._leaves.items():
                p = self.params[n]
                for path, idx, dims in leaves:
                    shape = tuple(idx.shape)
                    one = (1,)
                    if dims is None:
                        vr, vc, v = one, one, shape
                    else:  # v_row drops the larger axis d0, v_col the other
                        d1, d0 = dims
                        vr = shape[:d0] + shape[d0 + 1:]
                        vc = shape[:d1] + shape[d1 + 1:]
                        v = one
                    state["v_row"][path], state["v_col"][path] = p.new_zeros(vr), p.new_zeros(vc)
                    state["v"][path] = p.new_zeros(v)
            return state
        init = self.opt_kw.get("initial_scale", 0.0) if self.fields == ("nu",) else 0.0
        for f in self.fields:
            state[f] = {n: torch.full_like(self.params[n], init,
                                           dtype=self.field_dtype(f, self.params[n].dtype))
                        for n in self.live}
        return state

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Applies one update from `grads` (name -> tensor in the parameter's
        dtype, or f32) in place; returns the updates (name -> tensor; zero
        for frozen parameters)."""
        st = self.state
        count = st["count"]
        g = {n: grads[n].to(self.params[n].dtype) for n in self.live}
        if self.clip_norm:
            norm = self.global_norm(g)
            if not bool(norm < self.clip_norm):
                g = {n: t / norm.to(t.dtype) * _s(self.clip_norm, t) for n, t in g.items()}
        c = count + 1
        updates = getattr(self, f"_{self.slot.removesuffix('_count')}")(g, c)
        for names, wd in self.decays:
            for n in names & updates.keys():
                updates[n] = updates[n] + _s(wd, updates[n]) * self.params[n]
        for n in updates:
            updates[n] = updates[n] * _s(self.lr, updates[n])
        for names, mult in self.scales:
            for n in names & updates.keys():
                updates[n] = updates[n] * _s(mult, updates[n])
        for names, fn in self.schedules:
            lr = fn(count)
            for n in names & updates.keys():
                updates[n] = updates[n] * _s(lr, updates[n])
        for n in self.frozen:
            updates[n] = torch.zeros_like(self.params[n])
        for n, u in updates.items():
            u = -u
            updates[n] = u
            p = self.params[n]
            p.copy_((p + u).to(p.dtype))
        st["count"] = c
        return updates

    def _adam(self, g: dict, c: int) -> dict:
        st, kw = self.state, self.opt_kw
        b1, b2 = kw.get("b1", 0.9), kw.get("b2", 0.999)
        eps, eps_root = kw.get("eps", 1e-8), kw.get("eps_root", 0.0)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(c))
        updates = {}
        for n, t in g.items():
            # b1 * mu in mu's dtype, b1 rounded to it first (JAX's weak-typed
            # scalar), as optax's update_moment on a bf16 mu
            mu_prev, nu_prev = st["mu"][n], st["nu"][n]
            mu = _s(1 - b1, t) * t + mu_prev * _s(b1, mu_prev)
            nu = _s(1 - b2, t) * (t * t) + nu_prev * _s(b2, nu_prev)
            updates[n] = (mu / _divisor(bc1, mu)) / (
                torch.sqrt(nu / _divisor(bc2, nu) + _s(eps_root, nu)) + _s(eps, nu))
            st["mu"][n] = mu.to(st["mu"][n].dtype)
            st["nu"][n] = nu.to(nu_prev.dtype)
        return updates

    def _lion(self, g: dict, c: int) -> dict:
        st, kw = self.state, self.opt_kw
        b1, b2 = kw.get("b1", 0.9), kw.get("b2", 0.99)
        updates = {}
        for n, t in g.items():
            m = st["mu"][n]
            updates[n] = torch.sign(_s(1 - b1, t) * t + _s(b1, m) * m)
            st["mu"][n] = (_s(1 - b2, t) * t + _s(b2, m) * m).to(m.dtype)
        return updates

    def _rms(self, g: dict, c: int) -> dict:
        st, kw = self.state, self.opt_kw
        decay, eps = kw.get("decay", 0.9), kw.get("eps", 1e-8)
        updates = {}
        for n, t in g.items():
            nu = _s(1 - decay, t) * (t * t) + _s(decay, st["nu"][n]) * st["nu"][n]
            st["nu"][n] = nu
            if kw.get("bias_correction", False):
                nu = nu / _divisor(float(np.float32(1) - np.float32(decay) ** np.float32(c)), nu)
            if kw.get("eps_in_sqrt", True):
                scaling = torch.rsqrt(nu + _s(eps, nu))
            else:
                scaling = 1 / (torch.sqrt(nu) + _s(eps, nu))
            updates[n] = scaling * t
        return updates

    def _trace(self, g: dict, c: int) -> dict:
        st, kw = self.state, self.opt_kw
        decay = kw["decay"]
        updates = {}
        for n, t in g.items():
            tr = st["trace"][n]
            new = t + _s(decay, tr) * tr
            updates[n] = t + _s(decay, new) * new if kw.get("nesterov", False) else new
            st["trace"][n] = new.to(tr.dtype)
        return updates

    def _factored_rms(self, g: dict, c: int) -> dict:
        """optax's scale_by_factored_rms on each JAX leaf of each parameter."""
        st, kw = self.state, self.opt_kw
        step = c - 1 - kw.get("step_offset", 0)
        decay = float(np.float32(1) - np.float32(step + 1) ** np.float32(-kw.get("decay_rate",
                                                                                 0.8)))
        epsilon = kw.get("epsilon", 1e-30)
        updates = {}
        for n, t in g.items():
            flat, out = t.reshape(-1), torch.empty_like(t).reshape(-1)
            for path, idx, dims in self._leaves[n]:
                grad = flat[idx]
                sq = grad * grad + _s(epsilon, grad)
                d = _s(decay, grad)
                e = _s(1 - d, grad)
                if dims is not None:
                    d1, d0 = dims
                    v_row = d * st["v_row"][path] + e * sq.mean(d0)
                    v_col = d * st["v_col"][path] + e * sq.mean(d1)
                    st["v_row"][path], st["v_col"][path] = v_row, v_col
                    reduced = d1 - 1 if d1 > d0 else d1
                    row = (v_row / v_row.mean(reduced, keepdim=True)) ** -0.5
                    u = grad * row.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
                else:
                    v = d * st["v"][path] + e * sq
                    st["v"][path] = v
                    u = grad * v ** -0.5
                out[idx.reshape(-1)] = u.reshape(-1)
            updates[n] = out.reshape(t.shape)
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
        """{"count": the step, field: {name (or JAX path for factored_rms)
        -> tensor} for each of the transformation's fields}."""
        return {"count": self.state["count"], **{f: dict(self.state[f]) for f in self.fields}}

    def load_state_dict(self, state: dict) -> None:
        new = {"count": int(state["count"])}
        if self.slot == "factored_rms":
            dev = next(iter(self.params.values())).device
            for f in self.fields:
                new[f] = {k: _copied(state[f][k]).to(dev, self.state[f][k].dtype)
                          for k in self.state[f]}
        else:
            for f in self.fields:
                new[f] = {n: torch.as_tensor(state[f][n]).to(
                    self.params[n].device, self.field_dtype(f, self.params[n].dtype))
                    for n in self.live}
        self.state = new


def _copied(x) -> torch.Tensor:
    """A tensor of its own holding `x` (a tensor, or an array, which Orbax
    restores read-only)."""
    return x.clone() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _s(x: float, like: torch.Tensor) -> float:
    """The Python scalar `x` rounded to `like`'s dtype, as JAX casts a
    weak-typed scalar to the array's dtype before the operation (bf16 rounds
    it; f32 leaves it as torch's own scalar would). It stays a Python float:
    torch computes a bf16 op in f32, where the product or sum with a
    bf16-exact scalar gives the bits of the bf16 operation, and a device
    tensor would cost a blocking copy per scalar per step."""
    return _rounded(float(x), like.dtype)


@functools.lru_cache(maxsize=4096)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def _divisor(x: float, like: torch.Tensor):
    """:func:`_s` as the divisor of `like`: on CUDA a 0-d device tensor
    (one a value, dtype and device), since a CUDA division by a Python
    scalar multiplies by its reciprocal, up to an ulp off JAX's division;
    on the CPU the scalar."""
    if not like.is_cuda:
        return _s(x, like)
    return _device_scalar(_s(x, like), like.dtype, like.device)


@functools.lru_cache(maxsize=64)
def _device_scalar(x: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


def factored_dims(shape: tuple, min_dim: int | None = 128):
    """optax's _factored_dims: the two largest axes (second largest first)
    when both are at least `min_dim`, else None (always None for a
    `min_dim` of None: ``factored=False``)."""
    if min_dim is None or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def leaf_index_maps(params: dict, jax_layout: Callable, min_dim: int | None = 128) -> dict:
    """name -> [(JAX path, index map, factored dims or None)]: each JAX leaf
    of each parameter as a long tensor of the leaf's shape holding the flat
    indices of the parameter's elements it is made of, from `jax_layout`
    applied to index arrays (two f32-exact halves of each index, so leaves
    past 2**24 elements map exactly), and :func:`factored_dims` of its
    shape."""
    out = {}
    for n, p in params.items():
        idx = np.arange(p.numel(), dtype=np.int64).reshape(tuple(p.shape))
        lo, hi = (jax_layout({n: (idx % 4096).astype(np.float32)}),
                  jax_layout({n: (idx // 4096).astype(np.float32)}))
        leaves = []
        for path in flax_paths(n):
            keys = path.split("/")
            a, b = lo, hi
            for k in keys:
                a, b = a[k], b[k]
            leaf = torch.from_numpy(np.asarray(b).astype(np.int64) * 4096
                                    + np.asarray(a).astype(np.int64)).to(p.device)
            leaves.append((path, leaf, factored_dims(tuple(leaf.shape), min_dim)))
        out[n] = leaves
    return out


def chain_layout(config: dict) -> list[str]:
    """The state of each transformation of ``make``'s chain (JAX :206-208),
    in order: ``empty`` (an ``EmptyState``), ``masked`` (a ``MaskedState``
    of one), the masked ``optax_name`` transformation's slot (:data:`SLOTS`:
    ``adam``, ``lion``, ``rms`` or ``rms_count`` (with bias correction),
    ``trace``, ``factored_rms``) or ``schedule`` (a masked
    ``ScaleByScheduleState``). Another ``optax_name`` raises."""
    schedule = config.get("schedule")
    if not isinstance(schedule, (list, tuple)):
        schedule = [(".*", schedule)]
    name = config.get("optax_name", "scale_by_adam")
    if name not in OPTAX_NAMES:
        raise NotImplementedError(f"optax_name={name!r} is not ported; the port takes "
                                  f"{', '.join(OPTAX_NAMES)}")
    slot = OPTAX_NAMES[name]
    if slot == "rms" and dict(config.get("optax", {})).get("bias_correction"):
        slot = "rms_count"
    layout = ["masked" if config.get("grad_clip_norm") else "empty", slot]
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
    port's names. The chain's indices must be the config's `layout`.
    ``factored_rms``'s fields stay per JAX leaf, keyed by path."""
    arrays = {k for k, v in chain.items() if _has_array(v)}
    want = {str(i) for i, kind in enumerate(layout) if kind in SLOTS or kind == "schedule"}
    if arrays != want:
        raise ValueError(f"the optimizer chain holds state at indices {sorted(arrays)}, this "
                         f"config's chain at {sorted(want)} ({list(layout)})")
    slot = layout[1]
    fields, has_count = SLOTS[slot]
    inner = chain["1"]["inner_state"]
    count = chain_count(chain, layout)
    if has_count and int(np.asarray(inner["count"])) != count:
        raise ValueError(f"the optimizer chain's {slot} count {int(np.asarray(inner['count']))} "
                         f"is not its schedules' {count}")
    convert = _flatten_paths if slot == "factored_rms" else from_jax
    return {"count": count, **{f: convert(inner[f]) for f in fields}}


def _has_array(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_array(v) for v in tree.values())
    return tree is not None


def _flatten_paths(tree, prefix: str = "") -> dict:
    """A nested dict's array leaves by slash-joined path (``None`` left out)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_paths(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _fill_paths(skeleton, leaves: dict, prefix: str = ""):
    """`skeleton` (a nested dict) with the leaves of `leaves` (by path) in
    place, ``None`` elsewhere."""
    return {k: _fill_paths(v, leaves, f"{prefix}{k}/") if isinstance(v, dict)
            else leaves.get(f"{prefix}{k}") for k, v in skeleton.items()}


def state_dict_to_chain(state: dict, layout: Sequence[str], to_jax: Callable) -> dict:
    """The JAX chain state of the port's :meth:`Optimizer.state_dict`, the
    inverse of :func:`chain_to_state_dict`: `to_jax` the port's names (the
    live params') -> a JAX param tree with ``None`` at the frozen params'
    leaves (``to_jax({})``: every leaf ``None``). Counts are int32, as optax
    keeps them."""
    count = np.asarray(state["count"], np.int32)
    chain = {}
    for i, kind in enumerate(layout):
        if kind in SLOTS:
            fields, has_count = SLOTS[kind]
            if kind == "factored_rms":
                skeleton = to_jax({})
                inner = {f: _fill_paths(skeleton, state[f]) for f in fields}
            else:
                inner = {f: to_jax(state[f]) for f in fields}
            chain[str(i)] = {"inner_state": {"count": count, **inner} if has_count else inner}
        elif kind == "schedule":
            chain[str(i)] = {"inner_state": {"count": count}}
        else:
            chain[str(i)] = None if kind == "empty" else {"inner_state": None}
    return chain


def l2_norm(tensors) -> torch.Tensor:
    """Global l2 norm with f32 accumulation (``train/step.py:_l2_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))

