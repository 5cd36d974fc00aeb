"""Checkpoint reading and writing: flat-name npz, Orbax train states and
legacy tensorstore checkpoints.

Counterpart of ``openvision_tpu/train/checkpoint.py`` with its own
``recover_tree`` and ``recover_dtype`` (``openvision_tpu/utils/tree.py:52,
:139``), since the JAX package's modules import JAX. Three formats:

- **npz** (``save_npz`` / ``load_npz``, JAX :177-204): one array per flat
  slash-joined name ("params/img/cls", ...); numpy stores bfloat16 as
  2-byte void, which :func:`recover_dtype` turns back into a
  ``torch.bfloat16`` tensor.
- **Orbax train states** (JAX ``restore_params`` / ``save_train_state``,
  :61-110), the Model-Zoo ``jax_orbax_weight`` layout:
  ``<dir>/<step>/_CHECKPOINT_METADATA`` and ``<step>/default/`` holding
  ``_METADATA`` (the tree's names) and an OCDBT store of zarr v2 arrays
  (``train/ocdbt.py``, ``train/zarr.py``), each leaf keyed by its
  dot-joined path ("params.img.w/.zarray", "params.img.w/0.0").
  :func:`restore_params` reads the ``params`` subtree of the newest
  committed step (or a given one): a directory named by a step number with
  ``_CHECKPOINT_METADATA`` in it, not an ``*.orbax-checkpoint-tmp-*`` one.
  :func:`save_orbax` writes a train-state tree as one process of
  JAX's Orbax save lays it out (zstd level 1 chunks), so that the JAX
  package restores it.
- **Legacy tensorstore** (JAX ``load_legacy_ts``, :127-172): one zarr
  directory a leaf (blosc/lz4) named by its ``~``-joined path, most with a
  ``~value`` suffix, in ``{path}-{step:09d}`` beside a ``{path}-LAST``
  pointer; :func:`restore_params` routes such a directory to
  :func:`load_legacy_ts`, as JAX does (:82-100).

:func:`load_checkpoint` and :func:`load_state_dict` take any of the three.
Leaves come back as numpy arrays, bfloat16 ones as ``torch.bfloat16``
tensors.

The trainer's train state (:func:`save_train_state`,
:func:`restore_train_state`) is the JAX trainer's: an Orbax step directory
``<workdir>/checkpoints/<step>/`` holding ``{"params": <the JAX param
tree>, "opt": <the optax chain state>}`` (``convert/openclip.py``,
``optim.py:state_dict_to_chain``), so either trainer resumes the other's
run. The port keeps the records its input pipeline has read in
``data_position-<step>.json`` beside the step (JAX keeps grain's iterator
state in ``data_state-<step>-p<i>.bin``, which the port reads where it
maps onto a record count, :func:`grain_position`, and never writes). The
newest `keep` steps are kept. :func:`saved_steps` also lists the port's
earlier format, one npz a step (``ckpt-<step>.npz``: ``params/<name>``,
``opt/count``, ``opt/mu/<name>``, ``opt/nu/<name>``, ``step``,
``data_position``), which :func:`restore_train_state` still reads. On a
process mesh the save gathers every leaf whole (FSDP2 chunks over data x
fsdp, tensor shards over tensor, ``convert/openclip.py:unshard_tensor``)
and process 0 alone writes the one-process state, which the caption tool
and the daemon load unchanged; the restore cuts each process's pieces from
it again.
"""

from __future__ import annotations

import base64
import glob
import json
import os
import re
import shutil
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from openvision_tpu_torch import optim
from openvision_tpu_torch.convert.openclip import (
    jax_params_to_state_dict, partial_state_dict_to_jax_params, shard_tensor,
    state_dict_to_jax_params, unshard_tensor)
from openvision_tpu_torch.train import codecs, ocdbt, zarr


def recover_tree(names: Sequence[str], values: Sequence[Any]) -> Dict[str, Any]:
    """Rebuilds a nested dict from flat slash-delimited names."""
    tree: Dict[str, Any] = {}
    for name, value in zip(names, values):
        *parents, leaf = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def recover_dtype(a: np.ndarray):
    """numpy's void-stored bfloat16 -> a torch.bfloat16 tensor; any other
    array passes through."""
    if a.dtype.kind == "V":
        if a.itemsize != 2:
            raise ValueError(f"unknown {a.itemsize}-byte void dtype in the npz")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:  # stored as 2-byte void, as numpy does
            return v.view(torch.int16).numpy().view(np.dtype("V2"))
        return v.numpy()
    return np.asarray(v)


def save_npz(path: str, tree: Any) -> None:
    """Writes a nested dict of arrays (numpy or torch) as a flat-named npz,
    atomically (a temporary file, then a rename)."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    tmp = path + "-TEMPORARY"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_npz(path: str, tree_key: Optional[str] = None) -> Dict[str, Any]:
    """Loads a flat-named npz back into a nested dict. `path` may carry a
    ``:subtree`` suffix ("ckpt.npz:img") selecting a subtree, of which
    alone the arrays are read."""
    if tree_key is None and ":" in os.path.basename(path):
        path, tree_key = path.rsplit(":", 1)
    with open(path, "rb") as f:
        data = np.load(f, allow_pickle=False)
        flat = {k: recover_dtype(data[k]) for k in data.files
                if tree_key is None or k == tree_key or k.startswith(tree_key + "/")}
    tree = recover_tree(list(flat), list(flat.values()))
    return tree[tree_key] if tree_key else tree


def _is_legacy_ts(directory: str) -> bool:
    """A reference tensorstore directory: `~`-joined array names, each a zarr
    directory, or a base path with a `-LAST` step pointer beside it."""
    if os.path.exists(directory + "-LAST"):
        return True
    if not os.path.isdir(directory):
        return False
    return any("~" in d and os.path.exists(os.path.join(directory, d, ".zarray"))
               for d in os.listdir(directory))


ORBAX_TMP = ".orbax-checkpoint-tmp-"
_ZSTD = {"id": "zstd", "level": 1}
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# every leaf replicated over the restoring process's devices (a one-process save)
_REPLICATED = json.dumps({"sharding_type": "NamedSharding", "shape": [-1], "axis_names": ["d"],
                          "partition_spec": []})


def _file_getter(directory: str):
    def get(key: str) -> Optional[bytes]:
        path = os.path.join(directory, key)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()
    return get


def load_legacy_ts(path: str, regex: Optional[str] = None) -> Dict[str, Any]:
    """The tree of a reference ``save_checkpoint_ts`` checkpoint: `path` is
    a step directory or the base path of a ``{path}-LAST`` pointer; leaf
    names drop the serializer's ``~value`` suffix and turn ``~`` into
    ``/``; `regex` keeps the names it matches."""
    if os.path.exists(path + "-LAST"):
        with open(path + "-LAST") as f:
            path = f"{path}-{f.read().strip()}"
    pat = re.compile(regex) if regex else None
    names, dirs = [], []
    for entry in sorted(os.listdir(path)):
        adir = os.path.join(path, entry)
        if not os.path.exists(os.path.join(adir, ".zarray")):
            continue
        name = entry[: -len("~value")] if entry.endswith("~value") else entry
        name = name.replace("~", "/")
        if pat is None or pat.match(name):
            names.append(name)
            dirs.append(adir)
    if not names:
        raise FileNotFoundError(f"no zarr arrays found in {path}")
    return recover_tree(names, codecs.parallel_map(
        lambda d: zarr.read_array(_file_getter(d)), dirs))


def orbax_steps(directory: str) -> list[int]:
    """The committed steps of an Orbax checkpoint directory, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and ORBAX_TMP not in d
                  and os.path.isfile(os.path.join(directory, d, "_CHECKPOINT_METADATA")))


def _orbax_leaves(item: str) -> list[tuple]:
    """The leaves' paths (tuples of keys) of one Orbax item, from
    ``_METADATA``'s tree."""
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or not os.path.exists(os.path.join(item, "manifest.ocdbt")):
        raise NotImplementedError(f"{item}: Orbax checkpoints without an OCDBT store are not "
                                  "supported")
    out = []
    for entry in meta["tree_metadata"].values():
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            continue
        path = tuple(k["key"] for k in entry["key_metadata"])
        if value.get("value_type", "jax.Array") not in _ARRAY_TYPES:
            raise NotImplementedError(f"{item}: leaf {'.'.join(path)} of type "
                                      f"{value['value_type']!r} is not supported (arrays and "
                                      "scalars)")
        out.append(path)
    return out


def restore_params(directory: str, step: Optional[int] = None,
                   subtree: Optional[str] = "params") -> Dict[str, Any]:
    """The `subtree` (``params``; None: the whole tree) of an Orbax train
    state, from the newest committed step or `step`; a legacy tensorstore
    directory goes to :func:`load_legacy_ts` (its ``params`` subtree if it
    has one)."""
    if _is_legacy_ts(directory):
        tree = load_legacy_ts(directory)
        return tree.get("params", tree) if subtree else tree
    steps = orbax_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed Orbax checkpoint step in {directory}")
    step = steps[-1] if step is None else int(step)
    if step not in steps:
        raise FileNotFoundError(f"{directory}: no committed step {step} (steps: {steps})")
    item = os.path.join(directory, str(step), "default")
    leaves = [p for p in _orbax_leaves(item) if not subtree or p[0] == subtree]
    with ocdbt.Database(item) as store:
        arrays = codecs.parallel_map(lambda p: zarr.read_array(store.get, ".".join(p) + "/"),
                                     leaves)
    return recover_tree(["/".join(p[1:] if subtree else p) for p in leaves], arrays)


def _key_metadata(path: tuple) -> list:
    """Orbax's keys of a leaf's path: a sequence index (an optax chain's
    position) is of key type 1, a dict key of 2."""
    return [{"key": k, "key_type": 1 if k.isdigit() else 2} for k in path]


def save_orbax(directory: str, step: int, tree: Dict[str, Any]) -> str:
    """Writes `tree` (a train state: ``{"params": ..., "opt": ...}``, numpy
    or torch leaves; ``None`` for a node without arrays, an optax
    ``EmptyState`` or ``MaskedNode``, which Orbax records and never reads)
    as step `step` of the Orbax checkpoint `directory`, as JAX's
    ``save_train_state`` lays out one process's save: into an
    ``*.orbax-checkpoint-tmp-*`` directory, renamed when complete. Returns
    the step's directory."""
    final = os.path.join(os.path.abspath(directory), str(step))
    if os.path.exists(final):
        raise FileExistsError(f"{final} exists")
    tmp = f"{final}{ORBAX_TMP}{time.time_ns()}"
    item = os.path.join(tmp, "default")
    os.makedirs(item)
    t0 = time.time_ns()
    flat = _flatten(tree)
    empty = [tuple(name.split("/")) for name, v in flat.items() if v is None]
    leaves = [(tuple(name.split("/")), v if isinstance(v, torch.Tensor) else np.asarray(v))
              for name, v in flat.items() if v is not None]

    def encode(leaf):
        path, value = leaf
        name, data = ".".join(path), zarr.chunk_bytes(value)
        shape = tuple(value.shape)
        meta = (f"{name}/.zarray", zarr.zarray(shape, zarr.dtype_name(value), _ZSTD))
        if not data.size:  # no chunk in an empty grid
            return [meta]
        return [meta, (f"{name}/{'.'.join('0' * len(shape)) or '0'}", codecs.zstd_compress(data))]

    items = [kv for pair in codecs.parallel_map(encode, leaves) for kv in pair]
    ocdbt.write_orbax_store(item, items)
    values = {path: {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(value.shape)} for path, value in leaves}
    values.update({path: {"value_type": "None", "skip_deserialize": True} for path in empty})
    # in the tree's flattened order: Orbax rebuilds a sequence's entries in it
    tree_meta = {str(path): {"key_metadata": _key_metadata(path), "value_metadata": values[path]}
                 for path in sorted(values, key=lambda p: [(0, int(k), "") if k.isdigit()
                                                           else (1, 0, k) for k in p])}
    with open(os.path.join(item, "_sharding"), "w") as f:
        json.dump({base64.b64encode(".".join(path).encode()).decode(): _REPLICATED
                   for path, _ in leaves}, f)
    with open(os.path.join(item, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": {"default": _HANDLER}, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
    os.rename(tmp, final)
    return final


def load_checkpoint(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The param tree of a checkpoint, routed as the JAX caption tool routes
    it: an .npz file (its ``params`` subtree if it holds a train state; no
    steps), else an Orbax or legacy tensorstore directory
    (:func:`restore_params`, at `step` or the newest)."""
    if os.path.isfile(path) and path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:  # a train state: read its params alone
            state = any(k.startswith("params/") for k in data.files)
        return load_npz(path, "params" if state else None)
    return restore_params(path, step)


def load_state_dict(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The port's state dict of a checkpoint: the trainer's own train state
    (the port's names, one process or a gathered mesh) as it is, a JAX param
    tree converted (``convert/openclip.py:jax_params_to_state_dict``)."""
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    params = load_checkpoint(path, step)
    if "logit_scale" in params:  # the port's names (JAX calls the temperature "t")
        return {k: torch.as_tensor(v) for k, v in params.items()}
    return jax_params_to_state_dict(params)


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-{step}.npz")


def _npz_steps(directory: str) -> list[int]:
    steps = []
    for path in glob.glob(os.path.join(directory, "ckpt-*.npz")):
        m = re.fullmatch(r"ckpt-(\d+)\.npz", os.path.basename(path))
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def saved_steps(directory: str) -> list[int]:
    """The steps of a workdir's ``checkpoints`` directory, oldest first: its
    committed Orbax step directories (either trainer's) and the port's
    earlier ``ckpt-<step>.npz`` files."""
    return sorted(set(orbax_steps(directory)) | set(_npz_steps(directory)))


def step_format(directory: str, step: int) -> str:
    """``orbax`` or ``npz``: the format step `step` of `directory` is in
    (an Orbax step directory wins over an npz of the same step)."""
    return "orbax" if step in orbax_steps(directory) else "npz"


def step_bytes(directory: str, step: int) -> int:
    """The bytes on disk of step `step` of `directory` (its Orbax step
    directory, or its npz)."""
    if step_format(directory, step) == "npz":
        return os.path.getsize(_ckpt_path(directory, step))
    root = os.path.join(directory, str(step))
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def _position_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"data_position-{step}.json")


def _grain_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"data_state-{step}-p0.bin")


def grain_position(raw: bytes) -> Optional[int]:
    """The records every process has read, from the grain iterator state
    JAX's trainer saves (process 0's ``data_state-<step>-p0.bin``), or
    None where it does not map onto one count. Without grain workers the
    sampler of shard i of n hands out records i, i + n, ..., so ``k``
    records read end at ``last_seen = i + (k - 1) n`` and the processes
    together read ``k n``."""
    try:
        state = json.loads(raw)
    except ValueError:
        return None
    seen = state.get("last_seen_indices")
    if state.get("version") != 2 or state.get("worker_count", 0) != 0 or not isinstance(
            seen, dict) or set(seen) != {"0"}:
        return None
    sampler = str(state.get("sampler", ""))
    index = re.search(r"shard_index=(\d+)", sampler)
    count = re.search(r"shard_count=(\d+)", sampler)
    i, n = int(index.group(1)) if index else 0, int(count.group(1)) if count else 1
    return int(seen["0"]) - i + n


def data_position(directory: str, step: int) -> tuple[Optional[int], str]:
    """(the records read at `step`, where it came from); None where the
    workdir holds no position of that step that the port can use."""
    path = _position_path(directory, step)
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f)["data_position"]), "data_position"
    path = _grain_path(directory, step)
    if os.path.exists(path):
        with open(path, "rb") as f:
            position = grain_position(f.read())
        return position, "grain" if position is not None else "grain (not mapped)"
    return None, "none"


def jax_heads(model: torch.nn.Module) -> dict:
    """The head counts :func:`state_dict_to_jax_params` needs, from the
    model's first attention of each tower."""
    from openvision_tpu_torch.models.attention_module import MultiHeadAttention

    heads = {}
    for key, tower in (("num_heads_vision", "visual"), ("num_heads_text", "text"),
                       ("num_heads_decoder", "txt_decoder")):
        module = getattr(model, tower, None)
        first = next((m for m in module.modules() if isinstance(m, MultiHeadAttention)),
                     None) if module is not None else None
        if first is not None:
            heads[key] = first.num_heads
    return heads


def _jax_train_state(state: dict, heads: dict, opt) -> dict:
    """The JAX train state (params, the optax chain) of a gathered one."""
    params = {n: t.detach().float().cpu().numpy() for n, t in state["params"].items()}
    shapes = {n: v.shape for n, v in params.items()}
    chain = optim.state_dict_to_chain(
        state, opt.chain, to_jax=lambda m: partial_state_dict_to_jax_params(m, shapes, **heads))
    adam = chain[str(opt.chain.index("adam"))]["inner_state"]
    adam["mu"] = _map_leaves(adam["mu"], lambda v: torch.from_numpy(v).to(opt.mu_dtype))
    return {"params": state_dict_to_jax_params(params, **heads), "opt": chain}


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _remove_step(directory: str, step: int) -> None:
    shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)
    for path in (_ckpt_path(directory, step), _position_path(directory, step)):
        if os.path.exists(path):
            os.remove(path)


def _whole(piece: torch.Tensor, name: str, param, opt) -> torch.Tensor:
    """The whole leaf of which `piece` is this process's part, `param` the
    model's parameter (an FSDP2 DTensor gives the chunks' layout)."""
    if hasattr(param, "device_mesh"):
        from torch.distributed.tensor import DTensor

        piece = DTensor.from_local(piece, param.device_mesh, param.placements,
                                   shape=param.shape, stride=param.stride()).full_tensor()
    kind = opt.tensor_plan.get(name)
    if kind is not None:
        parts = [torch.empty_like(piece) for _ in range(opt.mesh.tensor)]
        dist.all_gather(parts, piece.contiguous(), group=opt.mesh.tensor_group)
        piece = unshard_tensor(parts, kind)
    return piece


def _piece(whole: torch.Tensor, name: str, param, opt) -> torch.Tensor:
    """This process's part of a whole leaf (the inverse of :func:`_whole`)."""
    kind = opt.tensor_plan.get(name)
    if kind is not None:
        whole = shard_tensor(whole, kind, opt.mesh.coords["tensor"], opt.mesh.tensor)
    if hasattr(param, "device_mesh"):  # FSDP2: torch.chunk rows over fsdp
        chunks = torch.chunk(whole, opt.mesh.shape["fsdp"], dim=0)
        i = opt.mesh.coords["fsdp"]
        whole = chunks[i] if i < len(chunks) else whole[:0]
    return whole


def gather_leaves(pieces: dict, model: torch.nn.Module, opt) -> dict:
    """The whole leaves (on the CPU) of which `pieces` (name -> tensor, laid
    out as the optimizer's parameters: gradients, moments) are this
    process's parts; a collective on a process mesh (every process calls it)."""
    if opt.mesh is None:
        return {n: t.detach().cpu() for n, t in pieces.items()}
    if opt.fsdp_chunked and hasattr(model, "reshard"):
        model.reshard()  # FSDP2's root keeps its leaves gathered after a forward alone
    params = dict(model.named_parameters())
    return {n: _whole(t.detach(), n, params[n], opt).cpu() for n, t in pieces.items()}


def gather_train_state(model: torch.nn.Module, opt) -> dict:
    """The whole train state (params, opt count, mu, nu) on the CPU; a
    collective on a process mesh."""
    if opt.mesh is None:
        return {"params": dict(model.state_dict()), "count": opt.state["count"],
                "mu": opt.state["mu"], "nu": opt.state["nu"]}
    return {"params": gather_leaves(opt.params, model, opt), "count": opt.state["count"],
            "mu": gather_leaves(opt.state["mu"], model, opt),
            "nu": gather_leaves(opt.state["nu"], model, opt)}


def save_train_state(directory: str, step: int, model: torch.nn.Module, opt,
                     data_position: int, keep: int = 1) -> Optional[dict]:
    """Writes the train state of `step` as an Orbax step directory and its
    data position beside it; deletes all but the newest `keep` steps. On a
    process mesh every process calls it, process 0 writes. Returns the
    save's bytes and seconds (process 0)."""
    state = gather_train_state(model, opt)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    t0 = time.perf_counter()
    os.makedirs(directory, exist_ok=True)
    tree = _jax_train_state(state, jax_heads(model), opt)
    step_dir = save_orbax(directory, step, tree)
    path = _position_path(directory, step)
    with open(path + "-TEMPORARY", "w") as f:
        json.dump({"data_position": int(data_position)}, f)
    os.replace(path + "-TEMPORARY", path)
    for old in saved_steps(directory)[:-max(keep, 1)]:
        _remove_step(directory, old)
    return {"path": step_dir, "bytes": step_bytes(directory, step),
            "seconds": time.perf_counter() - t0}


def _check_names(got, want, what: str, where: str) -> None:
    if set(got) != set(want):
        raise ValueError(f"{where}: the {what} names do not match the model's "
                         f"(missing {sorted(set(want) - set(got))[:5]}, "
                         f"extra {sorted(set(got) - set(want))[:5]})")


@torch.no_grad()
def restore_train_state(directory: str, step: int, model: torch.nn.Module,
                        opt) -> tuple[Optional[int], str]:
    """Loads the train state of `step` (an Orbax step directory of either
    trainer, or the port's earlier npz) into `model` and `opt` (this
    process's pieces of it on a process mesh); returns (the data position
    it was saved at, or None where the workdir has none the port can use;
    where the position came from)."""
    where = os.path.join(directory, str(step))
    if step_format(directory, step) == "npz":
        tree = load_npz(_ckpt_path(directory, step))
        params, opt_tree = tree["params"], tree["opt"]
        moments = {"count": int(opt_tree["count"]), "mu": opt_tree["mu"], "nu": opt_tree["nu"]}
        position = (int(tree["data_position"]), "npz")
    else:
        tree = restore_params(directory, step, subtree=None)
        if set(tree) != {"params", "opt"}:
            raise ValueError(f"{where}: a train state holds params and opt, this one "
                             f"{sorted(tree)}")
        params = jax_params_to_state_dict(tree["params"])
        moments = optim.chain_to_state_dict(tree["opt"], opt.chain,
                                            from_jax=jax_params_to_state_dict)
        position = data_position(directory, step)
    names = dict(model.named_parameters())
    _check_names(params, names, "parameter", where)
    for what in ("mu", "nu"):
        _check_names(moments[what], opt.live, f"optimizer {what}", where)
    if opt.mesh is None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        mu, nu = moments["mu"], moments["nu"]
    else:
        def pieces(leaves, keys):
            return {n: _piece(torch.as_tensor(leaves[n]), n, names[n], opt) for n in keys}

        for n, t in pieces(params, opt.params).items():
            opt.params[n].copy_(t)
        mu, nu = pieces(moments["mu"], opt.live), pieces(moments["nu"], opt.live)
    opt.load_state_dict({"count": int(moments["count"]), "mu": mu, "nu": nu})
    return position
