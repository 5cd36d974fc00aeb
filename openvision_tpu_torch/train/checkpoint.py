"""Checkpoint reading and writing: the flat-name npz format.

Counterpart of the npz half of ``openvision_tpu/train/checkpoint.py``
(``save_npz`` / ``load_npz``, :177-204) with its own ``recover_tree`` and
``recover_dtype`` (``openvision_tpu/utils/tree.py:52, :139``), since the
JAX package's modules import JAX. An npz holds one array per flat
slash-joined name ("params/img/cls", ...); numpy stores bfloat16 as 2-byte
void, which :func:`recover_dtype` turns back into a ``torch.bfloat16``
tensor. Orbax train-state directories and legacy tensorstore checkpoints
are not ported yet: :func:`load_checkpoint` names the format and raises.

The trainer's own train state (:func:`save_train_state`,
:func:`restore_train_state`) is one npz per step in the same format, under
the port's parameter names: ``params/<name>``, the optimizer's
``opt/count``, ``opt/mu/<name>`` (bf16) and ``opt/nu/<name>``, ``step``
and ``data_position`` (records the input pipeline has read), written
atomically; the newest `keep` files are kept. On a process mesh the save
gathers every leaf whole (FSDP2 chunks over data x fsdp, tensor shards over
tensor, ``convert/openclip.py:unshard_tensor``) and process 0 alone writes
the one-process file, which the caption tool and the daemon load unchanged;
the restore cuts each process's pieces from it again.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from openvision_tpu_torch.convert.openclip import shard_tensor, unshard_tensor


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
    ``:subtree`` suffix ("ckpt.npz:img") selecting a subtree."""
    if tree_key is None and ":" in os.path.basename(path):
        path, tree_key = path.rsplit(":", 1)
    with open(path, "rb") as f:
        data = np.load(f, allow_pickle=False)
        flat = {k: recover_dtype(data[k]) for k in data.files}
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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The param tree of a checkpoint, routed as the JAX caption tool routes
    it: an .npz file (its ``params`` subtree if it holds a train state);
    legacy tensorstore and Orbax checkpoints raise NotImplementedError."""
    if os.path.isfile(path) and path.endswith(".npz"):
        tree = load_npz(path)
        return tree.get("params", tree)
    fmt = "legacy tensorstore" if _is_legacy_ts(path) else "Orbax"
    raise NotImplementedError(
        f"{path}: {fmt} checkpoints are not ported yet; convert it to a flat npz "
        "with the JAX package (train/checkpoint.py:save_npz)")


def load_state_dict(path: str) -> Dict[str, Any]:
    """The port's state dict of a checkpoint: the trainer's own train state
    (the port's names, one process or a gathered mesh) as it is, a JAX param
    tree converted (``convert/openclip.py:jax_params_to_state_dict``)."""
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    params = load_checkpoint(path)
    if "logit_scale" in params:  # the port's names (JAX calls the temperature "t")
        return {k: torch.as_tensor(v) for k, v in params.items()}
    return jax_params_to_state_dict(params)


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-{step}.npz")


def saved_steps(directory: str) -> list[int]:
    steps = []
    for path in glob.glob(os.path.join(directory, "ckpt-*.npz")):
        m = re.fullmatch(r"ckpt-(\d+)\.npz", os.path.basename(path))
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


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
                     data_position: int, keep: int = 1) -> Optional[str]:
    """Writes the train state of `step`; deletes all but the newest `keep`.
    On a process mesh every process calls it, process 0 writes."""
    state = gather_train_state(model, opt)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, step)
    save_npz(path, {
        "params": state["params"],
        "opt": {"count": np.asarray(state["count"]), "mu": state["mu"], "nu": state["nu"]},
        "step": np.asarray(step), "data_position": np.asarray(data_position)})
    for old in saved_steps(directory)[:-max(keep, 1)]:
        os.remove(_ckpt_path(directory, old))
    return path


@torch.no_grad()
def restore_train_state(directory: str, step: int, model: torch.nn.Module, opt) -> int:
    """Loads the train state of `step` into `model` and `opt` (this
    process's pieces of it on a process mesh); returns the data position it
    was saved at."""
    tree = load_npz(_ckpt_path(directory, step))
    opt_tree = tree["opt"]
    if opt.mesh is None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in tree["params"].items()})
        mu, nu = opt_tree["mu"], opt_tree["nu"]
    else:
        params = dict(model.named_parameters())

        def pieces(leaves, names):
            return {n: _piece(torch.as_tensor(leaves[n]), n, params[n], opt) for n in names}

        for n, t in pieces(tree["params"], opt.params).items():
            opt.params[n].copy_(t)
        mu, nu = pieces(opt_tree["mu"], opt.live), pieces(opt_tree["nu"], opt.live)
    opt.load_state_dict({"count": int(opt_tree["count"]), "mu": mu, "nu": nu})
    return int(tree["data_position"])
