"""JAX <-> OpenCLIP <-> port weight name maps, on numpy arrays.

Counterpart of ``openvision_tpu/convert/openclip.py``, with its own flatten
helpers in place of ``openvision_tpu.utils`` (which imports JAX).

Name map (flat JAX name <-> OpenCLIP key), vision tower:
  img/cls                      <-> visual.class_embedding          (squeeze)
  img/embedding/kernel         <-> visual.conv1.weight             (HWIO<->OIHW)
  img/embedding/bias           <-> visual.conv1.bias
  img/pos_embedding            <-> visual.positional_embedding     (squeeze)
  img/encoder_norm/{scale,bias}<-> visual.ln_post.{weight,bias}
  img/head/kernel              <-> visual.proj                     (no transpose)
  img/head/bias                <-> visual.proj_bias
  img/Transformer/encoderblock_N/LayerNorm_{0,1}    <-> resblocks.N.ln_{1,2}
  .../MultiHeadDotProductAttention_0/{q,k,v}/kernel <-> attn.in_proj_weight (concat, T)
  .../out/kernel                                     <-> attn.out_proj.weight (T)
  .../MlpBlock_0/Dense_{0,1}/kernel                  <-> mlp.{c_fc,c_proj}.weight (T)
  .../ls1/ls1, .../ls2/ls2 (LayerScale)              <-> ls_1.gamma, ls_2.gamma
Text tower: txt/Embed_0/embedding <-> token_embedding.weight, txt/pos_embedding
<-> positional_embedding, txt/encoder_norm <-> ln_final, txt/head/kernel <->
text_projection (no transpose), blocks <-> transformer.resblocks.N.*; and
t <-> logit_scale, b <-> logit_bias.

Caption decoder (no OpenCLIP counterpart; port names under ``txt_decoder.``,
JAX names under ``txt_decoder/``):
  image_projection_layer/kernel <-> image_projection_layer.weight  (T)
  text_projection_layer/kernel  <-> text_projection_layer.weight   (T)
  learnable_tokens              <-> learnable_tokens
  decoder_norm/{scale,bias}     <-> decoder_norm.{weight,bias}
  head/kernel                   <-> head.weight                    (T)
  Transformer/encoderblock_N    <-> transformer.resblocks.N        (as the towers)
  Transformer/crossattn_encoderblock_N/LayerNorm_{0,1,2}
                                <-> transformer.cross_resblocks.N.{ln_1,ln_1_kv,ln_2}
  .../MultiHeadDotProductAttention_0 (DenseGeneral: (D, H, hd) q/k/v
  kernels, (H, hd) biases, (H, hd, D) out) <-> attn.in_proj_weight (concat, T),
  attn.out_proj; .../MlpBlock_0 <-> mlp.

The port's ``CLIPModel`` state dict is the OpenCLIP one with the text
tower's keys under ``text.`` and the decoder's under ``txt_decoder.``:
:func:`openclip_to_state_dict` and :func:`state_dict_to_openclip` convert
the towers between the two, :func:`jax_params_to_state_dict` takes a JAX
param tree (towers and decoder) straight to the port, and
:func:`state_dict_to_jax_params` goes back.

Tensor-parallel shards (the JAX ``tensor`` axis rules, parallel/mesh.py:41-52:
heads and mlp over tensor): a plan names each sharded leaf's kind --
``qkv`` (``attn.in_proj_weight`` / ``in_proj_bias``: the rank's rows of q, of
k and of v, stacked), ``rows`` (``mlp.c_fc.weight`` / ``c_fc.bias``) or
``cols`` (``attn.out_proj.weight``, ``mlp.c_proj.weight``) --
and :func:`shard_state_dict` cuts one rank's shard, :func:`unshard_state_dict`
joins the shards of every rank back, bit for bit (numpy or torch leaves).
The JAX rules' ``vocab`` axis over tensor takes the same kinds
(``train/step.py:tensor_plan``): ``rows`` for ``text.token_embedding.weight``
and ``txt_decoder.head.weight`` (vocab rows), ``cols`` for ``visual.proj``
and ``text.text_projection`` (output features; ``rows`` for
``visual.proj_bias``).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def tree_flatten_with_names(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": leaf as numpy}; torch leaves (a bf16 one
    from an npz) become f32 numpy."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(tree_flatten_with_names(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree)}


def recover_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> nested dict (inverse of tree_flatten_with_names)."""
    tree: Dict[str, Any] = {}
    for name, val in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _blk(key: str):
    m = re.search(r"encoderblock_(\d+)/(.*)", key)
    return (int(m.group(1)), m.group(2)) if m else (None, None)


def jax_to_openclip(params: Any) -> Dict[str, np.ndarray]:
    """Flattens a two-tower JAX param tree into an OpenCLIP state_dict."""
    flat = tree_flatten_with_names(params)
    out: Dict[str, np.ndarray] = {}
    visited: set = set()

    def attn_qkv(prefix_jax: str, prefix_torch: str, block_id):
        if block_id in visited:
            return
        visited.add(block_id)
        ws, bs = [], []
        for n in ("query", "key", "value"):
            w = flat[f"{prefix_jax}/MultiHeadDotProductAttention_0/{n}/kernel"]
            b = flat[f"{prefix_jax}/MultiHeadDotProductAttention_0/{n}/bias"]
            if w.ndim == 3:  # DenseGeneral (embed, heads, head_dim)
                w = w.reshape(w.shape[0], -1)
                b = b.reshape(-1)
            ws.append(w.T)
            bs.append(b)
        out[f"{prefix_torch}.attn.in_proj_weight"] = np.concatenate(ws, axis=0)
        out[f"{prefix_torch}.attn.in_proj_bias"] = np.concatenate(bs, axis=0)

    for key, val in flat.items():
        if key == "t":
            out["logit_scale"] = val.reshape(())
            continue
        if key == "b":
            out["logit_bias"] = val.reshape(())
            continue
        tower, rest = key.split("/", 1) if "/" in key else (key, "")
        if tower == "img":
            if rest == "cls":
                out["visual.class_embedding"] = val[0, 0]
            elif rest == "embedding/kernel":
                out["visual.conv1.weight"] = val.transpose(3, 2, 0, 1)
            elif rest == "embedding/bias":
                out["visual.conv1.bias"] = val
            elif rest == "pos_embedding":
                out["visual.positional_embedding"] = val[0]
            elif rest == "encoder_norm/scale":
                out["visual.ln_post.weight"] = val
            elif rest == "encoder_norm/bias":
                out["visual.ln_post.bias"] = val
            elif rest == "head/kernel":
                out["visual.proj"] = val
            elif rest == "head/bias":
                out["visual.proj_bias"] = val
            elif "encoderblock_" in rest:
                i, sub = _blk(rest)
                _convert_block(out, f"img/Transformer/encoderblock_{i}",
                               f"visual.transformer.resblocks.{i}", sub, val,
                               ("img", i), attn_qkv)
        elif tower == "txt":
            if rest == "Embed_0/embedding":
                out["token_embedding.weight"] = val
            elif rest == "pos_embedding":
                out["positional_embedding"] = val[0]
            elif rest == "encoder_norm/scale":
                out["ln_final.weight"] = val
            elif rest == "encoder_norm/bias":
                out["ln_final.bias"] = val
            elif rest == "head/kernel":
                out["text_projection"] = val
            elif "encoderblock_" in rest:
                i, sub = _blk(rest)
                _convert_block(out, f"txt/Transformer/encoderblock_{i}",
                               f"transformer.resblocks.{i}", sub, val, ("txt", i), attn_qkv)
        # txt_decoder params have no OpenCLIP counterpart (CoCa head):
        # jax_decoder_to_state_dict maps them to the port's names.
    return out


def _convert_block(out, jax_prefix, torch_prefix, sub, val, block_id, attn_qkv):
    if sub.startswith("LayerNorm_"):
        n = int(sub.split("_")[1].split("/")[0]) + 1
        kind = "weight" if sub.endswith("scale") else "bias"
        out[f"{torch_prefix}.ln_{n}.{kind}"] = val
    elif "MlpBlock_0/Dense_0" in sub:
        name = "weight" if sub.endswith("kernel") else "bias"
        out[f"{torch_prefix}.mlp.c_fc.{name}"] = val.T if name == "weight" else val
    elif "MlpBlock_0/Dense_1" in sub:
        name = "weight" if sub.endswith("kernel") else "bias"
        out[f"{torch_prefix}.mlp.c_proj.{name}"] = val.T if name == "weight" else val
    elif "MultiHeadDotProductAttention_0/out" in sub:
        if sub.endswith("kernel"):
            w = val.reshape(-1, val.shape[-1]) if val.ndim == 3 else val
            out[f"{torch_prefix}.attn.out_proj.weight"] = w.T
        else:
            out[f"{torch_prefix}.attn.out_proj.bias"] = val
    elif "MultiHeadDotProductAttention_0" in sub:
        attn_qkv(jax_prefix, torch_prefix, block_id)
    elif sub in ("ls1/ls1", "ls2/ls2"):
        out[f"{torch_prefix}.ls_{sub[2]}.gamma"] = val


def openclip_to_jax(state_dict: Dict[str, Any], *, num_heads_vision: int,
                    num_heads_text: int, use_dense_general: bool = False) -> Dict[str, Any]:
    """Inverse mapping: OpenCLIP state_dict -> nested JAX two-tower params."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    flat: Dict[str, np.ndarray] = {}

    def put_block(torch_prefix: str, jax_prefix: str, num_heads: int):
        blocks = sorted({
            int(re.match(rf"{re.escape(torch_prefix)}\.(\d+)\.", k).group(1))
            for k in sd if k.startswith(torch_prefix + ".")
        })
        for i in blocks:
            tb = f"{torch_prefix}.{i}"
            jb = f"{jax_prefix}/encoderblock_{i}"
            for n in (1, 2):
                flat[f"{jb}/LayerNorm_{n-1}/scale"] = sd[f"{tb}.ln_{n}.weight"]
                flat[f"{jb}/LayerNorm_{n-1}/bias"] = sd[f"{tb}.ln_{n}.bias"]
            flat[f"{jb}/MlpBlock_0/Dense_0/kernel"] = sd[f"{tb}.mlp.c_fc.weight"].T
            flat[f"{jb}/MlpBlock_0/Dense_0/bias"] = sd[f"{tb}.mlp.c_fc.bias"]
            flat[f"{jb}/MlpBlock_0/Dense_1/kernel"] = sd[f"{tb}.mlp.c_proj.weight"].T
            flat[f"{jb}/MlpBlock_0/Dense_1/bias"] = sd[f"{tb}.mlp.c_proj.bias"]
            for n in (1, 2):
                if f"{tb}.ls_{n}.gamma" in sd:
                    flat[f"{jb}/ls{n}/ls{n}"] = sd[f"{tb}.ls_{n}.gamma"]
            w = sd[f"{tb}.attn.in_proj_weight"]  # (3D, D)
            b = sd[f"{tb}.attn.in_proj_bias"]
            d = w.shape[1]
            for j, name in enumerate(("query", "key", "value")):
                wj = w[j * d:(j + 1) * d].T  # (D, D)
                bj = b[j * d:(j + 1) * d]
                if use_dense_general:
                    wj = wj.reshape(d, num_heads, d // num_heads)
                    bj = bj.reshape(num_heads, d // num_heads)
                flat[f"{jb}/MultiHeadDotProductAttention_0/{name}/kernel"] = wj
                flat[f"{jb}/MultiHeadDotProductAttention_0/{name}/bias"] = bj
            wo = sd[f"{tb}.attn.out_proj.weight"].T  # (D, D)
            if use_dense_general:
                wo = wo.reshape(num_heads, d // num_heads, d)
            flat[f"{jb}/MultiHeadDotProductAttention_0/out/kernel"] = wo
            flat[f"{jb}/MultiHeadDotProductAttention_0/out/bias"] = sd[f"{tb}.attn.out_proj.bias"]

    flat["img/cls"] = sd["visual.class_embedding"][None, None, :]
    flat["img/embedding/kernel"] = sd["visual.conv1.weight"].transpose(2, 3, 1, 0)
    if "visual.conv1.bias" in sd:
        flat["img/embedding/bias"] = sd["visual.conv1.bias"]
    if "visual.positional_embedding" in sd:
        flat["img/pos_embedding"] = sd["visual.positional_embedding"][None]
    flat["img/encoder_norm/scale"] = sd["visual.ln_post.weight"]
    flat["img/encoder_norm/bias"] = sd["visual.ln_post.bias"]
    if "visual.proj" in sd:
        flat["img/head/kernel"] = sd["visual.proj"]
    if "visual.proj_bias" in sd:
        flat["img/head/bias"] = sd["visual.proj_bias"]
    put_block("visual.transformer.resblocks", "img/Transformer", num_heads_vision)

    flat["txt/Embed_0/embedding"] = sd["token_embedding.weight"]
    flat["txt/pos_embedding"] = sd["positional_embedding"][None]
    flat["txt/encoder_norm/scale"] = sd["ln_final.weight"]
    flat["txt/encoder_norm/bias"] = sd["ln_final.bias"]
    flat["txt/head/kernel"] = sd["text_projection"]
    put_block("transformer.resblocks", "txt/Transformer", num_heads_text)

    flat["t"] = sd["logit_scale"].reshape(1)
    if "logit_bias" in sd:
        flat["b"] = sd["logit_bias"].reshape(1)
    return recover_tree(flat)


def openclip_to_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """OpenCLIP state_dict -> the port's CLIPModel state dict (f32 tensors).

    The text tower's keys move under ``text.``; ``logit_bias`` is dropped,
    as the JAX tools ignore it (an exported two-tower model holds none; a
    JAX param tree's ``b`` reaches the trainer through
    :func:`jax_params_to_state_dict`).
    """
    out = {}
    for k, v in state_dict.items():
        if k == "logit_bias":
            continue
        name = k if k.startswith("visual.") or k == "logit_scale" else f"text.{k}"
        out[name] = (v.detach().float() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, dtype=np.float32)))
    return out


def state_dict_to_openclip(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's CLIPModel state dict -> OpenCLIP state_dict."""
    return {k.removeprefix("text."): v for k, v in state_dict.items()}


_DEC_LN = {"LayerNorm_0": "ln_1", "LayerNorm_1": "ln_1_kv", "LayerNorm_2": "ln_2"}


def jax_decoder_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """The ``txt_decoder`` JAX subtree -> the port's ``txt_decoder.*`` names."""
    flat = tree_flatten_with_names(params)
    out: Dict[str, np.ndarray] = {}
    top = {
        "image_projection_layer/kernel": ("image_projection_layer.weight", True),
        "text_projection_layer/kernel": ("text_projection_layer.weight", True),
        "learnable_tokens": ("learnable_tokens", False),
        "decoder_norm/scale": ("decoder_norm.weight", False),
        "decoder_norm/bias": ("decoder_norm.bias", False),
        "head/kernel": ("head.weight", True),
    }
    for key, val in flat.items():
        if key in top:
            name, transpose = top[key]
            out[f"txt_decoder.{name}"] = val.T if transpose else val
            continue
        m = re.match(r"Transformer/(crossattn_)?encoderblock_(\d+)/(.*)", key)
        if m is None:
            raise KeyError(f"unknown txt_decoder param {key!r}")
        cross, i, sub = bool(m.group(1)), int(m.group(2)), m.group(3)
        prefix = f"txt_decoder.transformer.{'cross_resblocks' if cross else 'resblocks'}.{i}"
        if cross and sub.startswith("LayerNorm_"):
            ln, kind = sub.split("/")
            out[f"{prefix}.{_DEC_LN[ln]}.{'weight' if kind == 'scale' else 'bias'}"] = val
            continue
        jax_prefix = f"Transformer/{m.group(1) or ''}encoderblock_{i}"

        def attn_qkv(jp, tp, _block_id, flat=flat):
            if f"{tp}.attn.in_proj_weight" in out:
                return
            ws, bs = [], []
            for n in ("query", "key", "value"):
                w = flat[f"{jp}/MultiHeadDotProductAttention_0/{n}/kernel"]
                b = flat[f"{jp}/MultiHeadDotProductAttention_0/{n}/bias"]
                ws.append(w.reshape(w.shape[0], -1).T)
                bs.append(b.reshape(-1))
            out[f"{tp}.attn.in_proj_weight"] = np.concatenate(ws, axis=0)
            out[f"{tp}.attn.in_proj_bias"] = np.concatenate(bs, axis=0)

        _convert_block(out, jax_prefix, prefix, sub, val, None, attn_qkv)
    return out


def state_dict_to_jax_decoder(sd: Dict[str, Any], num_heads: int) -> Dict[str, np.ndarray]:
    """The port's ``txt_decoder.*`` entries -> flat JAX names under
    ``txt_decoder/`` (cross-attention params DenseGeneral-shaped)."""
    sd = {k.removeprefix("txt_decoder."): np.asarray(v) for k, v in sd.items()
          if k.startswith("txt_decoder.")}
    flat = {
        "txt_decoder/image_projection_layer/kernel": sd["image_projection_layer.weight"].T,
        "txt_decoder/text_projection_layer/kernel": sd["text_projection_layer.weight"].T,
        "txt_decoder/learnable_tokens": sd["learnable_tokens"],
        "txt_decoder/decoder_norm/scale": sd["decoder_norm.weight"],
        "txt_decoder/decoder_norm/bias": sd["decoder_norm.bias"],
        "txt_decoder/head/kernel": sd["head.weight"].T,
    }
    blocks = sorted({tuple(k.split(".")[1:3]) for k in sd if k.startswith("transformer.")})
    for kind, i in blocks:
        tb = f"transformer.{kind}.{i}"
        cross = kind == "cross_resblocks"
        jb = f"txt_decoder/Transformer/{'crossattn_' if cross else ''}encoderblock_{i}"
        lns = {v: k for k, v in _DEC_LN.items()} if cross else {"ln_1": "LayerNorm_0",
                                                                   "ln_2": "LayerNorm_1"}
        for tname, jname in lns.items():
            flat[f"{jb}/{jname}/scale"] = sd[f"{tb}.{tname}.weight"]
            flat[f"{jb}/{jname}/bias"] = sd[f"{tb}.{tname}.bias"]
        for j in (0, 1):
            lin = ("c_fc", "c_proj")[j]
            flat[f"{jb}/MlpBlock_0/Dense_{j}/kernel"] = sd[f"{tb}.mlp.{lin}.weight"].T
            flat[f"{jb}/MlpBlock_0/Dense_{j}/bias"] = sd[f"{tb}.mlp.{lin}.bias"]
        w, b = sd[f"{tb}.attn.in_proj_weight"], sd[f"{tb}.attn.in_proj_bias"]
        d = w.shape[1]
        attn = f"{jb}/MultiHeadDotProductAttention_0"
        for j, name in enumerate(("query", "key", "value")):
            wj, bj = w[j * d:(j + 1) * d].T, b[j * d:(j + 1) * d]
            if cross:
                wj, bj = wj.reshape(d, num_heads, d // num_heads), bj.reshape(num_heads, -1)
            flat[f"{attn}/{name}/kernel"], flat[f"{attn}/{name}/bias"] = wj, bj
        wo = sd[f"{tb}.attn.out_proj.weight"].T
        flat[f"{attn}/out/kernel"] = wo.reshape(num_heads, d // num_heads, d) if cross else wo
        flat[f"{attn}/out/bias"] = sd[f"{tb}.attn.out_proj.bias"]
    return flat


def jax_params_to_state_dict(params: Any) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dict of arrays: towers, and the caption
    decoder under ``txt_decoder`` if present) -> port state dict (f32).

    This is how weights cross from the JAX package to the port; a SigLIP
    logit bias ``b`` becomes ``logit_bias``."""
    sd = openclip_to_state_dict(jax_to_openclip(params))
    if "b" in params:
        sd["logit_bias"] = torch.from_numpy(np.array(params["b"], dtype=np.float32).reshape(()))
    if "txt_decoder" in params:
        for k, v in jax_decoder_to_state_dict(params["txt_decoder"]).items():
            sd[k] = torch.from_numpy(np.array(v, dtype=np.float32))
    return sd


def state_dict_to_jax_params(sd: Dict[str, Any], *, num_heads_vision: int,
                             num_heads_text: int, num_heads_decoder: int = 0) -> Dict[str, Any]:
    """The port's state dict -> the JAX param tree (numpy leaves), the
    inverse of :func:`jax_params_to_state_dict`."""
    towers = {k: v for k, v in sd.items() if not k.startswith("txt_decoder.")}
    params = openclip_to_jax(state_dict_to_openclip(towers), num_heads_vision=num_heads_vision,
                             num_heads_text=num_heads_text)
    if len(towers) < len(sd):
        dec = recover_tree(state_dict_to_jax_decoder(sd, num_heads_decoder))
        params["txt_decoder"] = dec["txt_decoder"]
    return params


def _numpy32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def partial_state_dict_to_jax_params(sd: Dict[str, Any], shapes: Dict[str, tuple],
                                     **heads) -> Dict[str, Any]:
    """:func:`state_dict_to_jax_params` of a state dict holding some of the
    model's names (`shapes`: every name's shape), such as an optimizer's
    moments, which only the live params have: the JAX leaves of the names
    it lacks are ``None``. Leaves come back as f32 numpy arrays (a bf16
    moment converts exactly; the caller casts it back)."""
    full = {n: _numpy32(sd[n]) if n in sd else np.zeros(shape, np.float32)
            for n, shape in shapes.items()}
    tree = state_dict_to_jax_params(full, **heads)
    for name in shapes.keys() - sd.keys():
        for path in flax_paths(name):
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node[p]
            node[leaf] = None
    return tree


_TOWER_LEAVES = {
    "visual.class_embedding": "img/cls",
    "visual.conv1.weight": "img/embedding/kernel",
    "visual.conv1.bias": "img/embedding/bias",
    "visual.positional_embedding": "img/pos_embedding",
    "visual.ln_post.weight": "img/encoder_norm/scale",
    "visual.ln_post.bias": "img/encoder_norm/bias",
    "visual.proj": "img/head/kernel",
    "visual.proj_bias": "img/head/bias",
    "text.token_embedding.weight": "txt/Embed_0/embedding",
    "text.positional_embedding": "txt/pos_embedding",
    "text.ln_final.weight": "txt/encoder_norm/scale",
    "text.ln_final.bias": "txt/encoder_norm/bias",
    "text.text_projection": "txt/head/kernel",
    "logit_scale": "t",
    "logit_bias": "b",
    "txt_decoder.image_projection_layer.weight": "txt_decoder/image_projection_layer/kernel",
    "txt_decoder.text_projection_layer.weight": "txt_decoder/text_projection_layer/kernel",
    "txt_decoder.learnable_tokens": "txt_decoder/learnable_tokens",
    "txt_decoder.decoder_norm.weight": "txt_decoder/decoder_norm/scale",
    "txt_decoder.decoder_norm.bias": "txt_decoder/decoder_norm/bias",
    "txt_decoder.head.weight": "txt_decoder/head/kernel",
}
_STACKS = {"visual.transformer.resblocks": "img/Transformer/encoderblock_",
           "text.transformer.resblocks": "txt/Transformer/encoderblock_",
           "txt_decoder.transformer.resblocks": "txt_decoder/Transformer/encoderblock_",
           "txt_decoder.transformer.cross_resblocks":
               "txt_decoder/Transformer/crossattn_encoderblock_"}
_BLOCK_LEAVES = {
    "attn.out_proj.weight": ["MultiHeadDotProductAttention_0/out/kernel"],
    "attn.out_proj.bias": ["MultiHeadDotProductAttention_0/out/bias"],
    "attn.in_proj_weight": [f"MultiHeadDotProductAttention_0/{n}/kernel"
                            for n in ("query", "key", "value")],
    "attn.in_proj_bias": [f"MultiHeadDotProductAttention_0/{n}/bias"
                          for n in ("query", "key", "value")],
    "mlp.c_fc.weight": ["MlpBlock_0/Dense_0/kernel"],
    "mlp.c_fc.bias": ["MlpBlock_0/Dense_0/bias"],
    "mlp.c_proj.weight": ["MlpBlock_0/Dense_1/kernel"],
    "mlp.c_proj.bias": ["MlpBlock_0/Dense_1/bias"],
}


def flax_paths(name: str) -> list[str]:
    """The flat JAX names (``a/b/c``) a port parameter holds: one, or the
    query, key and value kernels (or biases) for ``in_proj_weight`` (``bias``).

    The optimizer masks each parameter by these, so the JAX configs' regexes
    (``.*/kernel$``, ``img/.*``) keep their meaning in the port."""
    if name in _TOWER_LEAVES:
        return [_TOWER_LEAVES[name]]
    m = re.fullmatch(r"(.*)\.(\d+)\.(ln_\w+\.\w+|ls_\d\.gamma|attn\.\w+(?:\.\w+)?|mlp\.\w+\.\w+)",
                     name)
    if m is None or m.group(1) not in _STACKS:
        raise KeyError(f"no JAX name for parameter {name!r}")
    prefix = f"{_STACKS[m.group(1)]}{m.group(2)}/"
    leaf = m.group(3)
    if leaf.startswith("ls_"):  # the JAX checkpoint quirk: module ls1 holds param ls1
        return [f"{prefix}ls{leaf[3]}/ls{leaf[3]}"]
    if leaf.startswith("ln_"):
        ln, kind = leaf.split(".")
        cross = "cross_resblocks" in m.group(1)
        jax_ln = {v: k for k, v in _DEC_LN.items()}[ln] if cross else \
            f"LayerNorm_{int(ln[3]) - 1}"
        return [f"{prefix}{jax_ln}/{'scale' if kind == 'weight' else 'bias'}"]
    return [prefix + p for p in _BLOCK_LEAVES[leaf]]


# ---------------------------------------------------------------------------
# tensor-parallel shards
# ---------------------------------------------------------------------------

TENSOR_KINDS = ("qkv", "rows", "cols")


def _cat(parts, axis: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), dim=axis)
    return np.concatenate(parts, axis=axis)


def shard_tensor(value, kind: str, rank: int, size: int):
    """Rank `rank` of `size`'s shard of one leaf (see the module doc)."""
    if kind == "qkv":
        d = value.shape[0] // 3
        n = d // size
        return _cat([value[i * d + rank * n:i * d + (rank + 1) * n] for i in range(3)], 0)
    if kind == "rows":
        n = value.shape[0] // size
        return value[rank * n:(rank + 1) * n]
    if kind == "cols":
        n = value.shape[1] // size
        return value[:, rank * n:(rank + 1) * n]
    raise ValueError(f"unknown tensor-shard kind {kind!r}")


def unshard_tensor(parts, kind: str):
    """The leaf whose shards, in rank order, are `parts`."""
    if kind == "qkv":
        n = parts[0].shape[0] // 3
        return _cat([p[i * n:(i + 1) * n] for i in range(3) for p in parts], 0)
    return _cat(parts, 0 if kind == "rows" else 1)


def shard_state_dict(sd: Dict[str, Any], plan: Dict[str, str], *, rank: int,
                     size: int) -> Dict[str, Any]:
    """Rank `rank` of `size`'s state dict: each leaf `plan` names cut to its
    shard, every other leaf as it is (replicated over tensor)."""
    return {k: shard_tensor(v, plan[k], rank, size) if k in plan else v for k, v in sd.items()}


def unshard_state_dict(parts, plan: Dict[str, str]) -> Dict[str, Any]:
    """The whole state dict from the shards of every tensor rank, in rank
    order; the inverse of :func:`shard_state_dict`."""
    return {k: unshard_tensor([p[k] for p in parts], plan[k]) if k in plan else v
            for k, v in parts[0].items()}
