"""Per-tower checkpoint loading, over the port's state-dict names.

Counterpart of ``openvision_tpu/models/loading.py`` (reference vit.py:903
and two_towers.py:121): :func:`load_vit` and :func:`load_text` fill one
tower from a checkpoint, :func:`load_two_towers` both towers and the
temperature. A checkpoint is an npz (``"file.npz:img"`` picks a subtree),
an Orbax train-state directory or a legacy tensorstore one
(``train/checkpoint.py:restore_params``; ``"dir:img"`` also picks a
subtree). Its JAX names become the port's (``convert/openclip.py``), then
``dont_load`` regexes, written against the tower's JAX names as in JAX
("head/.*"), keep those parameters at their init
(``train/trainer.py:merge_params``), and a learned image position embedding
is resampled to the tower's grid (``models/vit.py:resample_posemb``).
Each function takes the tower's current state dict (``tower.state_dict()``,
or the whole model's for :func:`load_two_towers`) and returns the loaded
one. The published short names of :data:`VANITY_NAMES` point at ``gs://``,
which needs the network: they raise.
"""

from __future__ import annotations

import os

import torch

from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

# Published-checkpoint short names (reference vit.py:935-968).
VANITY_NAMES = {
    "howto-i21k-Ti/16": "gs://vit_models/augreg/Ti_16-i21k-300ep-lr_0.001-aug_none-wd_0.03-do_0.0-sd_0.0.npz",
    "howto-i21k-S/32": "gs://vit_models/augreg/S_32-i21k-300ep-lr_0.001-aug_none-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-S/16": "gs://vit_models/augreg/S_16-i21k-300ep-lr_0.001-aug_light1-wd_0.03-do_0.0-sd_0.0.npz",
    "howto-i21k-B/32": "gs://vit_models/augreg/B_32-i21k-300ep-lr_0.001-aug_light1-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-B/16": "gs://vit_models/augreg/B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-B/8": "gs://vit_models/augreg/B_8-i21k-300ep-lr_0.001-aug_medium2-wd_0.1-do_0.0-sd_0.0.npz",
    "howto-i21k-L/16": "gs://vit_models/augreg/L_16-i21k-300ep-lr_0.001-aug_strong1-wd_0.1-do_0.0-sd_0.0.npz",
    "i1k-s16-90ep": "gs://big_vision/vit_s16_i1k_90ep.npz",
    "i1k-s16-150ep": "gs://big_vision/vit_s16_i1k_150ep.npz",
    "i1k-s16-300ep": "gs://big_vision/vit_s16_i1k_300ep.npz",
    "deit3_S_224_1k": "gs://big_vision/zoo/deit3/bv_deit_3_small_224_1k.npz",
    "deit3_S_224_21k": "gs://big_vision/zoo/deit3/bv_deit_3_small_224_21k.npz",
    "deit3_S_384_1k": "gs://big_vision/zoo/deit3/bv_deit_3_small_384_1k.npz",
    "deit3_S_384_21k": "gs://big_vision/zoo/deit3/bv_deit_3_small_384_21k.npz",
    "deit3_B_224_1k": "gs://big_vision/zoo/deit3/bv_deit_3_base_224_1k.npz",
    "deit3_B_224_21k": "gs://big_vision/zoo/deit3/bv_deit_3_base_224_21k.npz",
    "deit3_B_384_1k": "gs://big_vision/zoo/deit3/bv_deit_3_base_384_1k.npz",
    "deit3_B_384_21k": "gs://big_vision/zoo/deit3/bv_deit_3_base_384_21k.npz",
    "deit3_L_224_1k": "gs://big_vision/zoo/deit3/bv_deit_3_large_224_1k.npz",
    "deit3_L_224_21k": "gs://big_vision/zoo/deit3/bv_deit_3_large_224_21k.npz",
    "deit3_L_384_1k": "gs://big_vision/zoo/deit3/bv_deit_3_large_384_1k.npz",
    "deit3_L_384_21k": "gs://big_vision/zoo/deit3/bv_deit_3_large_384_21k.npz",
}


def _load_tree(init_file: str):
    """The JAX tree of an npz, Orbax or legacy checkpoint (or one subtree of
    it, after a ``:``)."""
    from openvision_tpu_torch.train.checkpoint import load_npz, restore_params

    init_file = VANITY_NAMES.get(init_file, init_file)
    if init_file.startswith("gs://"):
        raise NotImplementedError(f"{init_file}: reading gs:// needs the network; copy the "
                                  "checkpoint to a local path")
    if init_file.endswith(".npz") or ".npz:" in init_file:
        return load_npz(init_file)
    path, key = init_file, None
    if not os.path.exists(path) and ":" in os.path.basename(path):
        path, key = path.rsplit(":", 1)
    tree = restore_params(path)
    return tree[key] if key else tree


def _load_tower(init_params: dict, init_file: str, tower: str, prefix: str, dont_load) -> dict:
    from openvision_tpu_torch.train.trainer import merge_params

    restored = _load_tree(init_file)
    if tower in restored and "Transformer" not in restored:
        restored = restored[tower]
    loaded = {k.removeprefix(prefix): v
              for k, v in jax_params_to_state_dict({tower: restored}).items()}
    pats = [f"{tower}/(?:{p})" for p in ([dont_load] if isinstance(dont_load, str)
                                         else dont_load)]
    merged = merge_params({prefix + k: v for k, v in loaded.items()},
                          {prefix + k: v for k, v in init_params.items()}, pats)
    return {k.removeprefix(prefix): v for k, v in merged.items()}


def load_vit(init_params: dict, init_file: str, dont_load=()) -> dict:
    """A ViT tower's state dict loaded from `init_file`, its learned
    position embedding resampled to `init_params`' grid."""
    from openvision_tpu_torch.models.vit import resample_posemb

    restored = _load_tower(init_params, init_file, "img", "visual.", dont_load)
    k = "positional_embedding"
    if k in init_params and k in restored:
        restored[k] = resample_posemb(torch.as_tensor(restored[k]), init_params[k].shape[0])
    return restored


def load_text(init_params: dict, init_file: str, dont_load=()) -> dict:
    """A text tower's state dict loaded from `init_file`."""
    return _load_tower(init_params, init_file, "txt", "text.", dont_load)


def load_two_towers(init_params: dict, init_files, img_load_kw=None, txt_load_kw=None) -> dict:
    """The CLIP state dict `init_params` with both towers and the
    temperature loaded; `init_files` is a path or an {"img", "txt", "t"}
    dict (also "image", "text", "temperature")."""
    if isinstance(init_files, str):
        init_files = {k: f"{init_files}:{k}" for k in ("img", "txt", "t")}
    else:
        init_files = dict(init_files)

    def tower(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in init_params.items() if k.startswith(prefix)}

    restored = dict(init_params)
    img_init = init_files.pop("image", init_files.pop("img", None))
    if img_init:
        loaded = load_vit(tower("visual."), img_init, **(img_load_kw or {}))
        restored.update({f"visual.{k}": v for k, v in loaded.items()})
    txt_init = init_files.pop("text", init_files.pop("txt", None))
    if txt_init:
        loaded = load_text(tower("text."), txt_init, **(txt_load_kw or {}))
        restored.update({f"text.{k}": v for k, v in loaded.items()})
    t_init = init_files.pop("temperature", init_files.pop("t", None))
    if t_init:
        restored["logit_scale"] = jax_params_to_state_dict({"t": _load_tree(t_init)})[
            "logit_scale"]
    if init_files:
        raise ValueError(f"unused keys in init_files: {list(init_files)}")
    return restored
