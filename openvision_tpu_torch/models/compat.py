"""Reference-config compatibility: translate OpenVision model kwargs.

Counterpart of ``openvision_tpu/models/compat.py``: configs written for the
reference use ``use_flash_attn``, ``scan_attn``, ``mlp_chunck``, string
dtypes and a ``mesh`` argument. This maps them onto the port's fields, with
torch dtypes. ``scan_attn`` (JAX: the blockwise "scan" path) maps to
``flash``, the port's memory-efficient attention. ``mlp_chunck`` becomes
the towers' ``chunk`` (the ``scan_mlp`` chunk) and ``patch_embeding`` the
ViT's ``patch_embedding``, as in JAX.
"""

from __future__ import annotations

from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def translate_model_kwargs(kw: dict[str, Any]) -> dict[str, Any]:
    kw = dict(kw)
    kw.pop("mesh", None)  # a process mesh is built by the trainer, not the module
    kw.pop("block_size", None)

    if kw.pop("use_flash_attn", False) or kw.pop("scan_attn", False):
        kw["attn_impl"] = "flash"
    kw.pop("scan_attn", None)

    if "mlp_chunck" in kw:  # the reference's (sic) spelling
        kw["chunk"] = kw.pop("mlp_chunck")
    if "patch_embeding" in kw:
        kw["patch_embedding"] = kw.pop("patch_embeding")
    if "casual_mask" in kw:  # the reference's (sic) spelling
        kw["causal"] = kw.pop("casual_mask")

    for key in ("dtype", "param_dtype"):
        v = kw.get(key)
        if isinstance(v, str):
            kw[key] = _DTYPES[v]

    return kw
