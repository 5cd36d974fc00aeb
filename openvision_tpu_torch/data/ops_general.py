"""General preprocessing ops (numpy): ``value_range``, ``keep`` and ``flatten``.

The port's copies of ``openvision_tpu/data/ops_general.py:13, :27, :166``:
the two the base training config names and the value range the eval pp
strings may name.
"""

from __future__ import annotations

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op


@pp_op("value_range")
@inkey_outkey(indefault="image", outdefault="image")
def get_value_range(vmin=-1.0, vmax=1.0, in_min=0.0, in_max=255.0, clip_values=False):
    def op(image, rng):
        image = np.asarray(image, np.float32)
        image = (image - in_min) / (in_max - in_min)
        image = vmin + image * (vmax - vmin)
        if clip_values:
            image = np.clip(image, vmin, vmax)
        return image

    return op


@pp_op("keep")
def get_keep(*keys):
    def op(data, rng):
        return {k: v for k, v in data.items() if k in keys}

    return op


@pp_op("flatten")
def get_flatten():
    """Flattens nested dicts: {"a": {"b": 1}} -> {"a/b": 1}."""

    def op(data, rng):
        out = {}

        def rec(prefix, d):
            for k, v in d.items():
                key = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    rec(key, v)
                else:
                    out[key] = v

        rec("", data)
        return out

    return op
