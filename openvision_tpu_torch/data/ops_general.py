"""General preprocessing ops (numpy): ``keep`` and ``flatten``.

The port's copies of ``openvision_tpu/data/ops_general.py:27, :166``, the
two the base training config names.
"""

from __future__ import annotations

from openvision_tpu_torch.data.pp import pp_op


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
