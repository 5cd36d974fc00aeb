"""Config helpers: the `key=val,flag` argument mini-language.

Counterpart of ``openvision_tpu/configs/common.py:parse_arg``, returning a
plain dict (the JAX package's ``ml_collections`` is not a dependency of the
port). Values are coerced by each default's type; bare names become True;
keys with no default are cast to int, float or bool where they parse.
"""

from __future__ import annotations

from typing import Any


def parse_arg(arg: str | None, **defaults: Any) -> dict:
    """Parses `"a=1,b=x,flag"` against typed defaults into a dict."""
    out = dict(defaults)
    if not arg:
        return out
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            out[part] = True
            continue
        key, val = part.split("=", 1)
        key = key.strip()
        val = val.strip().strip("'\"")
        if key not in defaults:
            out[key] = _autocast(val)
            continue
        default = defaults[key]
        if isinstance(default, bool):
            out[key] = val.lower() in ("true", "1", "yes", "t")
        elif isinstance(default, int):
            out[key] = int(val)
        elif isinstance(default, float):
            out[key] = float(val)
        else:
            out[key] = val
    return out


def _autocast(val: str) -> Any:
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    return val
