"""Global op registry + the `"op(arg, k=v)|op2"` preprocessing DSL parser.

The port's copy of ``openvision_tpu/utils/registry.py`` (pure Python; the
port imports nothing of the JAX package): ops register under a name, and
`parse_op_string` turns `"name(1, k='x')"` into `(name, args, kwargs)` using
`ast.literal_eval` so arbitrary code can never execute from a config string.
"""

from __future__ import annotations

import ast
import contextlib
from typing import Any, Callable


class Registry:
    """A flat global registry of named factories."""

    _global: dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str, replace: bool = False):
        def decorator(fn):
            if name in cls._global and not replace:
                raise KeyError(f"Duplicate registration for {name!r}")
            cls._global[name] = fn
            return fn

        return decorator

    @classmethod
    def lookup(cls, spec: str) -> Callable:
        """Resolves `"name(args)"` to a zero-config callable factory result."""
        name, args, kwargs = parse_op_string(spec)
        if name not in cls._global:
            known = ", ".join(sorted(cls._global))
            raise KeyError(f"Unknown op {name!r}. Known ops: {known}")
        return cls._global[name](*args, **kwargs)

    @classmethod
    def knows(cls, name: str) -> bool:
        return name.split("(")[0] in cls._global

    @classmethod
    @contextlib.contextmanager
    def temporary_ops(cls, **ops: Callable):
        """Context manager that registers ops for the duration of a block."""
        saved = dict(cls._global)
        try:
            for k, v in ops.items():
                cls._global[k] = lambda *a, _v=v, **kw: _v
            yield
        finally:
            cls._global.clear()
            cls._global.update(saved)


def parse_op_string(spec: str) -> tuple[str, tuple, dict[str, Any]]:
    """Parses `"name(1, 2, k='v')"` → `("name", (1, 2), {"k": "v"})`.

    Bare names parse as zero-arg calls. Only Python literals are allowed as
    arguments (numbers, strings, bools, None, tuples/lists/dicts of those).
    """
    spec = spec.strip()
    if "(" not in spec:
        if not spec.isidentifier():
            raise ValueError(f"Invalid op name: {spec!r}")
        return spec, (), {}

    expr = ast.parse(spec, mode="eval").body
    if not isinstance(expr, ast.Call) or not isinstance(expr.func, ast.Name):
        raise ValueError(f"Expected a single call expression, got: {spec!r}")

    args = tuple(ast.literal_eval(a) for a in expr.args)
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in expr.keywords}
    return expr.func.id, args, kwargs
