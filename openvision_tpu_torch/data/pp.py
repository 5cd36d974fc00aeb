"""Preprocessing-op framework: numpy dict→dict ops composed by pp strings.

The port's copy of ``openvision_tpu/data/pp.py`` (numpy only), operating on
numpy/python values so ops run in any Python pipeline.

Op contract: a registered factory returns `fn(data, rng) -> data` where
`data` is a dict and `rng` a np.random.Generator (deterministic per record).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from openvision_tpu_torch.utils.registry import Registry, parse_op_string


def pp_op(name: str):
    """Registers a pp-op factory under `name` (and `preprocess_ops.<name>`)."""

    def wrap(factory):
        Registry.register(name, replace=True)(factory)
        Registry.register(f"preprocess_ops.{name}", replace=True)(factory)
        return factory

    return wrap


def inkey_outkey(indefault=None, outdefault=None):
    """Adapts a single-tensor op into a dict op with inkey/outkey kwargs.

    The wrapped factory's op has signature `fn(value, rng)`; the adapter moves
    `data[inkey]` through it into `data[outkey]` (reference registry.py:41).
    """

    def decorate(factory):
        @functools.wraps(factory)
        def factory_wrapper(*args, inkey=indefault, outkey=outdefault, key=None, **kw):
            ikey = key or inkey
            okey = key or outkey or ikey
            op = factory(*args, **kw)

            def dict_op(data, rng):
                data[okey] = op(data[ikey], rng)
                return data

            return dict_op

        return factory_wrapper

    return decorate


def build_pp_fn(pp_string: str) -> Callable:
    """Composes `"op1(...)|op2"` into one `fn(data, rng) -> data`."""
    ops = []
    for spec in pp_string.split("|"):
        spec = spec.strip()
        if not spec:
            continue
        name, args, kwargs = parse_op_string(spec)
        lookup = name if Registry.knows(name) else f"preprocess_ops.{name}"
        factory = Registry._global.get(lookup)
        if factory is None:
            raise KeyError(f"Unknown pp op {name!r}")
        ops.append(factory(*args, **kwargs))

    def composed(data: dict, rng: np.random.Generator | None = None) -> dict:
        if rng is None:
            rng = np.random.default_rng(0)
        for op in ops:
            data = op(data, rng)
        return data

    return composed


def import_pp_modules(names=("ops_general", "ops_image", "ops_text", "bert_ops", "ops_aug",
                             "ops_autoaugment")):
    """Imports the port's op modules so their registrations run (ops_aug's
    batch mixup/cutmix is applied by the training pipeline, not as a pp
    op)."""
    import importlib

    for n in names:
        importlib.import_module(f"openvision_tpu_torch.data.{n}")
