"""The optax update rules of the interpretability tools, over one tensor.

``feature_viz`` steps with ``optax.adamax(optax.cosine_decay_schedule(1.0,
400))`` and ``gradient_ascent`` with ``optax.adam(5.0)``
(openvision_tpu/tools/feature_viz.py:59, gradient_ascent.py:57). Each
:class:`Transform` is optax's (init, update) pair: the same moments, the
schedule read at the count before its increment and the bias correction at
the count after it, the same f32 operations in the same order, so an update
agrees with optax's to f32 rounding. :func:`apply_updates` is
``optax.apply_updates``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


class Transform(NamedTuple):
    init: Callable
    update: Callable  # (grads, state) -> (updates, state)


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """init_value * 0.5 * (1 + cos(pi * min(count, decay_steps) /
    decay_steps)), in f32 (optax's alpha 0, exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        decay = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c
                                                           / np.float32(decay_steps)))
        return float(np.float32(init_value) * decay)

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _step_size(learning_rate: Union[float, Schedule], count: int) -> float:
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    return float(np.float32(-lr))


def _init(params: torch.Tensor) -> dict:
    return {"count": 0, "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)}


def adamax(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> Transform:
    """``optax.adamax``: mu = (1 - b1) g + b1 mu, nu = max(|g| + eps, b2 nu),
    update = -lr(count) * (mu / (1 - b1^(count + 1))) / nu."""

    def update(g, state):
        count = state["count"] + 1
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = torch.maximum(g.abs() + eps, b2 * state["nu"])
        u = mu / _bias_correction(b1, count) / nu
        return _step_size(learning_rate, state["count"]) * u, {"count": count, "mu": mu, "nu": nu}

    return Transform(_init, update)


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam`` (eps_root 0): update = -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    def update(g, state):
        count = state["count"] + 1
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * (g * g) + b2 * state["nu"]
        u = (mu / _bias_correction(b1, count)) / (torch.sqrt(nu / _bias_correction(b2, count))
                                                  + eps)
        return _step_size(learning_rate, state["count"]) * u, {"count": count, "mu": mu, "nu": nu}

    return Transform(_init, update)


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return params + updates.to(params.dtype)
