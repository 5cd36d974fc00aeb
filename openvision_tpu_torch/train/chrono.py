"""Step timing: images/s, the host-wait share, progress.

Counterpart of ``openvision_tpu/train/chrono.py:Chrono`` for one device.
Each step is timed on the host from the moment it asks for its batch to the
moment its update has finished on the device (the trainer synchronizes
before it ticks); the part spent waiting for the input pipeline is the host
wait. :meth:`Chrono.tick` reports, over the steps since the last tick,
``step_ms``, ``img/sec``, ``host_wait_share``, ``examples_seen``,
``progress`` and ``uptime``; the first tick after a start or resume counts
its steps as warm-up and reports no rate. ``accum_train_time`` survives a
resume through :meth:`save` / :meth:`load`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Chrono:
    def __init__(self):
        self.program_start = time.monotonic()
        self.global_bs = None
        self.total_steps = None
        self.accum_train_time = 0.0
        self._reset_window()
        self._warm = False

    def _reset_window(self):
        self.window_steps = 0
        self.window_time = 0.0
        self.window_wait = 0.0

    def inform(self, *, total_steps=None, global_bs=None) -> None:
        self.total_steps = total_steps or self.total_steps
        self.global_bs = global_bs or self.global_bs

    def step_done(self, step_time: float, wait_time: float) -> None:
        """Adds one step: its host time, of which `wait_time` waited for data."""
        self.window_steps += 1
        self.window_time += step_time
        self.window_wait += wait_time

    def tick(self, step: int, measure: Optional[Callable] = None) -> dict:
        metrics = {"uptime": time.monotonic() - self.program_start,
                   "examples_seen": (self.global_bs or 0) * step}
        if self.total_steps:
            metrics["progress"] = step / self.total_steps
        if self._warm and self.window_steps and self.window_time > 0:
            metrics["step_ms"] = 1e3 * self.window_time / self.window_steps
            metrics["img/sec"] = (self.global_bs or 0) * self.window_steps / self.window_time
            metrics["host_wait_share"] = self.window_wait / self.window_time
            self.accum_train_time += self.window_time
        self._warm = True
        self._reset_window()
        if measure:
            for k, v in metrics.items():
                measure(k, v)
        return metrics

    def save(self) -> dict:
        return {"accum_train_time": self.accum_train_time}

    def load(self, state: dict) -> None:
        self.accum_train_time = float(state.get("accum_train_time", 0.0))
