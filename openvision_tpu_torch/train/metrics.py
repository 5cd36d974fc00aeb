"""Metric writer: one JSONL row per logged step.

Counterpart of ``openvision_tpu/train/metrics.py:MetricWriter``: the config
dumped once as ``<workdir>/config.json`` and one row per step appended to
``<workdir>/metrics.jsonl``. Rows are written synchronously (a row per log
step costs microseconds); wandb mirroring is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch


class MetricWriter:
    def __init__(self, workdir: Optional[str] = None, config: Optional[dict] = None):
        self.step = -1
        self.step_metrics: dict[str, Any] = {}
        self.path = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self.path = os.path.join(workdir, "metrics.jsonl")
            if config is not None:
                with open(os.path.join(workdir, "config.json"), "w") as f:
                    json.dump(config, f, indent=2, default=str)

    def step_start(self, step: int) -> None:
        self._flush()
        self.step = step
        self.step_metrics = {}

    def measure(self, name: str, value) -> float:
        """Records one scalar (a tensor is read once); returns it as a float."""
        if isinstance(value, torch.Tensor):
            value = value.detach().float().reshape(-1)[0].item()
        value = float(value)
        self.step_metrics[name] = value
        return value

    def _flush(self) -> None:
        if self.path and self.step >= 0 and self.step_metrics:
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": self.step, **self.step_metrics}) + "\n")

    def close(self) -> None:
        self._flush()
        self.step_metrics = {}
