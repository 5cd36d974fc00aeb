"""The training loop: config -> data -> model -> state -> steps.

Counterpart of ``openvision_tpu/train/trainer.py:train`` (:180-506): the
input pipeline (``data/pipeline.py``), the model and optimizer from the
config's seed (``train/step.py``), the init decision chain (resume from the
workdir's own newest checkpoint, with the data position it was saved at;
else ``ft_from``, a flat-name npz: a JAX param tree or the port's own train
state; else the fresh init), then the loop: one update per batch,
measurements, :class:`~openvision_tpu_torch.train.chrono.Chrono` timing and
the process's CUDA kernel launch counts so far (``launches/<kernel>``)
written every ``log_training_steps``, the train state every ``ckpt_steps``
and at the end (``train/checkpoint.py``). The first batch's token ids are
checked against the vocabulary sizes (:45-79).

Evaluators (:137, :332-346, :494-504): ``config.evals`` builds them
(``evaluators/common.py:from_config``; one whose data or options are
unavailable is noted and left out), each runs every ``log_steps`` and at the
end (once at the last step, where the JAX loop runs it twice), writing
``{prefix}{metric}`` and ``z/secs/eval/{name}`` into that step's row;
``eval_only`` runs them once at the starting step (the resumed or
fine-tuned weights) and trains nothing. The chronometer times each step
alone, from its batch request to its synchronize, so an eval between steps
never enters its rates (the JAX trainer pauses its wall-clock chronometer
around an eval for the same end).

Each step ends in a device synchronize, so its host time covers its device
work and the chronometer's host-wait share is the input pipeline's part.

Several processes (``torchrun``, one per rank): ``maybe_distributed_init``
(``parallel/mesh.py``; JAX :82) joins the process group of torchrun's
environment and gives each process its device, the config's
``sharding.mesh`` (data, fsdp, tensor) becomes the process mesh, active for
the whole run, each process loads its (data, fsdp) rows of every batch, the
model and optimizer are placed by ``train/step.py``, ``sync`` (JAX :90) is a
barrier at the run's named points, and process 0 alone writes the metrics,
the chronometer and the checkpoints (JAX :194, :228, :385), which save the
whole state.

Left out, and refused by name when a config asks for them: evaluators
with data and ``eval_only`` on a process mesh (the JAX evaluators split the
classes over processes, disclf.py:201-206), the seq and pipe mesh axes, the
profiler hook, ``steps_per_dispatch``, ``load_transform`` and
``masked_init``; the SIGTERM hook is not installed (a resume loses the steps
since the last checkpoint).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from openvision_tpu_torch import optim
from openvision_tpu_torch.data import pipeline
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.parallel import create_mesh, maybe_distributed_init, rank, sync, use_mesh
from openvision_tpu_torch.train import checkpoint as ckpt_lib
from openvision_tpu_torch.train import step as step_mod
from openvision_tpu_torch.train.chrono import Chrono
from openvision_tpu_torch.train.metrics import MetricWriter


def _should(step: int, every: Optional[int], total: int) -> bool:
    return bool(every) and (step % every == 0 or step == total)


def _refuse_unported(config: dict) -> None:
    for key in ("load_transform", "masked_init"):
        if config.get(key):
            raise NotImplementedError(f"config.{key} is not ported yet")
    if config.get("profile_stop_step"):
        raise NotImplementedError("the profiler hook (profile_start_step/profile_stop_step) is "
                                  "not ported yet")
    if int(config.get("steps_per_dispatch", 1) or 1) > 1:
        raise NotImplementedError("steps_per_dispatch > 1 is not ported yet")


def refuse_evals_on_a_mesh(config: dict, world: int) -> None:
    """Raises, naming the evaluator, when several processes would evaluate:
    an entry of config.evals with data (``data_dir`` or ``source``), or
    ``eval_only``."""
    if world <= 1:
        return
    for name, cfg in (config.get("evals") or {}).items():
        if cfg.get("data_dir") or cfg.get("source") is not None:
            raise NotImplementedError(
                f"config.evals.{name}: evaluators on a process mesh ({world} processes) are "
                "not ported yet; evaluate in one process")
    if config.get("eval_only"):
        raise NotImplementedError(f"eval_only on a process mesh ({world} processes) is not "
                                  "ported yet; evaluate in one process")


def build_evaluators(config: dict, model, mesh, note=print) -> list:
    """[(name, evaluator, log_steps, prefix)] of config.evals; an evaluator
    that fails to build is noted and left out (JAX :137)."""
    from openvision_tpu_torch.evaluators import common as eval_common

    def on_error(name, e):
        note(f"evaluator {name!r} disabled: {e}")

    return eval_common.from_config(config, model, mesh, on_error=on_error)


def check_token_range(config: dict, batch: dict) -> None:
    """Raises when a token id of the first batch exceeds its embedding size
    (a vocab_size below the tokenizer's trains on NaNs)."""
    m = config["model"]
    limits = {"labels1": m["text"].get("vocab_size"), "labels2": m["text"].get("vocab_size"),
              "autoreg_labels": m.get("text_decoder_config", {}).get("num_classes")}
    for key, limit in limits.items():
        if limit and key in batch and int(np.max(batch[key])) >= limit:
            raise ValueError(f"batch[{key!r}] contains token id {int(np.max(batch[key]))} but "
                             f"the model's vocab/num_classes is {limit}: the tokenizer vocab "
                             "and config vocab_size disagree")


def train(config: dict, workdir: Optional[str] = None, device="cuda"):
    """Trains for config["total_steps"]; returns (model, optimizer, the last
    step's measurements as floats)."""
    _refuse_unported(config)
    device = maybe_distributed_init(device)
    refuse_evals_on_a_mesh(config, dist.get_world_size() if dist.is_initialized() else 1)
    mesh = create_mesh(**dict((config.get("sharding") or {}).get("mesh") or {}),
                       device_type=device.type)
    with use_mesh(mesh):
        return _train(config, workdir, device, mesh)


def _train(config, workdir, device, mesh):
    main = rank() == 0
    writer = MetricWriter(workdir if main else None, config)
    chrono = Chrono()

    def note(msg):
        if main:
            print(f"NOTE: {msg}", flush=True)

    batch_size = config["input"]["batch_size"]
    loader, ntrain = pipeline.training(config["input"], seed=config.get("seed", 0),
                                       rows=mesh.batch_rows(batch_size))
    total_steps = optim.steps("total", config, ntrain, batch_size)
    chrono.inform(total_steps=total_steps, global_bs=batch_size)
    note(f"{total_steps} steps, batch {batch_size}, on {device}, mesh {mesh.shape}")

    ckpt_dir = os.path.join(workdir, "checkpoints") if workdir else None
    chrono_path = os.path.join(workdir, "chrono.json") if workdir else None
    saved = ckpt_lib.saved_steps(ckpt_dir) if ckpt_dir else []
    params = None
    if not saved and config.get("ft_from"):
        note(f"finetuning from {config['ft_from']}")
        params = ckpt_lib.load_state_dict(config["ft_from"])
    model = step_mod.build_model(config).to(device)
    sizes = {n: p.numel() for n, p in model.named_parameters()}  # whole, before placement
    opt = step_mod.init_train_state(
        config, model, total_steps=total_steps, data_size=ntrain, mesh=mesh,
        params=None if params is None else {k: v.to(device) for k, v in params.items()})
    writer.measure("num_params", sum(sizes.values()))
    note(f"{sum(sizes.values()) / 1e6:.1f}M params")

    first_step = 0
    if saved:
        first_step = saved[-1]
        loader.position = ckpt_lib.restore_train_state(ckpt_dir, first_step, model, opt)
        note(f"resuming from step {first_step} at data position {loader.position}")
        if os.path.exists(chrono_path):
            with open(chrono_path) as f:
                chrono.load(json.load(f))
    sync("init")

    evaluators = build_evaluators(config, model, mesh, note) if config.get("evals") else []
    evaluated = {}  # evaluator name -> the step it last ran at

    def run_evals(step: int, final: bool = False) -> None:
        for name, evaluator, log_steps, prefix in evaluators:
            if evaluated.get(name) == step or not (final or _should(step, log_steps,
                                                                    total_steps)):
                continue
            if writer.step != step:
                writer.step_start(step)
            t0 = time.monotonic()
            for metric, value in evaluator.run({"model": model, "step": step}):
                writer.measure(f"{prefix}{metric}", value)
            writer.measure(f"z/secs/eval/{name}", time.monotonic() - t0)
            evaluated[name] = step

    if config.get("eval_only", False):
        writer.step_start(first_step)
        run_evals(first_step, final=True)
        writer.close()
        return model, opt, {}

    update_fn = step_mod.make_update_fn(config, model, opt)
    log_every = config.get("log_training_steps", 50)
    ckpt_every = config.get("ckpt_steps", 1000) if config.get("save_ckpt", True) else 0
    keep = config.get("keep_ckpt", 1)
    measurements = {}
    model.train()
    for step in range(first_step + 1, total_steps + 1):
        t0 = time.perf_counter()
        batch = next(loader)
        t_data = time.perf_counter() - t0
        if step == first_step + 1:
            check_token_range(config, batch)
        measurements = update_fn(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        chrono.step_done(time.perf_counter() - t0, t_data)
        if _should(step, log_every, total_steps):
            writer.step_start(step)
            for name, value in measurements.items():
                writer.measure(name, value)
            for name, n in kernels.LAUNCHES.items():  # this process's, since it started
                if n:
                    writer.measure(f"launches/{name}", n)
            chrono.tick(step, writer.measure)
            note(f"step {step}/{total_steps} loss={float(measurements['training_loss']):.4f}")
        if ckpt_dir and _should(step, ckpt_every, total_steps):
            ckpt_lib.save_train_state(ckpt_dir, step, model, opt, loader.get_state(), keep)
            if main:
                with open(chrono_path, "w") as f:
                    json.dump(chrono.save(), f)
            sync("checkpoint")
        run_evals(step)
    sync("final")
    run_evals(total_steps, final=True)
    writer.close()
    return model, opt, {k: float(v) for k, v in measurements.items()}
