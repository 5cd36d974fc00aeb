"""The training loop: config -> data -> model -> state -> steps.

Counterpart of ``openvision_tpu/train/trainer.py:train`` (:180-506): the
input pipeline (``data/pipeline.py``), the model and optimizer from the
config's seed (``train/step.py``), the init decision chain (resume from the
workdir's own newest checkpoint, with the data position it was saved at;
else ``ft_from``: a flat-name npz, a JAX param tree or the port's own train
state, or an Orbax or legacy tensorstore directory of a JAX run; else the
fresh init), then the loop: one update per batch,
measurements, :class:`~openvision_tpu_torch.train.chrono.Chrono` timing,
the process's peak device memory (``peak_gb``) and its CUDA kernel launch
counts so far (``launches/<kernel>``)
written every ``log_training_steps``, the train state every ``ckpt_steps``
and at the end (``train/checkpoint.py``). The first batch's token ids are
checked against the vocabulary sizes (:45-79).

``load_transform`` and ``masked_init`` merge as ``utils/tree.py:merge_params``
(:93): every parameter from the checkpoint but those whose JAX name
(``convert/openclip.py:flax_paths``) fullmatches a ``dont_load`` regex,
which keep their init; any other name in one and not the other raises.

The loop's options (:354-490): ``steps_per_dispatch`` k > 1 runs chunks of
k updates issued back to back with one device synchronize at the chunk's
end, a chunk never running past a step with a log, checkpoint, eval or
profiler event (it may end on one), and chunks of 1 once SIGTERM is seen;
the parameters are those of k = 1. ``profile_start_step`` /
``profile_stop_step`` trace steps [start, stop] with ``torch.profiler``
into ``workdir/profile/trace-<start>-<stop>.json`` (process 0). SIGTERM
sets a flag that the loop reads at each chunk's end: it writes the
checkpoint of that step and returns, so the process exits 0 and the next
run resumes on the next batch; on a process mesh the processes' flags are
summed by one all-reduce a chunk, so every process stops at the same step
(a signal to one process alone stops them all), and the chunks there do not
shorten on one process's flag.

Evaluators (:137, :332-346, :494-504): ``config.evals`` builds them
(``evaluators/common.py:from_config``; one whose data or options are
unavailable is noted and left out), each runs every ``log_steps`` and at the
end (once at the last step, where the JAX loop runs it twice), writing
``{prefix}{metric}`` and ``z/secs/eval/{name}`` into that step's row;
``eval_only`` runs them once at the starting step (the resumed or
fine-tuned weights) and trains nothing. On a process mesh every process
runs every evaluator, in lockstep (JAX :342-344: the classes and the images
split over the batch shards, ``evaluators/disclf.py``), and process 0
writes the metrics. The chronometer times each step
alone, from its batch request to its synchronize, so an eval between steps
never enters its rates (the JAX trainer pauses its wall-clock chronometer
around an eval for the same end).

Each step ends in a device synchronize, so its host time covers its device
work and the chronometer's host-wait share is the input pipeline's part.

Several processes (``torchrun``, one per rank): ``maybe_distributed_init``
(``parallel/mesh.py``; JAX :82) joins the process group of torchrun's
environment and gives each process its device, the config's
``sharding.mesh`` (data, fsdp, tensor, seq, pipe) becomes the process mesh, active for
the whole run, each process loads its (data, fsdp) rows of every batch, the
model and optimizer are placed by ``train/step.py``, ``sync`` (JAX :90) is a
barrier at the run's named points, and process 0 alone writes the metrics,
the chronometer and the checkpoints (JAX :194, :228, :385), which save the
whole state (every seq and pipe rank holds every parameter). The first
note names the mesh.
"""

from __future__ import annotations

import json
import os
import re
import signal
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


def install_preemption_flag() -> dict:
    """A flag that SIGTERM sets (JAX :156-178), and the handler it replaced
    (``"previous"``, for :func:`restore_signal`); off the main thread, where
    no handler can be installed, a flag that nothing sets."""
    flag = {"hit": False, "previous": None}

    def handler(signum, frame):
        flag["hit"] = True

    try:
        flag["previous"] = signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass
    return flag


def restore_signal(flag: dict) -> None:
    if flag["previous"] is not None:
        signal.signal(signal.SIGTERM, flag["previous"])


def merge_params(loaded: dict, inited: dict, dont_load=()) -> dict:
    """`inited` (a port state dict) with each value taken from `loaded`, but
    for the names whose JAX names fullmatch a `dont_load` regex, which keep
    their init (``utils/tree.py:merge_params``); a name in one dict and not
    the other, and not dont_load'ed, raises."""
    from openvision_tpu_torch.convert.openclip import flax_paths

    pats = [re.compile(p) for p in ([dont_load] if isinstance(dont_load, str) else dont_load)]

    def keep_init(name: str) -> bool:
        try:
            paths = flax_paths(name)
        except KeyError:
            paths = [name]
        hits = {any(p.fullmatch(path) for p in pats) for path in paths}
        if len(hits) > 1:
            raise ValueError(f"dont_load matches some but not all of {paths} ({name})")
        return hits.pop()

    missing = sorted(k for k in inited.keys() - loaded.keys() if not keep_init(k))
    extra = sorted(k for k in loaded.keys() - inited.keys() if not keep_init(k))
    if missing or extra:
        raise ValueError("Checkpoint/model mismatch.\n"
                         f"  In model but not checkpoint (and not dont_load'ed): {missing}\n"
                         f"  In checkpoint but not model (and not dont_load'ed): {extra}")
    return {k: (torch.as_tensor(loaded[k]) if k in loaded and not keep_init(k) else v)
            for k, v in inited.items()}


def transform_geometry(loaded: dict, inited: dict) -> dict:
    """`loaded` with its patch kernel resized and its learned image position
    embedding resampled to the shapes of `inited` (JAX :103-125)."""
    from openvision_tpu_torch.models.vit import resample_posemb, resize_patch_kernel

    loaded = dict(loaded)
    k = "visual.conv1.weight"
    if k in loaded and k in inited and tuple(loaded[k].shape) != tuple(inited[k].shape):
        loaded[k] = resize_patch_kernel(torch.as_tensor(loaded[k]), inited[k].shape[2:])
    k = "visual.positional_embedding"
    if k in loaded and k in inited:
        loaded[k] = resample_posemb(torch.as_tensor(loaded[k]), inited[k].shape[0])
    return loaded


def initial_params(config: dict, model, note) -> Optional[dict]:
    """The state dict a fresh run starts from: ``ft_from``, else
    ``load_transform``, else ``masked_init`` (each an npz, an Orbax
    directory's newest step or a legacy tensorstore directory), else None
    (the seed's init)."""
    from openvision_tpu_torch.models.init import init_params

    if config.get("ft_from"):
        note(f"finetuning from {config['ft_from']}")
        return ckpt_lib.load_state_dict(config["ft_from"])
    for key in ("load_transform", "masked_init"):
        if config.get(key):
            note(f"{key} from {config[key]}")
            loaded = ckpt_lib.load_state_dict(config[key])
            inited = {k: v.detach().clone() for k, v in
                      init_params(model, config.get("seed", 0)).state_dict().items()}
            if key == "load_transform":
                loaded = transform_geometry(loaded, inited)
            return merge_params(loaded, inited, config.get("dont_load", ()))
    return None


def build_evaluators(config: dict, model, mesh, note=print) -> list:
    """[(name, evaluator, log_steps, prefix)] of config.evals; an evaluator
    that fails to build is noted and left out (JAX :137)."""
    from openvision_tpu_torch.evaluators import common as eval_common

    def on_error(name, e):
        note(f"evaluator {name!r} disabled: {e}")

    return eval_common.from_config(config, model, mesh, on_error=on_error)


def start_profiler(device):
    """A running torch.profiler over the host and, on a card, CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, directory: str, start: int, stop: int) -> str:
    """Stops `profiler` and writes its Chrome trace; returns the path."""
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{start}-{stop}.json")
    profiler.export_chrome_trace(path)
    return path


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
    device = maybe_distributed_init(device)
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
    with torch.device(device):  # its zero parameters allocated on the device, not the host
        model = step_mod.build_model(config).to(device)
    params = None if saved else initial_params(config, model, note)
    sizes = {n: p.numel() for n, p in model.named_parameters()}  # whole, before placement
    opt = step_mod.init_train_state(
        config, model, total_steps=total_steps, data_size=ntrain, mesh=mesh,
        params=None if params is None else {k: v.to(device) for k, v in params.items()})
    writer.measure("num_params", sum(sizes.values()))
    note(f"{sum(sizes.values()) / 1e6:.1f}M params")

    first_step = 0
    if saved:
        kind = {"orbax": "an Orbax step directory",
                "npz": "the port's npz"}[ckpt_lib.step_format(ckpt_dir, saved[-1])]
        note(f"resuming from step {saved[-1]} ({kind})")
        t0 = time.perf_counter()
        position, source = ckpt_lib.restore_train_state(ckpt_dir, saved[-1], model, opt)
        note(f"restored step {saved[-1]}: {ckpt_lib.step_bytes(ckpt_dir, saved[-1])} bytes in "
             f"{time.perf_counter() - t0:.3f} s")
        first_step = opt.state["count"]  # the optimizer's count, as JAX's get_count
        if position is None:
            note(f"no data-iterator state for this step ({source}): data restarts")
        else:
            loader.position = position
            note(f"resuming data at position {position} ({source})")
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
            for metric, value in evaluator.run({"model": model, "opt": opt, "step": step}):
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
    k_dispatch = int(config.get("steps_per_dispatch", 1) or 1)
    prof_start = config.get("profile_start_step", 0)
    prof_stop = config.get("profile_stop_step", 0)
    profiling = bool(workdir and prof_stop and main)
    profiler = None
    preempt = install_preemption_flag()
    world = dist.get_world_size() if dist.is_initialized() else 1

    def has_event(s: int) -> bool:
        """A step no chunk may run past (JAX :397-409)."""
        return (_should(s, log_every, total_steps) or bool(ckpt_dir and _should(s, ckpt_every,
                                                                                 total_steps))
                or any(_should(s, ls, total_steps) for _, _, ls, _ in evaluators)
                or bool(prof_stop and (s == prof_stop or s + 1 == prof_start)))

    def preempted() -> bool:
        hit = torch.tensor(float(preempt["hit"]))
        if world > 1:  # every process stops at the same step
            hit = hit.to(device)
            dist.all_reduce(hit)  # the count of processes that saw SIGTERM
        return bool(hit.item())

    def save(step: int) -> None:
        saved = ckpt_lib.save_train_state(ckpt_dir, step, model, opt, loader.get_state(), keep)
        if saved:
            note(f"checkpoint of step {step}: {saved['bytes']} bytes in "
                 f"{saved['seconds']:.3f} s ({saved['bytes'] / saved['seconds'] / 1e9:.3f} GB/s)")
        if main:
            with open(chrono_path, "w") as f:
                json.dump(chrono.save(), f)
        sync("checkpoint")

    measurements = {}
    model.train()
    step = first_step
    try:
        while step < total_steps:
            s0 = step + 1
            chunk = 1
            # on a mesh the chunks never follow one process's flag: every process must
            # reach the agreement's all-reduce after the same steps
            if (k_dispatch > 1 and not (preempt["hit"] and world == 1)
                    and s0 + k_dispatch - 1 <= total_steps
                    and not any(has_event(s) for s in range(s0, s0 + k_dispatch - 1))):
                chunk = k_dispatch
            step = s0 + chunk - 1
            if profiling and s0 == prof_start:
                profiler = start_profiler(device)
            t0 = time.perf_counter()
            t_data = 0.0
            for s in range(s0, step + 1):  # k updates, no host sync between them
                t1 = time.perf_counter()
                batch = next(loader)
                t_data += time.perf_counter() - t1
                if s == first_step + 1:
                    check_token_range(config, batch)
                measurements = update_fn(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            chrono.step_done(time.perf_counter() - t0, t_data, chunk)
            if profiler is not None and step >= prof_stop:
                stop_profiler(profiler, os.path.join(workdir, "profile"), prof_start, prof_stop)
                profiler = None
            if _should(step, log_every, total_steps):
                writer.step_start(step)
                for name, value in measurements.items():
                    writer.measure(name, value)
                for name, n in kernels.LAUNCHES.items():  # this process's, since it started
                    if n:
                        writer.measure(f"launches/{name}", n)
                if device.type == "cuda":
                    writer.measure("peak_gb", torch.cuda.max_memory_allocated(device) / 1e9)
                chrono.tick(step, writer.measure)
                note(f"step {step}/{total_steps} loss={float(measurements['training_loss']):.4f}")
            if ckpt_dir and _should(step, ckpt_every, total_steps):
                save(step)
            if preempted():
                note(f"preemption signal at step {step}: checkpointing and exiting")
                if ckpt_dir and not _should(step, ckpt_every, total_steps):
                    save(step)
                writer.close()
                return model, opt, {k: float(v) for k, v in measurements.items()}
            run_evals(step)
    finally:
        if profiler is not None:
            profiler.stop()
        restore_signal(preempt)
        loader.close()
    sync("final")
    run_evals(total_steps, final=True)
    writer.close()
    return model, opt, {k: float(v) for k, v in measurements.items()}
