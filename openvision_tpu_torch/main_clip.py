"""Train OpenVision / CoCa with the PyTorch port.

    python -m openvision_tpu_torch.main_clip \
        --config openvision_tpu_torch/configs/openvision.py:res=224,img=L/14,dtype=bfloat16 \
        --workdir /tmp/run1 [--override input.batch_size=64 ...] [--device cuda|cpu]

Counterpart of the JAX package's ``main_clip`` / ``train/trainer.py:main``
(:509-537): the config file is loaded from its path with the ``:arg``
string after it, each ``--override a.b.c=value`` sets one dotted key (the
value parsed as int, float, bool, or else kept as a string), and
``train/trainer.py:train`` runs. ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the plain versions of the kernels.

Scoring a checkpoint: ``--override eval_only=True`` runs the config's
evaluators once and trains nothing, on the workdir's newest checkpoint or
on ``ft_from`` (a flat-name npz: the port's train state or a JAX param
tree; or a JAX run's Orbax or legacy tensorstore directory), each
evaluator's data named by an override, e.g. a TFRecord directory written by
``python -m openvision_tpu_torch.data.prepare``:

    python -m openvision_tpu_torch.main_clip --config ...:res=224,img=L/14,dtype=bfloat16 \
        --workdir /tmp/eval --override eval_only=True --override ft_from=/ckpt.npz \
        --override evals.disclf.data_dir=/data/in1k_val_tfrecord \
        --override evals.retrieval.data_dir=/data/coco_val.npz

Several processes, one per rank of the config's ``sharding.mesh``
(``data_parallelism``, ``fsdp_parallelism``, ``tensor_parallelism``,
``seq_parallelism`` (with ``attn_impl=ring``), ``pipe_parallelism`` in the
config arg, or ``--override sharding.mesh.tensor=2``), come from torchrun:

    python -m torch.distributed.run --nproc_per_node 2 -m openvision_tpu_torch.main_clip \
        --config openvision_tpu_torch/configs/openvision.py:...,tensor_parallelism=2 ...

Each process takes ``cuda:{LOCAL_RANK % device_count}``; the processes talk
over NCCL when each has a GPU of its own, over gloo when they share one or
run on the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import importlib.util

from openvision_tpu_torch.configs.common import _autocast


def load_config(spec: str) -> dict:
    """`path/to/config.py[:arg]` -> the dict its get_config(arg) returns."""
    path, _, arg = spec.partition(":")
    mod_spec = importlib.util.spec_from_file_location("run_config", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.get_config(arg or None)


def apply_override(config: dict, override: str) -> None:
    """Sets `a.b.c=value` in the nested config; a number steps into a list
    or tuple (``schedule.0.1.warmup_steps=1``)."""
    key, _, val = override.partition("=")
    *parents, leaf = key.split(".")
    node = config
    for p in parents:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    node[leaf] = _autocast(val)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True, help="path/to/config.py[:arg1=val,flag]")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--override", action="append", default=[],
                        help="dotted config overrides: a.b.c=value")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    for ov in args.override:
        apply_override(config, ov)
    from openvision_tpu_torch.train.trainer import train

    return train(config, args.workdir, device=args.device)


if __name__ == "__main__":
    main()
