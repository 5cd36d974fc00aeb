"""Tensor- and data-parallel training across processes, against JAX and one process.

One world of four gloo processes on the CPU (``tests/torch_tp_worker.py``,
started with torchrun's environment variables) runs every check once; the
tests below read what its process 0 wrote. While it runs, this process
computes the JAX package's tensor-parallel block, ``fused_mhsa_block`` under
``create_mesh(data=2, fsdp=2, tensor=2)`` on the 8-device virtual CPU mesh
(its Pallas kernels ``_block_partial_kernel`` and
``_block_partial_bwd_kernel`` in interpret mode), value and grads, and holds
the port's result, gathered to process 0 from a (data 2, tensor 2) mesh and
with the prefix-LM mask from a (fsdp 2, tensor 2) mesh, against it.

The port's own checks follow the JAX package's tests/test_fused_tp.py and
hold the multi-process result against the port's one-process result (which
tests/test_torch_grads.py and tests/test_torch_tp_kernels.py hold against
JAX). Tolerances:

- against JAX: those of tests/test_fused_tp.py (values atol = rtol = 1e-5,
  grads 5e-5), f32 on both sides;
- against one process: 1e-5 relative to the largest value for values and
  loss, 5e-5 for gradients (f32 sums over the shards and over the batch
  shards in another order); the key bias's gradient is zero in exact
  arithmetic, so it is held relative to the query bias's largest gradient;
- the fused_t degrade: tests/test_fused_tp.py's 1e-4 (value) and 2e-4
  (grads), relative to the largest value;
- the tiny CoCa step on a (fsdp 2, tensor 2) mesh with FSDP2: loss rtol
  1e-5, grads atol 1e-5 / rtol 1e-3, the key bias skipped, as
  test_fused_coca_train_step_tp_matches_xla.

The world gets 150 s: a hung rendezvous fails these tests, not the suite.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openvision_tpu.ops.fused_attention import fused_mhsa_block as jblock
from openvision_tpu.parallel import batch_sharding, create_mesh, use_mesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_tp_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_block(causal, prefix):
    """(out, grads of sum(out**2) w.r.t. x and every parameter) of the JAX
    package's block under a (2, 2, 2) mesh: its tensor-parallel path."""
    x, p = worker.block_inputs()
    x, p = jnp.asarray(x), tuple(jnp.asarray(a) for a in p)

    def block(x, p):
        return jblock(x, *p, num_heads=worker.HEADS, causal=causal, prefix_len=prefix,
                      interpret=True)

    def loss(x, p):
        return jnp.sum(block(x, p) ** 2)

    mesh = create_mesh(data=2, fsdp=2, tensor=2)
    xs = jax.device_put(x, batch_sharding(mesh))
    with use_mesh(mesh):
        out = jax.jit(block)(xs, p)
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(xs, p)
    return np.asarray(out), [np.asarray(g) for g in (gx, *gp)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the four processes, computes the JAX references meanwhile,
    and returns (out_dir, {mode: JAX result})."""
    out = str(tmp_path_factory.mktemp("tp_world"))
    env = {**os.environ, "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(4):
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"), out],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        refs = {"block": _jax_block(False, 0), "block_prefix": _jax_block(True, 7)}
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world did not finish in {WORLD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        logs = "".join(open(os.path.join(out, f"rank{r}.log")).read()[-3000:] for r in range(4))
        pytest.fail(f"a process of the world failed: {[p.returncode for p in procs]}\n{logs}")
    return out, refs


def _errors(world, name):
    with open(os.path.join(world[0], f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["block", "block_prefix"])
def test_tp_block_matches_jax_tp(world, name):
    """The port's TP block across processes against JAX
    fused_mhsa_block_tp on create_mesh(data=2, fsdp=2, tensor=2)."""
    got = np.load(os.path.join(world[0], f"{name}.npz"))
    out, grads = world[1][name]
    np.testing.assert_allclose(got["out"], out, atol=1e-5, rtol=1e-5)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(got[f"g{i}"], g, atol=5e-5, rtol=5e-5, err_msg=str(i))


def test_tp_block_matches_unsharded(world):
    e = _errors(world, "block")
    assert e["out"] <= 1e-5, e


def test_tp_block_grads_match_unsharded(world):
    e = _errors(world, "block")
    assert all(e[k] <= 5e-5 for k in e if k.startswith("d")), e


def test_tp_block_prefix_lm_matches_unsharded(world):
    e = _errors(world, "block_prefix")
    assert e["out"] <= 1e-5 and all(e[k] <= 5e-5 for k in e if k.startswith("d")), e


def test_tp_qkv_matches_unsharded(world):
    e = _errors(world, "tp_qkv")
    assert e["out"] <= 1e-5 and all(e[k] <= 5e-5 for k in e if k.startswith("d")), e


def test_tp_heads_indivisible_falls_back(world):
    """3 heads on tensor 2: the attention stays whole (batch-sharded), the
    MLP is sharded, and the stack equals the one-process stack."""
    e = _errors(world, "indivisible")
    assert e["sharded_attention"] == 0 and e["sharded_mlp"] == 1 and e["plan_is_rule"] == 1
    assert e["out"] <= 1e-5 and all(e[k] <= 5e-5 for k in e if k.startswith("d")), e


def test_fused_t_under_tensor_parallel_degrades_to_tp_fused(world):
    e = _errors(world, "fused_t")
    assert e["sharded_attention"] == 1 and e["sharded_mlp"] == 1
    assert e["out"] <= 1e-4 and all(e[k] <= 2e-4 for k in e if k.startswith("d")), e
    messages = _errors(world, "fused_t_warning")["messages"]
    assert any("fused_t is batch-sharded only" in m for m in messages), messages


def test_fused_coca_train_step_tp_matches_one_process(world):
    e = _errors(world, "coca")
    assert e["fsdp_chunked"] > 0 and e["tensor_sharded"] > 0, e
    assert e["loss"] <= 1e-5 and e["grad_excess"] <= 0.0, e


def test_sharded_global_norm_matches_unsharded(world):
    e = _errors(world, "coca")
    assert e["norm"] <= 1e-5, e


def test_local_contrastive_loss_matches_global(world):
    e = _errors(world, "contrastive")
    assert e["loss"] <= 1e-5 and all(e[k] <= 5e-5 for k in e if k.startswith("d")), e


def test_main_clip_trains_on_a_mesh_and_saves_one_checkpoint(world):
    """main_clip on (fsdp 2, tensor 2) under torchrun's variables: finite
    losses, process 0's one checkpoint, bit-equal to the gathered params,
    loadable into a one-process model and by the caption tool."""
    e = _errors(world, "trainer")
    assert len(e["losses"]) == 2 and np.isfinite(e["losses"]).all(), e
    assert e["checkpoints"] == [2] and e["equal"] == 1 and e["count"] == 2, e
    assert e["caption_ids"] == [2, 12], e  # the caption tool loads it
    assert e["files"] == ["checkpoints", "chrono.json", "config.json", "metrics.jsonl"], e


@pytest.mark.parametrize("size", [2, 4])
def test_shard_state_dict_round_trip_is_bit_exact(size):
    """JAX params (numpy) -> the port's state dict -> every rank's shard ->
    joined -> JAX params again, bit for bit."""
    from openvision_tpu_torch.convert.openclip import (
        jax_params_to_state_dict, shard_state_dict, state_dict_to_jax_params,
        tree_flatten_with_names, unshard_state_dict)
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.train.step import build_model, tensor_plan

    model = init_params(build_model(worker.coca_config()), 3)
    heads = dict(num_heads_vision=2, num_heads_text=3, num_heads_decoder=3)
    params = state_dict_to_jax_params({k: v.numpy() for k, v in model.state_dict().items()},
                                      **heads)
    sd = jax_params_to_state_dict(params)
    plan = tensor_plan(model, size)
    assert plan and set(plan) <= set(sd)
    parts = [shard_state_dict(sd, plan, rank=r, size=size) for r in range(size)]
    for name, kind in plan.items():
        assert parts[0][name].shape[0 if kind != "cols" else 1] * size == \
            sd[name].shape[0 if kind != "cols" else 1]
    back = state_dict_to_jax_params({k: v.numpy() for k, v in unshard_state_dict(
        parts, plan).items()}, **heads)
    want, got = tree_flatten_with_names(params), tree_flatten_with_names(back)
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(np.asarray(want[k]), np.asarray(got[k])), k
