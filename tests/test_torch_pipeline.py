"""Pipeline parallelism over ``pipe``, against the JAX package.

The multi-process cases run in the gloo world of four processes that this
file shares with ``tests/test_torch_ring_attention.py``
(``tests/torch_seq_pipe_worker.py``, started once a session with
torchrun's environment, one torch thread each, 150 s). While it runs, this
process computes the JAX side on the 8-device virtual CPU mesh. Checks
and tolerances (JAX's own, ``tests/test_pipeline_parallel.py`` and
``tests/test_pipeline_wired.py``):

- ``pipeline_apply`` on ``tests/test_pipeline_parallel.py``'s block (DEPTH
  8, D 16) against JAX's ``pipeline_apply`` at (pipe 4, m 4, v 1), (data
  2, pipe 2, m 8, v 2), (pipe 4, m 6, v 2: a partial last wave) and (data
  2, pipe 2, m 3, v 4: c = 1): within 1e-5; every pipe rank holds the
  same bits;
- its layers' gradients (summed over pipe) and its input's gradient on
  (pipe 4), v = 1 and 2, within 1e-4 of JAX's;
- a real ``Encoder`` (xla blocks, depth 4) pipelined on (data 2, pipe 2)
  against JAX's ``Encoder``: outputs within 1e-5, parameter and input
  gradients within 1e-5 absolute and 1e-4 relative; one row a process
  runs too (a microbatch of one);
- one CoCa gradient of ``tests/test_pipeline_wired.py``'s config at
  ``pipe_parallelism=2`` beside data 2, beside fsdp 2 (FSDP2's chunks
  inside the stages), and beside data 2 with GradCache (accum 2) in the
  global contrastive mode, against the port's one process on the whole
  batch: loss within 1e-5 relative, every gradient within 1e-5 of its
  norm; every stack ran the pipeline; after an update every process holds
  the same parameters, and the draws are equal within each pipe group;
- ``main_clip`` for 2 steps at ``pipe_parallelism=2``: finite losses, and
  process 0's checkpoint restores at pipe 1 with the parameters every
  process holds;
- without a world: an impl that cannot ride the pipe warns and runs the
  stack in sequence; the layers a stage owns; ``auto`` picks ``xla`` under
  pipe > 1, as JAX's config does.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.pipeline_parallel import pipeline_apply as jax_pipeline
from openvision_tpu.ops.pipeline_parallel import stack_layer_params as jax_stack
from openvision_tpu.parallel import create_mesh
from openvision_tpu_torch import parallel
from openvision_tpu_torch.configs.openvision import get_config
from openvision_tpu_torch.models.encoder import Encoder
from openvision_tpu_torch.ops.pipeline_parallel import pipeline_sharding, stack_layer_params

sys.path.insert(0, os.path.dirname(__file__))
import torch_seq_pipe_worker as worker  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-5)
PIPE_GRAD = dict(atol=1e-4, rtol=1e-4)
ENC_GRAD = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(kw: dict):
    """The JAX mesh of a port mesh: the rest of the 8 devices over data
    where the port's mesh has no data axis."""
    devices = jax.devices()
    if "data" not in kw:
        return create_mesh(data=len(devices) // kw["pipe"], **kw)
    return create_mesh(**kw, devices=devices[:int(np.prod(list(kw.values())))])


def _jax_block(prm, x):
    return x + jnp.tanh(x @ prm["w"] + prm["b"]) @ prm["w2"]


def _jax_refs(models):
    out = {}
    params = {f"encoderblock_{i}": {k: jnp.asarray(a) for k, a in p.items()}
              for i, p in enumerate(worker.pipe_params())}
    stacked = jax_stack(params, worker.DEPTH)
    for label, kw, m, v, b in worker.PIPE_CASES:
        mesh = _jax_mesh(kw)
        x = jnp.asarray(worker.pipe_input(b))
        out[label] = np.asarray(jax.jit(lambda s, x, mesh=mesh, m=m, v=v: jax_pipeline(
            _jax_block, s, x, mesh, num_microbatches=m, interleave=v))(stacked, x))
    mesh = _jax_mesh(dict(pipe=4))
    x = jnp.asarray(worker.pipe_input(8, 4))
    for v in worker.PIPE_GRAD_V:
        def loss(s, x, v=v):
            return jnp.sum(jax_pipeline(_jax_block, s, x, mesh, num_microbatches=4,
                                        interleave=v) ** 2)

        gs, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, x)
        for k, g in gs.items():
            for i in range(worker.DEPTH):
                out[f"grad_v{v}/{i}/{k}"] = np.asarray(g[i])
        out[f"grad_v{v}/x"] = np.asarray(gx)
    module, params, _ = models["encoder"]
    x = jnp.asarray(worker.encoder_input())
    out["enc/out"] = np.asarray(jax.jit(module.apply)({"params": params}, x))
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(module.apply({"params": p}, x) ** 2),
                              argnums=(0, 1)))(params, x)
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    out.update({f"enc/grad/{k.removeprefix('visual.transformer.')}": np.asarray(g)
                for k, g in jax_params_to_state_dict({"img": {"Transformer": gp}}).items()})
    out["enc/dx"] = np.asarray(gx)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.world_fixture(tmp_path_factory, _jax_refs)


@pytest.mark.parametrize("case", [c[0] for c in worker.PIPE_CASES])
def test_pipeline_matches_jax(world, case):
    out, refs, _ = world
    np.testing.assert_allclose(worker.arrays(out, "pipeline")[case], refs[case], **FWD)
    assert worker.errors(out, "pipeline")["pipe_equal"][case] == 1


@pytest.mark.parametrize("v", worker.PIPE_GRAD_V)
def test_pipeline_grads_match_jax(world, v):
    out, refs, _ = world
    got = worker.arrays(out, "pipeline")
    names = sorted(k for k in refs if k.startswith(f"grad_v{v}/"))
    assert len(names) == worker.DEPTH * 3 + 1
    for n in names:
        np.testing.assert_allclose(got[n], refs[n], err_msg=n, **PIPE_GRAD)
    assert worker.errors(out, "pipeline")["pipe_equal"][f"dx_v{v}"] == 1


def test_pipeline_encoder_matches_jax(world):
    out, refs, _ = world
    got = worker.arrays(out, "encoder")
    assert worker.errors(out, "encoder")["pipelined"] == 1
    np.testing.assert_allclose(got["out"], refs["enc/out"], **FWD)
    np.testing.assert_allclose(got["dx"], refs["enc/dx"], **ENC_GRAD)
    names = sorted(k.removeprefix("enc/") for k in refs if k.startswith("enc/grad/"))
    assert names and names == sorted(k for k in got if k.startswith("grad/"))
    for n in names:
        np.testing.assert_allclose(got[n], refs[f"enc/{n}"], err_msg=n, **ENC_GRAD)


def test_pipeline_small_batch_runs(world):
    """One row a process: a pipeline of one microbatch, the stack's rows."""
    out, refs, _ = world
    e = worker.errors(out, "encoder")
    assert e["small_pipelined"] == 1
    small = worker.arrays(out, "encoder")["small"]
    np.testing.assert_allclose(small, refs["enc/out"][:2], **FWD)


@pytest.mark.parametrize("mesh", ["data2_pipe2", "fsdp2_pipe2", "data2_pipe2_gradcache"])
def test_pipeline_train_step_matches_one_process(world, mesh):
    e = worker.errors(world[0], "train_steps")[mesh]
    assert e["leaves"] == e["want_leaves"], e
    assert e["pipelined"] == ["text.transformer", "txt_decoder.transformer",
                              "visual.transformer"], e
    assert e["loss"] < 1e-5 and e["grad"] < 1e-5, e
    assert e["params_equal"] == 1 and e["draws_equal"] == 1, e


def test_pipeline_checkpoint_restores_at_pipe_one(world):
    e = worker.errors(world[0], "trainer")
    assert len(e["losses"]) == 2 and np.isfinite(e["losses"]).all(), e
    assert e["checkpoints"] == [2] and e["count"] == 2, e
    assert e["restored"] == 1 and e["ranks_equal"] == 1, e


def test_pipeline_ineligible_impl_warns():
    mesh = parallel.Mesh(dict(data=1, fsdp=1, tensor=1, seq=1, pipe=4),
                         dict.fromkeys(parallel.MESH_AXES, 0))
    torch.manual_seed(0)
    enc = Encoder(16, 4, 2, 64, attn_impl="fused")
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        want = enc(x)
        with parallel.use_mesh(mesh), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = enc(x)
    assert any("not pipeline-eligible" in str(m.message) for m in w)
    assert not enc.pipelined
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("depth,stages,v", [(8, 4, 1), (8, 4, 2), (8, 2, 4), (12, 3, 2)])
def test_stages_own_each_layer_once(depth, stages, v):
    """Stage p's chunk j: global layers [(j P + p) c, (j P + p + 1) c), as
    JAX's staged params (pipeline_parallel.py:_rearrange) place them."""
    owned = [pipeline_sharding(depth, stages, p, v) for p in range(stages)]
    assert sorted(i for o in owned for i in o) == list(range(depth))
    layers = np.arange(depth).reshape(v, stages, depth // (stages * v)).swapaxes(0, 1)
    for p in range(stages):
        assert owned[p] == layers[p].reshape(-1).tolist()
    assert stack_layer_params({f"encoderblock_{i}": i for i in range(depth)}, depth) == \
        list(range(depth))


def test_config_auto_attn_respects_pipe_parallelism():
    base = "res=224,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8"
    c = get_config(base + ",pipe_parallelism=2")
    assert c["model"]["image"]["attn_impl"] == c["model"]["text"]["attn_impl"] == "xla"
    assert c["model"]["text_decoder_config"]["attn_impl"] == "xla"
    assert c["sharding"]["mesh"]["pipe"] == 2
    c = get_config(base)
    assert c["model"]["image"]["attn_impl"] == "fused"
    assert c["model"]["text_decoder_config"]["attn_impl"] == "fused"
