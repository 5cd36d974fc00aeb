"""Ring attention over ``seq`` and the ``ring`` route, against the JAX package.

The multi-process cases run in the gloo world of four processes that this
file shares with ``tests/test_torch_pipeline.py``
(``tests/torch_seq_pipe_worker.py``, started once a session with
torchrun's environment, one torch thread each, 150 s). While it runs, this
process computes the JAX side on the 8-device virtual CPU mesh. Checks
and tolerances (JAX's own, ``tests/test_ring_attention.py`` and
``tests/test_ring_wiring.py``):

- ``ring_attention_whole`` (the per-chunk ``ring_attention_sharded``
  between a scatter and a gather) on (seq 4) and (data 2, seq 2), causal and
  not, at L = 10 (padded to 12 on the ring of 4), against JAX's
  ``ring_attention_sharded``: the output within 1e-5, the gradients of
  sum(out**2) with respect to q, k and v within 1e-4 absolute and 1e-3
  relative; every seq rank holds the same bits;
- the mu/16 ViT (17 tokens, padded to 18) and the causal Ti text tower on
  ``ring`` over (data 2, seq 2), the JAX towers' weights carried over by
  the port's converter, against JAX's ``xla`` towers: the output within
  1e-5, every parameter gradient within 1e-4 / 1e-3;
- one CoCa gradient of ``tests/test_pipeline_wired.py``'s config at
  ``seq_parallelism=2, attn_impl=ring`` beside data 2, beside tensor 2
  (the heads sharded inside the ring), and beside data 2 with GradCache
  (accum 2) in the global contrastive mode, against the port's one process
  on the whole batch: loss within 1e-5 relative, every gradient
  within 1e-5 of its norm; after an update every process holds the same
  parameters, and the draws are equal within each seq group;
- inside a ``ring`` stack over (data 2, seq 2) each block takes this
  rank's (B, ceil(L / 2), D) tokens (a forward hook), and a stack with
  dropout and drop-path in training gives the output and gradients of the
  same stack at seq 1 on the process's rows (its draws) within f32
  rounding;
- without a world: ``ring`` with no mesh, or a mesh whose seq is 1, equals
  ``xla``; a mask, a prefix-LM mask or attention dropout under seq > 1
  raises by name (JAX drops them without a word).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvision_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from openvision_tpu.parallel import create_mesh
from openvision_tpu_torch import parallel
from openvision_tpu_torch.models import vit as tvit
from openvision_tpu_torch.ops.attention import dispatch_attention, xla_attention

sys.path.insert(0, os.path.dirname(__file__))
import torch_seq_pipe_worker as worker  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-3)
RING_CASES = [f"{m}_{c}" for m in worker.RING_MESHES for c in ("full", "causal")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(kw: dict):
    devices = jax.devices()
    n = int(np.prod(list(kw.values())))
    if n < len(devices) and "data" not in kw:
        kw = dict(kw, data=len(devices) // n)  # the rest of the 8 devices over data
        n = len(devices)
    return create_mesh(**kw, devices=devices[:n])


def _grads_by_name(grads, key: str, prefix: str) -> dict:
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    return {k.removeprefix(prefix): np.asarray(v)
            for k, v in jax_params_to_state_dict({key: grads}).items()}


def _jax_refs(models):
    out = {}
    q, k, v = (jnp.asarray(a) for a in worker.ring_inputs())
    for name, kw in worker.RING_MESHES.items():
        mesh = _jax_mesh(kw)
        for causal in (False, True):
            def f(q, k, v, causal=causal, mesh=mesh):
                return jax_ring(q, k, v, mesh, seq_axis="seq", causal=causal)

            tag = f"{name}_{'causal' if causal else 'full'}"
            out[f"{tag}/out"] = np.asarray(jax.jit(f)(q, k, v))
            grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
            for label, g in zip(("dq", "dk", "dv"), grads):
                out[f"{tag}/{label}"] = np.asarray(g)
    for name, x, key, prefix in (("vit", worker.vit_images(), "img", "visual."),
                                 ("text", worker.text_tokens().astype(np.int32), "txt", "text.")):
        module, params, _ = models[name]

        def loss(p, x, module=module):
            return jnp.sum(module.apply({"params": p}, x) ** 2)

        out[f"{name}/out"] = np.asarray(jax.jit(module.apply)({"params": params}, x))
        grads = jax.jit(jax.grad(loss))(params, x)
        out.update({f"{name}/grad/{n}": g
                    for n, g in _grads_by_name(grads, key, prefix).items()})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.world_fixture(tmp_path_factory, _jax_refs)


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_attention_matches_jax(world, case):
    out, refs, _ = world
    got = worker.arrays(out, "ring")
    np.testing.assert_allclose(got[f"{case}/out"], refs[f"{case}/out"], **FWD)
    for label in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[f"{case}/{label}"], refs[f"{case}/{label}"], **GRAD)
    assert worker.errors(out, "ring")["seq_equal"][case] == 1


@pytest.mark.parametrize("tower", ["vit", "text"])
def test_ring_towers_match_jax_xla(world, tower):
    out, refs, _ = world
    got = worker.arrays(out, "towers")
    np.testing.assert_allclose(got[f"{tower}/out"], refs[f"{tower}/out"], **FWD)
    names = sorted(k for k in refs if k.startswith(f"{tower}/grad/"))
    assert names and names == sorted(k for k in got if k.startswith(f"{tower}/grad/"))
    for n in names:
        np.testing.assert_allclose(got[n], refs[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("mesh", ["data2_seq2", "tensor2_seq2", "data2_seq2_gradcache"])
def test_ring_train_step_matches_one_process(world, mesh):
    e = worker.errors(world[0], "train_steps")[mesh]
    assert e["leaves"] == e["want_leaves"] and e["pipelined"] == [], e
    assert e["loss"] < 1e-5 and e["grad"] < 1e-5, e
    assert e["params_equal"] == 1 and e["draws_equal"] == 1, e


@pytest.mark.parametrize("tower,length", [("vit", 17), ("text", worker.TEXT_LEN)])
def test_ring_stack_keeps_its_tokens_sharded_over_seq(world, tower, length):
    """Inside a ``ring`` stack at (data 2, seq 2) every block takes this
    rank's (B, ceil(L / 2), D) tokens (a forward hook on each block), the
    stack records it, and the pool sees whole tokens again."""
    e = worker.errors(world[0], "towers")[tower]
    width = {"vit": tvit.decode_variant(worker.VIT["variant"])["width"], "text": 192}[tower]
    assert e["seq_sharded"] == 1
    assert e["blocks"] and all(b == [4, -(-length // 2), width] for b in e["blocks"]), e
    assert e["out"] == [4, worker.VIT["num_classes"]], e


def test_ring_stack_dropout_draws_what_one_process_draws(world):
    """Dropout and drop-path in training on a ``ring`` stack over (data 2,
    seq 2), L = 7 padded to 8: the output and the input's and every
    parameter's gradient (the blocks' summed over seq) equal those of the
    same stack on the process's rows at seq 1, within f32 rounding."""
    e = worker.errors(world[0], "dropout_stack")
    assert e["sharded"] == 1 and e["ref_sharded"] == 0 and e["draws"] > 0.05, e
    assert e["out"] < FWD["atol"] and e["dx"] < GRAD["atol"] and e["grad"] < GRAD["atol"], e


def _vit(impl):
    return tvit.Model(image_size=48, attn_impl=impl, **worker.VIT)


def test_ring_without_seq_axis_falls_back():
    torch.manual_seed(0)
    ring, xla = _vit("ring"), _vit("xla")
    for p in ring.parameters():
        torch.nn.init.normal_(p, std=0.05)
    xla.load_state_dict(ring.state_dict())
    img = torch.from_numpy(worker.vit_images()[:2, :48, :48])
    with torch.no_grad():
        want = xla(img)
        torch.testing.assert_close(ring(img), want, **FWD)  # no active mesh
        one = parallel.Mesh(dict(data=1, fsdp=1, tensor=1, seq=1, pipe=1),
                            dict.fromkeys(parallel.MESH_AXES, 0))
        with parallel.use_mesh(one):
            torch.testing.assert_close(ring(img), want, **FWD)


@pytest.mark.parametrize("what", ["mask", "prefix", "dropout"])
def test_ring_refuses_what_it_cannot_honour_over_seq(what):
    q = torch.randn(2, 6, 2, 8)
    kw = {"mask": dict(mask=torch.ones(2, 1, 6, 6, dtype=torch.bool)),
          "prefix": dict(causal=True, prefix_len=2),
          "dropout": dict(dropout_rate=0.1, dropout_gen=torch.Generator())}[what]
    assert dispatch_attention("ring", q, q, q, **kw).shape == q.shape  # xla without seq
    seq2 = parallel.Mesh(dict(data=1, fsdp=1, tensor=1, seq=2, pipe=1),
                         dict.fromkeys(parallel.MESH_AXES, 0))
    with parallel.use_mesh(seq2), pytest.raises(NotImplementedError, match="'ring' over seq=2"):
        dispatch_attention("ring", q, q, q, **kw)


def test_ring_with_no_group_is_plain_attention():
    from openvision_tpu_torch.ops.ring_attention import ring_attention

    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 7, 2, 8)).astype(np.float32))
               for _ in range(3))
    for causal in (False, True):
        torch.testing.assert_close(ring_attention(q, k, v, group=None, causal=causal),
                                   xla_attention(q, k, v, causal=causal), **FWD)
