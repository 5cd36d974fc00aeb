"""The recipe on a process mesh, across processes, against one process and JAX.

One world of four gloo processes on the CPU (``tests/torch_mesh_recipe_worker.py``,
started with torchrun's environment variables, one torch thread each) builds
both meshes, (data 2, tensor 2) and (fsdp 2, tensor 2), and runs every check
once; the tests below read what its process 0 wrote. While it runs, this
process computes the JAX package's SigLIP loss in its ``local`` mode on
``create_mesh(data=2, fsdp=2, tensor=2)`` (the 8-device virtual CPU mesh),
its ``global`` mode and the global contrastive loss, values and embedding
gradients. Checks and tolerances:

- the draws: on each mesh the token-masking and drop-path draws differ
  between the batch shards, are equal within a tensor group and equal, row
  for row, one process's draws on the whole batch; dropout's differ between
  the shards and are equal within a tensor group;
- the vocab axis over tensor (the JAX rules): on (data 2, tensor 2) each
  rank holds half of the token embedding, of the decoder head and of the
  towers' heads, and ``unshard_state_dict`` joins them back bit for bit; a
  vocab that tensor does not divide raises, as JAX refuses it;
- GradCache (coca with masking 0.5 and drop-path 0.1, clip, siglip; accum 2),
  siglip's local mode and the global contrastive mode (accum 1 and 2) on
  both meshes against the port's one process on the whole batch, f32, the
  vocab-axis leaves sharded (the vocab-parallel lookup and caption loss):
  loss within 1e-5 relative, every gradient within 1e-5 of its norm;
- the mesh losses (siglip local and global, the global contrastive mode):
  the shares summed and the gathered embedding gradients against JAX's
  within 1e-5 relative (atol 1e-5 of the largest value), f32 on both sides,
  and against the one-process port within 1e-5 relative;
- disclf (the f32 towers' plain versions, and int8 with static scales
  calibrated on 4 images) with 7 classes over 2 batch shards and 22 images
  (a ragged last batch on each shard), retrieval and the contrastive
  monitor on both meshes against the one-process port evaluator: the class
  matrix within 1e-5, the counts and metrics equal, the int8 scales equal
  to one process's and within every tensor group; retrieval's embeddings
  within 1e-5; the monitor's loss within 1e-5, ncorrect equal;
- ``eval_only`` through ``main_clip`` on a (data 2, tensor 2) mesh writes
  one row whose metrics equal the one-process evaluators' on the same init;
- SIGTERM to process 1 alone after step 1 of a (data 2, tensor 2) GradCache
  run: every process stops at step 1 and one checkpoint is written; the
  rerun resumes on step 2, and its parameters after step 3 are those of an
  uninterrupted run (within 1e-6 of the largest value);
- ``make_for_inference``'s rows and batch counts with and without
  ``shard`` (no world needed: the mesh only names the shard);
- ``load_checkpoint`` of a train state reads its params alone.

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

from openvision_tpu import losses as jlosses
from openvision_tpu.parallel import batch_sharding, create_mesh

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_recipe_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 150
MESHES = ["data2_tensor2", "fsdp2_tensor2"]
CASES = [f"{loss}_accum{accum}_{'local' if local else 'global'}"
         for loss, accum, local, _ in worker.GRAD_CASES]
LOSSES = ["siglip_local", "siglip_global", "contrastive_global"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_losses():
    """{label: (loss, [d zimg, d ztxt1, d ztxt2])} of the JAX package."""
    zimg, z1, z2 = (jnp.asarray(a) for a in worker.embeddings())
    t, b = jnp.float32(10.0), jnp.float32(-5.0)
    mesh = create_mesh(data=2, fsdp=2, tensor=2)
    fns = {"siglip_local": lambda zi, za, zb: jlosses.siglip_loss(zi, za, t, b, mesh=mesh,
                                                                  mode="local")[0],
           "siglip_global": lambda zi, za, zb: jlosses.siglip_loss(zi, za, t, b,
                                                                   mode="global")[0],
           "contrastive_global": lambda zi, za, zb: jlosses.bidirectional_contrastive_loss(
               zi, [za, zb], t, mode="global")[0]}
    args = [jax.device_put(z, batch_sharding(mesh)) for z in (zimg, z1, z2)]
    out = {}
    with mesh:
        for label, fn in fns.items():
            loss, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2)))(*args)
            out[label] = (np.asarray(loss), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the four processes, computes the JAX references meanwhile,
    and returns (out_dir, {label: JAX result})."""
    out = str(tmp_path_factory.mktemp("mesh_recipe"))
    env = {**os.environ, "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(4):
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_mesh_recipe_worker.py"), out],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        refs = _jax_losses()
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


@pytest.mark.parametrize("mesh", MESHES)
def test_draws_one_per_global_row(world, mesh):
    e = _errors(world, f"draws_{mesh}")
    for label in ("mask", "drop_path", "dropout"):
        assert e[f"{label}_shards_differ"] == 1 and e[f"{label}_tensor_equal"] == 1, (label, e)
    assert e["mask_one_process"] == 1 and e["drop_path_one_process"] == 1, e


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_gradcache_and_losses_on_a_mesh_match_one_process(world, mesh, case):
    e = _errors(world, "gradcache")[f"{mesh}/{case}"]
    assert e["leaves"] == e["want_leaves"] and e["tensor_sharded"] > 0, e
    assert (e["fsdp_chunked"] > 0) == mesh.startswith("fsdp"), e
    assert e["loss"] <= 1e-5 and e["grad"] <= 1e-5, e


def test_vocab_leaves_split_over_tensor(world):
    """On (data 2, tensor 2) each rank holds half of the token embedding and
    of the decoder head (vocab rows) and half of each tower's head (output
    features), and the ranks' shards join back to the one-process leaves
    bit for bit; test_gradcache_and_losses_on_a_mesh_match_one_process holds
    the vocab-sharded coca step (GradCache 2 with masking and drop-path, and
    accum 1) to one process."""
    e = _errors(world, "vocab")
    assert e["kinds"] == {"text.token_embedding.weight": "rows", "visual.proj": "cols",
                          "text.text_projection": "cols", "txt_decoder.head.weight": "rows"}, e
    assert set(e["fractions"].values()) == {0.5} and e["flags"] == [2, 2, 2, 2], e
    assert e["unshard_equal"] == 1, e


def test_a_vocab_tensor_does_not_divide_raises():
    from openvision_tpu_torch.train import step as tstep

    c = worker.grad_config(*worker.GRAD_CASES[0])
    c["model"]["text"]["vocab_size"] = c["model"]["text_decoder_config"]["num_classes"] = 63
    with pytest.raises(ValueError, match=r"token_embedding: its vocab \(63\) does not divide "
                                         r"over tensor=2"):
        tstep.tensor_plan(tstep.build_model(c), 2)


@pytest.mark.parametrize("label", LOSSES)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_losses_match_jax(world, mesh, label):
    got = np.load(os.path.join(world[0], "losses.npz"))
    loss, grads = world[1][label]
    np.testing.assert_allclose(got[f"{mesh}.{label}.loss"], loss, rtol=1e-5, atol=0)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(got[f"{mesh}.{label}.dz{i}"], g, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-12), err_msg=str(i))


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_losses_match_one_process(world, mesh):
    for label in LOSSES:
        e = _errors(world, "losses")[f"{mesh}/{label}"]
        assert all(v <= 1e-5 for v in e.values()), (label, e)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_disclf_on_a_mesh_matches_one_process(world, mesh, mode):
    e = _errors(world, "evaluators")[mesh]
    assert e["classes"] <= 1e-5, e
    got = e[mode]
    assert got["counts"] == got["want_counts"] and got["metrics_equal"] == 1, got
    assert got["counts"][1] == worker.EVAL_IMAGES, got
    assert got["scales_equal"] == 1 and got["scales_tensor_equal"] == 1, got


@pytest.mark.parametrize("mesh", MESHES)
def test_retrieval_and_the_monitor_on_a_mesh_match_one_process(world, mesh):
    e = _errors(world, "evaluators")[mesh]
    r = e["retrieval"]
    assert r["equal"] == 1 and r["zimg"] <= 1e-5 and r["ztxt"] <= 1e-5, r
    c = e["contrastive"]
    assert c["loss"] <= 1e-5 and c["ncorrect_equal"] == 1, c


def test_eval_only_on_a_mesh_matches_one_process(world):
    e = _errors(world, "eval_only")
    assert e["rows"] == 1 and e["step"] == 0, e
    assert set(e["want"]) == set(e["got"]) and len(e["want"]) == 7, e
    assert e["got"] == e["want"], e


def test_sigterm_to_one_process_stops_the_mesh_and_resumes(world):
    e = _errors(world, "sigterm")
    assert e["stopped_at"] == [1, 1, 1, 1] and e["saved"] == [1], e
    assert e["resumed_steps"] == [1, 2, 3] and e["count"] == 3, e
    assert e["params"] <= 1e-6, e


class _Shard:
    def __init__(self, shards, index):
        self.batch_shards, self.batch_index = shards, index


@pytest.mark.parametrize("n,batch,shards", [(22, 8, 2), (10, 8, 4), (3, 8, 4), (16, 16, 2)])
def test_make_for_inference_shards_the_rows(n, batch, shards):
    """shard=True: each batch shard reads a contiguous part (the first
    n % shards one longer, grain's even split) in batches of batch/shards,
    every shard as many batches (ceil(n / batch)), padding marked; the
    shards' real rows are the source, once. shard=False: every shard reads
    everything, in ceil(n / (batch / shards)) batches."""
    from openvision_tpu_torch.data import pipeline as tpipe

    src = tpipe.DictSource({"image": np.arange(n, dtype=np.float32)[:, None]})
    seen, counts = [], set()
    for i in range(shards):
        batches = list(tpipe.make_for_inference(src, "", batch, mesh=_Shard(shards, i))())
        counts.add(len(batches))
        assert all(b["image"].shape == (batch // shards, 1) for b in batches)
        rows = np.concatenate([b["image"][b["_mask"] > 0, 0] for b in batches])
        lo = i * (n // shards) + min(i, n % shards)
        np.testing.assert_array_equal(rows, np.arange(lo, lo + n // shards + (i < n % shards)))
        seen.append(rows)
        whole = list(tpipe.make_for_inference(src, "", batch, shard=False,
                                              mesh=_Shard(shards, i))())
        assert len(whole) == -(-n // (batch // shards))
        np.testing.assert_array_equal(
            np.concatenate([b["image"][b["_mask"] > 0, 0] for b in whole]), np.arange(n))
    assert counts == {-(-n // batch)}
    np.testing.assert_array_equal(np.concatenate(seen), np.arange(n))


def test_load_checkpoint_reads_a_train_states_params_alone(tmp_path, monkeypatch):
    """ft_from and load_transform take the params of a train state npz (the
    trainer's, with opt.mu and opt.nu beside them): only those arrays are
    read, and they are the params saved."""
    import torch

    from openvision_tpu_torch.train import checkpoint as tck

    rng = np.random.default_rng(0)
    params = {"visual.proj": rng.standard_normal((4, 3)).astype(np.float32),
              "logit_scale": np.float32(2.3)}
    tck.save_npz(str(tmp_path / "ckpt-1.npz"), {
        "params": params, "opt": {"count": np.asarray(1), "mu": params, "nu": params},
        "step": np.asarray(1), "data_position": np.asarray(8)})
    read = []
    recover = tck.recover_dtype
    monkeypatch.setattr(tck, "recover_dtype", lambda a: read.append(a.shape) or recover(a))
    got = tck.load_state_dict(str(tmp_path / "ckpt-1.npz"))
    assert len(read) == len(params) and set(got) == set(params)
    for k, v in params.items():
        torch.testing.assert_close(got[k], torch.as_tensor(v))
    read.clear()
    assert set(tck.load_npz(str(tmp_path / "ckpt-1.npz"))) == {"params", "opt", "step",
                                                                "data_position"}
    assert len(read) == 3 * len(params) + 3
