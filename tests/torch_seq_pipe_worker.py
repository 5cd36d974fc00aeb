"""One process of the gloo world that the seq and pipe tests share.

Run as ``python tests/torch_seq_pipe_worker.py OUT_DIR`` with torchrun's
environment (RANK, WORLD_SIZE=4, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
``tests/test_torch_ring_attention.py`` and ``tests/test_torch_pipeline.py``
start the four processes once (:func:`start_world`) and read what process
0 wrote to OUT_DIR (``<check>.npz``: arrays the tests hold against the JAX
package; ``<check>.json``: errors against the port's one process, which
the tests bound). OUT_DIR holds ``weights.pt``, the towers' and the
encoder's state dicts converted from the JAX package's initialisers, which
the test side writes before the world starts. Every other input comes from
seeded numpy (the functions below, which the tests call too).
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_worker as tp  # noqa: E402

from openvision_tpu_torch import parallel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 150
DEPTH, D = 8, 16  # tests/test_pipeline_parallel.py's block stack
# (label, mesh, microbatches, chunks a stage, global batch)
PIPE_CASES = (("pipe4_m4_v1", dict(pipe=4), 4, 1, 16),
              ("data2_pipe2_m8_v2", dict(data=2, pipe=2), 8, 2, 16),
              ("pipe4_m6_v2", dict(pipe=4), 6, 2, 24),  # a partial last wave
              ("data2_pipe2_m3_v4", dict(data=2, pipe=2), 3, 4, 24))  # c = 1
PIPE_GRAD_V = (1, 2)  # gradients on (pipe 4), 4 microbatches of a batch of 8
RING_MESHES = {"seq4": dict(seq=4), "data2_seq2": dict(data=2, seq=2)}
RING_SHAPE = (4, 10, 2, 16)  # (B, L, H, D): L = 10 pads to 12 on a ring of 4
VIT = dict(num_classes=32, variant="mu/16", posemb="sincos2d", pool_type="gap",
           output_tokens=False, emb_head_bias=False, head_zeroinit=False)
VIT_RES = 64  # 16 patches + cls: 17 tokens pad to 18 on seq 2
TEXT = dict(num_classes=32, variant="Ti", pool_type="last", vocab_size=128, causal=True,
            output_tokens=False)
TEXT_LEN = 12
ENCODER = dict(depth=4, num_heads=2, mlp_dim=64)  # width 16 (:func:`encoder_input`)
COCA_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,"
            "output_token_len=8,vocab_size=64,runlocal=True,remat=none,attn_impl=xla")
TRAIN_ARG = ("res=32,img=mu/16,txt_name=Ti,txt_decoder_name=Ti,token_len=16,output_token_len=8,"
             "remat=none,data_parallelism=2")  # main_clip's run, on the repo's vocab
# the one-step checks: (mesh, config arg appended, config entries); GradCache
# with the global contrastive mode on one pipe and one seq mesh
GRADCACHE = {"grad_accum": 2, "local_loss": False}
STEP_MESHES = {"data2_pipe2": (dict(data=2, pipe=2), ",data_parallelism=2,pipe_parallelism=2", {}),
               "fsdp2_pipe2": (dict(data=1, fsdp=2, pipe=2),
                               ",fsdp_parallelism=2,pipe_parallelism=2", {}),
               "data2_pipe2_gradcache": (dict(data=2, pipe=2),
                                         ",data_parallelism=2,pipe_parallelism=2", GRADCACHE),
               "data2_seq2": (dict(data=2, seq=2),
                              ",data_parallelism=2,seq_parallelism=2,attn_impl=ring", {}),
               "tensor2_seq2": (dict(data=1, tensor=2, seq=2),
                                ",tensor_parallelism=2,seq_parallelism=2,attn_impl=ring", {}),
               "data2_seq2_gradcache": (dict(data=2, seq=2), ",data_parallelism=2,"
                                        "seq_parallelism=2,attn_impl=ring", GRADCACHE)}


# ---------------------------------------------------------------------------
# inputs (the tests make the same ones)
# ---------------------------------------------------------------------------


def pipe_params(seed=0) -> list:
    """DEPTH layers of the block's {"w", "b", "w2"} (f32 numpy)."""
    r = np.random.default_rng(seed)
    return [{"w": (r.standard_normal((D, D)) * 0.3).astype(np.float32),
             "b": (r.standard_normal(D) * 0.1).astype(np.float32),
             "w2": (r.standard_normal((D, D)) * 0.3).astype(np.float32)} for _ in range(DEPTH)]


def pipe_input(b: int, length: int = 6, seed=9) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, length, D)).astype(np.float32)


def block_fn(prm, x):
    """tests/test_pipeline_parallel.py's block, on a dict of tensors."""
    return x + torch.tanh(x @ prm["w"] + prm["b"]) @ prm["w2"]


def ring_inputs(seed=3) -> list:
    r = np.random.default_rng(seed)
    return [r.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(3)]


def vit_images(seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((8, VIT_RES, VIT_RES, 3)).astype(
        np.float32)


def text_tokens(seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 128, (8, TEXT_LEN)).astype(np.int64)


def encoder_input(seed=4, length=5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((8, length, 16)).astype(np.float32)


def coca_config(extra: str = "") -> dict:
    """tests/test_pipeline_wired.py's config (image depth 4) with `extra`
    appended to its arg, its text tower and decoder cut to 2 blocks."""
    from openvision_tpu_torch.configs.openvision import get_config

    c = get_config(COCA_ARG + extra)
    c["input"]["batch_size"] = 16
    c["model"]["image"]["depth"] = 4
    c["model"]["text"]["depth"] = c["model"]["text_decoder_config"]["depth"] = 2
    c["model"]["out_dim"] = (32, 32)
    c["lr"] = 1e-3
    c["schedule"] = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    return c


def jax_models() -> dict:
    """The test side's JAX modules and their initialised params: {name:
    (module, params, the port's state dict of them)} for the xla ViT, the
    xla causal text tower and the Encoder (JAX is imported here only: the
    world's processes never call this)."""
    import jax
    import jax.numpy as jnp

    from openvision_tpu.models import encoder as jencoder
    from openvision_tpu.models import text as jtext
    from openvision_tpu.models import vit as jvit
    from openvision_tpu.parallel import unbox
    from openvision_tpu_torch.convert.openclip import jax_params_to_state_dict

    def init(module, example):
        return unbox(jax.jit(module.init)(jax.random.PRNGKey(0), example)["params"])

    def state(params, key, prefix):
        return {k.removeprefix(prefix): torch.from_numpy(np.array(v))
                for k, v in jax_params_to_state_dict({key: params}).items()}

    out = {}
    vit = jvit.Model(attn_impl="xla", **VIT)
    p = init(vit, jnp.zeros((1, VIT_RES, VIT_RES, 3)))
    out["vit"] = (vit, p, state(p, "img", "visual."))
    text = jtext.Model(attn_impl="xla", **TEXT)
    p = init(text, jnp.zeros((1, TEXT_LEN), jnp.int32))
    out["text"] = (text, p, state(p, "txt", "text."))
    enc = jencoder.Encoder(**ENCODER)
    p = init(enc, jnp.asarray(encoder_input()))
    out["encoder"] = (enc, p, state({"Transformer": p}, "img", "visual.transformer."))
    return out


# ---------------------------------------------------------------------------
# the world, started once for both test files
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(out: str) -> str:
    """Starts the four processes on `out` and waits for them: '' or what
    went wrong."""
    env = {**os.environ, "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(4):
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out],
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        return f"the gloo world did not finish in {WORLD_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        logs = "".join(open(os.path.join(out, f"rank{r}.log")).read()[-3000:] for r in range(4))
        return f"a process of the world failed: {[p.returncode for p in procs]}\n{logs}"
    return ""


def start_world(root: str, write_weights) -> str:
    """The world's OUT_DIR under `root`: the first caller (of the pytest
    session's workers, which share `root`) writes the weights with
    `write_weights(path)`, runs the world and records the outcome; the
    others wait on the lock and read it. Raises with the outcome's error."""
    out = os.path.join(root, "torch_seq_pipe_world")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(root, "torch_seq_pipe_world.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = os.path.join(out, "outcome.txt")
        if not os.path.exists(done):
            write_weights(os.path.join(out, "weights.pt"))
            with open(done, "w") as f:
                f.write(_run_world(out))
        error = open(done).read()
    if error:
        raise RuntimeError(error)
    return out


def world_fixture(tmp_path_factory, jax_refs):
    """A test file's world fixture: (OUT_DIR, jax_refs(models), models).
    The JAX references are computed while the world (started once for the
    session's workers, :func:`start_world`) runs."""
    import threading

    models = jax_models()
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the session's workers share the parent
        root = root.parent
    result = {}

    def run():
        try:
            result["out"] = start_world(str(root), lambda path: torch.save(
                {k: v[2] for k, v in models.items()}, path))
        except Exception as e:  # noqa: BLE001 - reported by the fixture
            result["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = jax_refs(models)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return result["out"], refs, models


def arrays(out: str, name: str) -> dict:
    """Process 0's ``<name>.npz``."""
    with np.load(os.path.join(out, f"{name}.npz")) as f:
        return dict(f)


def errors(out: str, name: str) -> dict:
    """Process 0's ``<name>.json``."""
    with open(os.path.join(out, f"{name}.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the checks (every process runs each; process 0 writes)
# ---------------------------------------------------------------------------


_MESHES: dict = {}


def mesh_of(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _MESHES:
        _MESHES[key] = parallel.create_mesh(**kw)
    return _MESHES[key]


def group_equal(t: torch.Tensor, group) -> bool:
    """Whether every process of `group` holds the bits of `t`."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return all(torch.equal(p, t) for p in parts)


def ring(world):
    """``ring_attention_whole`` (the per-chunk ``ring_attention_sharded``
    between a scatter and a gather) over seq (causal and not) on each ring
    mesh: the output and the gradients of sum(out**2) with respect to q, k
    and v, gathered over the batch shards; and whether every seq rank holds
    the same bits of them."""
    from openvision_tpu_torch.ops.ring_attention import ring_attention_whole

    arrays, equal = {}, {}
    for name, kw in RING_MESHES.items():
        mesh = mesh_of(**kw)
        for causal in (False, True):
            qkv = [torch.from_numpy(a)[mesh.batch_rows(RING_SHAPE[0])].requires_grad_(True)
                   for a in ring_inputs()]
            out = ring_attention_whole(*qkv, mesh, seq_axis="seq", causal=causal)
            (out ** 2).sum().backward()
            tag = f"{name}_{'causal' if causal else 'full'}"
            got = [out.detach()] + [t.grad for t in qkv]
            equal[tag] = int(all(group_equal(t, mesh.seq_group) for t in got))
            for label, t in zip(("out", "dq", "dk", "dv"), got):
                arrays[f"{tag}/{label}"] = tp.gather_rows(t, mesh).numpy()
    world.save("ring", arrays=arrays, errors={"seq_equal": equal})


def pipeline(world):
    """``pipeline_apply`` on each PIPE_CASES mesh (outputs), then on (pipe
    4) the gradients of sum(out**2) at each PIPE_GRAD_V: the layers'
    (summed over pipe, as the train step sums them) and the input's."""
    from openvision_tpu_torch.ops.pipeline_parallel import pipeline_apply

    arrays, equal = {}, {}
    for label, kw, m, v, b in PIPE_CASES:
        mesh = mesh_of(**kw)
        layers = [{k: torch.from_numpy(a) for k, a in p.items()} for p in pipe_params()]
        x = torch.from_numpy(pipe_input(b))[mesh.batch_rows(b)]
        out = pipeline_apply(block_fn, layers, x, mesh, num_microbatches=m, interleave=v)
        equal[label] = int(group_equal(out, mesh.pipe_group))
        arrays[label] = tp.gather_rows(out, mesh).numpy()
    mesh = mesh_of(pipe=4)
    for v in PIPE_GRAD_V:
        layers = [{k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
                  for p in pipe_params()]
        x = torch.from_numpy(pipe_input(8, 4)).requires_grad_(True)
        out = pipeline_apply(block_fn, layers, x, mesh, num_microbatches=4, interleave=v)
        (out ** 2).sum().backward()
        for i, p in enumerate(layers):
            for k, t in p.items():
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                arrays[f"grad_v{v}/{i}/{k}"] = parallel.all_reduce(g, mesh.pipe_group).numpy()
        equal[f"dx_v{v}"] = int(group_equal(x.grad, mesh.pipe_group))
        arrays[f"grad_v{v}/x"] = x.grad.numpy()
    world.save("pipeline", arrays=arrays, errors={"pipe_equal": equal})


def _stack_prefixes(model, flag: str) -> tuple:
    from openvision_tpu_torch.models.encoder import Encoder

    return tuple(f"{n}.resblocks." if n else "resblocks." for n, m in model.named_modules()
                 if isinstance(m, Encoder) and getattr(m, flag))


def _whole_grads(model, mesh, batch: bool = True) -> dict:
    """The model's parameter gradients summed over pipe (the pipelined
    blocks' stages), over seq (the blocks of the stacks whose tokens stayed
    sharded over seq) and over the batch shards (unless `batch` is False),
    as the train step sums them."""
    pipe, seq = _stack_prefixes(model, "pipelined"), _stack_prefixes(model, "seq_sharded")
    out = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if pipe and n.startswith(pipe):
            g = parallel.all_reduce(g, mesh.pipe_group)
        if seq and n.startswith(seq):
            g = parallel.all_reduce(g, mesh.seq_group)
        out[n] = (parallel.all_reduce(g, mesh.batch_group) if batch else g).numpy()
    return out


def towers(world, weights):
    """The mu/16 ViT and the causal Ti text tower on ``ring`` over (data 2,
    seq 2): outputs and the gradients of sum(out**2)."""
    from openvision_tpu_torch.models import text as ttext
    from openvision_tpu_torch.models import vit as tvit

    mesh = mesh_of(data=2, seq=2)
    arrays, layout = {}, {}
    for name, model, x in (
            ("vit", tvit.Model(image_size=VIT_RES, attn_impl="ring", **VIT),
             torch.from_numpy(vit_images())),
            ("text", ttext.Model(context_length=TEXT_LEN, attn_impl="ring", **TEXT),
             torch.from_numpy(text_tokens()))):
        model.load_state_dict(weights[name])
        seen = []  # the tokens each block takes
        for block in model.transformer.resblocks:
            block.register_forward_hook(lambda m, args, out: seen.append(list(args[0].shape)))
        with parallel.use_mesh(mesh):
            out = model(x[mesh.batch_rows(x.shape[0])])
        (out ** 2).sum().backward()
        layout[name] = {"blocks": seen, "out": list(out.shape),
                        "seq_sharded": int(model.transformer.seq_sharded)}
        arrays[f"{name}/out"] = tp.gather_rows(out, mesh).numpy()
        arrays.update({f"{name}/grad/{n}": g for n, g in _whole_grads(model, mesh).items()})
    world.save("towers", arrays=arrays, errors=layout)


def dropout_stack(world, weights):
    """The Encoder on ``ring`` in training with dropout and drop-path over
    (data 2, seq 2) against the same stack on this process's batch rows
    under a mesh of the same batch shard and seq 1 (the draws of a process
    that holds every token of those rows): the output and the gradients of
    sum(out**2) (the input's and every parameter's, the blocks' summed over
    seq), each within its largest value's f32 rounding; the ring refuses
    the probabilities' dropout by name, so the blocks' attention dropout is
    off and the per-token dropouts (the residual branches', the MLP
    hidden's) and drop-path are what the layout draws."""
    from openvision_tpu_torch.models.encoder import Encoder

    mesh = mesh_of(data=2, seq=2)
    one = parallel.Mesh(dict(data=2, fsdp=1, tensor=1, seq=1, pipe=1),
                        dict(data=mesh.coords["data"], fsdp=0, tensor=0, seq=0, pipe=0))
    x = torch.from_numpy(encoder_input(seed=6, length=7))[mesh.batch_rows(8)]

    def run(m, train=True):
        enc = Encoder(16, attn_impl="ring", dropout=0.2, drop_path=0.3, **ENCODER)
        enc.load_state_dict(weights["encoder"])
        for block in enc.resblocks:
            block.attn.dropout_rate = 0.0
        xin = x.clone().requires_grad_(True)
        with parallel.use_mesh(m):
            out = enc(xin, train=train, rng=torch.Generator().manual_seed(11))
        (out ** 2).sum().backward()
        return out.detach(), xin.grad, _whole_grads(enc, m, batch=False), enc.seq_sharded

    out, dx, grads, sharded = run(mesh)
    ref_out, ref_dx, ref_grads, ref_sharded = run(one)
    errors = {"sharded": int(sharded), "ref_sharded": int(ref_sharded),
              "out": tp.rel(out, ref_out), "dx": tp.rel(dx, ref_dx),
              "grad": max(tp.rel(g, ref_grads[n]) for n, g in grads.items()),
              "draws": tp.rel(ref_out, run(one, train=False)[0])}  # what the draws changed
    errors = {k: float(parallel.all_reduce_max(torch.tensor(float(v)), None))  # every rank's
              for k, v in errors.items()}
    world.save("dropout_stack", errors=errors)


def encoder(world, weights):
    """A real Encoder (xla blocks) pipelined on (data 2, pipe 2): outputs
    and the gradients of sum(out**2) (the input's too); then one row a
    process (a microbatch of one)."""
    from openvision_tpu_torch.models.encoder import Encoder

    mesh = mesh_of(data=2, pipe=2)
    enc = Encoder(16, **ENCODER)
    enc.load_state_dict(weights["encoder"])
    x = torch.from_numpy(encoder_input())[mesh.batch_rows(8)].requires_grad_(True)
    with parallel.use_mesh(mesh):
        out = enc(x)
        pipelined = enc.pipelined
    (out ** 2).sum().backward()
    arrays = {"out": tp.gather_rows(out, mesh).numpy(), "dx": tp.gather_rows(x.grad, mesh).numpy()}
    arrays.update({f"grad/{n}": g for n, g in _whole_grads(enc, mesh).items()})
    one = torch.from_numpy(encoder_input())[mesh.batch_index:mesh.batch_index + 1]
    with parallel.use_mesh(mesh), torch.no_grad():
        small = enc(one)
        small_pipelined = enc.pipelined
    arrays["small"] = tp.gather_rows(small, mesh).numpy()
    world.save("encoder", arrays=arrays,
               errors={"pipelined": int(pipelined), "small_pipelined": int(small_pipelined)})


def _grad_errors(grads: dict, ref: dict) -> float:
    """The largest |g - ref| over every leaf, relative to the leaf's norm
    (the key bias's third left out: its true gradient is 0, softmax being
    shift-invariant, so both sides are rounding noise)."""
    worst = 0.0
    for n, g in grads.items():
        r = ref[n]
        if n.endswith("attn.in_proj_bias"):
            d = g.shape[0] // 3
            keep = torch.cat([torch.arange(d), torch.arange(2 * d, 3 * d)])
            g, r = g[keep], r[keep]
        worst = max(worst, float((g - r).abs().max()) / max(float(torch.linalg.norm(r)), 1e-12))
    return worst


def train_steps(world):
    """One CoCa gradient on each STEP_MESHES mesh against the port's one
    process on the whole batch (loss, every gradient relative to its norm),
    then one update: every process's parameters (whole again where FSDP2 or
    tensor shards them) the same bits; the draws (token masking, drop-path,
    dropout) equal within the seq and pipe groups."""
    from openvision_tpu_torch.models.init import init_params
    from openvision_tpu_torch.models.layers import DropPath, Dropout, dropout_generator
    from openvision_tpu_torch.models.vit import random_token_masking
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    batch = {k: torch.from_numpy(v) for k, v in tp.coca_batch().items()}
    out = {}
    for name, (kw, extra, entries) in STEP_MESHES.items():
        c = dict(coca_config(extra), **entries)
        ref_model = init_params(tstep.build_model(c), 0)
        state = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
        ref_opt = tstep.init_train_state(c, ref_model, total_steps=10, params=state)
        ref_meas, ref_grads = tstep.make_grad_fn(c, ref_model, ref_opt)(
            batch, rng=tstep.step_generator(0, 0))
        mesh = mesh_of(**kw)
        axis = mesh.pipe_group if mesh.pipe > 1 else mesh.seq_group
        model = tstep.build_model(c)
        local = {k: v[mesh.batch_rows(16)] for k, v in batch.items()}
        with parallel.use_mesh(mesh):
            opt = tstep.init_train_state(c, model, total_steps=10, mesh=mesh, params=state)
            meas, grads = tstep.make_grad_fn(c, model, opt)(local, rng=tstep.step_generator(0, 0))
            pipelined = sorted(n for n, m in model.named_modules()
                               if getattr(m, "pipelined", False))
            tstep.make_update_fn(c, model, opt)(local)
            x = torch.ones(8, 6, 2)
            draws = [random_token_masking(x, 0.5, torch.Generator().manual_seed(5), "random",
                                          2, 3)[1],
                     DropPath(0.5)(torch.ones(8, 3), torch.Generator().manual_seed(6)),
                     Dropout(0.5)(torch.ones(8, 3),
                                  dropout_generator(torch.Generator().manual_seed(7), 0.5))]
        whole = ckpt.gather_leaves(opt.params, model, opt)
        flat = torch.cat([t.detach().reshape(-1) for t in whole.values()])
        out[name] = {
            "loss": tp.rel(meas["training_loss"], ref_meas["training_loss"]),
            "grad": _grad_errors(ckpt.gather_leaves(grads, model, opt), ref_grads),
            "leaves": len(grads), "want_leaves": len(ref_grads), "pipelined": pipelined,
            "params_equal": int(group_equal(flat, None)),
            "draws_equal": int(all(group_equal(d, axis) for d in draws))}
    world.save("train_steps", errors=out)


def trainer_run(world, out_dir):
    """main_clip for 2 steps at pipe_parallelism=2 (data 2): finite losses,
    the mesh named in the log, process 0's checkpoint restored at pipe 1
    with the parameters every process holds."""
    from openvision_tpu_torch.main_clip import main
    from openvision_tpu_torch.train import checkpoint as ckpt
    from openvision_tpu_torch.train import step as tstep

    wd = os.path.join(out_dir, "train")
    arg = TRAIN_ARG + ",pipe_parallelism=2"
    model, opt, _ = main(["--config", f"openvision_tpu_torch/configs/openvision.py:{arg}",
                          "--workdir", wd, "--override", "input.batch_size=8",
                          "--override", "input.data.num_examples=16",
                          "--override", "total_steps=2", "--override", "model.image.depth=4",
                          "--override", "model.text.depth=2",
                          "--override", "model.text_decoder_config.depth=2",
                          "--override", "schedule.0.1.warmup_steps=1",
                          "--override", "log_training_steps=1", "--device", "cpu"])
    params = {n: p.detach() for n, p in model.named_parameters()}
    flat = torch.cat([p.reshape(-1) for p in params.values()])
    equal_ranks = group_equal(flat, None)
    if world.rank != 0:
        return
    rows = [json.loads(line) for line in open(os.path.join(wd, "metrics.jsonl"))]
    saved = ckpt.saved_steps(os.path.join(wd, "checkpoints"))
    from openvision_tpu_torch.configs.openvision import get_config

    config = get_config(TRAIN_ARG)  # pipe 1: the sequential stacks
    config["model"]["image"]["depth"] = 4
    config["model"]["text"]["depth"] = config["model"]["text_decoder_config"]["depth"] = 2
    one = tstep.build_model(config)
    one.load_state_dict(ckpt.load_state_dict(os.path.join(wd, "checkpoints"), saved[-1]))
    restored = all(torch.equal(one.state_dict()[n], params[n]) for n in params)
    world.save("trainer", errors={
        "losses": [r["training_loss"] for r in rows if "training_loss" in r],
        "checkpoints": saved, "restored": int(restored), "ranks_equal": int(equal_ranks),
        "count": opt.state["count"]})


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    parallel.maybe_distributed_init("cpu")
    world = tp.World(out_dir)
    weights = torch.load(os.path.join(out_dir, "weights.pt"))
    ring(world)
    pipeline(world)
    towers(world, weights)
    dropout_stack(world, weights)
    encoder(world, weights)
    train_steps(world)
    trainer_run(world, out_dir)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
