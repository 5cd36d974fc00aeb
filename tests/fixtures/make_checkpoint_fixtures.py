"""Writes the checkpoint fixtures that tests/test_torch_checkpoint_formats.py
and chip_smoke.py read, with the JAX package (Orbax) and tensorstore:

- ``orbax_train_state/``: a JAX train state saved at step 3 by
  ``openvision_tpu.train.checkpoint.save_train_state`` (Orbax, OCDBT,
  zstd): bf16 and f32 leaves, an int32 optimizer count, a 0-d leaf, leaves
  under and over OCDBT's 1024-byte inline limit, and one leaf saved sharded
  over 4 host devices (4 chunks);
- ``legacy_ts-000000100/`` and ``legacy_ts-LAST``: the reference's
  tensorstore/zarr layout (one zarr array a leaf, blosc/lz4 as tensorstore
  writes it by default, ``~``-joined names with the ``~value`` suffix): f32,
  bf16 and f64 leaves, one f32 chunk of 1.3 MB that blosc cuts into blocks;
- ``orbax_zarr3/``: the same kind of tree saved by Orbax's
  ``PyTreeCheckpointHandler(use_zarr3=True)``: zarr v3 arrays, each chunk in
  a ``sharding_indexed`` shard (bytes + zstd inside, a crc32c index);
- ``orbax_numbered/``: saved by ``save_train_state`` with the OCDBT config's
  ``manifest_kind`` set to ``numbered`` (Orbax writes ``single``): the
  versions in ``manifest.<16 hex digits>`` files, several per database;
- ``orbax_two_process/``: saved by two JAX processes
  (``jax.distributed.initialize``, two host devices each, as
  tests/test_multiprocess.py runs them), leaves sharded over the four
  devices: two ``ocdbt.process_<i>/`` stores under one merged manifest;
- ``orbax_chain/``: a train state of a tiny CoCa model whose ``opt`` is the
  real chain of ``optim.make`` with ``configs/openvision.py``'s optimizer
  settings (bf16 mu, b2 0.95, wd 0.2 on kernels) plus frozen params, two
  schedules, an lr multiplier and gradient clipping, after 3 updates;
  ``orbax_chain.npz`` holds the gradients of update 4 (``grads/<JAX
  name>``) and JAX's state after it (``want/params``, ``want/mu``,
  ``want/nu``, ``want/count``); ``orbax_chain.json`` the optimizer config
  and the model's head counts;
- ``orbax_train_state.npz``, ``legacy_ts.npz`` and the ``.npz`` of each
  Orbax fixture above: the whole trees as the JAX package reads them back
  (Orbax's restore; ``load_legacy_ts``), under ``save_npz``'s flat
  slash-joined names, compressed.

Run from the repo root: ``python tests/fixtures/make_checkpoint_fixtures.py``
(all of them) or with the fixtures' names as arguments (``orbax_zarr3
orbax_numbered orbax_two_process orbax_chain orbax_train_state legacy_ts``).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

if sys.argv[1:2] != ["--two-process-worker"]:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import tensorstore as ts  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from openvision_tpu.train import checkpoint as ckpt_lib  # noqa: E402
from openvision_tpu.utils import tree_flatten_with_names  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def orbax_fixture(rng):
    root = os.path.join(HERE, "orbax_train_state")
    shutil.rmtree(root, ignore_errors=True)
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((8, 4)), jnp.float32),
                             NamedSharding(mesh, P("d", None)))
    state = {
        "params": {
            "img": {"embedding": {"kernel": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16),
                                  "bias": jnp.asarray(rng.standard_normal(3), jnp.float32)},
                    "head": {"kernel": jnp.asarray(rng.standard_normal((40, 20)), jnp.float32)},
                    "pos_embedding": sharded},
            "t": jnp.asarray(2.3, jnp.float32),
        },
        "opt": {"count": jnp.asarray(3, jnp.int32),
                "mu": {"head": jnp.asarray(rng.standard_normal((40, 20)), jnp.bfloat16)}},
    }
    mngr = ckpt_lib.create_checkpoint_manager(root, async_save=False)
    ckpt_lib.save_train_state(mngr, 3, state)
    mngr.wait_until_finished()
    mngr.close()
    mngr = ckpt_lib.create_checkpoint_manager(root, async_save=False)
    meta = mngr.item_metadata(3).tree
    abstract = jax.tree.map(lambda m: jax.ShapeDtypeStruct(
        m.shape, m.dtype, sharding=NamedSharding(mesh, P())), meta)
    whole = mngr.restore(3, args=ocp.args.StandardRestore(abstract))
    mngr.close()
    save_npz(root + ".npz", whole)


def save_npz(path, tree):
    """``checkpoint.save_npz``'s flat names, compressed."""
    flat, _ = tree_flatten_with_names(tree)
    np.savez_compressed(path, **{n: np.asarray(v) for n, v in flat})


def legacy_fixture(rng):
    base = os.path.join(HERE, "legacy_ts")
    step_dir = f"{base}-000000100"
    shutil.rmtree(step_dir, ignore_errors=True)
    leaves = {
        "params~img~embedding~kernel~value": rng.standard_normal((4, 3)).astype(np.float32),
        "params~img~pos_embedding~value": rng.standard_normal((1, 5, 4)).astype(jnp.bfloat16),
        "params~img~head~kernel~value": (np.arange(512 * 640) % 97).astype(np.float32)
        .reshape(512, 640) * np.float32(0.25),
        "params~t~value": np.asarray(2.3, np.float32),
        "opt~0~count~value": np.asarray(100, np.int32),
        "chrono~accum_train_time": np.asarray(7.5, np.float64),
    }
    os.makedirs(step_dir)
    for name, arr in leaves.items():
        dtype = "bfloat16" if arr.dtype == jnp.bfloat16 else arr.dtype.name
        spec = {"driver": "zarr", "metadata": {"chunks": list(arr.shape)},
                "kvstore": {"driver": "file", "path": os.path.join(step_dir, name)}}
        t = ts.open(spec, create=True, dtype=ts.dtype(dtype), shape=arr.shape).result()
        t[...] = arr
    with open(f"{base}-LAST", "w") as f:
        f.write("000000100")
    save_npz(base + ".npz", ckpt_lib.load_legacy_ts(base))


def _small_state(rng, mesh, big=False):
    """A train-state tree: bf16 and f32 leaves, an int32 count, a 0-d leaf,
    leaves under and over OCDBT's 1024-byte inline limit, and one sharded
    over every device of `mesh` (one chunk each); each leaf a global array
    of `mesh`, as a save of several processes needs. `big`: one more leaf
    sharded over `mesh`, its chunks over the inline limit (so each process
    writes values into its own data files)."""
    def put(x, spec=P()):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, NamedSharding(mesh, spec),
                                            lambda idx: x[idx])

    state = {
        "params": {
            "img": {"embedding": {"kernel": put(rng.standard_normal((4, 3)).astype(jnp.bfloat16)),
                                  "bias": put(rng.standard_normal(3).astype(np.float32))},
                    "head": {"kernel": put(rng.standard_normal((40, 20)).astype(np.float32))},
                    "pos_embedding": put(rng.standard_normal((8, 4)).astype(np.float32),
                                         P("d", None))},
            "t": put(np.float32(2.3)),
        },
        "opt": {"count": put(np.int32(3)),
                "mu": {"head": put(rng.standard_normal((40, 20)).astype(jnp.bfloat16))}},
    }
    if big:
        state["params"]["big"] = put(rng.standard_normal((256, 8)).astype(np.float32),
                                     P("d", None))
    return state


def _restore_whole(root, step=3):
    """The tree of `root`'s `step` as JAX restores it, every leaf whole on
    this process's first device."""
    mngr = ocp.CheckpointManager(root, item_handlers=ocp.PyTreeCheckpointHandler())
    meta = mngr.item_metadata(step).tree
    device = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
    abstract = jax.tree.map(lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype, sharding=device),
                            meta)
    whole = mngr.restore(step, args=ocp.args.PyTreeRestore(
        abstract, restore_args=jax.tree.map(lambda a: ocp.ArrayRestoreArgs(
            sharding=device, global_shape=a.shape, dtype=a.dtype), abstract)))
    mngr.close()
    return jax.device_get(whole)


def zarr3_fixture(rng):
    root = os.path.join(HERE, "orbax_zarr3")
    shutil.rmtree(root, ignore_errors=True)
    state = _small_state(rng, Mesh(np.array(jax.devices()[:4]), ("d",)))
    mngr = ocp.CheckpointManager(
        root, options=ocp.CheckpointManagerOptions(create=True, enable_async_checkpointing=False),
        item_handlers=ocp.PyTreeCheckpointHandler(use_zarr3=True))
    mngr.save(3, args=ocp.args.PyTreeSave(state))
    mngr.wait_until_finished()
    mngr.close()
    save_npz(root + ".npz", _restore_whole(root))


def numbered_fixture(rng):
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu

    root = os.path.join(HERE, "orbax_numbered")
    shutil.rmtree(root, ignore_errors=True)
    state = _small_state(rng, Mesh(np.array(jax.devices()[:4]), ("d",)))
    single = tsu.add_ocdbt_write_options

    def numbered(spec, target_data_file_size=None):
        single(spec, target_data_file_size)
        spec["config"]["manifest_kind"] = "numbered"

    tsu.add_ocdbt_write_options = numbered
    try:
        mngr = ckpt_lib.create_checkpoint_manager(root, async_save=False)
        ckpt_lib.save_train_state(mngr, 3, state)
        mngr.wait_until_finished()
        mngr.close()
    finally:
        tsu.add_ocdbt_write_options = single
    save_npz(root + ".npz", _restore_whole(root))


def two_process_worker(coordinator, pid, root):
    """One of the two processes of ``two_process_fixture``."""
    jax.distributed.initialize(coordinator_address=coordinator, num_processes=2,
                               process_id=int(pid))
    assert jax.device_count() == 4 and jax.local_device_count() == 2
    mesh = Mesh(np.array(jax.devices()), ("d",))
    state = _small_state(np.random.default_rng(3), mesh, big=True)
    mngr = ckpt_lib.create_checkpoint_manager(root, async_save=False)
    ckpt_lib.save_train_state(mngr, 3, state)
    mngr.wait_until_finished()
    mngr.close()
    whole = _restore_whole(root)
    if int(pid) == 0:
        save_npz(root + ".npz", whole)
    jax.distributed.shutdown()


def two_process_fixture(_rng):
    root = os.path.join(HERE, "orbax_two_process")
    shutil.rmtree(root, ignore_errors=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, "--two-process-worker",
                               f"localhost:{port}", str(i), root], env=env)
             for i in range(2)]
    codes = [p.wait(timeout=300) for p in procs]
    assert codes == [0, 0], codes
    assert sorted(d for d in os.listdir(os.path.join(root, "3", "default"))
                  if d.startswith("ocdbt.process_")) == ["ocdbt.process_0", "ocdbt.process_1"]


CHAIN_ARG = ("res=16,img=mu/8,txt_name=Ti,txt_decoder_name=Ti,token_len=8,output_token_len=4,"
             "vocab_size=32,runlocal=True,remat=none,attn_impl=xla,dec_attn_impl=xla")
CHAIN_WIDTH = dict(width=16, depth=1, mlp_dim=32, num_heads=2)
CHAIN_OPTIMIZER = {  # configs/openvision.py's optimizer, and what it must map besides
    "optax_name": "scale_by_adam", "optax": {"mu_dtype": "bfloat16", "b1": 0.9, "b2": 0.95},
    "lr": 1e-3, "wd": 0.2, "grad_clip_norm": 1.0, "lr_mults": [["txt/.*", 0.5]],
    "schedule": [["img/embedding/.*", None],
                 ["img/.*", {"decay_type": "cosine", "warmup_steps": 2}],
                 [".*", {"decay_type": "linear", "warmup_steps": 1, "linear_end": 0.1}]],
}
CHAIN_SCHED_KW = {"total_steps": 10, "batch_size": 8, "data_size": None}


def chain_fixture(rng):
    from openvision_tpu import optim
    from openvision_tpu.configs import openvision as cfg_mod
    from openvision_tpu.train import step as step_mod

    root = os.path.join(HERE, "orbax_chain")
    shutil.rmtree(root, ignore_errors=True)
    c = cfg_mod.get_config(CHAIN_ARG)
    for tower in (c.model.image, c.model.text, c.model.text_decoder_config):
        tower.update(CHAIN_WIDTH)
    c.model.out_dim = (16, 16)
    model = step_mod.build_model(c)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                        jnp.zeros((4, 8), jnp.int32), train=True)["params"]
    params = jax.tree.map(lambda x: getattr(x, "value", x), params,
                          is_leaf=lambda x: hasattr(x, "value"))
    tx, _ = optim.make(CHAIN_OPTIMIZER, params, sched_kw=CHAIN_SCHED_KW)
    opt = tx.init(params)
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.05,
                                                  p.dtype), params)

    for _ in range(3):
        upd, opt = update(grads(), opt, params)
        params = optax.apply_updates(params, upd)
    mngr = ckpt_lib.create_checkpoint_manager(root, async_save=False)
    ckpt_lib.save_train_state(mngr, 3, {"params": params, "opt": opt})
    mngr.wait_until_finished()
    mngr.close()
    g = grads()
    upd, opt = update(g, opt, params)
    params = optax.apply_updates(params, upd)
    adam = opt[1].inner_state
    live = lambda tree: {k: v for k, v in tree_flatten_with_names(tree)[0]
                         if not isinstance(v, optax.MaskedNode)}
    np.savez_compressed(root + ".npz", **{
        **{f"grads/{k}": np.asarray(v) for k, v in live(g).items()},
        **{f"want/params/{k}": np.asarray(v) for k, v in live(params).items()},
        **{f"want/mu/{k}": np.asarray(v, np.float32) for k, v in live(adam.mu).items()},
        **{f"want/nu/{k}": np.asarray(v) for k, v in live(adam.nu).items()},
        "want/count": np.asarray(optim.get_count(opt))})
    with open(root + ".json", "w") as f:
        json.dump({"optimizer": CHAIN_OPTIMIZER, "sched_kw": CHAIN_SCHED_KW,
                   "num_heads_vision": 2, "num_heads_text": 2, "num_heads_decoder": 2}, f,
                  indent=1)


FIXTURES = {"orbax_train_state": orbax_fixture, "legacy_ts": legacy_fixture,
            "orbax_zarr3": zarr3_fixture, "orbax_numbered": numbered_fixture,
            "orbax_two_process": two_process_fixture, "orbax_chain": chain_fixture}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-process-worker"]:
        two_process_worker(*sys.argv[2:5])
        sys.exit(0)
    for name in sys.argv[1:] or FIXTURES:
        FIXTURES[name](np.random.default_rng(0))
