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
- ``orbax_train_state.npz`` and ``legacy_ts.npz``: the whole trees as the
  JAX package reads them back (Orbax's restore; ``load_legacy_ts``), under
  ``save_npz``'s flat slash-joined names, compressed.

Run from the repo root: ``python tests/fixtures/make_checkpoint_fixtures.py``.
"""

import os
import shutil
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
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


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    orbax_fixture(rng)
    legacy_fixture(rng)
