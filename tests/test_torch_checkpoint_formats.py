"""The port's checkpoint readers and writer against the JAX package, Orbax
and tensorstore, on the CPU.

- Orbax written by JAX (``save_train_state``: OCDBT, zstd chunks without a
  content size, the ``ocdbt.process_0`` merge, a leaf sharded over 4 host
  devices): the port's ``restore_params`` equals JAX's bit for bit, on the
  newest and an explicit step, beside an uncommitted
  ``*.orbax-checkpoint-tmp-*`` directory and a step without
  ``_CHECKPOINT_METADATA``;
- Orbax written by the port (``save_orbax``): JAX's ``restore_params``
  reads it back bit for bit, and tensorstore lists and reads the same keys
  and values in the top-level and the process database;
- the OCDBT reader on tensorstore's own databases (interior nodes, several
  data files, inline and indirect values), and a corrupted node refused by
  its CRC-32C;
- the zarr reader on tensorstore's arrays: ragged chunks, both dimension
  separators, F order, missing chunks read as the fill value, blosc/lz4 at
  typesizes 1, 2, 4 and 8 and chunks over blosc's block size;
- legacy tensorstore checkpoints: the port's ``load_legacy_ts`` equals
  JAX's through the ``-LAST`` pointer, a step directory and a regex, and
  ``_is_legacy_ts`` agrees with JAX's on tests/test_legacy_ts.py's cases;
- the committed fixtures (tests/fixtures/make_checkpoint_fixtures.py) still
  equal a fresh JAX read of them, and the port reads them as their npz;
- Orbax's other layouts, each a fixture written by Orbax here: zarr v3
  arrays in ``sharding_indexed`` shards, the numbered OCDBT manifest, and
  the save of two JAX processes (two ``ocdbt.process_<i>/`` stores under a
  merged manifest), each read bit-equal to the npz of JAX's restore;
- the zarr v3 reader on tensorstore's arrays (chunk grids, big-endian
  bytes, zstd, crc32c, shards with the index at the start, a 0-d array,
  fill values), and a codec Orbax does not write raised by name.
Torch runs one intra-op thread here, as the suite runs this file beside
others on a shared CPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openvision_tpu.train import checkpoint as jck
from openvision_tpu_torch.train import checkpoint as tck
from openvision_tpu_torch.train import codecs, ocdbt, zarr

ts = pytest.importorskip("tensorstore")

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    """A leaf as numpy to compare byte for byte: a bf16 one (a torch tensor
    on the port's side, ml_dtypes on JAX's) as int16 marked by a dtype of its
    own, so that it equals no other int16."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        x = x.view(torch.int16).numpy()
    else:
        x = np.asarray(x)
        if x.dtype.name != "bfloat16":
            return x
        x = x.view(np.int16)
    return x.view(np.dtype([("bf16", "<i2")]))


def assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), path


def _jax_state(rng, scale=1.0):
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    sharded = jax.device_put(jnp.asarray(rng.standard_normal((8, 6)) * scale, jnp.float32),
                             NamedSharding(mesh, P("d", None)))
    return {"params": {"img": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16),
                               "big": jnp.asarray(rng.standard_normal((30, 20)), jnp.float32),
                               "sh": sharded},
                       "t": jnp.asarray(2.3 * scale, jnp.float32)},
            "opt": {"count": jnp.asarray(7, jnp.int32),
                    "mu": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)}}}


@pytest.fixture(scope="module")
def jax_orbax(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax") / "ckpt")
    rng = np.random.default_rng(0)
    mngr = jck.create_checkpoint_manager(root, async_save=False, max_to_keep=None)
    for step, scale in ((2, 1.0), (4, -3.0)):
        jck.save_train_state(mngr, step, _jax_state(rng, scale))
    mngr.wait_until_finished()
    mngr.close()
    return root


def test_jax_written_orbax_reads_bit_equal(jax_orbax, tmp_path):
    root = str(tmp_path / "ckpt")
    shutil.copytree(jax_orbax, root)
    # a save still in flight and a step directory without its commit record
    shutil.copytree(os.path.join(root, "4"), os.path.join(root, "9.orbax-checkpoint-tmp-17"))
    shutil.copytree(os.path.join(root, "4"), os.path.join(root, "8"))
    os.remove(os.path.join(root, "8", "_CHECKPOINT_METADATA"))
    assert tck.orbax_steps(root) == [2, 4]
    for step in (None, 2, 4):
        got = tck.restore_params(root, step)
        assert_same_tree(got, jax.device_get(jck.restore_params(jax_orbax, None, step=step)))
    assert float(tck.restore_params(root)["t"]) == pytest.approx(-3 * 2.3)
    with pytest.raises(FileNotFoundError, match="step 8"):
        tck.restore_params(root, 8)
    whole = tck.restore_params(root, 2, subtree=None)
    assert int(whole["opt"]["count"]) == 7 and whole["opt"]["count"].dtype == np.int32
    assert tck.load_checkpoint(root).keys() == {"img", "t"}


def _port_tree(rng):
    return {"params": {"img": {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
                                     .bfloat16(),
                               "big": rng.standard_normal((40, 20)).astype(np.float32),
                               "empty": np.zeros((0, 3), np.float32)},
                       "t": np.float32(1.5), "flag": np.asarray([True, False])},
            "opt": {"count": np.asarray(3, np.int32),
                    "mu": {"big": rng.standard_normal((40, 20)).astype(np.float32)}}}


def test_port_written_orbax_reads_back_in_jax_and_tensorstore(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _port_tree(np.random.default_rng(1))
    step_dir = tck.save_orbax(root, 5, tree)
    assert step_dir == os.path.join(root, "5") and os.listdir(root) == ["5"]
    got = jax.device_get(jck.restore_params(root, None))
    assert_same_tree(got, tree["params"])
    assert_same_tree(tck.restore_params(root, 5, subtree=None), tree)

    names = {"opt.count", "opt.mu.big", "params.flag", "params.img.big", "params.img.empty",
             "params.img.w", "params.t"}
    chunks = {"opt.count/0", "opt.mu.big/0.0", "params.flag/0", "params.img.big/0.0",
              "params.img.w/0.0", "params.t/0"}
    item = os.path.join(step_dir, "default")
    for db in (item, os.path.join(item, "ocdbt.process_0")):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + db}).result()
        keys = sorted(k.decode() for k in kv.list().result())
        assert keys == sorted({f"{n}/.zarray" for n in names} | chunks)
        with ocdbt.Database(db) as mine:
            assert mine.keys() == keys
            for k in keys:
                assert kv.read(k.encode()).result().value == mine.get(k), k
    with pytest.raises(FileExistsError):
        tck.save_orbax(root, 5, tree)


def _ts_ocdbt(root: str, rng, commits: int, max_node: int) -> dict:
    spec = {"driver": "ocdbt", "base": "file://" + root,
            "config": {"max_decoded_node_bytes": max_node, "max_inline_value_bytes": 100}}
    kv = ts.KvStore.open(spec).result()
    want = {}
    for _ in range(commits):
        with ts.Transaction() as txn:
            for _ in range(40):
                key = f"p.tower{rng.integers(4)}.block_{rng.integers(30):03d}/{rng.integers(3)}.0"
                want[key] = rng.bytes(int(rng.integers(0, 300)))
                kv.with_transaction(txn)[key.encode()] = want[key]
    return want


@pytest.mark.parametrize("commits,max_node", [(1, 1 << 20), (3, 512)])
def test_ocdbt_reader_matches_tensorstore(tmp_path, commits, max_node):
    root = str(tmp_path / "db")
    want = _ts_ocdbt(root, np.random.default_rng(commits), commits, max_node)
    with ocdbt.Database(root) as db:
        assert db.keys() == sorted(want)
        assert all(db.get(k) == v for k, v in want.items())
        assert db.get("p.absent") is None
    if max_node == 512:  # interior nodes and several data files
        assert len(os.listdir(os.path.join(root, "d"))) > 1


def test_ocdbt_reads_a_root_under_a_base_path(tmp_path):
    """A merged top-level manifest may point at a process database's node
    by that database's base path: the node's own data-file table is then
    read under it (what tensorstore does)."""
    root = str(tmp_path / "db")
    rng = np.random.default_rng(0)
    want = {f"k{i}": rng.bytes(int(rng.integers(0, 3000))) for i in range(20)}
    ocdbt.write_orbax_store(root, want.items())
    sub = os.path.join(root, "ocdbt.process_0")
    with open(os.path.join(sub, "manifest.ocdbt"), "rb") as f:
        c = ocdbt._Cursor(ocdbt.decode_file(f.read(), ocdbt.MANIFEST_MAGIC, "manifest"))
    c.take(16), c.varints(3), c.take(1), c.varint(), c.take(4)  # the config
    [(_, node)] = ocdbt._read_table(c)
    c.varints(2), c.take(1)  # one version: its generation, its root's height
    _, offset, length = c.varints(3)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(ocdbt._manifest(("ocdbt.process_0/", node), offset, length, len(want), 0))
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + root}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(want)
    with ocdbt.Database(root) as db:
        assert db.keys() == sorted(want)
        for k, v in want.items():
            assert db.get(k) == v == kv.read(k.encode()).result().value


def test_a_missing_codec_library_raises_by_name_each_time(monkeypatch):
    monkeypatch.setattr(codecs, "_LIBS", {})
    monkeypatch.setattr(codecs.ctypes.util, "find_library", lambda name: None)

    def no_library(name):
        raise OSError(f"{name}: cannot open shared object file")

    real = codecs.ctypes.CDLL
    monkeypatch.setattr(codecs.ctypes, "CDLL", no_library)
    for _ in range(2):
        with pytest.raises(OSError, match="liblz4.so.1"):
            codecs.lz4_lib()
    with pytest.raises(OSError, match="libzstd.so.1"):
        codecs.zstd_compress(b"x")
    monkeypatch.setattr(codecs.ctypes, "CDLL", real)  # found later: nothing was cached
    assert codecs.zstd_decompress(codecs.zstd_compress(b"abc")).tobytes() == b"abc"


def test_ocdbt_refuses_a_corrupt_node(tmp_path):
    root = str(tmp_path / "db")
    ocdbt.write_orbax_store(root, [("a/.zarray", b"x" * 10), ("a/0", b"y" * 2000)])
    node = os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])
    data = bytearray(open(node, "rb").read())
    data[20] ^= 1
    open(node, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Database(root)


def test_zstd_frames_round_trip():
    raw = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)
    frame = codecs.zstd_compress(raw)
    np.testing.assert_array_equal(codecs.zstd_decompress(frame), raw)
    np.testing.assert_array_equal(codecs.zstd_decompress(frame, raw.size), raw)
    with pytest.raises(ValueError, match="expected"):
        codecs.zstd_decompress(frame, raw.size + 1)
    # Orbax's chunk frames record no content size: streamed when no size is given
    with ocdbt.Database(os.path.join(FIXTURES, "orbax_train_state", "3", "default")) as db:
        chunk = db.get("params.img.head.kernel/0.0")
    assert chunk[4] == 0  # the frame header descriptor: no content size field
    np.testing.assert_array_equal(codecs.zstd_decompress(chunk),
                                  codecs.zstd_decompress(chunk, 40 * 20 * 4))


def _ts_array(path: str, arr: np.ndarray, meta: dict, region=None) -> None:
    dtype = "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.name
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path}, "metadata": meta}
    t = ts.open(spec, create=True, dtype=ts.dtype(dtype), shape=arr.shape).result()
    if region is None:
        t[...] = arr
    else:
        t[region] = arr[region]


ZARR_CASES = [  # (shape, dtype, metadata, written region or None)
    ((7, 5), "float32", {"chunks": [3, 2]}, None),
    ((7, 5), "float32", {"chunks": [3, 2], "dimension_separator": "/"}, None),
    ((7, 5, 3), "float64", {"chunks": [4, 5, 2], "order": "F"}, None),
    ((9, 4), "bfloat16", {"chunks": [4, 4], "dtype": "bfloat16", "fill_value": 1.5},
     np.s_[:4]),
    ((9, 4), "float32", {"chunks": [4, 4]}, np.s_[4:]),
    ((6,), "int32", {"chunks": [4], "compressor": None}, None),
    ((), "int64", {}, None),
    ((3, 2), "bool", {}, None),
    ((200, 300), "uint8", {"chunks": [200, 300]}, None),
    ((300, 500), "bfloat16", {"chunks": [300, 500]}, None),
    ((300, 500), "float64", {"chunks": [300, 500]}, None),
    ((5, 4), "float32", {"chunks": [5, 4], "compressor": {"id": "zstd", "level": 3}}, None),
]


@pytest.mark.parametrize("shape,dtype,meta,region", ZARR_CASES)
def test_zarr_reader_matches_tensorstore(tmp_path, shape, dtype, meta, region):
    rng = np.random.default_rng(len(shape))
    arr = (rng.standard_normal(shape) * 100).astype(jnp.dtype(dtype))
    if arr.size > 10000:  # compressible, so blosc writes several blocks
        arr = (np.arange(arr.size) % 7).reshape(shape).astype(jnp.dtype(dtype))
    path = str(tmp_path / "a")
    _ts_array(path, arr, meta, region)
    want = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": path}},
                   open=True).result().read().result()
    got = zarr.read_array(tck._file_getter(path))
    assert_same_tree({"a": got}, {"a": want})


def test_zarr_v3_raises(tmp_path):
    """A zarr v3 array reads (test_zarr3_reader_matches_tensorstore); a codec
    the reader does not know still raises by name."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    spec = {"driver": "zarr3", "kvstore": {"driver": "file", "path": str(tmp_path)},
            "metadata": {"codecs": [{"name": "transpose", "configuration": {"order": [1, 0]}},
                                    {"name": "bytes"}]}}
    ts.open(spec, create=True, dtype=ts.float32, shape=arr.shape).result()[...] = arr
    with pytest.raises(NotImplementedError, match="zarr v3 codec 'transpose'"):
        zarr.read_array(tck._file_getter(str(tmp_path)))


ZARR3_CASES = [  # (shape, dtype, metadata)
    ((7, 5), "float32", {"chunk_grid": {"name": "regular", "configuration": {
        "chunk_shape": [3, 2]}}}),
    ((9, 4), "bfloat16", {"data_type": "bfloat16", "fill_value": 1.5, "codecs": [
        {"name": "bytes", "configuration": {"endian": "big"}}, {"name": "zstd"}]}),
    ((8, 6), "int32", {"codecs": [{"name": "sharding_indexed", "configuration": {
        "chunk_shape": [4, 3], "codecs": [{"name": "bytes"}, {"name": "zstd"}],
        "index_codecs": [{"name": "bytes"}, {"name": "crc32c"}], "index_location": "start"}}]}),
    ((), "int64", {}),
    ((30, 20), "float64", {"codecs": [{"name": "bytes"}, {"name": "zstd"}, {"name": "crc32c"}]}),
]


@pytest.mark.parametrize("shape,dtype,meta", ZARR3_CASES)
def test_zarr3_reader_matches_tensorstore(tmp_path, shape, dtype, meta):
    arr = (np.random.default_rng(1).standard_normal(shape) * 100).astype(jnp.dtype(dtype))
    spec = {"driver": "zarr3", "kvstore": {"driver": "file", "path": str(tmp_path / "a")},
            "metadata": meta}
    t = ts.open(spec, create=True, dtype=ts.dtype(dtype), shape=arr.shape).result()
    if dtype == "bfloat16":  # half written: the rest is the fill value
        t[:5] = arr[:5]
    else:
        t[...] = arr
    want = ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": str(tmp_path / "a")}},
                   open=True).result().read().result()
    got = zarr.read_array(tck._file_getter(str(tmp_path / "a")))
    assert_same_tree({"a": got}, {"a": want})


@pytest.mark.parametrize("name", ["orbax_zarr3", "orbax_numbered", "orbax_two_process"])
def test_orbax_layouts_read_bit_equal(name):
    """Orbax's zarr v3 arrays, the numbered OCDBT manifest and a save of two
    processes (tests/fixtures/make_checkpoint_fixtures.py) read as the npz
    of JAX's restore of them."""
    root = os.path.join(FIXTURES, name)
    assert_same_tree(tck.restore_params(root, subtree=None), tck.load_npz(root + ".npz"))
    item = os.path.join(root, "3", "default")
    with open(os.path.join(item, "_METADATA")) as f:
        assert json.load(f)["use_zarr3"] == (name == "orbax_zarr3")
    if name == "orbax_numbered":
        assert any(n.startswith("manifest.0") for n in os.listdir(item))
    if name == "orbax_two_process":
        assert {d for d in os.listdir(item) if d.startswith("ocdbt.process_")} == {
            "ocdbt.process_0", "ocdbt.process_1"}
        with ocdbt.Database(item) as db:  # the merged tree reaches both processes' files
            files = {v[0].split("/")[0] for v in db.entries.values() if isinstance(v, tuple)}
        assert files == {"ocdbt.process_0", "ocdbt.process_1"}


@pytest.fixture()
def legacy(tmp_path):
    """tests/test_legacy_ts.py's layout, with multi-chunk bf16 and f64 leaves."""
    rng = np.random.default_rng(0)
    leaves = {
        "params~img~embedding~kernel~value": (rng.normal(size=(4, 3)).astype(np.float32),
                                              {"chunks": [3, 2]}),
        "params~img~pos_embedding~value": (rng.normal(size=(1, 50, 40)).astype(jnp.bfloat16),
                                           {"chunks": [1, 16, 40]}),
        "params~t~value": (np.asarray(2.3, np.float32), {}),
        "opt~0~count~value": (np.asarray(100, np.int32), {}),
        "chrono~accum_train_time": (np.asarray(7.5, np.float64), {}),
    }
    base = str(tmp_path / "ckpt")
    step_dir = f"{base}-000000100"
    os.makedirs(step_dir)
    for name, (arr, meta) in leaves.items():
        _ts_array(os.path.join(step_dir, name), arr, meta)
    with open(f"{base}-LAST", "w") as f:
        f.write("000000100")
    return base, step_dir


def test_legacy_ts_matches_jax(legacy):
    base, step_dir = legacy
    for path, regex in ((base, None), (step_dir, None), (step_dir, r"params/.*"),
                        (base, r"params/img/.*")):
        assert_same_tree(tck.load_legacy_ts(path, regex), jck.load_legacy_ts(path, regex))
    assert_same_tree(tck.restore_params(base), jck.restore_params(base, None))
    assert_same_tree(tck.load_checkpoint(step_dir), jck.load_legacy_ts(step_dir)["params"])


def test_is_legacy_ts_matches_jax(legacy, tmp_path):
    base, step_dir = legacy
    (tmp_path / "plain").mkdir()
    (tmp_path / "plain" / "x").write_text("")
    for path in (base, step_dir, str(tmp_path / "plain"), str(tmp_path / "absent"),
                 str(tmp_path)):
        assert tck._is_legacy_ts(path) == jck._is_legacy_ts(path), path


def test_committed_fixtures_equal_a_fresh_jax_read():
    orbax = os.path.join(FIXTURES, "orbax_train_state")
    want = tck.load_npz(orbax + ".npz")
    assert_same_tree(want["params"], jax.device_get(jck.restore_params(orbax, None)))
    assert_same_tree(tck.restore_params(orbax, subtree=None), want)
    item = os.path.join(orbax, "3", "default")
    assert os.path.isdir(os.path.join(item, "ocdbt.process_0"))
    with ocdbt.Database(item) as db:  # the sharded leaf's 4 chunks
        assert [k for k in db.keys() if k.startswith("params.img.pos_embedding/")] == [
            "params.img.pos_embedding/.zarray"] + [f"params.img.pos_embedding/{i}.0"
                                                    for i in range(4)]
        assert any(isinstance(v, tuple) for v in db.entries.values())  # an indirect value
    legacy = os.path.join(FIXTURES, "legacy_ts")
    want = tck.load_npz(legacy + ".npz")
    assert_same_tree(want, jck.load_legacy_ts(legacy))
    assert_same_tree(tck.load_legacy_ts(legacy), want)
