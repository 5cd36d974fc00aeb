"""The input pipelines in plain Python and numpy.

Counterpart of ``openvision_tpu/data/pipeline.py`` without grain (the card's
machine has none).

Training (``SyntheticClipSource`` :42-70, ``training`` :208-242): records
are read in a shuffled order that repeats forever, each one preprocessed by
the config's pp string (``data/pp.py``) with its own
``np.random.Generator``, and batched by stacking. The order and every
record's generator derive from the seed and the record's position in the
stream, so a run is reproducible and its position (the count of records
read) is all a checkpoint needs to resume on the exact next batch; grain's
own shuffle and per-record seeds are not reproduced. On a process mesh each
process reads only its rows of every global batch (``rows``, its (data,
fsdp) shard: ``parallel.Mesh.batch_rows``): the same records, with the same
generators, that the one-process loader puts there; the position still
counts the global batch's records. ``input.num_workers`` (grain's
``worker_count``, JAX trainer :211-213) runs the pp in that many spawned
worker processes, a batch's rows cut into contiguous chunks, and prepares
the next batch while the caller trains on this one; the records and their
generators are those of the synchronous loader, so a batch is the same with
0 workers or N. ``input.mixup.enabled`` applies :class:`MixupCutmixTransform`
(:178-205, ``data/ops_aug.py:mixup_cutmix``) to each batch (this process's
rows) after stacking, with a generator of the seed and the batch's first
position. :func:`training_mixture` (:245-269) draws each batch from one of
several pipelines, in the order ``default_rng(seed).choice`` gives over the
normalized weights, component i seeded with seed + i.

Inference (``make_for_inference`` :271-349): one epoch in order, the last
batch zero-padded and a ``_mask`` key marking the real rows; with
``num_workers > 0`` the pp runs in worker processes of a
``torch.utils.data.DataLoader``, in order. On a process mesh a batch holds
``batch_size / batch_shards`` rows, each batch shard reading its
contiguous part of the source (``shard=True``) or the whole of it.

Sources: ``synthetic``, ``DictSource`` (:73), ``JsonlImageSource`` (:92),
``WebdatasetTarSource`` (:489-565: webdataset tar shards, ``paths`` or the
sorted glob of ``pattern``; each shard indexed once by the port's native
indexer, ``native/indexer.cpp``), ``TfdsDirectorySource`` (:567), which
serves a TFDS-format directory of TFRecord shards (``data/tfrecord.py``: no
tensorflow, no tensorflow_datasets), with the ``split[a:b]`` sub-split
syntax and ``label.labels.txt``; its shards indexed natively too), and
``arrayrecord`` (``data/arrayrecord.py``: each record's bytes, as grain's
``ArrayRecordDataSource``).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Iterator, Sequence

import numpy as np

from openvision_tpu_torch.data import tfrecord
from openvision_tpu_torch.data.pp import build_pp_fn, import_pp_modules


class SyntheticClipSource:
    """Deterministic random images + captions (smoke tests, benchmarks)."""

    _CAPTIONS = (
        "a photo of a cat sitting on a mat",
        "an aerial view of a city at night. bright lights everywhere!",
        "two dogs playing in the snow",
        "a close-up of a red flower. petals glisten with dew!",
    )

    def __init__(self, num_examples: int = 1024, height: int = 64, width: int = 64):
        self._n = num_examples
        self._h, self._w = height, width

    def __repr__(self):
        return f"SyntheticClipSource(n={self._n}, h={self._h}, w={self._w})"

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int):
        rng = np.random.default_rng(i)
        img = rng.integers(0, 255, (self._h, self._w, 3), np.uint8)
        cap = self._CAPTIONS[i % len(self._CAPTIONS)]
        # "jpg": the webdataset feature name the training pp string reads
        return {"jpg": img, "txt": cap, "llava_caption": cap}


class DictSource:
    """In-memory dict-of-arrays source (eval sets, unit tests)."""

    def __init__(self, data: dict[str, Any]):
        self._data = data
        lens = {len(v) for v in data.values()}
        assert len(lens) == 1, f"ragged source: {lens}"
        self._n = lens.pop()

    def __repr__(self):
        return f"DictSource(keys={sorted(self._data)}, n={self._n})"

    def __len__(self):
        return self._n

    def __getitem__(self, i: int):
        return {k: v[i] for k, v in self._data.items()}


class JsonlImageSource:
    """JSONL with {"image": <path>, "txt": ..., ...}; images read lazily as bytes."""

    def __init__(self, jsonl_path: str, image_root: str = "", image_key: str = "image"):
        with open(jsonl_path) as f:
            self._rows = [json.loads(l) for l in f if l.strip()]
        self._path = jsonl_path
        self._root = image_root
        self._key = image_key

    def __repr__(self):
        return (f"JsonlImageSource({self._path!r}, root={self._root!r}, "
                f"key={self._key!r})")

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i: int):
        row = dict(self._rows[i])
        with open(os.path.join(self._root, row[self._key]), "rb") as f:
            row[self._key] = f.read()
        return row


def _shard_fd(cache: dict[int, int], shards: Sequence[str], shard: int) -> int:
    """This process's fd of a shard, read with os.pread (a positioned read,
    safe from several threads)."""
    fd = cache.get(shard)
    if fd is None:
        fd = os.open(shards[shard], os.O_RDONLY)
        prior = cache.setdefault(shard, fd)
        if prior != fd:
            os.close(fd)
            fd = prior
    return fd


class TfdsDirectorySource:
    """Random access over a TFDS-format directory of TFRecord shards, without
    the tensorflow_datasets package.

    Shards are ``*-{split}.tfrecord-*``, ``*.{split}.tfrecord-*`` or
    ``{split}.tfrecord-*``, indexed once (record offsets); records are
    parsed as tf.train.Example (``data/tfrecord.py``) with every feature
    decoded generically, a list unwrapped when it holds one value. Images
    stay encoded; the pp ``decode`` op decodes them.
    """

    def __init__(self, data_dir: str, split: str = "train"):
        sub = None  # "validation[:4]", "train[10:20]"
        m = re.fullmatch(r"(.+?)\[(-?\d*):(-?\d*)\]", split)
        if m:
            split = m.group(1)
            sub = slice(int(m.group(2)) if m.group(2) else None,
                        int(m.group(3)) if m.group(3) else None)
        self._shards: list[str] = []
        for pat in (f"*-{split}.tfrecord-*", f"*.{split}.tfrecord-*", f"{split}.tfrecord-*"):
            self._shards = sorted(glob.glob(os.path.join(data_dir, pat)))
            if self._shards:
                break
        if not self._shards:
            raise FileNotFoundError(f"no TFRecord shards for split {split!r} in {data_dir}")
        self._index = [(si, off, size) for si, path in enumerate(self._shards)
                       for off, size in tfrecord.index_records(path)]
        if sub is not None:
            self._index = self._index[sub]
        self._fds: dict[int, int] = {}
        self._label_names = _tfds_label_names(data_dir)
        self._repr = (f"TfdsDirectorySource({data_dir!r}, split={split!r}, "
                      f"sub={sub!r}, n={len(self._index)})")

    def __repr__(self):
        return self._repr

    def __len__(self):
        return len(self._index)

    @property
    def label_names(self):
        return self._label_names

    def __getstate__(self):
        return {**self.__dict__, "_fds": {}}

    def __getitem__(self, i: int):
        shard, offset, size = self._index[i]
        fd = _shard_fd(self._fds, self._shards, shard)
        return tfrecord.parse_example(os.pread(fd, size, offset))


def _tfds_label_names(data_dir: str):
    """Class names from the TFDS metadata file, when present."""
    for fname in ("label.labels.txt", "labels.labels.txt"):
        path = os.path.join(data_dir, fname)
        if os.path.exists(path):
            with open(path) as f:
                return [l.rstrip("\n") for l in f]
    return None


def tar_members(path: str) -> list[tuple[str, int, int]]:
    """(name, data offset, size) of each regular member of a tar shard, in
    archive order: the native indexer's scan, or tarfile's with
    ``OPENVISION_NO_NATIVE`` set (:func:`tar_members_py`)."""
    from openvision_tpu_torch.native import indexer

    out = indexer.tar_index(path)
    return tar_members_py(path) if out is None else out


def tar_members_py(path: str) -> list[tuple[str, int, int]]:
    """:func:`tar_members` by tarfile."""
    import tarfile

    with tarfile.open(path) as tf:
        return [(m.name, m.offset_data, m.size) for m in tf if m.isfile()]


class WebdatasetTarSource:
    """Random access over webdataset-style tar shards.

    Each shard is scanned once (the native indexer, ``native/indexer.cpp``;
    tarfile with ``OPENVISION_NO_NATIVE`` set), its members grouped by key
    prefix (``<key>.jpg``, ``<key>.txt``, ``<key>.json``, ...), the keys of a
    shard in sorted order; a record is read back with ``os.pread`` at its
    members' offsets. Image members (jpg, jpeg, png, webp) stay encoded
    under ``"jpg"`` (the pp ``decode`` and crop ops decode them: PNG with
    ``decode_png``, anything else with Pillow); ``txt`` is decoded as UTF-8;
    a ``json`` member's keys are merged in without overwriting;
    ``llava_caption`` defaults to ``txt``, ``txt`` to "".
    """

    def __init__(self, paths: Sequence[str], text_keys=("txt", "json")):
        self._shards: list[str] = list(paths)
        self._text_keys = text_keys
        self._index: list[tuple[int, dict[str, tuple[int, int]]]] = []
        for si, path in enumerate(self._shards):
            groups: dict[str, dict[str, tuple[int, int]]] = {}
            for name, offset, size in tar_members(path):
                key, _, ext = os.path.basename(name).rpartition(".")
                groups.setdefault(key, {})[ext.lower()] = (offset, size)
            self._index.extend((si, groups[key]) for key in sorted(groups))
        self._fds: dict[int, int] = {}

    def __repr__(self):
        return (f"WebdatasetTarSource(shards={self._shards!r}, "
                f"text_keys={tuple(self._text_keys)!r})")

    def __len__(self):
        return len(self._index)

    def __getstate__(self):
        return {**self.__dict__, "_fds": {}}

    def __getitem__(self, i: int):
        shard, members = self._index[i]
        fd = _shard_fd(self._fds, self._shards, shard)
        out: dict[str, Any] = {}
        for ext, (offset, size) in members.items():
            raw = os.pread(fd, size, offset)
            if ext in ("jpg", "jpeg", "png", "webp"):
                out["jpg"] = raw
            elif ext == "txt":
                out["txt"] = raw.decode("utf-8")
            elif ext == "json":
                for k, v in json.loads(raw).items():
                    out.setdefault(k, v)
        out.setdefault("txt", "")
        out.setdefault("llava_caption", out["txt"])
        return out


def get_source(data_cfg: dict):
    """The source a config's input.data names."""
    name = data_cfg.get("name", "synthetic")
    if name == "synthetic":
        return SyntheticClipSource(num_examples=data_cfg.get("num_examples", 1024),
                                   height=data_cfg.get("res", 64), width=data_cfg.get("res", 64))
    if name == "jsonl":
        return JsonlImageSource(data_cfg["path"], data_cfg.get("image_root", ""),
                                data_cfg.get("image_key", "image"))
    if name == "tfds":
        return TfdsDirectorySource(data_cfg["data_dir"], data_cfg.get("split", "train"))
    if name == "webdataset":
        return WebdatasetTarSource(data_cfg.get("paths") or sorted(glob.glob(data_cfg["pattern"])))
    if name == "arrayrecord":  # each record's bytes, as grain.ArrayRecordDataSource
        from openvision_tpu_torch.data.arrayrecord import ArrayRecordSource

        return ArrayRecordSource(data_cfg["paths"])
    raise ValueError(f"Unknown data source: {name!r}")


class MixupCutmixTransform:
    """Batch-level mixup / cutmix after batching (JAX :178-205): the batch
    mixed with its reversal by ``ops_aug.mixup_cutmix``."""

    def __init__(self, image_key: str = "image", label_key: str = "labels",
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0, switch_prob: float = 0.5,
                 num_classes: int | None = None):
        self.image_key, self.label_key = image_key, label_key
        self.kw = dict(mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                       switch_prob=switch_prob, num_classes=num_classes)

    def __call__(self, batch: dict, rng: np.random.Generator) -> dict:
        from openvision_tpu_torch.data.ops_aug import mixup_cutmix

        batch = dict(batch)
        batch[self.image_key], batch[self.label_key] = mixup_cutmix(
            batch[self.image_key], batch[self.label_key], rng, **self.kw)
        return batch


_WORKER: dict = {}  # a pp worker process's source, pp fn and seed


def _init_worker(source, pp_string: str, seed: int) -> None:
    import_pp_modules()
    _WORKER.update(source=source, pp_fn=build_pp_fn(pp_string), seed=seed)


def _preprocess_chunk(jobs) -> dict:
    """[(record index, stream position)] -> their stacked examples."""
    src, pp_fn, seed = _WORKER["source"], _WORKER["pp_fn"], _WORKER["seed"]
    return _stack([pp_fn(dict(src[i]), np.random.default_rng([seed, pos])) for i, pos in jobs])


class TrainIterator:
    """Batches of preprocessed records, forever, with a resumable position.

    With ``num_workers > 0`` a pool of that many spawned processes runs the
    pp; the next batch is submitted as soon as one is returned, so its
    preparation overlaps the caller's step. :meth:`close` stops the pool.
    """

    def __init__(self, source, pp_string: str, batch_size: int, seed: int, position: int = 0,
                 rows: slice = slice(None), num_workers: int = 0, mixup: dict | None = None):
        self.source, self.pp_string = source, pp_string
        self.pp_fn = build_pp_fn(pp_string)  # an unknown op raises here, in this process
        self.batch_size, self.seed = batch_size, seed
        self.rows = rows  # this process's rows of each global batch
        self.num_workers = num_workers
        self.mixup = MixupCutmixTransform(**mixup) if mixup else None
        self._position = position  # records returned so far
        self._order_epoch, self._order = None, None
        self._pool, self._pending = None, None  # pending: (position, futures)

    @property
    def position(self) -> int:
        return self._position

    @position.setter
    def position(self, value: int) -> None:
        self._pending = None  # a prefetched batch of another position is dropped
        self._position = value

    def _index(self, pos: int) -> int:
        n = len(self.source)
        epoch = pos // n
        if epoch != self._order_epoch:
            self._order = np.random.default_rng([self.seed, epoch]).permutation(n)
            self._order_epoch = epoch
        return int(self._order[pos % n])

    def _jobs(self, start: int) -> list:
        return [(self._index(pos), pos)
                for pos in range(start, start + self.batch_size)[self.rows]]

    def _submit(self, start: int):
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.source, self.pp_string, self.seed))
        jobs = self._jobs(start)
        per = -(-len(jobs) // (2 * self.num_workers))  # two chunks a worker
        return start, [self._pool.submit(_preprocess_chunk, jobs[i:i + per])
                       for i in range(0, len(jobs), per)]

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        start = self._position
        if self.num_workers > 0:
            if self._pending is None or self._pending[0] != start:
                self._pending = self._submit(start)
            chunks = [f.result() for f in self._pending[1]]
            batch = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
            self._pending = self._submit(start + self.batch_size)
        else:
            batch = _stack([self.pp_fn(dict(self.source[i]), np.random.default_rng([self.seed, pos]))
                            for i, pos in self._jobs(start)])
        if self.mixup is not None:
            batch = self.mixup(batch, np.random.default_rng([self.seed, start, 1]))
        self._position = start + self.batch_size
        return batch

    def get_state(self) -> int:
        return self._position

    def close(self) -> None:
        """Stops the worker processes (a later batch starts them again)."""
        self._pending = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


def training(input_cfg: dict, *, seed: int = 0, position: int = 0,
             rows: slice = slice(None), num_workers: int | None = None):
    """(batch iterator, number of examples) for the config's input section;
    the iterator yields `rows` of each global batch, its pp in
    `num_workers` processes (default ``input_cfg["num_workers"]``, else 0)."""
    import_pp_modules()
    source = get_source(input_cfg["data"])
    if num_workers is None:
        num_workers = int(input_cfg.get("num_workers", 0) or 0)
    mixup = dict(input_cfg.get("mixup") or {})
    mixup = mixup if mixup.pop("enabled", False) else None
    return (TrainIterator(source, input_cfg["pp"], input_cfg["batch_size"], seed, position, rows,
                          num_workers=num_workers, mixup=mixup), len(source))


class _Mixture:
    def __init__(self, loaders, probs, seed: int):
        self.loaders, self.probs, self.seed = loaders, probs, seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            yield next(self.loaders[rng.choice(len(self.loaders), p=self.probs)])


def training_mixture(input_cfgs: Sequence[dict], weights: Sequence[float], *, seed: int = 0,
                     num_workers: int | None = None):
    """A weighted mixture of training pipelines (JAX :245-269): each batch
    comes from component i with probability weights[i], in the order
    ``default_rng(seed)`` draws; component i is :func:`training` seeded with
    seed + i. Returns (iterable of batches, total examples)."""
    loaders, sizes = zip(*(training(c, seed=seed + i, num_workers=num_workers)
                           for i, c in enumerate(input_cfgs)))
    probs = np.asarray(weights, np.float64)
    return _Mixture(loaders, probs / probs.sum(), seed), int(sum(sizes))


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


class _Preprocessed:
    """The source's `records` (default all), record r through the pp string
    with record r's generator: a DataLoader dataset of plain data (the pp
    fn is built in each process from its string), so spawned worker
    processes can take it."""

    def __init__(self, source, pp_string: str, seed: int, records=None):
        self.source, self.pp_string, self.seed = source, pp_string, seed
        self.records = range(len(source)) if records is None else records
        self._pp_fn = self._build()  # an unknown op raises here, in the caller's process

    def _build(self):
        import_pp_modules()
        return build_pp_fn(self.pp_string) if self.pp_string else (lambda d, r: d)

    def __getstate__(self):
        return {**self.__dict__, "_pp_fn": None}

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> dict:
        if self._pp_fn is None:
            self._pp_fn = self._build()
        r = int(self.records[i])
        return self._pp_fn(dict(self.source[r]), np.random.default_rng([self.seed, r]))


def _as_is(example):
    return example


def _stack(examples: Sequence[dict]) -> dict:
    keys = examples[0].keys()
    return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}


def make_for_inference(source, pp_string: str, batch_size: int, *, seed: int = 0,
                       num_workers: int = 0, shard: bool = True, mesh=None):
    """Eval pipeline: a function giving one epoch's iterator of batches, the
    last one zero-padded, a ``_mask`` key (1 for real rows) on every batch.

    On a process `mesh` (``parallel.Mesh``) of several batch shards each
    batch holds ``batch_size / batch_shards`` rows. With `shard` each batch
    shard (not each process: the processes of a tensor group read the same
    rows) reads its contiguous part of the source, the first ``len % shards``
    parts one record longer (grain's ``ShardByJaxProcess``); without it every
    process reads the whole source, as retrieval needs (JAX
    ``evaluators/retrieval.py:124-133``). Every process yields the same
    number of batches, computed from global quantities only (a shard that
    runs out pads), so the collectives of an eval loop stay in lockstep.

    With ``num_workers > 0`` the pp runs in that many spawned worker
    processes of a ``torch.utils.data.DataLoader`` (spawned, not forked: the
    caller may hold threads), the records in order.
    """
    shards = 1 if mesh is None else mesh.batch_shards
    if batch_size % shards:
        raise ValueError(f"eval batch {batch_size} does not split over {shards} batch shards")
    local_bs = batch_size // shards
    n_steps = -(-len(source) // (batch_size if shard else local_bs))
    records = range(len(source))
    if shard and shards > 1:  # contiguous parts, the first len % shards one longer
        records = np.array_split(records, shards)[mesh.batch_index]
    data = _Preprocessed(source, pp_string, seed, records)

    def examples() -> Iterator[dict]:
        if num_workers <= 0:
            return (data[i] for i in range(len(data)))
        from torch.utils.data import DataLoader

        return iter(DataLoader(data, batch_size=None, shuffle=False, num_workers=num_workers,
                               collate_fn=_as_is, multiprocessing_context="spawn"))

    def iterate() -> Iterator[dict]:
        buf: list[dict] = []
        yielded = 0
        pad = None
        for ex in examples():
            ex["_mask"] = np.ones((), np.float32)
            buf.append(ex)
            if len(buf) == local_bs:
                yield _stack(buf)
                yielded += 1
                pad = pad or {k: np.zeros_like(v) for k, v in buf[-1].items()}
                buf = []
        if buf:
            pad = {k: np.zeros_like(v) for k, v in buf[-1].items()}
        if pad is None and yielded < n_steps:  # an empty shard: record 0's structure
            ex = _Preprocessed(source, pp_string, seed, range(1))[0]
            pad = {k: np.zeros_like(np.asarray(v)) for k, v in ex.items()}
            pad["_mask"] = np.zeros((), np.float32)
        while yielded < n_steps:
            while len(buf) < local_bs:
                buf.append(dict(pad))
            yield _stack(buf)
            yielded += 1
            buf = []

    return iterate
