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
counts the global batch's records.

Inference (``make_for_inference`` :271-349): one epoch in order, the last
batch zero-padded and a ``_mask`` key marking the real rows; with
``num_workers > 0`` the pp runs in worker processes of a
``torch.utils.data.DataLoader``, in order. One process only: a batch holds
``batch_size`` rows (the evaluators refuse a process mesh).

Sources: ``synthetic``, ``DictSource`` (:73), ``JsonlImageSource`` (:92) and
``TfdsDirectorySource`` (:567), which serves a TFDS-format directory of
TFRecord shards (``data/tfrecord.py``: no tensorflow, no
tensorflow_datasets), with the ``split[a:b]`` sub-split syntax and
``label.labels.txt``; its shards are indexed in Python (the JAX package's
native indexer is not ported). ``arrayrecord`` needs grain and
``webdataset`` is not ported: both raise by name.
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
    if name == "arrayrecord":
        raise NotImplementedError("data source 'arrayrecord' needs grain, which the port does "
                                  "not use; convert the records with data/prepare.py")
    raise NotImplementedError(f"data source {name!r} is not ported yet")


class TrainIterator:
    """Batches of preprocessed records, forever, with a resumable position."""

    def __init__(self, source, pp_fn, batch_size: int, seed: int, position: int = 0,
                 rows: slice = slice(None)):
        self.source, self.pp_fn = source, pp_fn
        self.batch_size, self.seed = batch_size, seed
        self.rows = rows  # this process's rows of each global batch
        self.position = position  # records read so far
        self._order_epoch, self._order = None, None

    def _index(self, pos: int) -> int:
        n = len(self.source)
        epoch = pos // n
        if epoch != self._order_epoch:
            self._order = np.random.default_rng([self.seed, epoch]).permutation(n)
            self._order_epoch = epoch
        return int(self._order[pos % n])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        examples = []
        for pos in range(self.position, self.position + self.batch_size)[self.rows]:
            rng = np.random.default_rng([self.seed, pos])
            examples.append(self.pp_fn(dict(self.source[self._index(pos)]), rng))
        self.position += self.batch_size
        return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in examples[0]}

    def get_state(self) -> int:
        return self.position


def training(input_cfg: dict, *, seed: int = 0, position: int = 0,
             rows: slice = slice(None)):
    """(batch iterator, number of examples) for the config's input section;
    the iterator yields `rows` of each global batch."""
    import_pp_modules()
    source = get_source(input_cfg["data"])
    return (TrainIterator(source, build_pp_fn(input_cfg["pp"]), input_cfg["batch_size"], seed,
                          position, rows), len(source))


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


class _Preprocessed:
    """source[i] through the pp string with record i's generator: a
    DataLoader dataset of plain data (the pp fn is built in each process
    from its string), so spawned worker processes can take it."""

    def __init__(self, source, pp_string: str, seed: int):
        self.source, self.pp_string, self.seed = source, pp_string, seed
        self._pp_fn = self._build()  # an unknown op raises here, in the caller's process

    def _build(self):
        import_pp_modules()
        return build_pp_fn(self.pp_string) if self.pp_string else (lambda d, r: d)

    def __getstate__(self):
        return {**self.__dict__, "_pp_fn": None}

    def __len__(self):
        return len(self.source)

    def __getitem__(self, i: int) -> dict:
        if self._pp_fn is None:
            self._pp_fn = self._build()
        return self._pp_fn(dict(self.source[i]), np.random.default_rng([self.seed, i]))


def _as_is(example):
    return example


def _stack(examples: Sequence[dict]) -> dict:
    keys = examples[0].keys()
    return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}


def make_for_inference(source, pp_string: str, batch_size: int, *, seed: int = 0,
                       num_workers: int = 0):
    """Eval pipeline: a function giving one epoch's iterator of batches, the
    last one zero-padded, a ``_mask`` key (1 for real rows) on every batch.
    One process reads the whole source.

    With ``num_workers > 0`` the pp runs in that many spawned worker
    processes of a ``torch.utils.data.DataLoader`` (spawned, not forked: the
    caller may hold threads), the records in order.
    """
    n_steps = -(-len(source) // batch_size)
    data = _Preprocessed(source, pp_string, seed)

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
            if len(buf) == batch_size:
                yield _stack(buf)
                yielded += 1
                pad = pad or {k: np.zeros_like(v) for k, v in buf[-1].items()}
                buf = []
        if buf:
            pad = {k: np.zeros_like(v) for k, v in buf[-1].items()}
        while yielded < n_steps:
            while len(buf) < batch_size:
                buf.append(dict(pad))
            yield _stack(buf)
            yielded += 1
            buf = []

    return iterate
