"""The training input pipeline in plain Python and numpy.

Counterpart of ``openvision_tpu/data/pipeline.py``'s ``SyntheticClipSource``
(:42-70) and ``training`` (:208-242) without grain (the card's machine has
none): records are read in a shuffled order that repeats forever, each one
preprocessed by the config's pp string (``data/pp.py``) with its own
``np.random.Generator``, and batched by stacking. The order and every
record's generator derive from the seed and the record's position in the
stream, so a run is reproducible and its position (the count of records
read) is all a checkpoint needs to resume on the exact next batch; grain's
own shuffle and per-record seeds are not reproduced. Only the ``synthetic``
source is ported.

On a process mesh each process reads only its rows of every global batch
(``rows``, its (data, fsdp) shard: ``parallel.Mesh.batch_rows``): the same
records, with the same generators, that the one-process loader puts there;
the position still counts the global batch's records.
"""

from __future__ import annotations

import numpy as np

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


def get_source(data_cfg: dict) -> SyntheticClipSource:
    name = data_cfg.get("name", "synthetic")
    if name != "synthetic":
        raise NotImplementedError(f"data source {name!r} is not ported yet (only synthetic)")
    return SyntheticClipSource(num_examples=data_cfg.get("num_examples", 1024),
                               height=data_cfg.get("res", 64), width=data_cfg.get("res", 64))


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
