"""Writes the ArrayRecord fixtures that tests/test_torch_arrayrecord.py and
chip_smoke.py read, with the ``array_record`` package's writer:

- ``arrayrecord/zstd_g1.ar``: the writer's default compression (zstd),
  ``group_size:1`` (one chunk a record, as grain asks for);
- ``arrayrecord/uncompressed_g16.ar``: ``uncompressed,group_size:16``.

Both hold :func:`fixture_records` (48 records of 0 to 400 bytes drawn from
seed 0), so a reader can hold what it reads against them without the
writer. Run from the repo root: ``python tests/fixtures/make_arrayrecord_fixture.py``.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = {"zstd_g1.ar": "group_size:1", "uncompressed_g16.ar": "uncompressed,group_size:16"}


def fixture_records() -> list:
    rng = np.random.default_rng(0)
    return [rng.bytes(int(rng.integers(0, 401))) for _ in range(48)]


def main() -> None:
    from array_record.python.array_record_module import ArrayRecordWriter

    out = os.path.join(HERE, "arrayrecord")
    os.makedirs(out, exist_ok=True)
    for name, options in FILES.items():
        w = ArrayRecordWriter(os.path.join(out, name), options)
        for record in fixture_records():
            w.write(record)
        w.close()
        print(f"wrote arrayrecord/{name} ({options})")


if __name__ == "__main__":
    main()
