"""The port's ArrayRecord reader (``data/arrayrecord.py``) against grain's
``ArrayRecordDataSource`` (the JAX pipeline's ``arrayrecord`` source) on
files written here by ``array_record``'s writer: its default (zstd, one
chunk of 65536 records), ``uncompressed``, ``group_size:1`` and
``group_size:64``, records of 0 to 3000 bytes crossing the 64 KiB block
headers; several files in one source; the committed fixtures
(``tests/fixtures/make_arrayrecord_fixture.py``) against the records they
were written from. Bytes must be equal. Brotli and snappy chunks raise by
name.
"""

import importlib.util
import os

import grain.python as grain
import numpy as np
import pytest
from array_record.python.array_record_module import ArrayRecordWriter

from openvision_tpu_torch.data import pipeline
from openvision_tpu_torch.data.arrayrecord import ArrayRecordSource

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _write(path, records, options):
    w = ArrayRecordWriter(str(path), options)
    for r in records:
        w.write(r)
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(1)
    return [rng.bytes(int(rng.integers(0, 3001))) for _ in range(160)]


@pytest.mark.parametrize("options", ["", "uncompressed", "group_size:1", "group_size:64",
                                     "uncompressed,group_size:64"])
def test_reader_gives_grains_bytes(tmp_path, records, options):
    path = _write(tmp_path / "a.ar", records, options)
    got, want = ArrayRecordSource([path]), grain.ArrayRecordDataSource([path])
    assert len(got) == len(want) == len(records)
    order = np.random.default_rng(0).permutation(len(records))  # random access
    for i in order:
        assert got[int(i)] == want[int(i)] == records[i]
    assert got[-1] == records[-1]


def test_several_files_and_the_pipeline_source(tmp_path, records):
    paths = [_write(tmp_path / "a.ar", records[:70], "group_size:1"),
             _write(tmp_path / "b.ar", records[70:], "group_size:64")]
    src = pipeline.get_source({"name": "arrayrecord", "paths": paths})
    want = grain.ArrayRecordDataSource(paths)
    assert isinstance(src, ArrayRecordSource) and len(src) == len(want) == 160
    assert [src[i] for i in range(160)] == [want[i] for i in range(160)]
    with pytest.raises(IndexError):
        src[160]


def test_committed_fixtures_hold_their_records():
    spec = importlib.util.spec_from_file_location(
        "make_arrayrecord_fixture", os.path.join(FIXTURES, "make_arrayrecord_fixture.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    want = gen.fixture_records()
    for name in gen.FILES:
        src = ArrayRecordSource(os.path.join(FIXTURES, "arrayrecord", name))
        assert [src[i] for i in range(len(src))] == want, name


@pytest.mark.parametrize("codec,name", [("brotli", "Brotli"), ("snappy", "snappy")])
def test_other_codecs_raise_by_name(tmp_path, records, codec, name):
    path = _write(tmp_path / "c.ar", records[:4], f"{codec},group_size:1")
    with pytest.raises(ValueError, match=f"a {name}-compressed chunk"):
        ArrayRecordSource([path])[0]
