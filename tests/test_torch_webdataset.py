"""The webdataset source, the input workers and the pipeline options against
the JAX package, on the CPU.

- ``WebdatasetTarSource`` on a tar fixture with png, jpg, txt and json
  members (two shards, keys out of order, a record without txt): every
  record equal to the JAX source's, index by index (the image bytes
  untouched under "jpg", txt decoded, json merged without overwriting,
  llava_caption defaulting to txt); ``get_source`` by ``paths`` and by the
  sorted glob of ``pattern``; the fds dropped when pickled;
- the training pipeline on it: batches of preprocessed records (a PNG
  member decoded by ``decode_png``) equal with ``num_workers`` 0 and 2, and
  equal again after a resume by ``position`` (exact);
- ``training_mixture``: the same order of components as the JAX mixture
  for the same seed and weights;
- ``input.mixup.enabled``: the batch mixed by ``mixup_cutmix`` with the
  generator of the seed and the batch's position.
"""

import io
import json
import pickle
import tarfile

import ml_collections
import numpy as np
import pytest

from openvision_tpu.data import pipeline as jpipe
from openvision_tpu_torch.data import pipeline as tpipe
from openvision_tpu_torch.data.ops_aug import mixup_cutmix
from openvision_tpu_torch.data.ops_image import decode_png, encode_png
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

PP = ('inception_crop(inkey="jpg", size=16, area_min=40)'
      '|my_bert_tokenize(max_len=12, output_token_len=8, '
      'vocab_path="assets/bert_base_vocab_bos_eos.txt", add_bos=True, add_eos=True, '
      'key1="txt", key2="llava_caption")|get_autoreg_label(pad_token=0)'
      '|keep("image", "labels1", "labels2", "autoreg_labels", "cap_loss_mask")')


def _member(tf, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _jpeg(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


def write_shard(path: str, keys, seed: int) -> None:
    """Records of a 20x28 image (PNG for even keys, JPEG for odd), a txt and
    a json; key 3 has no txt, key 5's json carries its own txt."""
    with tarfile.open(path, "w") as tf:
        for k in keys:
            img = np.random.default_rng(seed + k).integers(0, 255, (20, 28, 3), np.uint8)
            if k % 2 == 0:
                _member(tf, f"{k:06d}.png", encode_png(img))
            else:
                _member(tf, f"{k:06d}.jpg", _jpeg(img))
            if k != 3:
                _member(tf, f"{k:06d}.txt", f"caption number {k}".encode())
            meta = {"llava_caption": f"long caption {k}.", "uid": k}
            if k == 5:
                meta["txt"] = "from the json"
            _member(tf, f"{k:06d}.json", json.dumps(meta).encode())


@pytest.fixture
def shards(tmp_path):
    a, b = str(tmp_path / "shard-0001.tar"), str(tmp_path / "shard-0000.tar")
    write_shard(a, [4, 2, 3, 5], seed=0)
    write_shard(b, [0, 1, 6, 7, 8, 9, 10, 11], seed=0)
    return [a, b]


def test_records_equal_the_jax_source(shards):
    want = jpipe.WebdatasetTarSource(shards)
    got = tpipe.WebdatasetTarSource(shards)
    assert len(got) == len(want) == 12
    assert repr(got) == repr(want)
    for i in range(len(want)):
        assert got[i] == want[i], i
    # a shard's keys in sorted order: 2, 3, 4, 5
    assert got[1]["txt"] == "" and got[1]["llava_caption"] == "long caption 3."
    assert got[3]["txt"] == "caption number 5"  # a txt member wins over the json's
    assert got[3]["uid"] == 5
    assert decode_png(got[2]["jpg"]).shape == (20, 28, 3)  # key 4, a PNG member
    state = pickle.loads(pickle.dumps(got))
    assert state._fds == {} and state[5] == want[5]


def test_get_source_by_paths_and_pattern(shards, tmp_path):
    by_paths = tpipe.get_source({"name": "webdataset", "paths": shards})
    by_glob = tpipe.get_source({"name": "webdataset",
                                "pattern": str(tmp_path / "shard-*.tar")})
    jax_glob = jpipe.get_source({"name": "webdataset",
                                 "pattern": str(tmp_path / "shard-*.tar")})
    assert len(by_paths) == len(by_glob) == 12
    assert by_glob[0] == jax_glob[0] == by_paths[4]  # the glob sorts shard-0000 first
    with pytest.raises(ValueError, match="Unknown data source"):
        tpipe.get_source({"name": "nope"})


def _input(shards, **kw):
    return {"data": {"name": "webdataset", "paths": shards}, "batch_size": 4, "pp": PP, **kw}


def test_batches_equal_with_and_without_workers(shards):
    plain, n = tpipe.training(_input(shards), seed=3)
    workers, _ = tpipe.training(_input(shards, num_workers=2), seed=3)
    assert n == 12 and workers.num_workers == 2
    try:
        seen = []
        for _ in range(5):  # past an epoch boundary
            a, b = next(plain), next(workers)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            seen.append(a)
        assert seen[0]["image"].shape == (4, 16, 16, 3)
        # a resume at a checkpointed position gives the next batch again
        workers.position = 8
        again = next(workers)
        for k in again:
            np.testing.assert_array_equal(again[k], seen[2][k], err_msg=k)
        assert workers.get_state() == 12
    finally:
        workers.close()
    assert workers._pool is None


def test_training_mixture_order_matches_jax():
    weights = [0.2, 0.5, 0.3]
    cfgs = [{"data": {"name": "synthetic", "num_examples": 16, "res": 4 + 4 * i},
             "batch_size": 2, "pp": 'keep("jpg")'} for i in range(3)]
    jax_cfgs = [ml_collections.ConfigDict(c) for c in cfgs]
    jmix, jn = jpipe.training_mixture(jax_cfgs, weights, seed=11)
    tmix, tn = tpipe.training_mixture(cfgs, weights, seed=11)
    assert jn == tn == 48
    jit, tit = iter(jmix), iter(tmix)
    want = [next(jit)["jpg"].shape[1] for _ in range(24)]
    got = [next(tit)["jpg"].shape[1] for _ in range(24)]
    assert got == want and len(set(got)) == 3


def test_mixup_applies_after_batching():
    rng = np.random.default_rng(0)
    source = tpipe.DictSource({"image": rng.integers(0, 255, (8, 6, 6, 3)).astype(np.uint8),
                               "labels": rng.integers(0, 5, (8,))})
    pp = 'keep("image", "labels")'
    plain = tpipe.TrainIterator(source, pp, 4, seed=2)
    mixed = tpipe.TrainIterator(source, pp, 4, seed=2,
                                mixup=dict(num_classes=5, switch_prob=0.5))
    for start in (0, 4, 8):
        batch, got = next(plain), next(mixed)
        want = mixup_cutmix(batch["image"], batch["labels"], np.random.default_rng([2, start, 1]),
                            num_classes=5, switch_prob=0.5)
        np.testing.assert_array_equal(got["image"], want[0])
        np.testing.assert_array_equal(got["labels"], want[1])
        assert got["labels"].shape == (4, 5)
