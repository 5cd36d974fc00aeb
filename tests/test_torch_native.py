"""The port's native WordPiece tokenizer and shard indexer
(``openvision_tpu_torch/native/``), built with g++ at first use.

The native encode is held against the port's Python path and against the
JAX package's tokenizer on the same interpreter (the Unicode tables come
from its ``unicodedata``; stored ids would tie the test to one Python
version): the 1000 ImageNet class names in three prompt templates, accents,
CJK, a capital sigma (routed to Python), the line and paragraph separators
(U+2028, U+2029: neither Zs nor controls, so the cleanup keeps them, but
str.split() ends a word there) and a text of more than 8192 ids
(past the native buffer, routed to Python). Ids must be equal. The
indexers are held against tarfile and the Python struct walk on shards
written here (GNU long names and PAX headers included). A missing library
is built again at the next call (never remembered as missing), a failed
build raises with the compiler's output, a canary mismatch raises at load,
the tokenizer pickles for the input workers, and the native encode gives
each of several threads its own ids.
"""

import io
import os
import pickle
import tarfile

import numpy as np
import pytest

from openvision_tpu.data.tokenizer import WordPieceTokenizer as JaxWordPiece
from openvision_tpu_torch.data import pipeline
from openvision_tpu_torch.data import tfrecord
from openvision_tpu_torch.data import tokenizer as ttok
from openvision_tpu_torch.evaluators.in1k_classes import CLIP_IMAGENET_CLASS_NAMES
from openvision_tpu_torch.native import build, indexer, wordpiece
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

VOCAB = "assets/bert_base_vocab_bos_eos.txt"
EXTRA = ["Hello, naïve café — ÜBER straße!", "日本語のテキスト and English 中文",
         "ΣΟΦΙΑ ΚΑΙ ΣΟΦΟΣ Σ", "emoji 🙂 ∑∫√", "control\x01chars\x7f", "ÅNGSTRÖM İstanbul ǅ ﬁ",
         "\t tabs\nnew\rlines nbsp em", "verylongwordnotinthevocabulary" * 5, "", "   ",
         "line\u2028sep\u2029para x\u2028y\x85z"]


@pytest.fixture(scope="module")
def tokenizers():
    return ttok.WordPieceTokenizer(VOCAB), JaxWordPiece(VOCAB)


def test_native_wordpiece_matches_python_and_jax(tokenizers):
    tok, jtok = tokenizers
    assert tok._native is not None
    texts = [t.format(c) for c in CLIP_IMAGENET_CLASS_NAMES
             for t in ("a photo of a {}.", "a bad photo of the {}.", "itap of my {}")] + EXTRA
    texts.append("word " * 9000)  # more than 8192 ids: the Python path
    assert tok._native.encode(texts[-1]) is None
    for text in texts:
        want = tok._encode_py(text)
        assert tok.encode(text) == want == jtok._encode_py(text), text[:60]
    native = [t for t in texts if "Σ" not in t and len(t) < 40000]
    assert all(tok._native.encode(t) == tok._encode_py(t) for t in native)


def test_native_encode_is_safe_on_threads(tokenizers):
    """The daemon tokenizes on its request threads: each thread's ids are
    those of one thread alone."""
    from concurrent.futures import ThreadPoolExecutor

    tok, _ = tokenizers
    texts = [f"a photo of a {c}, {'very ' * (i % 7)}naïve" for i, c in
             enumerate(CLIP_IMAGENET_CLASS_NAMES[:400])]
    want = [tok._encode_py(t) for t in texts]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(tok.encode, texts * 4))
    assert got == want * 4


def test_tokenizer_pickles_and_loads_its_native_path_again(tokenizers):
    tok, _ = tokenizers
    clone = pickle.loads(pickle.dumps(tok))
    assert clone._native is not None and clone._native is not tok._native
    assert clone.encode("a photo of a naïve dog") == tok.encode("a photo of a naïve dog")


def test_no_native_switch_is_the_python_path(monkeypatch):
    monkeypatch.setenv("OPENVISION_NO_NATIVE", "1")
    tok = ttok.WordPieceTokenizer(VOCAB)
    assert tok._native is None and tok.encode("a dog") == tok._encode_py("a dog")
    assert indexer.tar_index(VOCAB) is None and indexer.tfrecord_index(VOCAB) is None


def test_canary_mismatch_raises(monkeypatch):
    class Wrong:
        def encode(self, text):
            return [0]

    monkeypatch.setattr(wordpiece, "load_native", lambda path: Wrong())
    with pytest.raises(RuntimeError, match="canary"):
        ttok.WordPieceTokenizer(VOCAB)


def test_missing_library_is_built_again_and_failures_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "root")
    path = tmp_path / "one.tfrecord"
    w = tfrecord.TFRecordWriter(str(path))
    for payload in (b"a", b"bc" * 100):
        w.write(payload)
    w.close()
    want = tfrecord.index_records_py(str(path))
    assert indexer.tfrecord_index(str(path)) == want
    lib = build.library("indexer")
    assert lib.parent.parent == tmp_path / "root"
    for f in lib.parent.iterdir():  # the library goes missing
        f.unlink()
    lib.parent.rmdir()
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/indexer.cpp"):
        indexer.tfrecord_index(str(path))
    monkeypatch.delenv("CXX")
    assert indexer.tfrecord_index(str(path)) == want  # looked for, and built, again
    assert lib.exists()


def _tar(path, members):
    with tarfile.open(path, "w", format=tarfile.PAX_FORMAT) as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        d = tarfile.TarInfo("a_directory")
        d.type = tarfile.DIRTYPE
        tf.addfile(d)


def test_native_indexers_match_tarfile_and_the_struct_walk(tmp_path):
    rng = np.random.default_rng(0)
    members = [(f"{i:05d}.{ext}", rng.bytes(int(rng.integers(0, 3000))))
               for i in range(12) for ext in ("jpg", "txt", "json")]
    members.append(("deep/" + "n" * 150 + ".txt", b"long name"))  # PAX path record
    members.append(("ünïcode_name.txt", b"pax too"))
    tar = str(tmp_path / "shard.tar")
    _tar(tar, members)
    assert indexer.tar_index(tar) == pipeline.tar_members_py(tar)
    assert [m[0] for m in indexer.tar_index(tar)] == [m[0] for m in members]
    with tarfile.open(tar, "w", format=tarfile.GNU_FORMAT) as tf:  # GNU long names
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    assert indexer.tar_index(tar) == pipeline.tar_members_py(tar)
    rec = str(tmp_path / "data.tfrecord")
    w = tfrecord.TFRecordWriter(rec)
    for name, data in members:
        w.write(data)
    w.close()
    assert indexer.tfrecord_index(rec) == tfrecord.index_records_py(rec) == \
        tfrecord.index_records(rec)
    assert len(indexer.tfrecord_index(rec)) == len(members)
    with pytest.raises(OSError):  # a shard that is not there
        indexer.tar_index(str(tmp_path / "no_such.tar"))


def test_native_indexers_grow_their_buffers(tmp_path):
    """Shards with more entries than the indexer's first buffers hold (1024
    entries, 128 KiB of names): the scan is redone with larger ones and
    equals the Python scans."""
    rec = str(tmp_path / "many.tfrecord")
    w = tfrecord.TFRecordWriter(rec)
    for i in range(3000):
        w.write(b"x" * (i % 5))
    w.close()
    assert indexer.tfrecord_index(rec) == tfrecord.index_records_py(rec)
    assert len(indexer.tfrecord_index(rec)) == 3000
    tar = str(tmp_path / "many.tar")
    _tar(tar, [("d" * (i % 200) + f"/{i:05d}.txt", b"y" * (i % 3)) for i in range(1500)])
    assert indexer.tar_index(tar) == pipeline.tar_members_py(tar)
    assert len(indexer.tar_index(tar)) == 1500
