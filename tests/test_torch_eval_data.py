"""The port's inference data path against the JAX package's, on the CPU.

- TFRecord shards: the port's ``TfdsDirectorySource`` gives records equal to
  JAX's on shards JAX's ``prepare`` wrote (through tensorflow here), and
  JAX's reader gives records equal to the port's on shards the port's
  ``prepare`` wrote (no tensorflow); the masked crc32c equals JAX's per-byte
  loop on random payloads; ``tf.train.Example`` bytes written by protobuf
  (packed and unpacked lists, negative int64s, several features) parse to
  what JAX's reader returns, and the port's encoding parses back through
  protobuf to the same values. Exact equality throughout.
- ``make_for_inference``: 7 records at batch 4 give the batches and
  ``_mask`` of JAX's (grain) pipeline exactly, in one process and with two
  DataLoader workers.
- The PNG decoder is bit-equal to PIL's ``convert("RGB")`` on the testcat
  images and on generated RGB / RGBA PNGs that use all five row filters;
  without Pillow, a JPEG raises an ImportError naming Pillow.
- Each eval pp op equals JAX's exactly on the same input.
"""

import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from openvision_tpu.data import pipeline as jpipe
from openvision_tpu.data import pp as jpp
from openvision_tpu.data import prepare as jprepare
from openvision_tpu_torch.data import ops_image as tops
from openvision_tpu_torch.data import pipeline as tpipe
from openvision_tpu_torch.data import pp as tpp
from openvision_tpu_torch.data import prepare as tprepare
from openvision_tpu_torch.data import tfrecord
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "assets", "bert_base_vocab_bos_eos.txt")


def _same(a, b):
    """Records (dicts of bytes / ints / floats / lists) equal by value."""
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, list):
            assert isinstance(vb, list) and len(va) == len(vb), k
            assert all(x == y for x, y in zip(va, vb)), k
        else:
            assert va == vb, k


# ---------------------------------------------------------------------------
# crc32c and the record framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 8, 255, 1024, 1025, 4097, 70_001])
def test_masked_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tfrecord.masked_crc32c(data) == jprepare._masked_crc32c(data)


def test_crc32c_check_value():
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the crc32c standard check value


def test_frame_matches_jax_writer(tmp_path):
    payloads = [b"", b"x", bytes(range(256)) * 9]
    path = tmp_path / "r.tfrecord"
    with open(path, "wb") as f:
        for p in payloads:
            jprepare._write_record(f, p)
    raw = path.read_bytes()
    assert raw == b"".join(tfrecord.frame(p) for p in payloads)
    assert [raw[o:o + n] for o, n in tfrecord.index_records(str(path))] == payloads


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------


def _jax_parse(payload: bytes) -> dict:
    """JAX's reader on one payload (TfdsDirectorySource.__getitem__'s body)."""
    from tensorflow.core.example import example_pb2

    ex = example_pb2.Example.FromString(payload)
    out = {}
    for name, feat in ex.features.feature.items():
        kind = feat.WhichOneof("kind")
        if kind == "bytes_list":
            vals = list(feat.bytes_list.value)
        elif kind == "int64_list":
            vals = [int(v) for v in feat.int64_list.value]
        elif kind == "float_list":
            vals = [float(v) for v in feat.float_list.value]
        else:
            continue
        out[name] = vals[0] if len(vals) == 1 else vals
    return out


def _proto_examples():
    from tensorflow.core.example import example_pb2

    exs = []
    ex = example_pb2.Example()
    ex.features.feature["image"].bytes_list.value.append(b"\x89PNG\x00\xff" * 50)
    ex.features.feature["label"].int64_list.value.append(7)
    ex.features.feature["file_name"].bytes_list.value.append(b"a.png")
    exs.append(ex.SerializeToString())
    ex = example_pb2.Example()
    ex.features.feature["neg"].int64_list.value.extend([-1, -(2**63), 2**63 - 1, 0, 300])
    ex.features.feature["f"].float_list.value.extend([0.1, -2.5, 1e30, 3.0])
    ex.features.feature["f1"].float_list.value.append(0.1)
    ex.features.feature["caps"].bytes_list.value.extend([b"one", b"", "été".encode()])
    ex.features.feature["empty"].bytes_list.SetInParent()
    ex.features.feature["unset"].SetInParent()
    exs.append(ex.SerializeToString())
    return exs


def _unpacked_example() -> bytes:
    """int64s and floats one a field (unpacked), map entries value-first."""
    def varint(v):
        v &= (1 << 64) - 1
        out = bytearray()
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
        return bytes(out)

    def ld(field, body):
        return varint((field << 3) | 2) + varint(len(body)) + body

    ints = b"".join(varint(1 << 3) + varint(v) for v in (5, -3, 1 << 40))
    floats = b"".join(varint((1 << 3) | 5) + struct.pack("<f", v) for v in (0.5, -1.25))
    entries = (ld(1, ld(2, ld(3, ints)) + ld(1, b"ids"))  # value before key
               + ld(1, ld(1, b"w") + ld(2, ld(2, floats))))
    return ld(1, entries)


@pytest.mark.parametrize("which", [0, 1, "unpacked"])
def test_parse_example_matches_jax_reader(which):
    payload = _unpacked_example() if which == "unpacked" else _proto_examples()[which]
    _same(tfrecord.parse_example(payload), _jax_parse(payload))


def test_serialized_example_parses_back_through_protobuf():
    feats = {"image": b"\x00\x01" * 40, "label": 3, "neg": [-5, 2**62], "f": [0.25, -1.5],
             "name": "x.png", "caps": [b"a", b"bb"]}
    payload = tfrecord.serialize_example(feats)
    want = {"image": b"\x00\x01" * 40, "label": 3, "neg": [-5, 2**62], "f": [0.25, -1.5],
            "name": b"x.png", "caps": [b"a", b"bb"]}
    _same(_jax_parse(payload), want)
    _same(tfrecord.parse_example(payload), want)


# ---------------------------------------------------------------------------
# prepare and TfdsDirectorySource, both ways
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("n01", "n02", "n03")):
        os.makedirs(root / cls)
        for i in range(3 + c):
            arr = rng.integers(0, 255, (20 + i, 30 - i, 3), np.uint8)
            fmt = "PNG" if (i + c) % 2 else "JPEG"
            Image.fromarray(arr).save(root / cls / f"img{i}.{fmt.lower()}", fmt)
    (root / "n01" / "notes.txt").write_text("not an image")
    return str(root)


def _records(src):
    return [src[i] for i in range(len(src))]


def test_port_reads_shards_jax_prepare_wrote(image_tree, tmp_path):
    out = str(tmp_path / "jax")
    n = jprepare.prepare(image_tree, out, split="validation", shards=2)
    port = tpipe.TfdsDirectorySource(out, "validation")
    jax_src = jpipe.TfdsDirectorySource(out, "validation")
    assert len(port) == len(jax_src) == n == 12
    for a, b in zip(_records(port), _records(jax_src)):
        _same(a, b)
    assert port.label_names == jax_src.label_names == ["n01", "n02", "n03"]
    sub = tpipe.TfdsDirectorySource(out, "validation[2:5]")
    for a, b in zip(_records(sub), _records(jpipe.TfdsDirectorySource(out, "validation[2:5]"))):
        _same(a, b)
    assert len(sub) == 3


def test_jax_reads_shards_port_prepare_wrote(image_tree, tmp_path):
    out = str(tmp_path / "port")
    n = tprepare.prepare(image_tree, out, split="validation", shards=3)
    port = tpipe.TfdsDirectorySource(out, "validation")
    jax_src = jpipe.TfdsDirectorySource(out, "validation")
    assert len(port) == len(jax_src) == n
    for a, b in zip(_records(port), _records(jax_src)):
        _same(a, b)
    jout = str(tmp_path / "jax")
    jprepare.prepare(image_tree, jout, split="validation", shards=3)
    for a, b in zip(_records(port), _records(tpipe.TfdsDirectorySource(jout, "validation"))):
        _same(a, b)
    for name in sorted(os.listdir(out)):  # the real masked crcs, record by record
        path = os.path.join(out, name)
        if "tfrecord" not in name:
            continue
        raw = open(path, "rb").read()
        for off, length in tfrecord.index_records(path):
            head, payload = raw[off - 12:off - 4], raw[off:off + length]
            assert struct.unpack("<I", raw[off - 4:off])[0] == jprepare._masked_crc32c(head)
            assert (struct.unpack("<I", raw[off + length:off + length + 4])[0]
                    == jprepare._masked_crc32c(payload))


def test_prepare_cli_and_get_source(image_tree, tmp_path, capsys):
    out = str(tmp_path / "cli")
    tprepare.main(["--src", image_tree, "--out", out, "--split", "validation", "--shards", "2"])
    assert "wrote 12 records" in capsys.readouterr().out
    src = tpipe.get_source({"name": "tfds", "data_dir": out, "split": "validation[:5]"})
    assert len(src) == 5
    assert len(tpipe.get_source({"name": "arrayrecord", "paths": []})) == 0  # data/arrayrecord.py


def test_jsonl_and_dict_sources_match_jax(image_tree, tmp_path):
    rows = [{"image": "n01/img0.jpeg", "txt": "a"}, {"image": "n02/img1.jpeg", "txt": "b"}]
    path = tmp_path / "x.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    cfg = {"name": "jsonl", "path": str(path), "image_root": image_tree}
    for a, b in zip(_records(tpipe.get_source(cfg)), _records(jpipe.get_source(cfg))):
        _same(a, b)
    data = {"image": np.arange(24).reshape(4, 6), "label": np.arange(4)}
    for a, b in zip(_records(tpipe.DictSource(data)), _records(jpipe.DictSource(data))):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# make_for_inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [0, 2])
def test_make_for_inference_matches_jax(workers):
    rng = np.random.default_rng(3)
    data = {"image": rng.integers(0, 255, (7, 12, 10, 3), np.uint8),
            "label": rng.integers(0, 5, (7,))}
    pp = "central_crop(8)|value_range(-1, 1)"
    want = list(jpipe.make_for_inference(jpipe.DictSource(data), pp, 4)())
    got = list(tpipe.make_for_inference(tpipe.DictSource(data), pp, 4, num_workers=workers)())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert got[1]["_mask"].tolist() == [1, 1, 1, 0]


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _png(arr: np.ndarray, filters) -> bytes:
    """A PNG of (H, W, 3|4) uint8 with row y filtered by filters[y % len]."""
    h, w, bpp = arr.shape
    raw = bytearray()
    prev = [0] * (w * bpp)
    for y in range(h):
        cur = arr[y].reshape(-1).tolist()
        f = filters[y % len(filters)]
        out = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            out.append((x - pred) & 255)
        raw += bytes([f]) + bytes(out)
        prev = cur

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2 if bpp == 3 else 6, 0, 0, 0)
    idat = zlib.compress(bytes(raw))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr) + chunk(b"IDAT", idat[:7])
            + chunk(b"IDAT", idat[7:]) + chunk(b"IEND", b""))


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "testcat"))
                                        if f.endswith(".png")))
def test_png_decoder_bit_equal_to_pil_on_testcat(name):
    data = open(os.path.join(REPO, "testcat", name), "rb").read()
    assert tops.png_is_plain(data)
    assert np.array_equal(tops.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("bpp", [3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_decoder_bit_equal_to_pil_on_every_filter(bpp, filters):
    arr = np.random.default_rng(bpp * 10 + len(filters)).integers(0, 256, (9, 13, bpp), np.uint8)
    arr[:, :4] = 250  # runs where the filters' sums wrap past 255
    data = _png(arr, filters)
    assert np.array_equal(_pil_rgb(data), arr[..., :3])
    assert np.array_equal(tops.decode_png(data), arr[..., :3])
    assert np.array_equal(tops._to_image_array(data), arr[..., :3])


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_png_decoder_bit_equal_to_pil_on_pil_written_pngs(mode):
    """Pillow's encoder picks each row's filter adaptively: a mix of all
    kinds, Average and Paeth undone a diagonal at a time."""
    rng = np.random.default_rng(len(mode))
    yy, xx = np.mgrid[0:45, 0:70]
    arr = np.stack([(3 * yy + 2 * xx) % 256, (yy * xx) % 256, 128 + 60 * np.sin(xx / 5)]
                   + [200 + 0 * xx] * (len(mode) - 3), -1)
    arr = (arr + rng.integers(0, 12, arr.shape)).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    data = buf.getvalue()
    assert tops.png_is_plain(data)
    raw = zlib.decompress(b"".join(c for t, c in tops._png_chunks(data) if t == b"IDAT"))
    filters = set(np.frombuffer(raw, np.uint8).reshape(45, -1)[:, 0].tolist())
    assert filters & {3, 4} and len(filters) > 1
    assert np.array_equal(tops.decode_png(data), _pil_rgb(data))
    assert np.array_equal(tops.decode_png(data), arr[..., :3])


def test_other_images_need_pillow(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "JPEG")
    jpeg = buf.getvalue()
    gray = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(gray, "PNG")
    assert not tops.png_is_plain(gray.getvalue())
    monkeypatch.setitem(sys.modules, "PIL", None)
    for data in (jpeg, gray.getvalue()):
        with pytest.raises(ImportError, match="Pillow"):
            tops._to_image_array(data)
    png = _png(np.ones((3, 5, 3), np.uint8), (1,))
    assert tops._to_image_array(png).shape == (3, 5, 3)  # no Pillow needed


# ---------------------------------------------------------------------------
# pp ops
# ---------------------------------------------------------------------------

PP_CASES = [
    "decode",
    "decode|resize(16)",
    "decode|resize((12, 20), method='bicubic')",
    "decode|resize_small(16, method='bilinear', antialias=True)",
    "decode|resize_small(24)|central_crop(24)",
    "decode|central_crop((10, 14))",
    "decode|vgg_value_range",
    "decode|value_range(-1, 1)",
    "decode|value_range(0, 1, 0, 255, True)",
    "decode|resize_small(24, key='image')|value_range(vmin=-2, vmax=2, inkey='image', outkey='x')",
]


@pytest.fixture(scope="module")
def pp_modules():
    jpp.import_pp_modules()
    tpp.import_pp_modules()


@pytest.mark.parametrize("spec", PP_CASES)
@pytest.mark.parametrize("kind", ["png", "jpeg", "array"])
def test_image_pp_ops_match_jax(pp_modules, spec, kind):
    arr = np.random.default_rng(1).integers(0, 256, (24, 31, 3), np.uint8)
    if kind == "array":
        image = arr
    else:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, kind.upper())
        image = buf.getvalue()
    want = jpp.build_pp_fn(spec)({"image": image}, np.random.default_rng(0))
    got = tpp.build_pp_fn(spec)({"image": image}, np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("text", ["a photo of a tench.", ["two", "captions here"],
                                  "x " * 60, b"bytes caption"])
def test_eval_tokenize_matches_jax(pp_modules, text):
    spec = (f'my_eval_bert_tokenize(inkey="texts", max_len=16, vocab_path="{VOCAB}", '
            'add_bos=True, add_eos=True)')
    want = jpp.build_pp_fn(spec)({"texts": text}, np.random.default_rng(4))
    got = tpp.build_pp_fn(spec)({"texts": text}, np.random.default_rng(4))
    assert np.array_equal(got["labels"], want["labels"])
    assert got["labels"].dtype == want["labels"].dtype


def test_clip_i1k_label_names_match_jax(pp_modules):
    for label in (0, 999, np.array([3, 17, 500])):
        want = jpp.build_pp_fn("clip_i1k_label_names")({"label": label}, None)
        got = tpp.build_pp_fn("clip_i1k_label_names")({"label": label}, None)
        assert np.array_equal(got["labels"], want["labels"])
