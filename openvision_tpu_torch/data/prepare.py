"""Dataset preparation CLI: a raw image tree -> TFDS-format TFRecord shards.

The port's copy of ``openvision_tpu/data/prepare.py``: it turns a
``<root>/<class_dir>/<img>`` tree (the ImageNet val layout) into sharded
TFRecord files and ``label.labels.txt`` that ``TfdsDirectorySource`` serves
and the disclf evaluator reads through ``data_dir=<out>``. It writes through
``data/tfrecord.py`` (no tensorflow): real masked-crc32c fields, so readers
that verify them accept the shards too.

Records carry {image: the encoded file's bytes, label: int64 (the class
directory's index in sorted order, the ImageNet wnid convention),
file_name: bytes}; record i goes to shard i % shards.

Usage:
  python -m openvision_tpu_torch.data.prepare --src /data/imagenet/val \
      --out /data/in1k_val_tfrecord --split validation [--shards 64]
"""

from __future__ import annotations

import argparse
import os

from openvision_tpu_torch.data import tfrecord

IMG_EXTS = (".jpeg", ".jpg", ".png", ".webp", ".bmp")


def _example(image_bytes: bytes, label: int, fname: str) -> bytes:
    return tfrecord.serialize_example(
        {"image": image_bytes, "label": int(label), "file_name": fname.encode()})


def prepare(src: str, out: str, split: str = "validation",
            shards: int = 64, name: str = "dataset") -> int:
    """Converts the tree; returns the number of records written."""
    classes = sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))
    if not classes:
        raise SystemExit(f"no class directories under {src}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "label.labels.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")

    files: list[tuple[str, int]] = []
    for li, cdir in enumerate(classes):
        cpath = os.path.join(src, cdir)
        for fn in sorted(os.listdir(cpath)):
            if fn.lower().endswith(IMG_EXTS):
                files.append((os.path.join(cpath, fn), li))
    shards = max(1, min(shards, len(files)))

    handles = [tfrecord.TFRecordWriter(
        os.path.join(out, f"{name}-{split}.tfrecord-{i:05d}-of-{shards:05d}"))
        for i in range(shards)]
    try:
        for i, (path, label) in enumerate(files):
            with open(path, "rb") as imgf:
                payload = _example(imgf.read(), label, os.path.basename(path))
            handles[i % shards].write(payload)
    finally:
        for h in handles:
            h.close()
    return len(files)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--src", required=True, help="root of <class_dir>/<image> tree")
    parser.add_argument("--out", required=True)
    parser.add_argument("--split", default="validation")
    parser.add_argument("--shards", type=int, default=64)
    parser.add_argument("--name", default="dataset")
    args = parser.parse_args(argv)
    n = prepare(args.src, args.out, args.split, args.shards, args.name)
    print(f"wrote {n} records to {args.out} ({args.shards} shards, split {args.split!r})")


if __name__ == "__main__":
    main()
