"""Generates unicode_tables.h for the native WordPiece tokenizer (the port's
copy of ``openvision_tpu/native/gen_tables.py``; ``native/build.py`` runs
:func:`main` into the build directory).

The C++ tokenizer must make exactly the same character decisions as
data/tokenizer.py, which uses Python's unicodedata. Rather than bundling ICU,
this script derives compact range tables and a lower+NFD-strip-accents
mapping FROM unicodedata itself at build time, so the two implementations
agree by construction.

Emitted tables:
- WS_RANGES: Zs category (plus the explicit \\t\\n\\r\\x20 handled in C++)
- CTRL_RANGES: C* categories minus \\t\\n\\r
- PUNCT_RANGES: P* categories (the ASCII blocks are also hardcoded in C++)
- SPLIT_RANGES: what str.split() splits on (str.isspace): after the
  cleanup's controls and Zs, that leaves the line and paragraph
  separators U+2028 and U+2029, which the Python path splits words at
- LOWER_MAP: cp -> up-to-3 output cps for chars where
  strip_accents(NFD(lower(c))) != c  (identity elsewhere)

Scans the full Unicode range (0..0x10FFFF); runs in a few seconds.
"""

from __future__ import annotations

import sys
import unicodedata


def _ranges(pred):
    out = []
    start = None
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            ok = False
        else:
            ok = pred(chr(cp))
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, 0x10FFFF))
    return out


def _transform(ch: str) -> str:
    """lower + NFD + drop Mn — the per-token transform of basic_tokenize."""
    return "".join(
        c for c in unicodedata.normalize("NFD", ch.lower())
        if unicodedata.category(c) != "Mn"
    )


def main(out_path: str = "unicode_tables.h"):
    ws = _ranges(lambda c: unicodedata.category(c) == "Zs")
    ctrl = _ranges(
        lambda c: c not in "\t\n\r" and unicodedata.category(c).startswith("C")
    )
    punct = _ranges(lambda c: unicodedata.category(c).startswith("P"))
    split = _ranges(str.isspace)
    mn = _ranges(lambda c: unicodedata.category(c) == "Mn")

    lower_map = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        t = _transform(ch)
        if t != ch:
            cps = [ord(c) for c in t]
            assert len(cps) <= 3, (cp, cps)
            cps += [0] * (3 - len(cps))
            lower_map.append((cp, cps))

    def fmt_ranges(name, rr):
        body = ",".join(f"{{{a},{b}}}" for a, b in rr)
        return (
            f"static const CpRange {name}[] = {{{body}}};\n"
            f"static const int {name}_N = {len(rr)};\n"
        )

    with open(out_path, "w") as f:
        f.write("// Auto-generated by gen_tables.py — do not edit.\n")
        f.write(f"// Python {sys.version.split()[0]}, "
                f"unicodedata {unicodedata.unidata_version}\n")
        f.write("#pragma once\n#include <cstdint>\n")
        f.write("struct CpRange { uint32_t lo, hi; };\n")
        f.write("struct LowerEntry { uint32_t cp; uint32_t out[3]; };\n")
        f.write(fmt_ranges("WS_RANGES", ws))
        f.write(fmt_ranges("CTRL_RANGES", ctrl))
        f.write(fmt_ranges("PUNCT_RANGES", punct))
        f.write(fmt_ranges("SPLIT_RANGES", split))
        f.write(fmt_ranges("MN_RANGES", mn))
        body = ",".join(
            f"{{{cp},{{{o[0]},{o[1]},{o[2]}}}}}" for cp, o in lower_map
        )
        f.write(f"static const LowerEntry LOWER_MAP[] = {{{body}}};\n")
        f.write(f"static const int LOWER_MAP_N = {len(lower_map)};\n")
    print(f"wrote {out_path}: ws={len(ws)} ctrl={len(ctrl)} "
          f"punct={len(punct)} split={len(split)} mn={len(mn)} lower={len(lower_map)}")


if __name__ == "__main__":
    main(*sys.argv[1:])
