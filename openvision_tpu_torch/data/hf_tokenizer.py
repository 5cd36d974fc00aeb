"""A model dir's Hugging Face tokenizer, read and run without ``transformers``.

JAX's ``LoadedModel.tokenize`` (``openvision_tpu/tools/model_io.py:52-77``)
hands a model dir with ``tokenizer.json`` / ``tokenizer_config.json`` to
``transformers.AutoTokenizer`` and calls it with ``padding="max_length",
truncation=True, max_length=context_length``; where that raises (no pad
token, no class to load, a config without a loadable tokenizer), it falls
through to the dir's ``vocab.txt``, else the repo's vocab. The card's
machine has no ``transformers`` and no ``tokenizers``, so :func:`load`
repeats that resolution from the dir's files (nothing is downloaded) and
:class:`HFTokenizer` repeats what the ``tokenizers`` library computes; it
returns None where JAX's route raises, so the caller falls through too.

The resolution (:func:`resolve_class`): ``tokenizer_config.json``'s
``tokenizer_class``, else ``config.json``'s, else ``config.json``'s
``model_type`` through transformers' own mapping (``data/hf_classes.py``,
generated here by ``data/gen_hf_tables.py``); the fast class where one
exists. None (AutoTokenizer raises) without ``config.json``, for a name or
model type transformers does not know, and for a class it cannot load
here (SentencePiece's, without ``sentencepiece``). With ``tokenizer.json``
the tokenizer is the file's; the ``BertTokenizer`` classes write the
config's ``do_lower_case``, ``strip_accents`` and
``tokenize_chinese_chars`` over its normalizer, as ``BertTokenizerFast``
does. Without it, a ``BertTokenizer`` class builds what
``BertTokenizerFast`` builds from ``vocab.txt`` (``[CLS] ... [SEP]``,
``do_lower_case``, ``[UNK]``) and a ``CLIPTokenizer`` class what
``CLIPTokenizerFast`` converts from ``vocab.json`` + ``merges.txt``;
``PreTrainedTokenizerFast`` and a fast class whose slow class needs
``sentencepiece`` load nothing (AutoTokenizer raises); any other class
built from its own vocab files raises by name. Then, as
``PreTrainedTokenizerFast.__init__``, the config's special tokens (the
class's defaults where it names none, ``hf_classes.SPECIAL_DEFAULTS``)
that are not added tokens yet become added tokens, new ids past the vocab
for those it lacks (:class:`HFTokenizer`). The pad token is the config's
or the class's, and ``padding_side`` / ``truncation_side`` are the config's.

The pipeline, as the library runs it on each text:

- the added tokens (``added_tokens``): those not ``normalized`` matched in
  the raw text first, the others in each normalized segment by their
  normalized content (leftmost, longest), each kept whole, their ``lstrip``
  / ``rstrip`` whitespace taken with them and ``single_word`` honoured;
- the normalizer: ``NFC`` / ``NFD`` / ``NFKC`` / ``NFKD``, ``Lowercase``
  (per character, as Rust's ``to_lowercase``), ``Strip``, ``StripAccents``
  (NFD's combining marks, every ``M*`` category, dropped), ``Replace``
  (string or regex pattern), ``Prepend`` (not on an empty text), ``Nmt``
  (SentencePiece's control characters dropped and its other spaces made
  one), ``Precompiled`` (SentencePiece's charsmap: :class:`Precompiled`),
  ``ByteLevel`` (each character's UTF-8 bytes through GPT-2's table),
  ``BertNormalizer`` (``clean_text``, ``handle_chinese_chars``,
  ``strip_accents`` (``Mn`` only; unset: as ``lowercase``), ``lowercase``)
  and ``Sequence``;
- the pre-tokenizer, each splitting every piece it is given:
  ``ByteLevel`` (``add_prefix_space``, the GPT-2 split pattern under
  ``use_regex``, then each piece's UTF-8 bytes through GPT-2's
  byte-to-unicode table), ``Whitespace`` (``\\w+|[^\\w\\s]+``),
  ``WhitespaceSplit``, ``Split`` (a string or regex pattern, ``invert``,
  and each ``behavior``: ``Removed``, ``Isolated``,
  ``MergedWithPrevious``, ``MergedWithNext``, ``Contiguous``),
  ``Metaspace`` (``replacement``, ``prepend_scheme`` always / first /
  never or the older ``add_prefix_space``, ``split``), ``Punctuation``,
  ``Digits`` (ASCII digits, ``individual_digits``), ``BertPreTokenizer``,
  ``UnicodeScripts`` (cut where the script changes, the library's own
  script table, ``Any`` characters joining the piece before them),
  ``CharDelimiterSplit`` and ``Sequence``;
- the model: ``WordPiece`` (greedy longest match, ``unk_token``,
  ``continuing_subword_prefix``, ``max_input_chars_per_word``),
  ``WordLevel`` (``vocab``, ``unk_token``), ``BPE`` (``merges`` as ``"a
  b"`` strings or ``[a, b]`` pairs, applied lowest rank first, leftmost
  on a tie; ``unk_token`` with ``fuse_unk``; ``continuing_subword_prefix``
  (stripped from a merge's second half, as the library names the merged
  token); ``end_of_word_suffix`` (CLIP's ``</w>``); ``byte_fallback``
  (``<0xXX>`` pieces); ``ignore_merges``) and ``Unigram`` (Viterbi over
  the pieces' scores, an unknown character scoring the lowest score less
  10, consecutive unknowns fused into one ``unk_id``, ``byte_fallback``);
- the post-processor: ``TemplateProcessing`` (the single template),
  ``BertProcessing`` and ``RobertaProcessing`` (``cls ... sep``),
  ``ByteLevel`` (offsets only: no ids) and ``Sequence`` (each wrapping the
  last); the pieces are first truncated to ``max_length`` less the special
  tokens it adds (``truncation_side``), then padded to ``max_length``
  (``padding_side``).

Python's ``re`` has no ``\\p{L}`` / ``\\p{N}`` classes, and its ``\\s`` and
``\\w`` are not the Rust engines' (``\\s`` takes U+001C-U+001F, ``\\w``
takes the ``No`` numbers and misses the marks). :func:`translate_regex`
rewrites a pattern's ``\\p{..}`` / ``\\P{..}`` (one- or two-letter general
categories), ``\\s`` / ``\\S`` (Unicode's White_Space property) and ``\\w``
/ ``\\W`` (letters, marks, ``Nd``, ``Nl``, ``Pc`` and the two join
controls) into explicit character ranges built from this interpreter's
``unicodedata``, inside or outside a bracketed class. The scripts and the
grapheme-cluster breaks that Python's ``unicodedata`` lacks come from
``data/unicode_tables.py`` (generated by ``data/gen_hf_tables.py`` and held
there against the library and ``regex``). Any other component raises by
name.
"""

from __future__ import annotations

import base64
import bisect
import functools
import importlib
import json
import os
import re
import struct
import sys
import unicodedata

import numpy as np

from openvision_tpu_torch.data import hf_classes
from openvision_tpu_torch.data.tokenizer import _is_cjk, _is_control, _is_punctuation

# Unicode's White_Space property (Rust's char::is_whitespace)
_WHITE_SPACE = frozenset([*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                          0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")
# transformers' SPECIAL_TOKENS_ATTRIBUTES, in its order
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")
# CLIPTokenizer's split pattern (transformers' CLIPConverter)
CLIP_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
# GPT-2's split pattern (the ByteLevel pre-tokenizer's use_regex)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_NMT_DROP = frozenset([*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F])
_NMT_SPACE = frozenset([0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029,
                        0x2581, 0xFEFF, 0xFFFD])
_UNK_PENALTY = 10.0  # a Unigram unknown character scores the lowest piece's score less this


def _is_whitespace(ch: str) -> bool:
    return ord(ch) in _WHITE_SPACE


def _token_content(t) -> str | None:
    if t is None or isinstance(t, str):
        return t
    return t.get("content")


# ---------------------------------------------------------------------------
# regex translation
# ---------------------------------------------------------------------------


def _ranges(pred) -> str:
    """A bracket class body of every code point `pred` takes, as ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if pred(cp):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append((start, prev))
            start = None
    if start is not None:
        out.append((start, prev))
    esc = lambda cp: f"\\U{cp:08x}"  # noqa: E731 - a range endpoint, escaped
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in out)


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The ranges of a class: ``s`` (White_Space), ``w`` (word characters)
    or a one- or two-letter general category (``L``, ``Nd``, ...)."""
    if name == "s":
        return _ranges(lambda cp: cp in _WHITE_SPACE)
    if name == "w":
        return _ranges(lambda cp: unicodedata.category(chr(cp))[0] in "LM"
                       or unicodedata.category(chr(cp)) in ("Nd", "Nl", "Pc")
                       or cp in (0x200C, 0x200D))
    return _ranges(lambda cp: unicodedata.category(chr(cp)).startswith(name))


@functools.lru_cache(maxsize=None)
def translate_regex(pattern: str) -> "re.Pattern":
    """`pattern` (Rust / Oniguruma syntax) compiled for Python's ``re``: see
    the module doc."""
    out, i, depth = [], 0, 0  # depth: inside a bracketed class
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP" and pattern[i + 2:i + 3] == "{":
                end = pattern.index("}", i)
                body, negate = _class_body(pattern[i + 3:end]), nxt == "P"
                i = end + 1
            elif nxt in "sSwW":
                body, negate, i = _class_body(nxt.lower()), nxt.isupper(), i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if depth and negate:
                raise ValueError(f"regex {pattern!r}: a negated class inside brackets")
            out.append(body if depth else f"[{'^' if negate else ''}{body}]")
            continue
        if c == "[" and not depth:  # a class opens: copy its ^ and a leading ]
            depth, j = 1, i + 1
            j += pattern[j:j + 1] == "^"
            j += pattern[j:j + 1] == "]"
            out.append(pattern[i:j])
            i = j
            continue
        if c == "]" and depth:
            depth = 0
        out.append(c)
        i += 1
    return re.compile("".join(out))


# ---------------------------------------------------------------------------
# Unicode properties Python lacks, and grapheme clusters
# ---------------------------------------------------------------------------


class UnicodeTables:
    """Lookups in ``data/unicode_tables.py`` (generated by ``data/gen_hf_tables.py``):
    a code point's script id (0 for the library's ``Any``: unassigned; the
    fixed scripts as ``tokenizers`` folds them: Hiragana, Katakana and
    U+30FC to Han, the space to Any), grapheme-cluster break, Indic conjunct
    break and Extended_Pictographic values."""

    def __init__(self):
        t = importlib.import_module("openvision_tpu_torch.data.unicode_tables")
        self._runs = {}
        for name in ("SCRIPT", "GCB", "PICT", "INCB"):
            runs = getattr(t, f"{name}_RUNS")
            self._runs[name] = ([a for a, _ in runs], [v for _, v in runs],
                                {n: i for i, n in enumerate(getattr(t, f"{name}_NAMES"))})
        ids = self._runs["SCRIPT"][2]
        self._han, self._fold = ids["HAN"], {ids["HIRAGANA"], ids["KATAKANA"]}
        self._any = ids["UNKNOWN"]
        self.GCB = self._runs["GCB"][2]
        self.INCB = self._runs["INCB"][2]

    def _value(self, name: str, cp: int) -> int:
        starts, values, _ = self._runs[name]
        return values[bisect.bisect_right(starts, cp) - 1]

    @functools.lru_cache(maxsize=None)
    def script(self, cp: int) -> int:
        """The script UnicodeScripts splits by (``Any``: 0, splits nothing)."""
        if cp == 0x30FC:
            return self._han
        if cp == 0x20:
            return 0
        v = self._value("SCRIPT", cp)
        return 0 if v == self._any else self._han if v in self._fold else v

    @functools.lru_cache(maxsize=None)
    def gcb(self, cp: int) -> int:
        return self._value("GCB", cp)

    @functools.lru_cache(maxsize=None)
    def incb(self, cp: int) -> int:
        return self._value("INCB", cp)

    @functools.lru_cache(maxsize=None)
    def pict(self, cp: int) -> int:
        return self._value("PICT", cp)


@functools.lru_cache(maxsize=1)
def unicode_tables() -> UnicodeTables:
    return UnicodeTables()


def graphemes(s: str, tables: UnicodeTables | None = None) -> list:
    """`s` cut into UAX #29's extended grapheme clusters (GB3-GB13 with
    GB9c's Indic conjuncts), as ``unicode-segmentation`` cuts them for the
    ``tokenizers`` library."""
    if not s:
        return []
    t = tables or unicode_tables()
    g = t.GCB
    ctrl = (g["CONTROL"], g["CR"], g["LF"])
    hangul_l, hangul_t, v_t = g["L"], g["T"], (g["V"], g["T"])
    lv_lvt, v_lv = (g["V"], g["LV"], g["LVT"]), (g["LV"], g["V"])
    t_lvt, extend = (g["LVT"], g["T"]), (g["EXTEND"], g["ZWJ"])
    cons, linker, inc_ext = t.INCB["CONSONANT"], t.INCB["LINKER"], t.INCB["EXTEND"]
    out, start = [], 0
    prev = t.gcb(ord(s[0]))
    ri = 1 if prev == g["REGIONALINDICATOR"] else 0  # regional indicators in a row
    pict = bool(t.pict(ord(s[0])))  # ExtPict Extend* so far
    zwj = False  # ExtPict Extend* ZWJ just before
    conj, link = t.incb(ord(s[0])) == cons, False  # Consonant [Extend Linker]*, a Linker seen
    for i in range(1, len(s)):
        cp = ord(s[i])
        cur, inc = t.gcb(cp), t.incb(cp)
        if prev == g["CR"] and cur == g["LF"]:
            joined = True
        elif prev in ctrl or cur in ctrl:
            joined = False
        elif prev == hangul_l and cur in (hangul_l, *lv_lvt):
            joined = True
        elif (prev in v_lv and cur in v_t) or (prev in t_lvt and cur == hangul_t):
            joined = True
        elif cur in extend or cur == g["SPACINGMARK"] or prev == g["PREPEND"]:
            joined = True
        elif inc == cons and conj and link:
            joined = True
        elif zwj and t.pict(cp):
            joined = True
        else:
            joined = cur == prev == g["REGIONALINDICATOR"] and ri % 2 == 1
        if not joined:
            out.append(s[start:i])
            start = i
        ri = ri + 1 if cur == g["REGIONALINDICATOR"] else 0
        zwj = pict and cur == g["ZWJ"]
        pict = bool(t.pict(cp)) or (pict and cur == g["EXTEND"])
        if inc == cons:
            conj, link = True, False
        elif conj and inc in (linker, inc_ext):
            link = link or inc == linker
        else:
            conj = link = False
        prev = cur
    out.append(s[start:])
    return out


class Precompiled:
    """SentencePiece's ``precompiled_charsmap`` normalizer, as the
    ``tokenizers`` library runs it (``spm_precompiled``): the base64 blob is
    a little-endian u32 byte count, that many bytes of a darts-clone double
    array (u32 units), then the NUL-terminated replacement strings the
    trie's values point into. A text goes by extended grapheme clusters: a
    cluster under 6 bytes whose UTF-8 has a prefix in the trie is replaced
    whole by the shortest prefix's string; any other cluster goes character
    by character, each replaced where it has a prefix in the trie."""

    def __init__(self, charsmap: str, where: str):
        blob = base64.b64decode(charsmap or "")
        size = int.from_bytes(blob[:4], "little") // 4 if len(blob) >= 4 else -1
        if size < 0 or len(blob) < 4 + 4 * size:
            raise ValueError(f"{where}: Precompiled: cannot parse precompiled_charsmap")
        self.units = struct.unpack(f"<{size}I", blob[4:4 + 4 * size])
        self.strings = blob[4 + 4 * size:]
        self.strings.decode("utf-8")  # the library refuses a blob that is not UTF-8
        self._cache = {}

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def transform(self, chunk: str) -> str | None:
        """The replacement of `chunk`'s shortest prefix in the trie, or None."""
        if chunk in self._cache:
            return self._cache[chunk]
        units, found = self.units, None
        node = self._offset(units[0])
        for c in chunk.encode("utf-8"):
            if c == 0:
                break
            node ^= c
            unit = units[node]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            node ^= self._offset(unit)
            if (unit >> 8) & 1:  # a leaf: its value is the replacement's offset
                at = units[node] & ((1 << 31) - 1)
                found = self.strings[at:self.strings.index(b"\0", at)].decode("utf-8")
                break
        self._cache[chunk] = found
        return found

    def __call__(self, s: str) -> str:
        out = []
        for cluster in graphemes(s):
            if len(cluster.encode("utf-8")) < 6:
                rep = self.transform(cluster)
                if rep is not None:
                    out.append(rep)
                    continue
            for ch in cluster:
                rep = self.transform(ch)
                out.append(ch if rep is None else rep)
        return "".join(out)


# ---------------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------------


def _bert_normalize(text: str, clean_text, chinese, strip_accents, lowercase) -> str:
    if clean_text:
        text = "".join(" " if _is_whitespace(c) else c for c in text
                       if not (c in "\x00\ufffd" or _is_control(c)))
    if chinese:
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
    strip = lowercase if strip_accents is None else strip_accents
    if strip:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lowercase:
        text = "".join(c.lower() for c in text)
    return text


def _pattern(spec: dict) -> "re.Pattern":
    """A Replace / Split pattern: {"String": s} or {"Regex": r}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    return translate_regex(spec["Regex"])


def build_normalizer(spec, where: str, bert_overrides: dict | None = None):
    """str -> str for a normalizer spec (None: the identity)."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_normalizer(n, where, bert_overrides) for n in spec["normalizers"]]
        return lambda s: functools.reduce(lambda acc, f: f(acc), parts, s)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return lambda s: "".join(c.lower() for c in s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(s):
            lo, hi = 0, len(s)
            while left and lo < hi and _is_whitespace(s[lo]):
                lo += 1
            while right and hi > lo and _is_whitespace(s[hi - 1]):
                hi -= 1
            return s[lo:hi]

        return strip
    if kind == "StripAccents":
        return lambda s: "".join(c for c in s if unicodedata.category(c)[0] != "M")
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda m: content, s)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Nmt":
        return lambda s: "".join(" " if ord(c) in _NMT_SPACE else c for c in s
                                 if ord(c) not in _NMT_DROP)
    if kind == "Precompiled":
        return Precompiled(spec.get("precompiled_charsmap"), where)
    if kind == "ByteLevel":  # each character's UTF-8 bytes through GPT-2's table
        table = bytes_to_unicode()
        return lambda s: "".join(table[b] for b in s.encode("utf-8"))
    if kind == "BertNormalizer":
        flags = dict(clean_text=spec.get("clean_text", True),
                     chinese=spec.get("handle_chinese_chars", True),
                     strip_accents=spec.get("strip_accents"),
                     lowercase=spec.get("lowercase", True))
        flags.update(bert_overrides or {})
        return lambda s: _bert_normalize(s, **flags)
    raise ValueError(f"{where}: normalizer {kind!r} is not read by the port (it reads NFC, NFD, "
                     "NFKC, NFKD, Lowercase, Strip, StripAccents, Replace, Prepend, Nmt, "
                     "Precompiled, ByteLevel, BertNormalizer and Sequence)")


# ---------------------------------------------------------------------------
# pre-tokenizers: each maps a list of (piece, starts the text) to a new list
# ---------------------------------------------------------------------------


def _regex_matches(pat, s: str) -> list:
    """[((start, end), is_match)] covering `s`, as the library's find_matches."""
    if not s:
        return [((0, 0), False)]
    out, prev = [], 0
    for m in pat.finditer(s):
        if prev != m.start():
            out.append(((prev, m.start()), False))
        out.append(((m.start(), m.end()), True))
        prev = m.end()
    if prev != len(s):
        out.append(((prev, len(s)), False))
    return out


def _char_matches(pred, s: str) -> list:
    """[((start, end), is_match)]: each character `pred` takes a match of its own."""
    if not s:
        return [((0, 0), False)]
    out, last = [], 0
    for i, c in enumerate(s):
        if pred(c):
            if last < i:
                out.append(((last, i), False))
            out.append(((i, i + 1), True))
            last = i + 1
    if last < len(s):
        out.append(((last, len(s)), False))
    return out


def _split(s: str, matches: list, behavior: str, invert: bool = False) -> list:
    """The pieces of `s` (non-empty) under a split `behavior`."""
    if invert:
        matches = [(o, not m) for o, m in matches]
    if behavior == "Removed":
        spans = [o for o, m in matches if not m]
    elif behavior == "Isolated":
        spans = [o for o, _ in matches]
    elif behavior in ("Contiguous", "MergedWithPrevious", "MergedWithNext"):
        seq = matches[::-1] if behavior == "MergedWithNext" else matches
        acc, prev = [], False
        for (a, b), m in seq:
            merge = (m == prev) if behavior == "Contiguous" else (m and not prev)
            if merge and acc:
                lo, hi = acc[-1]
                acc[-1] = (lo, b) if behavior != "MergedWithNext" else (a, hi)
            else:
                acc.append((a, b))
            prev = m
        spans = acc[::-1] if behavior == "MergedWithNext" else acc
    else:
        raise ValueError(f"split behavior {behavior!r}")
    return [s[a:b] for a, b in spans if b > a]


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character table."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def _each(fn):
    """A pre-tokenizer that splits each piece by fn(piece, first) -> pieces;
    a piece's first part keeps its `first` flag."""
    def run(pieces):
        out = []
        for piece, first in pieces:
            out.extend((p, first and j == 0) for j, p in enumerate(fn(piece, first)))
        return out
    return run


def _script_splits(s: str, tables: UnicodeTables) -> list:
    """The UnicodeScripts pre-tokenizer's pieces: a cut before the first
    character that is not ``Any`` and before each whose script differs from
    the last such one (``Any`` characters join the piece before them); as
    in the library, what precedes the first cut is dropped."""
    cuts, last = [], None
    for i, c in enumerate(s):
        script = tables.script(ord(c))
        if script and script != last:
            cuts.append(i)
            last = script
    bounds = [*cuts, len(s)]
    return [s[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]


def build_pre_tokenizer(spec, where: str, tables: UnicodeTables | None = None):
    """[(piece, first)] -> [(piece, first)] for a pre-tokenizer spec."""
    if spec is None:
        return lambda pieces: [(p, f) for p, f in pieces if p]
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [build_pre_tokenizer(p, where, tables) for p in spec["pretokenizers"]]
        return lambda pieces: functools.reduce(lambda acc, f: f(acc), parts, pieces)
    if kind == "BertPreTokenizer":
        def bert(s, _):
            words = _split(s, _char_matches(_is_whitespace, s), "Removed")
            return [p for w in words for p in _split(w, _char_matches(_is_punctuation, w),
                                                     "Isolated")]
        return _each(bert)
    if kind == "Whitespace":
        pat = translate_regex(r"\w+|[^\w\s]+")
        return _each(lambda s, _: _split(s, _regex_matches(pat, s), "Removed", invert=True))
    if kind == "WhitespaceSplit":
        return _each(lambda s, _: _split(s, _char_matches(_is_whitespace, s), "Removed"))
    if kind == "Split":
        pat = _pattern(spec["pattern"])
        behavior, invert = spec["behavior"], spec.get("invert", False)
        return _each(lambda s, _: _split(s, _regex_matches(pat, s), behavior, invert))
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        return _each(lambda s, _: _split(s, _char_matches(_is_punctuation, s), behavior))
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits") else "Contiguous"
        return _each(lambda s, _: _split(s, _char_matches(lambda c: "0" <= c <= "9", s),
                                         behavior))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = spec.get("split", True)

        def meta(s, first):
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                s = rep + s
            if not split:
                return [s] if s else []
            return _split(s, _char_matches(lambda c: c == rep, s), "MergedWithNext")

        return _each(meta)
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)
        pat = translate_regex(GPT2_PATTERN)
        table = bytes_to_unicode()

        def byte_level(s, _):
            if prefix and s and not s.startswith(" "):
                s = " " + s
            pieces = _split(s, _regex_matches(pat, s), "Isolated") if use_regex else (
                [s] if s else [])
            return ["".join(table[b] for b in p.encode("utf-8")) for p in pieces]

        return _each(byte_level)
    if kind == "UnicodeScripts":
        t = tables or unicode_tables()
        return _each(lambda s, _: _script_splits(s, t))
    if kind == "CharDelimiterSplit":
        delim = spec["delimiter"]
        return _each(lambda s, _: _split(s, _char_matches(lambda c: c == delim, s), "Removed"))
    raise ValueError(f"{where}: pre_tokenizer {kind!r} is not read by the port (it reads "
                     "ByteLevel, Whitespace, WhitespaceSplit, Split, Metaspace, Punctuation, "
                     "Digits, BertPreTokenizer, UnicodeScripts, CharDelimiterSplit and "
                     "Sequence)")


# ---------------------------------------------------------------------------
# models: piece -> ids
# ---------------------------------------------------------------------------


class WordPiece:
    def __init__(self, spec: dict, vocab: dict):
        self.vocab = vocab
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def __call__(self, word: str) -> list:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.vocab[self.unk]]
            ids.append(cur)
            start = end
        return ids


class WordLevel:
    def __init__(self, spec: dict, vocab: dict):
        self.vocab, self.unk = vocab, spec.get("unk_token")

    def __call__(self, word: str) -> list:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocab and there is no unk token")
        return [self.vocab[self.unk]]


class BPE:
    def __init__(self, spec: dict, vocab: dict):
        self.vocab = vocab
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.ranks = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            tail = b[len(self.prefix):] if self.prefix and b.startswith(self.prefix) else b
            self.ranks[a, b] = (rank, a + tail)
        self.cache = {}

    def __call__(self, word: str) -> list:
        if not word:
            return []
        if word in self.cache:
            return self.cache[word]
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        symbols, unk = [], None  # (token string, id) in order; unk: the pending unknown
        for i, ch in enumerate(word):
            s = (self.prefix if i > 0 else "") + ch + (self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk is not None:
                    symbols.append(unk)
                    unk = None
                symbols.append((s, self.vocab[s]))
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    if unk is not None:
                        symbols.append(unk)
                        unk = None
                    symbols.extend((c, self.vocab[c]) for c in codes)
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    symbols.append(unk)
                if unk is None or not self.fuse_unk:
                    unk = (None, self.vocab[self.unk])  # an unknown merges with nothing
        if unk is not None:
            symbols.append(unk)
        while len(symbols) > 1:
            best, at = None, None
            for j in range(len(symbols) - 1):
                r = self.ranks.get((symbols[j][0], symbols[j + 1][0]))
                if r is not None and (best is None or r[0] < best[0]):
                    best, at = r, j
            if best is None:
                break
            symbols[at:at + 2] = [(best[1], self.vocab[best[1]])]
        ids = [i for _, i in symbols]
        self.cache[word] = ids
        return ids


class Unigram:
    def __init__(self, spec: dict, vocab: dict):
        pieces = spec["vocab"]
        self.scores = {p: float(s) for p, s in pieces}
        self.ids = {p: i for i, (p, _) in enumerate(pieces)}
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.unk_score = min(self.scores.values()) - _UNK_PENALTY
        self.max_len = max(len(p) for p in self.scores)
        self.cache = {}

    def _viterbi(self, s: str) -> list:
        """The best segmentation's pieces, consecutive unknowns fused."""
        n = len(s)
        best = [None] * (n + 1)  # (score, start, id) of the best path ending at i
        best[0] = (0.0, None, None)
        for i in range(n):
            if best[i] is None:
                continue
            base, single = best[i][0], False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                piece = s[i:j]
                if piece not in self.scores:
                    continue
                cand = base + self.scores[piece]
                if best[j] is None or cand > best[j][0]:
                    best[j] = (cand, i, self.ids[piece])
                single = single or j == i + 1
            if not single:
                cand = base + self.unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk_id)
        out, pending, end = [], [], n
        while end > 0:
            _, start, pid = best[end]
            if self.unk_id is not None and pid == self.unk_id:
                pending.append(s[start:end])
            else:
                if pending:
                    out.append("".join(pending[::-1]))
                    pending = []
                out.append(s[start:end])
            end = start
        if pending:
            out.append("".join(pending[::-1]))
        return out[::-1]

    def __call__(self, word: str) -> list:
        if word in self.cache:
            return self.cache[word]
        ids = []
        for piece in self._viterbi(word):
            if piece in self.ids:
                ids.append(self.ids[piece])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in piece.encode("utf-8")]
                if all(c in self.ids for c in codes):
                    ids.extend(self.ids[c] for c in codes)
                    continue
            if self.unk_id is None:
                raise ValueError(f"Unigram: {piece!r} is unknown and there is no unk_id")
            ids.append(self.unk_id)
        self.cache[word] = ids
        return ids


_MODELS = {"WordPiece": WordPiece, "WordLevel": WordLevel, "BPE": BPE, "Unigram": Unigram}


# ---------------------------------------------------------------------------
# post-processors: (ids before, ids after) the sequence
# ---------------------------------------------------------------------------


def build_post_processor(spec, where: str) -> tuple:
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind in ("BertProcessing", "RobertaProcessing"):
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "ByteLevel":
        return [], []
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                seen = True
                continue
            ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
            (after if seen else before).extend(ids)
        return before, after
    if kind == "Sequence":
        before, after = [], []
        for p in spec["processors"]:
            b, a = build_post_processor(p, where)
            before, after = b + before, after + a
        return before, after
    raise ValueError(f"{where}: post_processor {kind!r} is not read by the port (it reads "
                     "TemplateProcessing, BertProcessing, RobertaProcessing, ByteLevel and "
                     "Sequence)")


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


def _added_token(t, special: bool) -> dict:
    """An ``AddedToken`` as the fields of ``tokenizer.json``'s
    ``added_tokens`` from a config's form of it (a string, or a dict of its
    fields): a string is ``AddedToken(t, special=special)``, normalized
    unless special."""
    if isinstance(t, str):
        return {"content": t, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": not special, "special": special}
    d = {k: v for k, v in t.items() if k != "__type"}
    d["special"] = special or bool(d.get("special"))
    d.setdefault("normalized", not d["special"])
    return d


class HFTokenizer:
    """A tokenizer of the ``tokenizer.json`` form (`spec`) loaded as the
    fast class `cls` with the class config `config`; ``__call__(texts,
    max_length)`` gives (N, max_length) int32 ids as JAX's AutoTokenizer
    route does. ``pad_id`` is None without a pad token (transformers refuses
    to pad: :func:`load` falls through).

    As ``PreTrainedTokenizerFast.__init__`` after loading the file: the
    config's ``added_tokens_decoder`` entries the file lacks (by id), then
    its special tokens (``bos`` ... ``mask``, the class's defaults where
    the config names none, then ``additional_special_tokens``) that are not
    added tokens yet become added tokens: a special token in the model's
    vocab keeps its id (and is matched in the raw text from then on), one
    missing from it takes the next new id (the vocab size, or one past the
    largest added id above it). Added tokens with ``normalized`` true are
    matched in each normalized segment by their normalized content, the
    others in the raw text first."""

    def __init__(self, spec: dict, config: dict, where: str,
                 cls: str = "PreTrainedTokenizerFast"):
        model = spec.get("model") or {}
        kind = model.get("type")
        if kind not in _MODELS:
            raise ValueError(f"{where}: model type {kind!r} is not read by the port (it reads "
                             f"{', '.join(_MODELS)})")
        vocab = dict(model["vocab"]) if kind != "Unigram" else {
            p: i for i, (p, _) in enumerate(model["vocab"])}
        self.model = _MODELS[kind](model, vocab)
        self.vocab = dict(vocab)
        self.added = {}
        for t in spec.get("added_tokens") or []:
            self.added[t["content"]] = t
            self.vocab.setdefault(t["content"], t["id"])
        bert = None
        if cls in _BERT_CLASSES:  # BertTokenizerFast's override
            bert = dict(lowercase=config.get("do_lower_case", True),
                        strip_accents=config.get("strip_accents"),
                        chinese=config.get("tokenize_chinese_chars", True))
        self.normalize = build_normalizer(spec.get("normalizer"), where, bert)
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"), where)
        self.prefix_ids, self.suffix_ids = build_post_processor(spec.get("post_processor"),
                                                                where)
        defaults = hf_classes.SPECIAL_DEFAULTS.get(cls, {})
        specials = {a: config.get(a, defaults.get(a)) for a in SPECIAL_ATTRS}
        self._add_config_tokens(config, specials, len(vocab))
        self.pad_id = self.vocab.get(_token_content(specials["pad_token"]))
        self.padding_side = config.get("padding_side", "right")
        self.truncation_side = config.get("truncation_side", "right")
        self.raw = {c: t for c, t in self.added.items() if not t.get("normalized", True)}
        self.norm = {}
        for c, t in self.added.items():
            if t.get("normalized", True) and c:
                self.norm.setdefault(self.normalize(c), t)

    def _add_config_tokens(self, config: dict, specials: dict, model_size: int) -> None:
        decoder = config.get("added_tokens_decoder") or {}
        todo = [_added_token(t, False) for _, t in sorted((int(i), t) for i, t in decoder.items())
                if t["content"] not in self.added]
        seen = {*self.added, *(t["content"] for t in todo)}
        named = [t for t in specials.values() if t is not None]
        for t in named + list(config.get("additional_special_tokens") or []):
            if _token_content(t) not in seen:
                seen.add(_token_content(t))
                todo.append(_added_token(t, True))
        for t in todo:
            c = t["content"]
            if not c or c in self.added:
                continue
            if c not in self.vocab:
                top = max((a["id"] for a in self.added.values()), default=-1)
                self.vocab[c] = top + 1 if top >= model_size else model_size
            self.added[c] = dict(t, id=self.vocab[c])

    @staticmethod
    def _split_added(text: str, tokens: dict):
        """[(segment, added token or None)] in order: `tokens` (content ->
        token) matched in `text` (leftmost, longest), with their
        lstrip/rstrip spaces."""
        if not tokens:
            return [(text, None)]
        contents = sorted(tokens, key=len, reverse=True)
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((c for c in contents if text.startswith(c, i)), None)
            if hit is None:
                i += 1
                continue
            t = tokens[hit]
            if t.get("single_word") and (
                    (i > 0 and not _is_whitespace(text[i - 1]) and not _is_punctuation(text[i - 1]))
                    or (i + len(hit) < len(text) and not _is_whitespace(text[i + len(hit)])
                        and not _is_punctuation(text[i + len(hit)]))):
                i += 1
                continue
            lo, hi = i, i + len(hit)
            if t.get("lstrip"):
                while lo > start and _is_whitespace(text[lo - 1]):
                    lo -= 1
            if t.get("rstrip"):
                while hi < len(text) and _is_whitespace(text[hi]):
                    hi += 1
            if lo > start:
                out.append((text[start:lo], None))
            out.append((hit, t))
            start = i = hi
        if start < len(text):
            out.append((text[start:], None))
        return out

    def encode(self, text: str) -> list[int]:
        """The pieces' ids, before truncation and the special tokens."""
        ids = []
        for j, (segment, tok) in enumerate(self._split_added(text, self.raw)):
            if tok is not None:
                ids.append(tok["id"])
                continue
            for k, (part, ntok) in enumerate(self._split_added(self.normalize(segment),
                                                               self.norm)):
                if ntok is not None:
                    ids.append(ntok["id"])
                    continue
                for piece, _ in self.pre_tokenize([(part, j == 0 and k == 0)]):
                    ids.extend(self.model(piece))
        return ids

    def __call__(self, texts, max_length: int) -> np.ndarray:
        room = max(0, max_length - len(self.prefix_ids) - len(self.suffix_ids))
        out = np.full((len(texts), max_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > room:
                ids = ids[:room] if self.truncation_side == "right" else ids[len(ids) - room:]
            ids = (self.prefix_ids + ids + self.suffix_ids)[:max_length]
            if self.padding_side == "right":
                out[i, :len(ids)] = ids
            else:
                out[i, max_length - len(ids):] = ids
        return out


def bert_vocab_spec(vocab_path: str, config: dict) -> dict:
    """The ``tokenizer.json`` form of what ``BertTokenizerFast`` builds from
    a ``vocab.txt`` (transformers' BertConverter): BertNormalizer,
    BertPreTokenizer, WordPiece over the file's lines, ``[CLS] $A [SEP]``."""
    with open(vocab_path, encoding="utf-8") as f:
        vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
    cls = _token_content(config.get("cls_token")) or "[CLS]"
    sep = _token_content(config.get("sep_token")) or "[SEP]"
    specials = [_token_content(config.get(k)) or d for k, d in (
        ("pad_token", "[PAD]"), ("unk_token", "[UNK]"), ("cls_token", "[CLS]"),
        ("sep_token", "[SEP]"), ("mask_token", "[MASK]"))]
    return {
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False} for t in specials if t in vocab],
        "normalizer": {"type": "BertNormalizer"},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "model": {"type": "WordPiece", "vocab": vocab,
                  "unk_token": _token_content(config.get("unk_token")) or "[UNK]"},
        "post_processor": {"type": "BertProcessing", "cls": [cls, vocab[cls]],
                           "sep": [sep, vocab[sep]]},
    }


def clip_vocab_spec(model_dir: str, config: dict) -> dict | None:
    """The ``tokenizer.json`` form of what ``CLIPTokenizerFast`` builds from
    ``vocab.json`` and ``merges.txt`` (transformers' CLIPConverter over the
    slow ``CLIPTokenizer``: its first merges line skipped and at most
    48,894 read; NFC, whitespace runs made one space, lowercase; CLIP's
    split pattern then ``ByteLevel`` without a prefix space; BPE with
    ``</w>``; ``<|startoftext|> ... <|endoftext|>``), the slow class's
    special tokens added (normalized); None without the files
    (AutoTokenizer raises)."""
    paths = [os.path.join(model_dir, n) for n in ("vocab.json", "merges.txt")]
    if not all(map(os.path.exists, paths)):
        return None
    with open(paths[0], encoding="utf-8") as f:
        vocab = json.load(f)
    with open(paths[1], encoding="utf-8") as f:
        merges = [line.split() for line in f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]]
    defaults = hf_classes.SPECIAL_DEFAULTS["CLIPTokenizerFast"]
    tok = {a: _token_content(config.get(a)) or defaults[a]
           for a in ("bos_token", "eos_token", "unk_token", "pad_token")}
    ids, added = dict(vocab), []
    for content in dict.fromkeys(tok.values()):
        ids.setdefault(content, len(ids))
        added.append({"id": ids[content], "content": content, "single_word": False,
                      "lstrip": False, "rstrip": False, "normalized": True, "special": True})
    return {
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "NFC"}, {"type": "Replace", "pattern": {"Regex": r"\s+"}, "content": " "},
            {"type": "Lowercase"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": CLIP_PATTERN}, "behavior": "Removed",
             "invert": True},
            {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True}]},
        "model": {"type": "BPE", "vocab": vocab, "merges": merges,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "</w>",
                  "fuse_unk": False, "unk_token": tok["unk_token"]},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": [tok["eos_token"], ids[tok["eos_token"]]],
                           "cls": [tok["bos_token"], ids[tok["bos_token"]]]},
    }


def resolve_class(model_dir: str, config: dict) -> str | None:
    """The tokenizer class ``AutoTokenizer`` loads for the dir here (the
    fast one where it exists), or None where it raises: the config's
    ``tokenizer_class``, else ``config.json``'s, else its ``model_type``
    through transformers' own mapping (``hf_classes.MODEL_TYPES``); a name
    transformers does not know, a model type it has no tokenizer for, a
    class it cannot load here (SentencePiece's, without ``sentencepiece``)
    and a dir without ``config.json`` give None."""
    cls = config.get("tokenizer_class")
    if cls is None:
        path = os.path.join(model_dir, "config.json")
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            model_config = json.load(f)
        cls = model_config.get("tokenizer_class")
        if cls is None:
            slow, fast = hf_classes.MODEL_TYPES.get(model_config.get("model_type"), (None, None))
            return fast or slow
    if not cls.endswith("Fast") and f"{cls}Fast" in hf_classes.CLASSES:
        return f"{cls}Fast"
    return cls if cls in hf_classes.CLASSES else None


def load(model_dir: str):
    """The model dir's tokenizer as JAX's ``AutoTokenizer`` route resolves
    it (see the module doc): an :class:`HFTokenizer`, or None where that
    route raises and JAX falls through to the vocab convention. A class
    built from its own vocab files other than BERT's and CLIP's raises by
    name."""
    config = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                config.update(json.load(f))
    cls = resolve_class(model_dir, config)
    if cls is None:
        return None
    path = os.path.join(model_dir, "tokenizer.json")
    if cls.endswith("Fast") and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
    elif cls in _BERT_CLASSES:
        vocab = os.path.join(model_dir, "vocab.txt")
        if not os.path.exists(vocab):
            return None  # BertTokenizer without its vocab: AutoTokenizer raises
        spec = bert_vocab_spec(vocab, config)
    elif cls in ("CLIPTokenizerFast", "CLIPTokenizer"):
        spec = clip_vocab_spec(model_dir, config)
        if spec is None:
            return None
    elif cls == "PreTrainedTokenizerFast" or not _slow_loadable(cls):
        return None  # nothing to build its backend from here: AutoTokenizer raises
    else:
        raise NotImplementedError(f"{model_dir}: tokenizer class {cls!r} built from its own "
                                  "vocab files is not read by the port (it builds BERT's "
                                  "vocab.txt and CLIP's vocab.json + merges.txt)")
    tok = HFTokenizer(spec, config, f"{model_dir}/tokenizer.json", cls)
    return None if tok.pad_id is None else tok


def _slow_loadable(cls: str) -> bool:
    """Whether transformers can build `cls` (a fast class without its
    ``tokenizer.json``, or a slow one) here: a fast class converts its slow
    class, which a SentencePiece class lacks without ``sentencepiece``."""
    slow = cls.removesuffix("Fast")
    pairs = [p for p in hf_classes.MODEL_TYPES.values() if cls in p]
    return slow in hf_classes.CLASSES and all(p[0] is not None for p in pairs)
