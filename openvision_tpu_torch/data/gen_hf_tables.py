"""Writes the tables ``data/hf_tokenizer.py`` reads that neither Python's
``unicodedata`` nor the card's machine has.

``python -m openvision_tpu_torch.data.gen_hf_tables`` (needs ``regex``,
``tokenizers`` and ``transformers``, none of which the port imports at run
time) writes two modules beside this one:

- ``unicode_tables.py``: each code point's script (the ``UnicodeScripts``
  pre-tokenizer), grapheme-cluster break property, Extended_Pictographic
  and Indic_Conjunct_Break values (UAX #29's extended grapheme clusters,
  which the ``Precompiled`` normalizer segments by), as runs (first code
  point, value), from ``regex``'s Unicode tables. Before writing, the
  script runs are checked against the ``tokenizers`` library's own
  ``UnicodeScripts`` on every code point in order and on a shuffled
  string (the library's table follows an older Unicode: where it differs
  from ``regex``'s, the library's is kept, found by probing it), and the
  grapheme rules against ``regex``'s ``\\X``; a mismatch
  stops the script.
- ``hf_classes.py``: what ``transformers.AutoTokenizer`` resolves here:
  each ``config.json`` ``model_type`` to its (slow, fast) tokenizer class
  names (None where the class cannot be loaded here: a SentencePiece class
  without ``sentencepiece``), the class names ``tokenizer_class`` can name,
  and each fast class's default special tokens (its ``__init__``'s).
"""

from __future__ import annotations

import inspect
import os
import random
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SPECIALS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
            "mask_token")


def _runs(prop: str, all_chars: str) -> tuple:
    """((first code point, value id), ...) of `prop` over every code point
    and {value id: name}."""
    import regex
    import regex._regex_core as core

    _, values = core.PROPERTIES[prop]
    names = {}
    for name, v in values.items():
        names.setdefault(v, name)
    value = {}
    for v, name in names.items():
        for m in regex.finditer(r"\p{%s=%s}+" % (prop, name), all_chars):
            value[m.start()] = (m.end(), v)
    runs, cp, last = [], 0, None
    while cp < len(all_chars):
        end, v = value[cp]
        if v != last:
            runs.append((cp, v))
            last = v
        cp = end
    return tuple(runs), names


def _library_scripts(runs: tuple, names: dict) -> tuple:
    """`runs` (regex's scripts) as the ``tokenizers`` library's own table
    has them, which follows an older Unicode: a code point the library
    splits nothing at (a lone one gives no piece) is ``Any`` (regex's
    ``Unknown``), and one that does not join a code point of its regex
    script takes the script it joins."""
    from tokenizers import pre_tokenizers

    lib = pre_tokenizers.UnicodeScripts()
    joins = lambda a, b: len(lib.pre_tokenize_str(chr(a) + chr(b))) == 1  # noqa: E731
    unknown = next(v for v, n in names.items() if n == "UNKNOWN")
    value = [0] * (sys.maxunicode + 1)
    for (a, v), (b, _) in zip(runs, (*runs[1:], (sys.maxunicode + 1, None))):
        value[a:b] = [v] * (b - a)
    lone = lambda cp: not lib.pre_tokenize_str(chr(cp))  # noqa: E731
    for cp in range(sys.maxunicode + 1):
        if 0xD800 <= cp < 0xE000 or lone(cp):
            value[cp] = unknown
    reps = {}
    for cp, v in enumerate(value):
        reps.setdefault(v, cp)
    for cp, v in enumerate(value):
        if v != unknown and not joins(reps[v], cp):
            value[cp] = next(u for u, r in reps.items() if u != unknown and joins(r, cp))
    out, last = [], None
    for cp, v in enumerate(value):
        if v != last:
            out.append((cp, v))
            last = v
    return tuple(out)


def _script_check(tables) -> None:
    """The port's UnicodeScripts against the library's on every code point
    in order and on a shuffled string of them."""
    from tokenizers import pre_tokenizers

    from openvision_tpu_torch.data import hf_tokenizer

    lib = pre_tokenizers.UnicodeScripts()
    run = hf_tokenizer.build_pre_tokenizer({"type": "UnicodeScripts"}, "check", tables=tables)
    cps = [c for c in range(0x20, sys.maxunicode + 1) if not 0xD800 <= c < 0xE000]
    shuffled = cps[:]
    random.Random(0).shuffle(shuffled)
    for order in (cps, shuffled):
        for i in range(0, len(order), 4096):
            s = "".join(map(chr, order[i:i + 4096]))
            want = [p for p, _ in lib.pre_tokenize_str(s)]
            got = [p for p, _ in run([(s, True)])]
            if got != want:
                bad = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
                raise SystemExit(f"UnicodeScripts differs at {got[bad]!r} vs {want[bad]!r}")


def _grapheme_check(tables) -> None:
    """The port's grapheme clusters against regex's \\X on random strings of
    the code points every rule touches."""
    import regex

    from openvision_tpu_torch.data import hf_tokenizer

    rng = random.Random(1)
    pool = [c for c in range(0x20, sys.maxunicode + 1)
            if not 0xD800 <= c < 0xE000 and (tables.gcb(c) or tables.incb(c) or tables.pict(c))]
    pool += [0x0D, 0x0A, 0x61, 0x1100, 0xAC00, 0x1F1E6, 0x1F600, 0x200D, 0x0915, 0x094D]
    for _ in range(20000):
        s = "".join(chr(rng.choice(pool)) for _ in range(rng.randint(1, 12)))
        want = regex.findall(r"\X", s)
        got = hf_tokenizer.graphemes(s, tables)
        if got != want:
            raise SystemExit(f"graphemes of {s!r}: {got} vs {want}")


def unicode_module() -> str:
    all_chars = "".join(chr(i) for i in range(sys.maxunicode + 1))
    out = ['"""Unicode property runs for ``data/hf_tokenizer.py``, written by',
           "``python -m openvision_tpu_torch.data.gen_hf_tables`` from ``regex``'s",
           f"tables (Unicode {__import__('unicodedata').unidata_version} beside this",
           "interpreter's ``unicodedata``): ((first code point, value), ...) runs.",
           '"""', ""]
    for var, prop in (("SCRIPT", "SC"), ("GCB", "GCB"), ("PICT", "EXTENDEDPICTOGRAPHIC"),
                      ("INCB", "INCB")):
        runs, names = _runs(prop, all_chars)
        if var == "SCRIPT":
            runs = _library_scripts(runs, names)
        out.append(f"{var}_NAMES = {tuple(names[v] for v in sorted(names))!r}")
        body = ", ".join(f"({a:#x}, {v})" for a, v in runs)
        out.append(f"{var}_RUNS = ({body},)")
        out.append("")
    return "\n".join(out)


def classes_module() -> str:
    import transformers
    from transformers.models.auto import configuration_auto as ca
    from transformers.models.auto import tokenization_auto as ta

    model_types = {}
    for model_type, config_name in ca.CONFIG_MAPPING_NAMES.items():
        try:
            config_cls = ca.CONFIG_MAPPING[model_type]
        except Exception:  # noqa: BLE001 - a config AutoConfig cannot import here
            continue
        own = ca.config_class_to_model_type(config_cls.__name__)
        if own is None:
            continue
        try:
            slow, fast = ta.TOKENIZER_MAPPING[config_cls]
        except KeyError:  # AutoTokenizer: "Unrecognized configuration class"
            continue
        model_types[model_type] = (getattr(slow, "__name__", None), getattr(fast, "__name__", None))
    names = sorted({n for pair in ta.TOKENIZER_MAPPING_NAMES.values() for n in pair if n}
                   | {"PreTrainedTokenizerFast"})
    loadable = sorted(n for n in names if ta.tokenizer_class_from_name(n) is not None
                      and not getattr(ta.tokenizer_class_from_name(n), "_backends", None))
    defaults = {}
    for n in loadable:
        if not n.endswith("Fast"):
            continue
        params = inspect.signature(ta.tokenizer_class_from_name(n).__init__).parameters
        d = {k: params[k].default for k in SPECIALS
             if k in params and isinstance(params[k].default, str)}
        if d:
            defaults[n] = d
    lines = ['"""What ``transformers.AutoTokenizer`` resolves, written by',
             "``python -m openvision_tpu_torch.data.gen_hf_tables`` from transformers",
             f"{transformers.__version__} without ``sentencepiece``: MODEL_TYPES maps a",
             "``config.json`` model_type to its (slow, fast) tokenizer class names (None: not",
             "loadable here), CLASSES the names a ``tokenizer_class`` can name, SPECIAL_DEFAULTS",
             'a fast class\'s default special tokens."""', "",
             "MODEL_TYPES = {"]
    lines += [f"    {k!r}: {v!r}," for k, v in sorted(model_types.items())]
    lines += ["}", "", "CLASSES = frozenset({"]
    lines += [f"    {n!r}," for n in loadable]
    lines += ["})", "", "SPECIAL_DEFAULTS = {"]
    lines += [f"    {k!r}: {v!r}," for k, v in sorted(defaults.items())]
    lines += ["}", ""]
    return "\n".join(lines)


def main() -> None:
    path = os.path.join(HERE, "unicode_tables.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(unicode_module())
    from openvision_tpu_torch.data import hf_tokenizer

    tables = hf_tokenizer.UnicodeTables()
    _script_check(tables)
    _grapheme_check(tables)
    with open(os.path.join(HERE, "hf_classes.py"), "w", encoding="utf-8") as f:
        f.write(classes_module())
    print(f"wrote {path} and hf_classes.py")


if __name__ == "__main__":
    main()
