"""Writes the Hugging Face tokenizer fixtures that tests/test_torch_hf_tokenizer.py
and chip_smoke.py read: one model dir a component or route of
``openvision_tpu_torch/data/hf_tokenizer.py``, each beside the ids JAX's
``LoadedModel.tokenize`` (``transformers.AutoTokenizer``, or its
fall-through to the vocab convention) gives for :data:`TEXTS`.

Each tokenizer is built and trained here with the ``tokenizers`` library on
:data:`TEXTS` (nothing is downloaded). ``sentencepiece`` is not installed,
so the ``Precompiled`` normalizer's charsmap is built by :func:`charsmap`: a
darts-clone double array (the format SentencePiece writes and the
library's ``spm_precompiled`` reads) of :data:`CHARSMAP`: full-width
letters and digits, ligatures, NBSP and a few keys of several characters.

``hf_tokenizers/<name>/`` holds the dir's files and ``expected_ids.json``
(``{"texts": [...], "<length>": ids}``, at each of :data:`LENGTHS`). Run
from the repo root: ``python tests/fixtures/make_hf_tokenizer_fixtures.py``
(needs tokenizers, transformers and the JAX package).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import struct
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "hf_tokenizers")
VOCAB = "assets/bert_base_vocab_bos_eos.txt"
LENGTHS = (12, 64)
TEXTS = [
    "a photo of a tench.", "itap of my goldfish", "a photo of a great white shark.",
    "Café naïve ÜBER Ωmega ΣΊΣΥΦΟΣ", "中文测试 日本語のテキスト カタカナー", "İstanbul ǅ ﬁ ﬂow",
    "ＦＵＬＬ ｗｉｄｔｈ ０１２３ text", "non breaking space", "été ｅ́",
    "１́ and ™ and Å", "mixed ελληνικά and русский текст", "snake_case_words and_more",
    "emoji 😀 and 👍🏽 done", "tab\tx y\x85z", "a cat <extra_a> a dog <mask> end", "CAT and Cat",
    "the Dog Park is near", "<|startoftext|> hi <|endoftext|>", "x" * 70, "", "word " * 20,
    "Ωmega_ΣΊΣΥΦΟΣ_中文", "ＡＢＣ ﬁ", "  leading and trailing  ",
]
# full-width ASCII, ligatures, NBSP, the Angstrom sign, ™, and keys of
# several characters (a decomposed e-acute; a full-width one with a combining
# acute, shorter than 6 bytes: its grapheme is replaced whole)
CHARSMAP = {**{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
            "ﬁ": "fi", "ﬂ": "fl", "ﬀ": "ff", " ": " ", "Å": "Å", "™": "TM",
            "é": "é", "ｅ́": "é", "　": " "}


def charsmap(mapping: dict) -> bytes:
    """SentencePiece's precompiled charsmap of `mapping` (str -> str): a
    little-endian u32 byte count, a darts-clone double array of the keys'
    UTF-8 (each leaf's value the byte offset of its replacement), then the
    NUL-terminated replacements. A unit: bits 0-7 the label, bit 8 a leaf
    child, bits 10-31 the offset to the node's base (base = position ^
    offset; a child with label c at base ^ c, the leaf at the base itself,
    its unit bit 31 set over the value). Bases are found first-fit, one
    node each; the array is padded to whole blocks of 256 units, as
    darts-clone's are."""
    strings, values = b"", {}
    for key, rep in mapping.items():
        values[key.encode("utf-8")] = len(strings)
        strings += rep.encode("utf-8") + b"\0"
    trie = {}
    for key, value in values.items():
        node = trie
        for byte in key:
            node = node.setdefault(byte, {})
        node[None] = value
    units, used, bases = {}, {0}, set()
    queue = [(trie, 0, 0)]  # (node, its position, its label)
    while queue:
        node, pos, label = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        slots = labels + ([0] if None in node else [])
        base = 1
        while base in bases or any((base ^ c) in used for c in slots):
            base += 1
        bases.add(base)
        offset = pos ^ base
        assert offset < 1 << 21, "a small trie needs no extended offsets"
        units[pos] = label | ((None in node) << 8) | (offset << 10)
        for c in labels:
            used.add(base ^ c)
            queue.append((node[c], base ^ c, c))
        if None in node:
            used.add(base)
            units[base] = (1 << 31) | node[None]
    # a lookup reads the unit at base ^ c for any byte c: pad past every base's block of 256
    array = [units.get(i, 0) for i in range((max(bases) | 0xFF) + 1)]
    return struct.pack(f"<I{len(array)}I", 4 * len(array), *array) + strings


def _trained(kind: str):
    """(tokenizer, its class, config entries) of each fixture built from a
    ``tokenizer.json``."""
    from tokenizers import (AddedToken, BertWordPieceTokenizer, Regex, Tokenizer, models,
                            normalizers, pre_tokenizers, processors, trainers)

    if kind == "precompiled_unigram":  # the T5 / mT5 / XLM-R form
        tok = Tokenizer(models.Unigram())
        tok.normalizer = normalizers.Sequence([
            normalizers.Precompiled(charsmap(CHARSMAP)),
            normalizers.Replace(Regex(" {2,}"), " ")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.train_from_iterator(TEXTS * 3, trainers.UnigramTrainer(
            vocab_size=150, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>"))
        tok.post_processor = processors.TemplateProcessing(
            single="$A </s>", special_tokens=[("</s>", tok.token_to_id("</s>"))])
        return tok, "PreTrainedTokenizerFast", {"pad_token": "<pad>", "eos_token": "</s>",
                                                "unk_token": "<unk>"}
    if kind == "bytelevel_normalizer":
        tok = Tokenizer(models.BPE())
        tok.normalizer = normalizers.Sequence([normalizers.NFC(), normalizers.ByteLevel()])
        tok.pre_tokenizer = pre_tokenizers.Split("Ġ", behavior="merged_with_next")
        tok.train_from_iterator(TEXTS * 3, trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<pad>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        return tok, "PreTrainedTokenizerFast", {"pad_token": "<pad>"}
    if kind in ("unicode_scripts", "char_delimiter"):
        tok = Tokenizer(models.BPE(unk_token="[UNK]"))
        tok.pre_tokenizer = (
            pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                     pre_tokenizers.UnicodeScripts()])
            if kind == "unicode_scripts" else pre_tokenizers.CharDelimiterSplit("_"))
        tok.train_from_iterator(TEXTS * 3, trainers.BpeTrainer(
            vocab_size=300, special_tokens=["[PAD]", "[UNK]"]))
        return tok, "PreTrainedTokenizerFast", {"pad_token": "[PAD]"}
    def wordpiece(**kw):  # BERT's pipeline, a small WordPiece vocab trained on TEXTS
        bert = BertWordPieceTokenizer(**kw)
        bert.train_from_iterator(TEXTS * 3, vocab_size=300)
        return bert._tokenizer

    if kind == "missing_specials":  # the config names tokens the vocab lacks
        return wordpiece(lowercase=True), "PreTrainedTokenizerFast", {
            "pad_token": "[PAD]", "mask_token": "<mask>", "bos_token": "[CLS]",
            "additional_special_tokens": ["<extra_a>", "<extra_b>"]}
    if kind == "normalized_added":  # added tokens matched after normalization
        tok = wordpiece(lowercase=True)
        tok.add_tokens([AddedToken("Cat", normalized=True), AddedToken("dog park"),
                        AddedToken("near", normalized=False)])
        return tok, "PreTrainedTokenizerFast", {"pad_token": "[PAD]"}
    if kind == "model_type_bert":  # no tokenizer_class: config.json's model_type
        return wordpiece(lowercase=False, strip_accents=False), None, {}
    raise ValueError(kind)


TRAINED = ("precompiled_unigram", "bytelevel_normalizer", "unicode_scripts", "char_delimiter",
           "missing_specials", "normalized_added", "model_type_bert")
# (name, config.json's model_type or None, tokenizer_class or None)
CLIP_VOCAB = (("clip_vocab_files", None, "CLIPTokenizer"), ("model_type_clip", "clip", None))
# dirs where AutoTokenizer raises here and JAX falls through: (name, model_type,
# files): an unknown model type, a SentencePiece model type (no
# sentencepiece here), T5's fast class from a spiece.model
FALL_THROUGH = (("model_type_unknown", "no_such_model", ("tokenizer.json",)),
                ("model_type_siglip", "siglip", ("tokenizer.json",)),
                ("t5_spiece_model", "t5", ("spiece.model",)))


def _clip_files(path: str) -> None:
    """CLIP's vocab.json and merges.txt (a BPE with ``</w>`` trained on
    TEXTS over the byte-level alphabet)."""
    from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers, trainers

    from openvision_tpu_torch.data.hf_tokenizer import CLIP_PATTERN

    tok = Tokenizer(models.BPE(unk_token="<|endoftext|>", end_of_word_suffix="</w>",
                               continuing_subword_prefix=""))
    tok.normalizer = normalizers.Sequence([normalizers.NFC(),
                                           normalizers.Replace(Regex(r"\s+"), " "),
                                           normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_PATTERN), behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.train_from_iterator(TEXTS * 3, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|startoftext|>", "<|endoftext|>"],
        end_of_word_suffix="</w>", initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.model.save(path)  # vocab.json, merges.txt (its first line "#version: 0.2")


def write_dir(name: str, path: str) -> None:
    """Writes fixture `name`'s files into `path` (made anew)."""
    from transformers import PreTrainedTokenizerFast

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    if name in TRAINED:
        tok, cls, config = _trained(name)
        PreTrainedTokenizerFast(tokenizer_object=tok).save_pretrained(path)
        with open(os.path.join(path, "tokenizer_config.json"), encoding="utf-8") as f:
            saved = json.load(f)
        saved.pop("tokenizer_class", None)
        saved.update(config)
        if cls is not None:
            saved["tokenizer_class"] = cls
        else:
            _write(path, "config.json", {"model_type": name.removeprefix("model_type_")})
        _write(path, "tokenizer_config.json", saved)
        if os.path.exists(os.path.join(path, "special_tokens_map.json")):
            os.remove(os.path.join(path, "special_tokens_map.json"))
        return
    for clip_name, model_type, cls in CLIP_VOCAB:
        if name == clip_name:
            _clip_files(path)
            _write(path, "tokenizer_config.json", {} if cls is None else {"tokenizer_class": cls})
            if model_type is not None:
                _write(path, "config.json", {"model_type": model_type})
            return
    for fall_name, model_type, files in FALL_THROUGH:
        if name == fall_name:
            _write(path, "config.json", {"model_type": model_type})
            _write(path, "tokenizer_config.json", {})
            if "tokenizer.json" in files:
                tok, _, _ = _trained("char_delimiter")
                tok.save(os.path.join(path, "tokenizer.json"))
            if "spiece.model" in files:  # any bytes: the slow class is not importable here
                with open(os.path.join(path, "spiece.model"), "wb") as f:
                    f.write(b"\x0a\x00")
            return
    raise ValueError(name)


NAMES = TRAINED + tuple(n for n, _, _ in CLIP_VOCAB) + tuple(n for n, _, _ in FALL_THROUGH)


def _write(path: str, name: str, obj) -> None:
    with open(os.path.join(path, name), "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=1)


def jax_ids(path: str, length: int):
    """JAX's ``LoadedModel.tokenize`` of TEXTS on the dir."""
    from openvision_tpu.tools.model_io import LoadedModel

    m = LoadedModel(vision=None, text=None, params={}, image_size=224, context_length=length,
                    vocab_size=30522, mean=(0,) * 3, std=(1,) * 3, vocab_path=VOCAB,
                    model_dir=path)
    return m.tokenize(TEXTS)


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    for name in NAMES:
        path = os.path.join(OUT, name)
        write_dir(name, path)
        want = {"texts": TEXTS, **{str(n): jax_ids(path, n).tolist() for n in LENGTHS}}
        _write(path, "expected_ids.json", want)
        print(f"wrote hf_tokenizers/{name}")
    print(f"charsmap: {len(base64.b64encode(charsmap(CHARSMAP)))} base64 characters")


if __name__ == "__main__":
    main()
