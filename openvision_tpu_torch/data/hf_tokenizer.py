"""A Hugging Face ``tokenizer.json`` of the WordPiece model type, read and
run without ``transformers``.

JAX's ``ModelIO.tokenize`` (``openvision_tpu/tools/model_io.py:52-77``)
hands a model dir with ``tokenizer.json`` / ``tokenizer_config.json`` to
``transformers.AutoTokenizer`` and calls it with ``padding="max_length",
truncation=True, max_length=context_length``. The card's machine has no
``transformers``, so the port reads the file itself and repeats what the
``tokenizers`` library computes for a BERT WordPiece tokenizer:

- the added tokens (``added_tokens``): matched in the raw text first
  (leftmost, longest) and kept whole, their ``lstrip`` / ``rstrip``
  whitespace taken with them;
- ``BertNormalizer``: ``clean_text`` (drop NUL, U+FFFD and control
  characters, whitespace to a space), ``handle_chinese_chars`` (spaces
  around CJK ideographs), ``strip_accents`` (NFD, drop nonspacing marks;
  unset: as ``lowercase``), then ``lowercase`` per character;
- ``BertPreTokenizer``: split on whitespace, each punctuation character a
  word of its own;
- ``WordPiece``: ``vocab``, ``unk_token``, ``continuing_subword_prefix``,
  ``max_input_chars_per_word`` (greedy longest match, the whole word as
  ``unk_token`` when a piece is missing or the word is too long);
- the post-processor (``BertProcessing``, ``TemplateProcessing``'s single
  template, or none), after truncating the pieces to ``max_length`` less
  the special tokens it adds (``truncation_side``); then padding to
  ``max_length`` with the pad token's id (``padding_side``).

``tokenizer_config.json`` gives the pad token and the sides, and for the
``BertTokenizer`` classes the normalizer flags that ``BertTokenizerFast``
writes over the file's (``do_lower_case``, ``strip_accents``,
``tokenize_chinese_chars``). Whitespace is Unicode's White_Space property
(Rust's ``char::is_whitespace``), control characters the ``C*``
categories, punctuation ASCII's and the ``P*`` categories, with this
interpreter's ``unicodedata``. Any other model type (BPE, Unigram,
WordLevel), normalizer or pre-tokenizer raises by name, as does a model dir
without a pad token: falling through to ``vocab.txt`` would give other ids
than JAX's route.
"""

from __future__ import annotations

import json
import os
import unicodedata

import numpy as np

from openvision_tpu_torch.data.tokenizer import _is_cjk, _is_control, _is_punctuation

# Unicode's White_Space property (Rust's char::is_whitespace)
_WHITE_SPACE = frozenset([*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                          0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")


def _is_whitespace(ch: str) -> bool:
    return ord(ch) in _WHITE_SPACE


def _token_content(t) -> str | None:
    if t is None or isinstance(t, str):
        return t
    return t.get("content")


class HFWordPieceTokenizer:
    """The WordPiece ``tokenizer.json`` of a model dir; ``__call__(texts,
    max_length)`` gives (N, max_length) int32 ids as JAX's AutoTokenizer
    route does."""

    def __init__(self, model_dir: str):
        with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            path = os.path.join(model_dir, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    config.update(json.load(f))
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(f"{model_dir}/tokenizer.json: model type {model.get('type')!r}; the "
                             "port reads the WordPiece model type only (not BPE, Unigram or "
                             "WordLevel)")
        self.vocab = dict(model["vocab"])
        self.unk = model.get("unk_token", "[UNK]")
        self.prefix = model.get("continuing_subword_prefix", "##")
        self.max_chars = model.get("max_input_chars_per_word", 100)
        self.added = {t["content"]: t for t in spec.get("added_tokens") or []}
        for content, t in self.added.items():
            self.vocab.setdefault(content, t["id"])

        norm = spec.get("normalizer")
        self.norm = None
        if norm is not None:
            if norm.get("type") != "BertNormalizer":
                raise ValueError(f"{model_dir}/tokenizer.json: normalizer {norm.get('type')!r}; "
                                 "the port reads BertNormalizer (or none)")
            self.norm = dict(clean_text=norm.get("clean_text", True),
                             chinese=norm.get("handle_chinese_chars", True),
                             strip_accents=norm.get("strip_accents"),
                             lowercase=norm.get("lowercase", True))
            if config.get("tokenizer_class") in _BERT_CLASSES:  # BertTokenizerFast's override
                self.norm.update(lowercase=config.get("do_lower_case", True),
                                 strip_accents=config.get("strip_accents"),
                                 chinese=config.get("tokenize_chinese_chars", True))
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") != "BertPreTokenizer":
            raise ValueError(f"{model_dir}/tokenizer.json: pre_tokenizer {pre.get('type')!r}; the "
                             "port reads BertPreTokenizer (or none)")
        self.split_words = pre is not None
        self.prefix_ids, self.suffix_ids = self._template(spec.get("post_processor"), model_dir)

        pad = _token_content(config.get("pad_token"))
        if pad is None or pad not in self.vocab:
            raise ValueError(f"{model_dir}: no pad token in tokenizer_config.json (or not in the "
                             "vocab); JAX's route pads to max_length with it")
        self.pad_id = self.vocab[pad]
        self.padding_side = config.get("padding_side", "right")
        self.truncation_side = config.get("truncation_side", "right")

    def _template(self, post, model_dir):
        """(ids before, ids after) the sequence, from the post-processor."""
        if post is None:
            return [], []
        kind = post.get("type")
        if kind == "BertProcessing":
            return [post["cls"][1]], [post["sep"][1]]
        if kind == "TemplateProcessing":
            before, after, seen = [], [], False
            for item in post["single"]:
                if "Sequence" in item:
                    seen = True
                    continue
                ids = post["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
            return before, after
        raise ValueError(f"{model_dir}/tokenizer.json: post_processor {kind!r}; the port reads "
                         "BertProcessing and TemplateProcessing (or none)")

    # ------------------------------------------------------------------

    def _split_added(self, text: str):
        """[(segment, is_added_token)] in order: the added tokens matched in
        the raw text (leftmost, longest), with their lstrip/rstrip spaces."""
        if not self.added:
            return [(text, False)]
        contents = sorted(self.added, key=len, reverse=True)
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((c for c in contents if text.startswith(c, i)), None)
            if hit is None:
                i += 1
                continue
            t = self.added[hit]
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
                out.append((text[start:lo], False))
            out.append((hit, True))
            start = i = hi
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _normalize(self, text: str) -> str:
        n = self.norm
        if n is None:
            return text
        if n["clean_text"]:
            text = "".join(" " if _is_whitespace(c) else c for c in text
                           if not (c in "\x00\ufffd" or _is_control(c)))
        if n["chinese"]:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        strip = n["lowercase"] if n["strip_accents"] is None else n["strip_accents"]
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if n["lowercase"]:
            text = "".join(c.lower() for c in text)  # per character, as Rust's to_lowercase
        return text

    def _words(self, text: str):
        if not self.split_words:
            return [text] if text else []
        words, cur = [], []
        for c in text:
            if _is_whitespace(c) or _is_punctuation(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if not _is_whitespace(c):
                    words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str):
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

    def encode(self, text: str) -> list[int]:
        """The pieces' ids, before truncation and the special tokens."""
        ids = []
        for segment, is_added in self._split_added(text):
            if is_added:
                ids.append(self.vocab[segment])
                continue
            for word in self._words(self._normalize(segment)):
                ids.extend(self._wordpiece(word))
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
