"""Pure-Python BERT WordPiece tokenizer and the CLIP label finalizer.

Counterpart of ``openvision_tpu/data/tokenizer.py`` (BasicTokenizer +
greedy longest-match WordPiece) and of ``_encode_special`` and
``_finalize_clip_tokens`` in ``openvision_tpu/data/bert_ops.py``. The JAX
package's modules are not imported because ``openvision_tpu.data`` loads
JAX through its package ``__init__``. The native C++ hot path
(``openvision_tpu/native/wordpiece.cpp``) is not wired in yet.

Vocab: assets/bert_base_vocab_bos_eos.txt -- 30,522 lines; [PAD]=0, [bos]=1,
[eos]=2, [CLS]/[SEP]/[UNK] at their standard BERT positions.
"""

from __future__ import annotations

import functools
import unicodedata
from typing import Iterable, List

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower_case: bool = True) -> List[str]:
    """Cleanup + whitespace/punctuation/CJK splitting (BERT BasicTokenizer)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    text = "".join(out)

    tokens = []
    for tok in text.split():
        if lower_case:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        cur: list[str] = []
        for ch in tok:  # split on punctuation
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a fixed vocab."""

    def __init__(self, vocab_path: str, lower_case: bool = True, unk_token: str = "[UNK]",
                 suffix: str = "##", max_chars_per_word: int = 100):
        with open(vocab_path) as f:
            self.vocab_list = f.read().split("\n")
        self.vocab = {tok: i for i, tok in enumerate(self.vocab_list)}
        self.lower_case = lower_case
        self.unk_token = unk_token
        self.unk_id = self.vocab[unk_token]
        self.suffix = suffix
        self.max_chars = max_chars_per_word

        self.pad_id = self.vocab.get("[PAD]", 0)
        self.cls_id = self.vocab.get("[CLS]")
        self.sep_id = self.vocab.get("[SEP]")
        self.bos_id = self.vocab.get("[bos]")
        self.eos_id = self.vocab.get("[eos]")

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.suffix + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        """Tokenizes free text to WordPiece ids (no special tokens added)."""
        ids: List[int] = []
        for word in basic_tokenize(text, self.lower_case):
            ids.extend(self.wordpiece(word))
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        special = {self.pad_id, self.cls_id, self.sep_id, self.bos_id, self.eos_id}
        for i in ids:
            if skip_special and i in special:
                continue
            toks.append(self.vocab_list[i] if 0 <= i < len(self.vocab_list) else "")
        out = ""
        for t in toks:
            if t.startswith(self.suffix):
                out += t[len(self.suffix):]
            else:
                out += (" " if out else "") + t
        return out


@functools.lru_cache(maxsize=8)
def get_tokenizer(vocab_path: str, lower_case: bool = True) -> WordPieceTokenizer:
    return WordPieceTokenizer(vocab_path, lower_case=lower_case)


def _pad_or_truncate(ids: List[int], length: int, pad_id: int):
    """Returns (padded ids, mask) where mask marks real tokens."""
    mask = [1] * min(len(ids), length) + [0] * max(0, length - len(ids))
    out = (ids + [pad_id] * length)[:length]
    return out, mask


def _encode_special(tok, text: str, add_bos: bool, add_eos: bool) -> List[int]:
    ids = tok.encode(text)
    if add_bos:
        ids = [tok.bos_id] + ids
    if add_eos:
        ids = ids + [tok.eos_id]
    return ids


def _finalize_clip_tokens(tok, ids: List[int], max_len: int, add_eos: bool):
    """Pads/truncates to max_len-1, eos-overwrites on truncation, appends CLS."""
    padded, mask = _pad_or_truncate(ids, max_len - 1, tok.pad_id)
    if add_eos and mask[-1] == 1:
        padded = padded[:-1] + [tok.eos_id]
    return np.asarray(padded + [tok.cls_id], np.int32)
