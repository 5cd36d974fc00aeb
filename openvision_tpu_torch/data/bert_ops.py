"""The training tokenize op ``my_bert_tokenize`` (pure-Python WordPiece).

The port's copy of ``openvision_tpu/data/bert_ops.py:94``: it samples a
sub-caption from key1 and a [.!]-split sub-caption from key2 and emits

- labels1, labels2: [bos] + tokens + [eos], padded or truncated to
  max_len - 1 (eos written over the last slot when truncated), then [CLS]
  appended at the END (open_clip's convention);
- labels_for_regress: [bos] + tokens(the FULL key2 text) + [eos] padded to
  output_token_len (no CLS);
- cap_loss_mask: the pad mask of labels_for_regress shifted left by the bos
  (aligned with the next-token targets) with a trailing 0.

Its draws from the record's ``np.random.Generator`` come in the JAX op's
order.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

from openvision_tpu_torch.data.pp import pp_op
from openvision_tpu_torch.data.tokenizer import (
    _encode_special, _finalize_clip_tokens, _pad_or_truncate, get_tokenizer)


def _as_text_list(x) -> List[str]:
    if isinstance(x, (bytes, np.bytes_)):
        return [x.decode("utf-8")]
    if isinstance(x, str):
        return [x]
    arr = np.asarray(x).reshape(-1)
    return [t.decode("utf-8") if isinstance(t, (bytes, np.bytes_)) else str(t) for t in arr]


def _sample_text(texts: Sequence[str], rng, sample_if_multi=True) -> str:
    texts = list(texts) + [""]
    if sample_if_multi:
        return texts[int(rng.integers(0, max(len(texts) - 1, 1)))]
    return texts[0]


@pp_op("my_bert_tokenize")
def get_my_bert_tokenize(max_len, output_token_len, vocab_path, add_bos=True, add_eos=True,
                         sample_if_multi=True, key1="txt", key2="llava_caption"):
    tok = get_tokenizer(vocab_path)

    def op(data, rng):
        txt = _sample_text(_as_text_list(data[key1]), rng, sample_if_multi)
        data["labels1"] = _finalize_clip_tokens(
            tok, _encode_special(tok, txt, add_bos, add_eos), max_len, add_eos)

        key2_text = " ".join(_as_text_list(data[key2]))
        subs = [p for p in re.split(r"[.!]+", key2_text) if len(p) > 0]
        if subs:
            sel = subs[int(rng.integers(0, len(subs)))]
        else:
            sel = key2_text = txt
        data["labels2"] = _finalize_clip_tokens(
            tok, _encode_special(tok, sel, add_bos, add_eos), max_len, add_eos)

        padded, mask = _pad_or_truncate(_encode_special(tok, key2_text, add_bos, add_eos),
                                        output_token_len, tok.pad_id)
        if add_eos and mask[-1] == 1:
            padded = padded[:-1] + [tok.eos_id]
        data["labels_for_regress"] = np.asarray(padded, np.int32)
        data["cap_loss_mask"] = np.asarray(mask[1:] + [0] if add_bos else mask, np.float32)
        return data

    return op
