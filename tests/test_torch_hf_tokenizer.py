"""A model dir's Hugging Face ``tokenizer.json`` in the port
(``data/hf_tokenizer.py`` through ``tools/model_io.LoadedModel.tokenize``)
against JAX's ``LoadedModel.tokenize``, which hands the dir to
``transformers.AutoTokenizer`` (a test dependency here, absent on the card's
machine). The tokenizers are built here with the ``tokenizers`` library
from the repo's vocab (BERT WordPiece): lowercase through
``PreTrainedTokenizerFast``, ``BertTokenizerFast`` (whose config's
``do_lower_case`` rules the normalizer), and a cased one with a
``TemplateProcessing`` post-processor and an added token. Ids must be
equal, padded and truncated to the context length. A BPE tokenizer and a
dir without a pad token raise by name.
"""

import os

import numpy as np
import pytest
from tokenizers import BertWordPieceTokenizer, Tokenizer, models, processors
from transformers import BertTokenizerFast, PreTrainedTokenizerFast

from openvision_tpu.tools.model_io import LoadedModel as JaxLoaded
from openvision_tpu_torch.evaluators.in1k_classes import CLIP_IMAGENET_CLASS_NAMES
from openvision_tpu_torch.tools import model_io

VOCAB = "assets/bert_base_vocab_bos_eos.txt"
TEXTS = [t.format(c) for c in CLIP_IMAGENET_CLASS_NAMES[::4] for t in ("a photo of a {}.",
                                                                        "itap of my {}")] + [
    "Café naïve ÜBER Ωmega ΣΊΣΥΦΟΣ", "中文测试 日本語", "a [UNK] b[CLS]c <obj> d", "tab\tx y\x85z",
    "İstanbul ǅ ﬁ", "x" * 150, "emoji 😀", "", "word " * 40]


def _jax_ids(model_dir, length=16):
    m = JaxLoaded(vision=None, text=None, params={}, image_size=224, context_length=length,
                  vocab_size=30522, mean=(0,) * 3, std=(1,) * 3, vocab_path=VOCAB,
                  model_dir=model_dir)
    return m.tokenize(TEXTS)


def _port_ids(model_dir, length=16):
    m = model_io.LoadedModel(vision=None, text=None, logit_scale=1.0, image_size=224,
                             context_length=length, vocab_size=30522, mean=(0,) * 3,
                             std=(1,) * 3, vocab_path=VOCAB, device="cpu", model_dir=model_dir)
    return m.tokenize(TEXTS)


def _save(tok, cls, path, **kw):
    cls(tokenizer_object=tok, unk_token="[UNK]", cls_token="[CLS]", sep_token="[SEP]",
        **kw).save_pretrained(path)
    model_io.hf_tokenizer.cache_clear()
    return str(path)


@pytest.mark.parametrize("kind", ["fast", "bert", "cased_template"])
def test_tokenizer_json_gives_jax_autotokenizer_ids(tmp_path, kind):
    if kind == "cased_template":
        tok = BertWordPieceTokenizer(VOCAB, lowercase=False, strip_accents=False)._tokenizer
        tok.post_processor = processors.TemplateProcessing(
            single="[bos] $A [eos] [CLS]", special_tokens=[("[bos]", 1), ("[eos]", 2),
                                                         ("[CLS]", 101)])
        tok.add_special_tokens(["<obj>"])
        path = _save(tok, PreTrainedTokenizerFast, tmp_path, pad_token="[PAD]",
                     truncation_side="left")
    else:
        tok = BertWordPieceTokenizer(VOCAB, lowercase=True)._tokenizer
        cls = BertTokenizerFast if kind == "bert" else PreTrainedTokenizerFast
        path = _save(tok, cls, tmp_path, pad_token="[PAD]")
    for length in (16, 80):
        want = _jax_ids(path, length)
        got = _port_ids(path, length)
        assert got.dtype == np.int32 and got.shape == (len(TEXTS), length)
        np.testing.assert_array_equal(got, want)
    # and not the vocab convention (bos ... eos, CLS at the end)
    assert not np.array_equal(got, model_io.tokenize_labels(TEXTS, VOCAB, 80))


def test_other_model_types_and_a_missing_pad_token_raise(tmp_path):
    bpe = Tokenizer(models.BPE(vocab={"a": 0, "b": 1, "ab": 2}, merges=[("a", "b")]))
    path = _save(bpe, PreTrainedTokenizerFast, tmp_path / "bpe", pad_token="a")
    with pytest.raises(ValueError, match="model type 'BPE'.*WordPiece"):
        _port_ids(path)
    tok = BertWordPieceTokenizer(VOCAB)._tokenizer
    path = _save(tok, PreTrainedTokenizerFast, tmp_path / "nopad")
    with pytest.raises(ValueError, match="no pad token"):
        _port_ids(path)
    os.remove(os.path.join(path, "tokenizer.json"))
    model_io.hf_tokenizer.cache_clear()
    with pytest.raises(ValueError, match="tokenizer_config.json without tokenizer.json"):
        _port_ids(path)
