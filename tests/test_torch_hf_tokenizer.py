"""A model dir's Hugging Face ``tokenizer.json`` in the port
(``data/hf_tokenizer.py`` through ``tools/model_io.LoadedModel.tokenize``)
against JAX's ``LoadedModel.tokenize``, which hands the dir to
``transformers.AutoTokenizer`` (a test dependency here, absent on the card's
machine). The tokenizers are built here with the ``tokenizers`` library
from the repo's vocab (BERT WordPiece): lowercase through
``PreTrainedTokenizerFast``, ``BertTokenizerFast`` (whose config's
``do_lower_case`` rules the normalizer), and a cased one with a
``TemplateProcessing`` post-processor and an added token; then, each
trained here on this file's ``TEXTS`` with the ``tokenizers`` trainers
(nothing downloaded): a BPE with ``Whitespace``, a CLIP-style BPE
(``NFC`` + ``Replace`` + ``Lowercase``, ``Split`` + ``ByteLevel`` with
``</w>``, ``RobertaProcessing``), a ``ByteLevelBPETokenizer``, a
``WordLevel`` (``StripAccents``, ``Strip``, ``Punctuation``, ``Digits``,
``BertProcessing``), a ``SentencePieceUnigramTokenizer`` (``Nmt``,
``NFKC``, ``Metaspace``) and a byte-fallback BPE with a ``Prepend``
normalizer and a ``Metaspace`` split; a WordPiece dir without a pad token
(``transformers`` refuses to pad, JAX falls through to the vocab
convention) and a ``BertTokenizer`` config beside a ``vocab.txt``. Ids must
be equal, padded and truncated to the context length (8 or 16, and 80). A
component the port does not read raises by name. Then each component and
route added since (``tests/fixtures/make_hf_tokenizer_fixtures.py``: the
Precompiled charsmap, the ByteLevel normalizer, UnicodeScripts,
CharDelimiterSplit, config-named special tokens missing from the vocab,
normalized added tokens, config.json's model_type, CLIP's vocab files,
and the dirs where AutoTokenizer raises), built anew against JAX, and the
committed fixture dirs against the ids stored beside them.
"""

import base64
import os
import sys

import numpy as np
import pytest
import json
import shutil

from tokenizers import (BertWordPieceTokenizer, ByteLevelBPETokenizer, Regex,
                        SentencePieceUnigramTokenizer, Tokenizer, decoders, models, normalizers,
                        pre_tokenizers, processors, trainers)
from transformers import BertTokenizerFast, PreTrainedTokenizerFast

from openvision_tpu.tools.model_io import LoadedModel as JaxLoaded
from openvision_tpu_torch.evaluators.in1k_classes import CLIP_IMAGENET_CLASS_NAMES
from openvision_tpu_torch.tools import model_io

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_hf_tokenizer_fixtures as fx  # noqa: E402
from torch_jax_wordpiece import jax_python_wordpiece  # noqa: E402,F401 (autouse)

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


def _port_ids(model_dir, length=16, texts=TEXTS):
    m = model_io.LoadedModel(vision=None, text=None, logit_scale=1.0, image_size=224,
                             context_length=length, vocab_size=30522, mean=(0,) * 3,
                             std=(1,) * 3, vocab_path=VOCAB, device="cpu", model_dir=model_dir)
    return m.tokenize(texts)


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


CLIP_SPLIT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|"
              r"[^\s\p{L}\p{N}]+")


def _trained(kind):
    """(tokenizer, pad token) of each model type, trained on TEXTS."""
    if kind == "bpe_whitespace":  # ROADMAP queue 3's measured case
        tok = Tokenizer(models.BPE(unk_token="[UNK]"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        tok.train_from_iterator(TEXTS, trainers.BpeTrainer(vocab_size=60,
                                                           special_tokens=["[PAD]", "[UNK]"]))
        return tok, "[PAD]"
    if kind == "clip_bpe":
        tok = Tokenizer(models.BPE(unk_token="<|endoftext|>", end_of_word_suffix="</w>",
                                   continuing_subword_prefix=""))
        tok.normalizer = normalizers.Sequence([normalizers.NFC(),
                                               normalizers.Replace(Regex(r"\s+"), " "),
                                               normalizers.Lowercase()])
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(CLIP_SPLIT), behavior="removed", invert=True),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        tok.train_from_iterator(TEXTS, trainers.BpeTrainer(
            vocab_size=400, special_tokens=["<|startoftext|>", "<|endoftext|>"],
            end_of_word_suffix="</w>", initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        tok.post_processor = processors.RobertaProcessing(
            ("<|endoftext|>", tok.token_to_id("<|endoftext|>")),
            ("<|startoftext|>", tok.token_to_id("<|startoftext|>")), trim_offsets=False,
            add_prefix_space=False)
        return tok, "<|endoftext|>"
    if kind == "byte_level_bpe":
        bl = ByteLevelBPETokenizer(add_prefix_space=True)
        bl.train_from_iterator(TEXTS, vocab_size=320, special_tokens=["<pad>", "<s>", "</s>"])
        tok = bl._tokenizer
        tok.post_processor = processors.Sequence([
            processors.ByteLevel(trim_offsets=False),
            processors.TemplateProcessing(single="<s> $A </s>", special_tokens=[
                ("<s>", tok.token_to_id("<s>")), ("</s>", tok.token_to_id("</s>"))])])
        return tok, "<pad>"
    if kind == "word_level":
        tok = Tokenizer(models.WordLevel(unk_token="[UNK]"))
        tok.normalizer = normalizers.Sequence([normalizers.NFD(), normalizers.StripAccents(),
                                               normalizers.Lowercase(), normalizers.Strip()])
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation(),
            pre_tokenizers.Digits(individual_digits=True)])
        tok.train_from_iterator(TEXTS[::2], trainers.WordLevelTrainer(
            special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]"]))
        tok.post_processor = processors.BertProcessing(("[SEP]", 3), ("[CLS]", 2))
        return tok, "[PAD]"
    if kind == "unigram":
        sp = SentencePieceUnigramTokenizer()
        sp.train_from_iterator(TEXTS[::2], vocab_size=120, special_tokens=["<pad>", "<unk>"],
                               unk_token="<unk>")
        return sp._tokenizer, "<pad>"
    # a byte-fallback BPE (the Llama form): Prepend + Replace, a Metaspace split
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first", split=True)
    tok.train_from_iterator(TEXTS[::3], trainers.BpeTrainer(
        vocab_size=200, special_tokens=["<unk>", "<pad>"] + [f"<0x{b:02X}>" for b in range(256)]))
    tok.post_processor = processors.TemplateProcessing(single="<unk> $A", special_tokens=[
        ("<unk>", 0)])
    tok.decoder = decoders.ByteFallback()
    return tok, "<pad>"


TRAINED = ["bpe_whitespace", "clip_bpe", "byte_level_bpe", "word_level", "unigram",
           "byte_fallback_bpe"]


@pytest.mark.parametrize("kind", TRAINED)
def test_other_model_types_give_jax_autotokenizer_ids(tmp_path, kind):
    tok, pad = _trained(kind)
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token=pad).save_pretrained(tmp_path)
    model_io.hf_tokenizer.cache_clear()
    path = str(tmp_path)
    for length in (8, 16, 80):
        want = _jax_ids(path, length)
        np.testing.assert_array_equal(_port_ids(path, length), want, err_msg=f"{kind} {length}")
    assert not np.array_equal(want, model_io.tokenize_labels(TEXTS, VOCAB, 80))


def test_bert_tokenizer_config_beside_a_vocab_txt(tmp_path):
    """tokenizer_config.json naming BertTokenizer and a vocab.txt, no
    tokenizer.json: AutoTokenizer builds BertTokenizerFast from the vocab."""
    shutil.copy(VOCAB, tmp_path / "vocab.txt")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    model_io.hf_tokenizer.cache_clear()
    for length in (12, 80):
        np.testing.assert_array_equal(_port_ids(str(tmp_path), length),
                                      _jax_ids(str(tmp_path), length))
    ids = _port_ids(str(tmp_path), 12)[TEXTS.index("a photo of a {}.".format(
        CLIP_IMAGENET_CLASS_NAMES[0]))]
    assert ids[0] == 101 and 102 in ids  # [CLS] ... [SEP]


def test_other_model_types_and_a_missing_pad_token_raise(tmp_path):
    """The name is from when these cases raised: a BPE model type, a
    WordPiece dir without a pad token, a tokenizer_config.json without
    tokenizer.json, and the Precompiled normalizer. They now give JAX's ids:
    the BPE its own, the next two the vocab convention JAX falls through to
    (transformers refuses to pad without a pad token; a config that names
    no class loads nothing), the Precompiled charsmap its own. A charsmap
    the library cannot parse raises on both sides (its panic is no
    Exception, so JAX does not fall through)."""
    bpe = Tokenizer(models.BPE(vocab={"a": 0, "b": 1, "ab": 2}, merges=[("a", "b")]))
    path = _save(bpe, PreTrainedTokenizerFast, tmp_path / "bpe", pad_token="a")
    np.testing.assert_array_equal(_port_ids(path), _jax_ids(path))
    tok = BertWordPieceTokenizer(VOCAB)._tokenizer
    path = _save(tok, PreTrainedTokenizerFast, tmp_path / "nopad")
    want = model_io.tokenize_labels(TEXTS, VOCAB, 16)
    np.testing.assert_array_equal(_jax_ids(path), want)
    np.testing.assert_array_equal(_port_ids(path), want)
    os.remove(os.path.join(path, "tokenizer.json"))
    model_io.hf_tokenizer.cache_clear()
    np.testing.assert_array_equal(_port_ids(path), _jax_ids(path))
    spec = json.loads(tok.to_str())
    blob = base64.b64encode(fx.charsmap(fx.CHARSMAP)).decode()
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": blob}
    os.makedirs(tmp_path / "charsmap")
    (tmp_path / "charsmap" / "tokenizer.json").write_text(json.dumps(spec))
    (tmp_path / "charsmap" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "[PAD]"}))
    model_io.hf_tokenizer.cache_clear()
    path = str(tmp_path / "charsmap")
    np.testing.assert_array_equal(_port_ids(path), _jax_ids(path))
    # a charsmap the library cannot parse: its panic passes JAX's fall-through
    spec["normalizer"]["precompiled_charsmap"] = ""
    (tmp_path / "charsmap" / "tokenizer.json").write_text(json.dumps(spec))
    model_io.hf_tokenizer.cache_clear()
    with pytest.raises(BaseException, match="precompiled_charsmap"):
        _jax_ids(path)
    with pytest.raises(ValueError, match="Precompiled: cannot parse precompiled_charsmap"):
        _port_ids(path)


@pytest.mark.parametrize("name", fx.NAMES)
def test_components_and_routes_give_jax_autotokenizer_ids(tmp_path, name):
    """Each component and route the port reads since the Precompiled
    normalizer (a darts-clone charsmap built here), the ByteLevel
    normalizer, the UnicodeScripts and CharDelimiterSplit pre-tokenizers,
    special tokens the config names and the vocab lacks, added tokens
    matched after normalization, config.json's model_type (BERT's class
    with its normalizer override, CLIP's from vocab files), CLIP's vocab.json
    + merges.txt, and the dirs where AutoTokenizer raises here (an unknown
    model type, SigLIP's and T5's SentencePiece classes without
    sentencepiece: the vocab convention), built anew here: the port's ids
    equal JAX's exactly."""
    path = str(tmp_path / name)
    fx.write_dir(name, path)
    for length in fx.LENGTHS:
        model_io.hf_tokenizer.cache_clear()
        want = fx.jax_ids(path, length)
        got = _port_ids(path, length, fx.TEXTS)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {length}")
    convention = model_io.tokenize_labels(fx.TEXTS, VOCAB, fx.LENGTHS[-1])
    falls_through = name in {n for n, _, _ in fx.FALL_THROUGH}
    assert np.array_equal(want, convention) == falls_through


@pytest.mark.parametrize("name", fx.NAMES)
def test_committed_fixtures_give_their_stored_ids(name):
    """The committed dirs under tests/fixtures/hf_tokenizers (which
    chip_smoke.py's phase 25 reads on the card, without transformers) give
    the ids stored beside them, JAX's when they were written."""
    path = os.path.join(fx.OUT, name)
    with open(os.path.join(path, "expected_ids.json"), encoding="utf-8") as f:
        want = json.load(f)
    assert want["texts"] == fx.TEXTS
    for length in fx.LENGTHS:
        model_io.hf_tokenizer.cache_clear()
        np.testing.assert_array_equal(_port_ids(path, length, fx.TEXTS),
                                      np.asarray(want[str(length)]), err_msg=f"{name} {length}")


def test_unicode_tables_match_the_library_and_regex():
    """The generated tables (``data/gen_hf_tables.py``): UnicodeScripts on
    every code point, in order and shuffled, as the tokenizers library
    splits; grapheme clusters as regex's \\X."""
    from openvision_tpu_torch.data import gen_hf_tables, hf_tokenizer

    tables = hf_tokenizer.unicode_tables()
    gen_hf_tables._script_check(tables)
    gen_hf_tables._grapheme_check(tables)
