"""Port parity: the tokenizers and text datasets of ``ml_trainer_tpu_torch``
(``data/tokenizers.py``, ``data/text.py``) against the JAX package's.

The same texts through the same committed fixture vocabs
(``tests/fixtures/tokenizers/``: a byte-level BPE of 456 tokens with its
merges, a WordPiece ``vocab.txt`` of 101 lines) must give the same ids,
bit for bit, and the text datasets the same arrays; a hypothesis fuzz of
strings covers what the fixed list misses.  Tolerance: none (integers).
"""

import os
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ml_trainer_tpu.data import text as jtext
from ml_trainer_tpu.data import tokenizers as jtok
from ml_trainer_tpu_torch.data import text as ttext
from ml_trainer_tpu_torch.data import tokenizers as ttok

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizers")

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "It's training time: don't stop, we're watching!",
    "  leading spaces and   interior runs",
    "trailing space ",
    "numbers 123 and 2026, symbols #@! and mixed bf16 v5e",
    "newlines\n\nand\ttabs\t end\n",
    "unicode: naïve café ümlaut 東京",
    "we're they've I'll he'd she's",
    "",
    "..'s wait!'t and #'d",
    "a\x0bb cat\x0csat\x85end",
    "a very long sentence " * 20,
]


def _pair(kind):
    if kind == "bpe":
        args = (os.path.join(FIX, "vocab.json"),
                os.path.join(FIX, "merges.txt"))
        return (jtok.ByteLevelBPETokenizer.from_files(*args),
                ttok.ByteLevelBPETokenizer.from_files(*args))
    path = os.path.join(FIX, "vocab.txt")
    return (jtok.WordPieceTokenizer.from_files(path),
            ttok.WordPieceTokenizer.from_files(path))


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
def test_fixture_ids_equal_the_jax_tokenizers(kind):
    j, t = _pair(kind)
    assert t.vocab_size == j.vocab_size
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids), text


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
@settings(max_examples=150, deadline=None)
@given(text=st.text(max_size=60))
def test_fuzzed_ids_equal_the_jax_tokenizers(kind, text):
    j, t = _pair(kind)
    assert t.encode(text) == j.encode(text)


@settings(max_examples=150, deadline=None)
@given(text=st.text(max_size=60))
def test_pretokenize_equals_the_jax_scanner(text):
    assert ttok.pretokenize(text) == jtok.pretokenize(text)


@pytest.mark.parametrize("prefer", [None, "bpe", "wordpiece"])
def test_load_tokenizer_picks_as_the_jax_package(prefer):
    j = jtok.load_tokenizer(FIX, prefer=prefer)
    t = ttok.load_tokenizer(FIX, prefer=prefer)
    assert type(t).__name__ == type(j).__name__
    assert ttok.load_tokenizer(os.path.dirname(FIX)) is None
    with pytest.raises(ValueError, match="prefer must be"):
        ttok.load_tokenizer(FIX, prefer="sentencepiece")


def test_vocab_dir_discovery_matches(monkeypatch, tmp_path):
    assert ttok.fixture_vocab_dir() == jtok.fixture_vocab_dir() is not None
    assert ttok.resolve_vocab_dir("x") == jtok.resolve_vocab_dir("x") == "x"
    monkeypatch.setenv("ML_TRAINER_TPU_VOCAB_DIR", str(tmp_path))
    assert ttok.resolve_vocab_dir() == jtok.resolve_vocab_dir() == str(
        tmp_path)


@pytest.mark.parametrize("kind,max_len", [("bpe", 16), ("wordpiece", 12),
                                          ("wordpiece", 64)])
def test_encode_batch_equals_jax(kind, max_len):
    j, t = _pair(kind)
    got = ttok.encode_batch(t, TEXTS, max_len)
    want = jtok.encode_batch(j, TEXTS, max_len)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tokenizer,vocab_size", [
    ("auto", 30522), ("bpe", 30522), ("wordpiece", 30522), ("hash", 997),
    ("auto", 64),  # the fixture vocab is too large: the hash stand-in
])
def test_tokenize_texts_equals_jax_with_its_warnings(tokenizer, vocab_size):
    out = {}
    for name, mod in (("jax", jtext), ("port", ttext)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            arrays = mod.tokenize_texts(TEXTS, 24, vocab_size=vocab_size,
                                        vocab_dir=FIX, tokenizer=tokenizer)
        out[name] = arrays, [str(w.message) for w in caught]
    (jid, jmask), jwarn = out["jax"]
    (tid, tmask), twarn = out["port"]
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_array_equal(tmask, jmask)
    assert twarn == jwarn
    assert (vocab_size == 64) == bool(twarn)


def test_tokenize_texts_errors_match(tmp_path):
    for mod in (jtext, ttext):
        with pytest.raises(ValueError, match="tokenizer must be"):
            mod.tokenize_texts(["a"], tokenizer="sp")
        with pytest.raises(FileNotFoundError, match="no vocab files"):
            mod.tokenize_texts(["a"], vocab_dir=str(tmp_path),
                               tokenizer="wordpiece")


def test_tokenized_dataset_and_sst2_tsv_equal_jax(tmp_path):
    labels = [i % 2 for i in range(len(TEXTS))]
    kw = dict(max_len=32, vocab_dir=FIX, tokenizer="wordpiece")
    j = jtext.TokenizedDataset.from_texts(TEXTS, labels, **kw)
    t = ttext.TokenizedDataset.from_texts(TEXTS, labels, **kw)
    for got, want in ((t.data, j.data), (t.targets, j.targets),
                      (t.attention_mask, j.attention_mask)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    path = tmp_path / "train.tsv"
    rows = [s.replace("\t", " ").replace("\n", " ") for s in TEXTS if s]
    path.write_text("sentence\tlabel\n" + "".join(
        f"{s}\t{i % 2}\n" for i, s in enumerate(rows)))
    j = jtext.load_sst2_tsv(str(path), **kw)
    t = ttext.load_sst2_tsv(str(path), **kw)
    assert len(t) == len(rows)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.targets, j.targets)
    np.testing.assert_array_equal(t.attention_mask, j.attention_mask)


@pytest.mark.parametrize("eos_id", [None, 0])
def test_pack_texts_and_packed_dataset_equal_jax(eos_id):
    texts = TEXTS * 3
    j = jtext.pack_texts(texts, seq_len=32, vocab_dir=FIX, eos_id=eos_id)
    t = ttext.pack_texts(texts, seq_len=32, vocab_dir=FIX, eos_id=eos_id)
    assert len(t) == len(j) > 1
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.targets, j.targets)
    np.testing.assert_array_equal(t.data[:, 1:], t.targets[:, :-1])
    stream = np.arange(100, dtype=np.int64)
    for seq_len in (7, 33):
        got = ttext.PackedLMDataset(stream, seq_len)
        want = jtext.PackedLMDataset(stream, seq_len)
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.targets, want.targets)
    for mod in (jtext, ttext):
        with pytest.raises(ValueError, match="too short"):
            mod.PackedLMDataset(np.arange(8), 8)
        with pytest.raises(FileNotFoundError, match="no tokenizer files"):
            mod.pack_texts(["a"], vocab_dir=os.path.dirname(FIX))
