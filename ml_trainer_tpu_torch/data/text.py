"""Tokenized-text datasets (the JAX package's ``data/text.py``, copied so
that the port imports nothing of it): the BERT fine-tuning and GPT-2
pretraining data paths.

* ``TokenizedDataset``: padded [N, S] token ids (+ labels), an
  ``ArrayDataset``, so the Loader's batched-gather path applies;
* ``tokenize_texts``: the in-tree byte-BPE/WordPiece tokenizers
  (``data/tokenizers.py``; the repo's fixture vocabs as the last resort)
  rank ahead of ``transformers``, and the deterministic hash stand-in is
  an explicit opt-in (``tokenizer='hash'``);
* ``load_sst2_tsv``: the GLUE SST-2 on-disk format (sentence\\tlabel);
* ``PackedLMDataset``: a concatenated token stream cut into blocks for
  causal-LM pretraining (every token supervised, no padding).

The same texts and vocab give the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ml_trainer_tpu_torch.data.datasets import ArrayDataset


def _stable_hash(word: str) -> int:
    """Process-independent word hash (builtin ``hash`` is salted per
    interpreter — it would tokenize the same text differently on every
    host/run)."""
    import hashlib

    return int.from_bytes(
        hashlib.md5(word.encode("utf-8")).digest()[:8], "little"
    )


# One-shot flag for the implicit data/tokenizer/ discovery warning.
_warned_implicit_vocab = False


def _hash_tokenize(text: str, vocab_size: int) -> List[int]:
    """Deterministic fallback tokenizer (whitespace + stable hash)."""
    return [
        (_stable_hash(w) % (vocab_size - 3)) + 3  # reserve 0=pad, 1=cls, 2=sep
        for w in text.lower().split()
    ]


def tokenize_texts(
    texts: Sequence[str],
    max_len: int = 128,
    tokenizer_name: Optional[str] = None,
    vocab_size: int = 30522,
    vocab_dir: Optional[str] = None,
    tokenizer: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Texts -> (input_ids [N, max_len], attention_mask [N, max_len]).

    Tokenizer preference order (``tokenizer='auto'``):

    1. the IN-TREE tokenizers (data/tokenizers.py) from ``vocab_dir`` —
       or ``$ML_TRAINER_TPU_VOCAB_DIR``, or ``data/tokenizer/``, or the
       repo's committed fixture vocabs as last resort
       (``vocab.json``+``merges.txt`` -> byte-level BPE; ``vocab.txt``
       -> WordPiece; ``tokenizer='bpe'``/``'wordpiece'`` tie-breaks a
       dir holding both).  Token ids then come from that vocab: build
       the model with the tokenizer's ``vocab_size``, not this
       function's ``vocab_size`` argument;
    2. ``transformers.AutoTokenizer`` when ``tokenizer_name`` is given
       and loadable (local files honored; no download attempted) —
       an explicit ``tokenizer_name`` also disables the fixture-vocab
       fallback in step 1, so it cannot be shadowed by defaults;
    3. the deterministic hash stand-in ONLY by explicit opt-in
       (``tokenizer='hash'``), bounded by ``vocab_size``, with
       BERT-style [CLS] ... [SEP] framing — or, with a loud warning, as
       the final fallback when nothing else is available.
    """
    if tokenizer not in ("auto", "bpe", "wordpiece", "hash"):
        raise ValueError(
            "tokenizer must be 'auto', 'bpe', 'wordpiece' or 'hash', "
            f"got {tokenizer!r}"
        )
    if tokenizer != "hash":
        from ml_trainer_tpu_torch.data.tokenizers import (
            encode_batch,
            fixture_vocab_dir,
            load_tokenizer,
            resolve_vocab_dir,
        )

        implicit = vocab_dir is None and not os.environ.get(
            "ML_TRAINER_TPU_VOCAB_DIR"
        )
        resolved = resolve_vocab_dir(vocab_dir)
        if (
            tokenizer_name is not None
            and implicit
            and resolved == fixture_vocab_dir()
        ):
            # The caller named a transformers tokenizer and no real
            # vocab dir was configured: the fixture fallback must not
            # shadow the explicit request.
            resolved = ""
        prefer = tokenizer if tokenizer in ("bpe", "wordpiece") else None
        tok = (
            load_tokenizer(resolved, prefer=prefer)
            if resolved and os.path.isdir(resolved) else None
        )
        if tok is None and tokenizer in ("bpe", "wordpiece"):
            raise FileNotFoundError(
                f"tokenizer={tokenizer!r} requested but no vocab files "
                f"in {resolved!r}"
            )
        if (
            tok is not None
            and implicit
            and resolved == os.path.join("data", "tokenizer")
        ):
            # The mere presence of a CWD-relative data/tokenizer/
            # changes token ids for callers that never asked for it;
            # say so ONCE per process so the switch is visible, not
            # silent.  (The fixture fallback is the documented default
            # and does not warn.)
            global _warned_implicit_vocab
            if not _warned_implicit_vocab:
                _warned_implicit_vocab = True
                import warnings

                warnings.warn(
                    f"tokenize_texts discovered a vocab in {resolved!r} "
                    "(CWD-relative default) and will use it instead of "
                    "the fixture default; pass vocab_dir=... or set "
                    "ML_TRAINER_TPU_VOCAB_DIR to make this explicit",
                    stacklevel=2,
                )
        if tok is not None:
            if tok.vocab_size <= vocab_size:
                return encode_batch(tok, texts, max_len)
            # The caller's model embeds only ``vocab_size`` rows;
            # emitting larger ids would index past the table.  Skip the
            # in-tree tokenizer rather than poison training, and say why.
            import warnings

            warnings.warn(
                f"tokenizer in {resolved!r} has vocab_size "
                f"{tok.vocab_size} > the declared embedding size "
                f"{vocab_size}; falling back to the hash tokenizer. "
                f"Build the model with vocab_size={tok.vocab_size} to "
                "use it.",
                stacklevel=2,
            )
        if tok is None and tokenizer_name is not None:
            try:
                from transformers import AutoTokenizer

                hf = AutoTokenizer.from_pretrained(
                    tokenizer_name, local_files_only=True
                )
                enc = hf(
                    list(texts), max_length=max_len, padding="max_length",
                    truncation=True, return_tensors="np",
                )
                return (
                    enc["input_ids"].astype(np.int32),
                    enc["attention_mask"].astype(np.int32),
                )
            except Exception:
                pass  # fall through to the hash stand-in
        if tok is None:
            import warnings

            warnings.warn(
                "no tokenizer vocab found anywhere (vocab_dir, "
                "$ML_TRAINER_TPU_VOCAB_DIR, data/tokenizer/, repo "
                "fixtures); using the hash stand-in tokenizer — pass "
                "tokenizer='hash' to opt in explicitly and silence "
                "this warning",
                stacklevel=2,
            )
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    for i, text in enumerate(texts):
        toks = [1] + _hash_tokenize(text, vocab_size)[: max_len - 2] + [2]
        ids[i, : len(toks)] = toks
        mask[i, : len(toks)] = 1
    return ids, mask


class TokenizedDataset(ArrayDataset):
    """[N, S] token ids with integer labels (sequence classification) —
    feeds BERT fine-tuning through the ordinary Loader."""

    def __init__(self, input_ids: np.ndarray, labels: np.ndarray,
                 attention_mask: Optional[np.ndarray] = None):
        super().__init__(np.asarray(input_ids, np.int32),
                         np.asarray(labels, np.int32))
        self.attention_mask = (
            None if attention_mask is None
            else np.asarray(attention_mask, np.int32)
        )

    @classmethod
    def from_texts(cls, texts: Sequence[str], labels: Sequence[int],
                   max_len: int = 128, tokenizer_name: Optional[str] = None,
                   vocab_size: int = 30522,
                   vocab_dir: Optional[str] = None,
                   tokenizer: str = "auto"):
        """``vocab_size`` bounds the offline tokenizer's ids — it MUST match
        the model's embedding table (out-of-range ids gather garbage).
        By default the in-tree tokenizers encode (fixture vocabs as last
        resort); ``tokenizer='hash'`` opts into the hash stand-in."""
        ids, mask = tokenize_texts(
            texts, max_len, tokenizer_name, vocab_size, vocab_dir,
            tokenizer=tokenizer,
        )
        return cls(ids, np.asarray(labels), mask)


def load_sst2_tsv(path: str, max_len: int = 128,
                  tokenizer_name: Optional[str] = None,
                  vocab_size: int = 30522,
                  vocab_dir: Optional[str] = None,
                  tokenizer: str = "auto") -> TokenizedDataset:
    """GLUE SST-2 ``train.tsv``/``dev.tsv`` (header, sentence\\tlabel)."""
    texts, labels = [], []
    with open(path) as fp:
        header = fp.readline()
        for line in fp:
            sentence, _, label = line.rstrip("\n").rpartition("\t")
            if sentence:
                texts.append(sentence)
                labels.append(int(label))
    return TokenizedDataset.from_texts(
        texts, labels, max_len, tokenizer_name, vocab_size, vocab_dir,
        tokenizer=tokenizer,
    )


def pack_texts(
    texts: Sequence[str],
    seq_len: int = 1024,
    vocab_dir: Optional[str] = None,
    eos_id: Optional[int] = None,
) -> "PackedLMDataset":
    """Tokenize ``texts`` with the in-tree tokenizer found in
    ``vocab_dir`` (see ``tokenize_texts`` discovery) and concatenate into
    a :class:`PackedLMDataset` — the GPT-2 pretraining data path with
    real tokenization.  ``eos_id`` (if given) separates documents in the
    stream, the byte-level-BPE convention."""
    from ml_trainer_tpu_torch.data.tokenizers import (
        load_tokenizer,
        resolve_vocab_dir,
    )

    vocab_dir = resolve_vocab_dir(vocab_dir)
    tok = load_tokenizer(vocab_dir)
    if tok is None:
        raise FileNotFoundError(
            f"no tokenizer files (vocab.json+merges.txt or vocab.txt) "
            f"in {vocab_dir!r}"
        )
    stream: List[int] = []
    for text in texts:
        stream.extend(tok.encode(text))
        if eos_id is not None:
            stream.append(eos_id)
    return PackedLMDataset(np.asarray(stream, np.int32), seq_len)


class PackedLMDataset(ArrayDataset):
    """Concatenated token stream chunked into [N, seq_len] blocks with
    next-token targets — the GPT-2 pretraining layout."""

    def __init__(self, token_stream: np.ndarray, seq_len: int = 1024):
        stream = np.asarray(token_stream, np.int32).ravel()
        n = (len(stream) - 1) // seq_len
        if n < 1:
            raise ValueError(
                f"token stream of {len(stream)} tokens too short for "
                f"seq_len={seq_len}"
            )
        data = stream[: n * seq_len].reshape(n, seq_len)
        targets = stream[1 : n * seq_len + 1].reshape(n, seq_len)
        super().__init__(data, targets)
