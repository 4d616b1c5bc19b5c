"""In-tree tokenizers (the JAX package's ``data/tokenizers.py``, copied so
that the port imports nothing of it): byte-level BPE (GPT-2 format) and
WordPiece (BERT format), pure Python, reading LOCAL vocab files.

Both read the public file formats (``vocab.json``/``merges.txt`` for
byte-level BPE, ``vocab.txt`` for WordPiece), so dropping in the real
GPT-2/BERT files changes no code; with the same files both packages give
the same ids, bit for bit.

* Byte-level BPE: text is pre-tokenized GPT-2-style (contractions,
  optional-space letter/number/symbol runs, whitespace splitting), each
  pre-token's UTF-8 bytes are mapped through the printable-byte
  remapping, then merged lowest-rank-first per ``merges.txt``.  Decoding
  inverts exactly: byte-level coverage makes the round trip lossless for
  any input text.
* WordPiece: BERT basic tokenization (lowercase + accent-strip when
  ``do_lower_case``, punctuation split, CJK isolation), then greedy
  longest-match-first with ``##`` continuations; words that cannot be
  pieced become ``[UNK]``.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple


# --------------------------------------------------------------- byte level
@lru_cache(maxsize=1)
def _byte_encoder() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char map (the GPT-2 trick:
    BPE vocab files store tokens as text, so raw bytes that are
    whitespace/control chars are shifted to printable codepoints)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


@lru_cache(maxsize=1)
def _byte_decoder() -> Dict[str, int]:
    return {c: b for b, c in _byte_encoder().items()}


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    """'L' (letter), 'N' (number), or 'O' (symbol) — the three run
    classes of the GPT-2 pre-tokenizer (\\p{L} / \\p{N} / neither)."""
    cat = unicodedata.category(ch)
    if cat.startswith("L"):
        return "L"
    if cat.startswith("N"):
        return "N"
    return "O"


def pretokenize(text: str) -> List[str]:
    """GPT-2's regex pre-tokenizer as an explicit scanner.

    Faithful to the published pattern (contractions first; ``' ?'`` +
    maximal same-class run; a whitespace run keeps its LAST char out
    when a token follows — that trailing space prefixes the next run —
    and only a literal space can prefix a run).  Parity with
    ``transformers.GPT2Tokenizer`` over the fixture vocab is pinned in
    tests."""
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                toks.append(c)
                i += len(c)
                break
        else:
            ch = text[i]
            start = i
            if ch == " " and i + 1 < n and not text[i + 1].isspace():
                i += 1  # ' ?' — a single literal space joins the run
                ch = text[i]
            if ch.isspace():
                j = i
                while j < n and text[j].isspace():
                    j += 1
                if j < n and j - i > 1:
                    j -= 1  # \s+(?!\S): leave one char for the next run
                toks.append(text[start:j])
                i = j
                continue
            cls = _char_class(ch)
            j = i
            while j < n and not text[j].isspace():
                if _char_class(text[j]) != cls:
                    break
                j += 1
            # NOTE: contractions only win when the scan is AT the
            # apostrophe (top of loop) — inside a symbol run the regex
            # consumes the apostrophe into the run ("..'s" tokenizes as
            # "..'", "s", not "..", "'s"), so no mid-run break here.
            toks.append(text[start:j])
            i = j
    return toks


class ByteLevelBPETokenizer:
    """GPT-2-format byte-level BPE: ``vocab.json`` (token -> id) +
    ``merges.txt`` (one ranked merge pair per line)."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(pair): r for r, pair in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as fp:
            vocab = json.load(fp)
        # Byte-level coverage is the design invariant (any input byte
        # maps to SOME vocab entry, so encode cannot hit an unknown).
        # A truncated/non-byte-level vocab.json would otherwise fail
        # with a KeyError mid-corpus — fail at load instead.
        missing = [
            c for c in _byte_encoder().values() if c not in vocab
        ]
        if missing:
            raise ValueError(
                f"{vocab_file} is not a byte-level BPE vocab: "
                f"{len(missing)} of the 256 byte-alphabet symbols are "
                f"missing (first: {missing[0]!r})"
            )
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as fp:
            for line in fp:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        # max id + 1 (same bound the WordPiece property documents): the
        # embedding-size guard needs the largest emittable id.
        return max(self.vocab.values(), default=-1) + 1

    def _bpe(self, token: str) -> List[str]:
        """Merge the mapped-byte sequence of one pre-token, lowest
        merge-rank first, until no ranked pair remains."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[k], parts[k + 1]) for k in range(len(parts) - 1)}
            best = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if best not in self.ranks:
                break
            merged: List[str] = []
            k = 0
            while k < len(parts):
                if (
                    k + 1 < len(parts)
                    and (parts[k], parts[k + 1]) == best
                ):
                    merged.append(parts[k] + parts[k + 1])
                    k += 2
                else:
                    merged.append(parts[k])
                    k += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        enc = _byte_encoder()
        ids: List[int] = []
        for pre in pretokenize(text):
            mapped = "".join(enc[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(mapped):
                pid = self.vocab.get(piece)
                if pid is None:
                    # Only possible with a vocab/merges mismatch (a merge
                    # whose product is not in vocab.json) — name it.
                    raise ValueError(
                        f"merge product {piece!r} missing from vocab.json "
                        "— vocab/merges files are inconsistent"
                    )
                ids.append(pid)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        dec = _byte_decoder()
        text = "".join(self.inv_vocab[int(i)] for i in ids)
        return bytes(dec[c] for c in text).decode("utf-8", errors="replace")


# --------------------------------------------------------------- wordpiece
def _strip_accents(text: str) -> str:
    return "".join(
        ch for ch in unicodedata.normalize("NFD", text)
        if unicodedata.category(ch) != "Mn"
    )


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII symbol ranges count as punctuation for BERT even where
    # unicode disagrees (e.g. '$', '^', '`').
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-format WordPiece over a local ``vocab.txt`` (one token per
    line, line number = id)."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_word_chars: int = 100):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_word_chars = max_word_chars
        self.cls_id = self.vocab.get("[CLS]")
        self.sep_id = self.vocab.get("[SEP]")
        self.pad_id = self.vocab.get("[PAD]", 0)

    @classmethod
    def from_files(cls, vocab_file: str, do_lower_case: bool = True):
        vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as fp:
            for i, line in enumerate(fp):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, do_lower_case)

    @property
    def vocab_size(self) -> int:
        # max id + 1, not len(): a vocab.txt with blank lines keeps
        # line-number ids, and the embedding-size guard in
        # tokenize_texts must bound the LARGEST id this tokenizer can
        # emit, not the entry count.
        return max(self.vocab.values(), default=-1) + 1

    def _basic_tokens(self, text: str) -> List[str]:
        # Control chars drop; CJK chars isolate; punctuation splits.
        cleaned: List[str] = []
        for ch in text:
            cp = ord(ch)
            # BERT's whitespace set is exactly " \t\n\r" + category Zs;
            # every OTHER category-C char (\x0b, \x0c, \x85, ...) is a
            # control char and DROPS — fusing its neighbors into one
            # word — even though Python's isspace() says otherwise.
            if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
                cleaned.append(" ")
            elif cp == 0 or cp == 0xFFFD or unicodedata.category(
                ch
            ).startswith("C"):
                continue
            elif _is_cjk(cp):
                cleaned.append(f" {ch} ")
            else:
                cleaned.append(ch)
        words: List[str] = []
        for word in "".join(cleaned).split():
            if self.do_lower_case:
                word = _strip_accents(word.lower())
            run = ""
            for ch in word:
                if _is_punctuation(ch):
                    if run:
                        words.append(run)
                        run = ""
                    words.append(ch)
                else:
                    run += ch
            if run:
                words.append(run)
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [
            p for w in self._basic_tokens(text) for p in self._wordpiece(w)
        ]

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids = []
        for t in self.tokenize(text):
            tid = self.vocab.get(t)
            if tid is None:
                # tokenize() only emits vocab entries or unk_token, so
                # this means the vocab lacks [UNK] itself — say so
                # instead of KeyError-ing mid-dataset-build.
                raise ValueError(
                    f"vocab.txt lacks the {t!r} token needed to encode "
                    "out-of-vocabulary words"
                )
            ids.append(tid)
        # Specials frame the sequence only when the vocab defines BOTH
        # (a custom vocab with [CLS] but no [SEP] must not emit None).
        if add_special_tokens and None not in (self.cls_id, self.sep_id):
            return [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        for i in ids:
            tok = self.inv_vocab.get(int(i), self.unk_token)
            if tok in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if tok.startswith("##"):
                out.append(tok[2:])
            else:
                if out:
                    out.append(" ")
                out.append(tok)
        return "".join(out)


# --------------------------------------------------------------- discovery
def fixture_vocab_dir() -> Optional[str]:
    """The repo's committed fixture vocabs (tests/fixtures/tokenizers:
    byte-BPE vocab.json+merges.txt AND WordPiece vocab.txt) — the
    zero-egress LAST-RESORT default, so the flagship text paths run real
    tokenization out of the box instead of the hash stand-in.  ``None``
    when the package is installed without the repo checkout."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    d = os.path.join(root, "tests", "fixtures", "tokenizers")
    return d if os.path.isdir(d) else None


def resolve_vocab_dir(vocab_dir: Optional[str] = None) -> str:
    """The single discovery policy: explicit argument, else
    ``$ML_TRAINER_TPU_VOCAB_DIR``, else ``data/tokenizer/`` relative to
    the working directory (the conventional drop-in spot for pretrained
    vocab files) when it exists, else the committed fixture vocabs
    (:func:`fixture_vocab_dir`)."""
    if vocab_dir:
        return vocab_dir
    env = os.environ.get("ML_TRAINER_TPU_VOCAB_DIR")
    if env:
        return env
    cwd_default = os.path.join("data", "tokenizer")
    if os.path.isdir(cwd_default):
        return cwd_default
    fix = fixture_vocab_dir()
    return fix if fix is not None else cwd_default


def load_tokenizer(vocab_dir: str, prefer: Optional[str] = None):
    """Build whichever tokenizer ``vocab_dir``'s files describe.

    ``vocab.json`` + ``merges.txt`` -> :class:`ByteLevelBPETokenizer`;
    ``vocab.txt`` -> :class:`WordPieceTokenizer`; neither -> ``None``.
    When BOTH file sets exist, BPE wins unless ``prefer='wordpiece'``
    (the BERT-shaped callers ask for WordPiece explicitly).  This is how
    ``tokenize_texts`` (data/text.py) discovers real tokenization."""
    if prefer not in (None, "bpe", "wordpiece"):
        raise ValueError(
            f"prefer must be None, 'bpe' or 'wordpiece', got {prefer!r}"
        )
    vj = os.path.join(vocab_dir, "vocab.json")
    mt = os.path.join(vocab_dir, "merges.txt")
    vt = os.path.join(vocab_dir, "vocab.txt")
    has_bpe = os.path.exists(vj) and os.path.exists(mt)
    has_wp = os.path.exists(vt)
    if has_wp and (prefer == "wordpiece" or not has_bpe):
        return WordPieceTokenizer.from_files(vt)
    if has_bpe:
        return ByteLevelBPETokenizer.from_files(vj, mt)
    return None


def encode_batch(
    tokenizer, texts: Sequence[str], max_len: int,
    pad_id: Optional[int] = None,
):
    """(input_ids [N, max_len], attention_mask [N, max_len]) int32 —
    truncate + right-pad, special-token framing where the tokenizer
    defines it (WordPiece [CLS]/[SEP]; BPE none, like GPT-2)."""
    import numpy as np

    if pad_id is None:
        pad_id = getattr(tokenizer, "pad_id", 0)
    ids = np.full((len(texts), max_len), pad_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    for i, text in enumerate(texts):
        row = tokenizer.encode(text)
        if isinstance(tokenizer, WordPieceTokenizer) and (
            len(row) > max_len
        ):
            # Keep the [SEP] terminator under truncation, like BERT.
            row = row[: max_len - 1] + [row[-1]]
        row = row[:max_len]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask
