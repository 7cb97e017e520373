"""Self-contained BERT WordPiece tokenizer (HF-compatible semantics): a copy
of mmvqa_tpu/data/tokenizer.py, held to the same ids by
tests/test_torch_text.py.

The reference calls ``BertTokenizer.from_pretrained('bert-base-uncased')``
(roco_utils.py:557, vqamed2019/utils.py:222). This environment has no network
access, so the tokenizer is implemented natively and loads a ``vocab.txt``
file supplied with the dataset (``--vocab_file`` or ``<data_dir>/vocab.txt``
/ ``<data_dir>/vocab/vocab.txt``). Semantics follow HF's BasicTokenizer
(lowercase, accent stripping, punctuation splitting, CJK isolation) +
WordPiece with '##' continuations and max 100 chars/word; golden-tested
against the local ``transformers.BertTokenizer`` class constructed from the
same vocab file (tests/test_tokenizer.py).

The ASCII fast path is ``native/wordpiece.cpp``, built with the host's C++
compiler by ``mmvqa_tpu_torch.native.loader`` at first use; a failed build
raises. Text that is not ASCII or holds a bracket (a special token) takes
the Python path, text by text, as in the reference.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)


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
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over a user-supplied vocab."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = UNK
        for tok in SPECIAL_TOKENS:
            if tok not in vocab:
                raise ValueError(f"vocab is missing special token {tok}")
        self.pad_token_id = vocab[PAD]
        self.unk_token_id = vocab[UNK]
        self.cls_token_id = vocab[CLS]
        self.sep_token_id = vocab[SEP]
        self.mask_token_id = vocab[MASK]
        self.never_split = set(SPECIAL_TOKENS)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        tok = cls(vocab)
        tok._init_native(path)
        return tok

    # -- native (C++) fast path ---------------------------------------------

    def _init_native(self, vocab_path: str) -> None:
        """Attach the ctypes WordPiece library (ASCII fast path; its ids are
        held to the Python path's by tests/test_torch_text.py). Raises if
        the library does not build or the vocab does not load."""
        from mmvqa_tpu_torch.native.loader import wordpiece_library

        lib = wordpiece_library()
        handle = lib.wp_load(vocab_path.encode())
        if not handle:
            raise RuntimeError(f"wordpiece library could not load {vocab_path}")
        self._native_lib = lib
        self._native_handle = handle

    def _native_ids(self, text: str) -> Optional[List[int]]:
        lib = getattr(self, "_native_lib", None)
        if lib is None or not text.isascii() or "[" in text:
            return None  # bracketed specials use the python never_split path
        import ctypes

        buf_len = max(64, 2 * len(text) + 16)
        buf = (ctypes.c_int32 * buf_len)()
        n = lib.wp_tokenize(
            self._native_handle, text.encode(), buf, buf_len
        )
        if n < 0:
            return None
        return list(buf[:n])

    @classmethod
    def find_and_load(
        cls, data_dir: str = "", vocab_file: str = ""
    ) -> "WordPieceTokenizer":
        candidates = []
        if vocab_file:
            candidates.append(vocab_file)
        if data_dir:
            candidates += [
                os.path.join(data_dir, "vocab.txt"),
                os.path.join(data_dir, "vocab", "vocab.txt"),
            ]
        for c in candidates:
            if os.path.exists(c):
                return cls.from_vocab_file(c)
        raise FileNotFoundError(
            f"no WordPiece vocab.txt found (looked at: {candidates}); pass "
            "--vocab_file or place vocab.txt in the data directory"
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- basic tokenization (HF BasicTokenizer semantics) -------------------

    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_on_punc(self, token: str) -> List[str]:
        if token in self.never_split:
            return [token]
        chars = list(token)
        out: List[List[str]] = []
        new_word = True
        for ch in chars:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(w) for w in out]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._tokenize_cjk(text)
        tokens = text.strip().split() if text.strip() else []
        out: List[str] = []
        for tok in tokens:
            if tok not in self.never_split:
                if self.do_lower_case:
                    tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_on_punc(tok))
        return [t for t in out if t]

    # -- wordpiece ----------------------------------------------------------

    def wordpiece(self, token: str, max_chars: int = 100) -> List[str]:
        if len(token) > max_chars:
            return [self.unk_token]
        chars = list(token)
        out: List[str] = []
        start = 0
        while start < len(chars):
            end = len(chars)
            cur = None
            while start < end:
                sub = "".join(chars[start:end])
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out

    # -- public API (mirrors the HF methods the reference uses) -------------

    def tokenize(self, text: str) -> List[str]:
        ids = self._native_ids(text)
        if ids is not None:
            return [self.ids_to_tokens[i] for i in ids]
        out: List[str] = []
        for tok in self.basic_tokenize(text):
            if tok in self.never_split:
                out.append(tok)
            else:
                out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._native_ids(text)
        if ids is None:
            ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids


def build_vocab_from_corpus(
    texts: Iterable[str],
    max_size: int = 30522,
    min_freq: int = 1,
) -> Dict[str, int]:
    """Whole-word vocabulary from a corpus, for hermetic fixtures and users
    without the original bert vocab: specials + single chars + frequent
    words.
    (No reference equivalent — test/bootstrap utility.)
    """
    from collections import Counter

    counter: Counter = Counter()
    chars: Counter = Counter()
    basic = _BareBasic()
    for text in texts:
        for tok in basic.basic_tokenize(text):
            counter[tok] += 1
            chars.update(tok)
    vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
    for ch in sorted(chars):
        for form in (ch, f"##{ch}"):
            if form not in vocab and len(vocab) < max_size:
                vocab[form] = len(vocab)
    for tok, freq in counter.most_common():
        if freq < min_freq or len(vocab) >= max_size:
            break
        if tok not in vocab:
            vocab[tok] = len(vocab)
    return vocab


class _BareBasic(WordPieceTokenizer):
    """Basic tokenizer without a vocab (for corpus scanning)."""

    def __init__(self):  # noqa: super not called on purpose
        self.do_lower_case = True
        self.never_split = set(SPECIAL_TOKENS)


def write_vocab(vocab: Dict[str, int], path: str) -> None:
    items = sorted(vocab.items(), key=lambda kv: kv[1])
    with open(path, "w", encoding="utf-8") as f:
        for tok, _ in items:
            f.write(tok + "\n")
