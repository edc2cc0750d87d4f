"""WordPiece tokenizer for a local BERT ``vocab.txt``.

The port's copy of what ``transformers.BertTokenizerFast(vocab_file=...,
do_lower_case=True)`` does for the extraction and inference CLIs, so the
port needs no ``transformers``:

* special tokens (``[PAD] [UNK] [CLS] [SEP] [MASK]``) written in the text
  are matched first, on the raw text, and keep their ids;
* the rest is normalized: NUL, U+FFFD and control characters (Unicode
  category ``C*`` except tab, newline and carriage return) are dropped,
  other whitespace becomes a space, CJK ideographs get a space on each side,
  accents are stripped (NFD, then nonspacing marks dropped) and each
  character is lower-cased on its own;
* then split on whitespace and around each punctuation character (ASCII
  punctuation and Unicode category ``P*``);
* each word becomes its greedy longest-match WordPiece pieces, the
  continuations prefixed ``##``; a word of more than 100 characters, or one
  with a remainder that no piece matches, is one ``[UNK]``;
* ``[CLS] ... [SEP]``, truncated to ``max_length``, padded with ``[PAD]``.
"""

from __future__ import annotations

import unicodedata

import numpy as np

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_WORD_CHARS = 100
# CJK ideograph blocks that get spaces around them (tokenizers' BertNormalizer)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126
            or unicodedata.category(ch).startswith("P"))


def _normalize(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in "\t\n\r" or unicodedata.category(ch) in ("Zs", "Zl", "Zp"):
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = "".join(ch for ch in unicodedata.normalize("NFD", "".join(out))
                   if unicodedata.category(ch) != "Mn")
    return "".join(ch.lower() for ch in text)


def _words(text: str) -> list[str]:
    words = []
    for chunk in _normalize(text).split(" "):
        start = 0
        for i, ch in enumerate(chunk):
            if _is_punctuation(ch):
                words += [chunk[start:i], ch]
                start = i + 1
        words.append(chunk[start:])
    return [w for w in words if w]


class WordPieceTokenizer:
    """``WordPieceTokenizer(vocab_file)(texts, max_length)`` returns numpy
    ``input_ids``, ``token_type_ids`` (zeros) and ``attention_mask``, int64
    ``[len(texts), max_length]``, as the HF call with
    ``padding="max_length", truncation=True, return_tensors="np"`` does."""

    def __init__(self, vocab_file):
        # as transformers' load_vocab reads it: one token a line (universal
        # newlines), the last of two equal lines wins
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {tok.rstrip("\n"): i for i, tok in enumerate(f.readlines())}
        missing = [t for t in SPECIAL_TOKENS if t not in self.vocab]
        if missing:
            raise ValueError(f"{vocab_file}: no {missing} in the vocabulary")
        self.unk = self.vocab["[UNK]"]
        # longest first, so that no special token is cut by a shorter one
        self._specials = sorted(SPECIAL_TOKENS, key=len, reverse=True)

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > MAX_WORD_CHARS:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return ids

    def encode(self, text: str) -> list[int]:
        """Token ids of ``text`` without ``[CLS]``/``[SEP]``."""
        ids, start, i = [], 0, 0
        while i < len(text):
            tok = next((t for t in self._specials if text.startswith(t, i)), None)
            if tok is None:
                i += 1
                continue
            ids += [p for w in _words(text[start:i]) for p in self._wordpiece(w)]
            ids.append(self.vocab[tok])
            i = start = i + len(tok)
        return ids + [p for w in _words(text[start:]) for p in self._wordpiece(w)]

    def __call__(self, texts, max_length: int, padding="max_length", truncation=True,
                 return_tensors="np"):
        if padding != "max_length" or not truncation or return_tensors != "np":
            raise ValueError("WordPieceTokenizer pads to max_length, truncates and returns "
                             "numpy arrays only")
        ids = np.full((len(texts), max_length), self.vocab["[PAD]"], np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = ([self.vocab["[CLS]"]] + self.encode(text)[:max(max_length - 2, 0)]
                    + [self.vocab["[SEP]"]])[:max_length]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids), "attention_mask": mask}
