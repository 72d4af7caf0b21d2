"""A WordPiece tokenizer with ``transformers.BertTokenizer``'s ids, for the
GroundingDINO captions of the mask preparation (prep/masks.py).

``WordPieceTokenizer(vocab_file)`` reads a BERT ``vocab.txt`` (one token a
line, the id its line number) and gives, for a caption, the ids
``BertTokenizer(vocab_file=...)`` gives with its defaults
(``do_lower_case=True``): the special tokens ([CLS], [SEP], [PAD], [UNK],
[MASK]) split out of the text first; then basic tokenization (control
characters dropped, white space normalized, a space around every CJK
ideograph, NFC, lower case, accents stripped, punctuation split off); then
greedy longest-match WordPiece with ``##`` continuations, ``[UNK]`` for a
word it cannot cover or one longer than 100 characters; [CLS] and [SEP]
around the whole.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_WORD_CHARS = 100


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for index, token in enumerate(f.readlines()):
            vocab[token.rstrip("\n")] = index
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # every non-letter, non-digit ASCII character counts, as in BERT
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


def _split_punctuation(token: str) -> List[str]:
    out: List[List[str]] = []
    start_new = True
    for ch in token:
        if _is_punctuation(ch):
            out.append([ch])
            start_new = True
        else:
            if start_new:
                out.append([])
            start_new = False
            out[-1].append(ch)
    return ["".join(x) for x in out]


def basic_tokenize(text: str) -> List[str]:
    """BERT's BasicTokenizer with lower casing and accent stripping."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            cleaned.append(" ")
        elif _is_cjk(cp):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(ch)
    text = unicodedata.normalize("NFC", "".join(cleaned))
    tokens = []
    for token in text.split():
        tokens.extend(_split_punctuation(_strip_accents(token.lower())))
    return " ".join(tokens).split()


class WordPieceTokenizer:
    """``tokenizer(caption)["input_ids"]`` and ``tokenizer.vocab``, as
    ``transformers.BertTokenizer`` offers them."""

    def __init__(self, vocab_file: str):
        self.vocab = load_vocab(vocab_file)
        self.unk_id = self.vocab["[UNK]"]
        self._special = re.compile("(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")

    def wordpiece(self, word: str) -> List[int]:
        """Greedy longest-match-first WordPiece ids of one basic token."""
        if len(word) > MAX_WORD_CHARS:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return ids

    def __call__(self, text: str) -> Dict[str, List[int]]:
        ids = [self.vocab["[CLS]"]]
        for i, chunk in enumerate(self._special.split(text)):
            if i % 2:  # a special token written in the text
                ids.append(self.vocab.get(chunk, self.unk_id))
                continue
            for token in basic_tokenize(chunk):
                ids.extend(self.wordpiece(token))
        return {"input_ids": ids + [self.vocab["[SEP]"]]}
