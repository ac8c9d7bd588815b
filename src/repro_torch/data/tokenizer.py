"""Tokenizers.

HashTokenizer — deterministic word-level hashing into an arbitrary vocab
size; used to exercise the assigned architectures' exact vocab sizes
(50k..202k) without shipping tokenizer assets.

A numpy copy of HashTokenizer from src/repro/data/tokenizer.py (the port
imports nothing of the JAX package; the byte-level tokenizer for real
text is not copied yet); tests/test_torch_host.py pins it bitwise to the
original.
"""

from __future__ import annotations

from typing import List, Sequence


class HashTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    SPECIALS = 3

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _hash(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return self.SPECIALS + h % (self.vocab_size - self.SPECIALS)

    def encode(self, text: str, *, bos: bool = True,
               eos: bool = True) -> List[int]:
        ids = [self._hash(w) for w in text.split()]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:  # lossy by construction
        return " ".join(f"<{i}>" for i in ids if i >= self.SPECIALS)
