"""A deterministic whitespace tokenizer: the chat specials as their ids,
every other word as its crc32 modulo the text vocabulary (less 16).

The same rule as the repository's test tokenizer, copied so that the
benchmark needs no test file. Random weights give no meaning to real ids,
so a request's cost depends only on its number of words."""

from __future__ import annotations

import zlib

SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645}


class StubTokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        for tag in SPECIALS:
            text = text.replace(tag, f" {tag} ")
        return [SPECIALS[t] % self.vocab_size if t in SPECIALS
                else zlib.crc32(t.encode()) % (self.vocab_size - 16)
                for t in text.replace("\n", " \\n ").split()]
