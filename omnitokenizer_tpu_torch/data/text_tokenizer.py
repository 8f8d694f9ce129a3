"""CLIP's byte-level BPE text tokenizer (mirror of
`omnitokenizer_tpu.data.text_tokenizer`), for 'text' conditioning and the
CoinRun caption pipeline.

    tk = SimpleTokenizer()                       # the merge table beside this module
    tk = SimpleTokenizer("bpe_simple_vocab_16e6.txt.gz")
    ids = tk.tokenize("Mugen jumps and collects a coin.", context_length=256)

The merge table is CLIP's `bpe_simple_vocab_16e6.txt[.gz]` (the reference
ships it at coinrun/language_model/); it is data the user supplies and is
not in this repository. `bpe_path` names it; without one the tokenizer
reads it from VOCAB_DIR (this module's directory) under that name, the
plain file first, and raises naming both places when neither is there.
A full table gives CLIP's vocabulary of 49408 ids (the reference's text
condition, lm_transformer.py:125).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Optional, Tuple

VOCAB_NAME = "bpe_simple_vocab_16e6.txt"
VOCAB_DIR = os.path.dirname(os.path.abspath(__file__))


def default_bpe_path() -> str:
    """The merge table in VOCAB_DIR: VOCAB_NAME, else VOCAB_NAME + '.gz'."""
    names = (VOCAB_NAME, VOCAB_NAME + ".gz")
    for name in names:
        path = os.path.join(VOCAB_DIR, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"CLIP's BPE merge table is not in {VOCAB_DIR}: put {names[0]} or {names[1]} there "
        "(the reference ships it at coinrun/language_model/), or pass bpe_path=")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte <-> printable-unicode map (GPT-2's and CLIP's)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or default_bpe_path()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]  # line 0 is the version header
        merges = [tuple(m.split()) for m in merges if m]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # CLIP's pattern with \p{L} / \p{N} narrowed to ASCII letters and
        # digits, as the JAX package has it (stdlib `re`); a non-ASCII
        # letter falls in the last class
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pat, _clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, text: str, context_length: int = 77, pad_id: int = 0) -> List[int]:
        """[sot] + the ids truncated to context_length - 2 + [eot], padded
        with pad_id to context_length."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        ids = [sot] + self.encode(text)[: context_length - 2] + [eot]
        return ids + [pad_id] * (context_length - len(ids))

    def tokenize(self, text: str, context_length: int = 256,
                 truncate_text: bool = True) -> List[int]:
        """The reference's tokenize (coinrun/tokenizer.py:139-158): [sot] +
        ids + [eot] zero-padded to context_length; a longer sequence is cut
        to context_length with eot in its last slot (unlike __call__, which
        cuts before wrapping), or raises with truncate_text=False."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        ids = [sot] + self.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate_text:
                raise RuntimeError(f"input is too long for context length {context_length}")
            ids = ids[:context_length]
            ids[-1] = eot
        return ids + [0] * (context_length - len(ids))
