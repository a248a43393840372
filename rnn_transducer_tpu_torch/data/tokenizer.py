"""Tokenizers (copy of `rnn_transducer_tpu/data/tokenizer.py`): char vocab
(LibriSpeech configs), TIMIT phoneme set, and a trainable subword BPE
(data/bpe.py) for the 1024-entry configs[2] vocab. `tokenizer_to_meta`
writes the JAX package's meta.json format, so a checkpoint's tokenizer
reads the same in both packages.

The reference family maps transcripts to ids with a simple char map or the
kaldi TIMIT phone list; blank is id 0 everywhere in this framework.
"""

from __future__ import annotations

import json

from rnn_transducer_tpu_torch.data.bpe import BpeTokenizer  # noqa: F401 (re-export)


class CharTokenizer:
    """Character-level tokenizer. id 0 = blank, ids 1.. = alphabet order."""

    DEFAULT_ALPHABET = " abcdefghijklmnopqrstuvwxyz'"

    def __init__(self, alphabet: str | None = None):
        self.alphabet = alphabet or self.DEFAULT_ALPHABET
        self.char_to_id = {c: i + 1 for i, c in enumerate(self.alphabet)}
        self.id_to_char = {i + 1: c for i, c in enumerate(self.alphabet)}

    @property
    def vocab_size(self) -> int:  # including blank
        return len(self.alphabet) + 1

    def encode(self, text: str) -> list[int]:
        return [self.char_to_id[c] for c in text.lower()
                if c in self.char_to_id]

    def decode(self, ids) -> str:
        return "".join(self.id_to_char.get(int(i), "") for i in ids)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"alphabet": self.alphabet}, f)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        with open(path) as f:
            return cls(json.load(f)["alphabet"])


# The 62-symbol TIMIT phone inventory (Lee & Hon 1989 set), plus 'h#'-folded
# silence handling left to the data prep. id 0 = blank.
TIMIT_PHONES = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w",
    "wh", "y", "z", "zh",
]


class PhonemeTokenizer:
    """TIMIT phoneme tokenizer. id 0 = blank, ids 1.. = TIMIT_PHONES order."""

    def __init__(self, phones=None):
        self.phones = list(phones or TIMIT_PHONES)
        self.phone_to_id = {p: i + 1 for i, p in enumerate(self.phones)}
        self.id_to_phone = {i + 1: p for i, p in enumerate(self.phones)}

    @property
    def vocab_size(self) -> int:
        return len(self.phones) + 1

    def encode(self, phones) -> list[int]:
        return [self.phone_to_id[p] for p in phones if p in self.phone_to_id]

    def decode(self, ids) -> list[str]:
        return [self.id_to_phone[int(i)] for i in ids
                if int(i) in self.id_to_phone]


# --- spec strings and checkpoint metadata --------------------------------
#
# A tokenizer is named on the CLI by a spec: "char", "phone"/"timit", or
# "bpe:<model.json>". Checkpoints store the full tokenizer inline in
# meta.json (to_meta/from_meta) so the decode CLI can emit text from
# --ckpt-dir alone.

def tokenizer_from_spec(spec: str):
    if spec == "char":
        return CharTokenizer()
    if spec in ("phone", "timit"):
        return PhonemeTokenizer()
    if spec.startswith("bpe:"):
        return BpeTokenizer.load(spec.split(":", 1)[1])
    raise ValueError(f"unknown tokenizer spec {spec!r} "
                     "(char | phone | bpe:<model.json>)")


def tokenizer_to_meta(tok) -> dict:
    if isinstance(tok, CharTokenizer):
        return {"kind": "char", "alphabet": tok.alphabet}
    if isinstance(tok, PhonemeTokenizer):
        return {"kind": "phone", "phones": tok.phones}
    if isinstance(tok, BpeTokenizer):
        return {"kind": "bpe", "symbols": tok.symbols,
                "merges": [list(m) for m in tok.merges]}
    raise TypeError(f"not a tokenizer: {tok!r}")


def tokenizer_from_meta(d: dict):
    kind = d.get("kind")
    if kind == "char":
        return CharTokenizer(d["alphabet"])
    if kind == "phone":
        return PhonemeTokenizer(d["phones"])
    if kind == "bpe":
        return BpeTokenizer(d["symbols"], d["merges"])
    raise ValueError(f"unknown tokenizer kind {kind!r}")


def decode_to_text(tok, ids) -> str:
    """Token ids -> display text (phones join with spaces)."""
    out = tok.decode(ids)
    return " ".join(out) if isinstance(out, list) else out
