"""Trainable byte-pair-encoding (subword) tokenizer (copy of
`rnn_transducer_tpu/data/bpe.py`; pure Python, so a model learned or
saved by either package reads the same in the other).

BASELINE.json configs[2] (LibriSpeech train-clean-100) pins a 1024-entry
vocabulary — larger than any character set, i.e. subword units. This is a
self-contained sentencepiece-style BPE: words get a "▁" boundary marker,
the initial symbols are characters, and merges are learned greedily by
corpus pair frequency. id 0 = blank, matching every tokenizer here.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict

WORD_MARK = "▁"  # "▁", marks a word boundary (sentencepiece convention)


def _word_counts(texts) -> Counter:
    counts: Counter = Counter()
    for text in texts:
        for w in text.lower().split():
            counts[WORD_MARK + w] += 1
    return counts


def _learn_merges(word_counts: Counter, n_merges: int):
    """Greedy BPE merge learning with incremental pair-count maintenance.

    Returns the merge list [(a, b), ...] in learned order. Deterministic:
    ties broken by lexicographic pair order.
    """
    words = [list(w) for w in word_counts]  # symbol lists, mutated in place
    freqs = list(word_counts.values())

    pair_counts: Counter = Counter()
    pair_words: dict[tuple, set[int]] = defaultdict(set)
    for wi, syms in enumerate(words):
        f = freqs[wi]
        for a, b in zip(syms, syms[1:]):
            pair_counts[(a, b)] += f
            pair_words[(a, b)].add(wi)

    merges = []
    for _ in range(n_merges):
        best = None
        for pair, c in pair_counts.items():
            if c <= 0:
                continue
            if best is None or c > best[1] or (c == best[1] and pair < best[0]):
                best = (pair, c)
        if best is None or best[1] < 2:  # nothing left worth merging
            break
        (a, b), _ = best
        merged = a + b
        merges.append((a, b))
        for wi in list(pair_words[(a, b)]):
            syms, f = words[wi], freqs[wi]
            i = 0
            while i < len(syms) - 1:
                if syms[i] == a and syms[i + 1] == b:
                    left = syms[i - 1] if i > 0 else None
                    right = syms[i + 2] if i + 2 < len(syms) else None
                    # retire the merged pair and its overlaps
                    pair_counts[(a, b)] -= f
                    if left is not None:
                        pair_counts[(left, a)] -= f
                        pair_counts[(left, merged)] += f
                        pair_words[(left, merged)].add(wi)
                    if right is not None:
                        pair_counts[(b, right)] -= f
                        pair_counts[(merged, right)] += f
                        pair_words[(merged, right)].add(wi)
                    syms[i:i + 2] = [merged]
                else:
                    i += 1
        del pair_counts[(a, b)]
        del pair_words[(a, b)]
    return merges


class BpeTokenizer:
    """Subword tokenizer. id 0 = blank; ids 1.. = characters then merges."""

    def __init__(self, symbols: list[str], merges: list):
        self.symbols = list(symbols)
        self.merges = [tuple(m) for m in merges]
        self.sym_to_id = {s: i + 1 for i, s in enumerate(self.symbols)}
        self.rank = {m: r for r, m in enumerate(self.merges)}
        self.chars = {s for s in self.symbols if len(s) == 1}
        self._word_cache: dict[str, list[int]] = {}

    @classmethod
    def train(cls, texts, vocab_size: int) -> "BpeTokenizer":
        """Learn a BPE model from an iterable of transcripts.

        vocab_size includes blank: n_symbols = vocab_size - 1. Characters
        observed in the corpus are always in the vocabulary; the remaining
        budget goes to merges (fewer if the corpus saturates first).
        """
        word_counts = _word_counts(texts)
        chars = sorted({c for w in word_counts for c in w})
        n_merges = vocab_size - 1 - len(chars)
        if n_merges < 0:
            raise ValueError(
                f"vocab_size {vocab_size} < {len(chars) + 1} (corpus "
                f"characters + blank)")
        merges = _learn_merges(word_counts, n_merges)
        # Distinct merges can yield the same string (e.g. a+'bc' and
        # 'ab'+c); dedupe so no vocabulary id is wasted on a symbol that
        # would shadow an earlier identical one.
        symbols = list(dict.fromkeys(chars + [a + b for a, b in merges]))
        return cls(symbols, merges)

    @property
    def vocab_size(self) -> int:  # including blank
        return len(self.symbols) + 1

    def _encode_word(self, word: str) -> list[int]:
        ids = self._word_cache.get(word)
        if ids is not None:
            return ids
        syms = [c for c in word if c in self.chars]  # unknown chars dropped
        while len(syms) > 1:
            ranked = [(self.rank[p], i)
                      for i, p in enumerate(zip(syms, syms[1:]))
                      if p in self.rank]
            if not ranked:
                break
            r, _ = min(ranked)
            a, b = self.merges[r]
            out, i = [], 0
            while i < len(syms):
                if i < len(syms) - 1 and syms[i] == a and syms[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            syms = out
        ids = [self.sym_to_id[s] for s in syms]
        self._word_cache[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for w in text.lower().split():
            ids.extend(self._encode_word(WORD_MARK + w))
        return ids

    def decode(self, ids) -> str:
        s = "".join(self.symbols[int(i) - 1] for i in ids
                    if 1 <= int(i) <= len(self.symbols))
        return s.replace(WORD_MARK, " ").strip()

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"kind": "bpe", "symbols": self.symbols,
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls(d["symbols"], d["merges"])
