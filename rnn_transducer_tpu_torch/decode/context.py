"""Contextual biasing (keyword / phrase boosting) for beam search
(PyTorch port of `rnn_transducer_tpu/decode/context.py`).

The phrase list is compiled on the host into a token trie, flattened into
two dense tables

  next_node[node, v] : int32  trie state after consuming label v
  delta[node, v]     : f32    score bonus for consuming label v

so a beam step adds `delta[cb_node]` to the label-extension scores and
advances each beam's node through `next_node`: two gathers, no
data-dependent control flow. The node is a function of the label prefix
alone, so biasing is exact under prefix merging.

Scoring is the subtractive partial boost: each trie arc earns its boost; a
completed phrase locks its boost in; a partial match that dies takes back
its unlocked boost (delta = -accum[node]) and re-enters the trie at the
root if the failing label starts a phrase. `final_bias` is the still
unlocked boost, which `beam_search` subtracts from the scores it reports.
The trie build is the JAX module's, line for line, so the tables are
bit-equal to the JAX package's; they are torch tensors on the CPU, and
`ContextBias.to(device)` moves them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class ContextBias(NamedTuple):
    """Tables for trie-driven score biasing (see the module docstring)."""
    next_node: torch.Tensor  # (N, V) int32
    delta: torch.Tensor      # (N, V) float32
    accum: torch.Tensor      # (N,)  float32 unlocked boost at each node

    def to(self, device) -> "ContextBias":
        """The same tables on `device`."""
        return ContextBias(*(t.to(device) for t in self))


def build_context_bias(phrases: Sequence[Sequence[int]], vocab_size: int, *,
                       blank: int = 0, boost: float = 2.0,
                       boosts: Sequence[float] | None = None) -> ContextBias:
    """Compile token-id phrases into dense biasing tables (on the CPU).

    Args:
      phrases: label-id sequences (tokenized with the model's tokenizer;
        must not contain `blank`).
      vocab_size: V; table columns.
      boost: per-token score bonus applied while matching.
      boosts: optional per-phrase per-token bonuses overriding `boost`.

    Returns a ContextBias (node 0 = root).
    """
    if boosts is None:
        boosts = [float(boost)] * len(phrases)
    if len(boosts) != len(phrases):
        raise ValueError(f"{len(boosts)} boosts for {len(phrases)} phrases")

    # --- trie build (host) ------------------------------------------------
    children: list[dict[int, int]] = [{}]  # node -> {label: child}
    arc_boost: list[dict[int, float]] = [{}]  # node -> {label: boost}
    is_final: list[bool] = [False]
    seen: set[tuple] = set()
    for phrase, b in zip(phrases, boosts):
        phrase = tuple(int(t) for t in phrase)
        if not phrase:
            raise ValueError("empty boost phrase")
        for t in phrase:
            if not (0 <= t < vocab_size):
                raise ValueError(f"phrase token {t} outside vocab "
                                 f"[0, {vocab_size})")
            if t == blank:
                raise ValueError("boost phrases must not contain the blank "
                                 f"id ({blank})")
        if phrase in seen:
            continue
        seen.add(phrase)
        node = 0
        for t in phrase:
            if t not in children[node]:
                children[node][t] = len(children)
                children.append({})
                arc_boost.append({})
                is_final.append(False)
            arc_boost[node][t] = max(arc_boost[node].get(t, -np.inf),
                                     float(b))
            node = children[node][t]
        is_final[node] = True

    n = len(children)
    # unlocked boost at each node: resets to 0 at phrase completions
    accum = np.zeros((n,), np.float32)
    stack = [0]
    while stack:
        u = stack.pop()
        for lab, c in children[u].items():
            accum[c] = 0.0 if is_final[c] else accum[u] + arc_boost[u][lab]
            stack.append(c)

    next_node = np.zeros((n, vocab_size), np.int32)
    delta = np.zeros((n, vocab_size), np.float32)
    root_children = children[0]
    for u in range(n):
        for v in range(vocab_size):
            if v in children[u]:
                next_node[u, v] = children[u][v]
                delta[u, v] = arc_boost[u][v]
            else:
                # match dies: take back the unlocked boost, then try to
                # restart a phrase at the root with this same label
                d = -accum[u]
                if v in root_children:
                    next_node[u, v] = root_children[v]
                    d += arc_boost[0][v]
                else:
                    next_node[u, v] = 0
                delta[u, v] = d
    return ContextBias(next_node=torch.from_numpy(next_node),
                       delta=torch.from_numpy(delta),
                       accum=torch.from_numpy(accum))


def final_bias(bias: ContextBias, node):
    """Unlocked (dangling partial-match) boost for carried node ids:
    subtract from raw beam scores to get completed-phrases-only scores."""
    return bias.accum[node.long()]


def load_boost_phrases(path: str, tokenizer, *, default_boost: float = 2.0):
    """Parse a boost file into (phrases, boosts) for build_context_bias.

    One phrase per line, optionally `<TAB><per-token boost>`; blank lines
    and `#` comments skipped. Phrases are tokenized with `tokenizer`
    (anything with .encode(text) -> ids).
    """
    phrases, boosts = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if "\t" in line:
                text, b = line.split("\t", 1)
                b = float(b)
            else:
                text, b = line, default_boost
            ids = list(tokenizer.encode(text.strip()))
            if ids:
                phrases.append(ids)
                boosts.append(b)
    if not phrases:
        raise ValueError(f"no boost phrases in {path}")
    return phrases, boosts
