"""Backoff n-gram language model for shallow fusion (PyTorch port of
`rnn_transducer_tpu/models/ngram.py`).

The model is compiled on the host into dense tables over its S context
states,

    lp[s, v]         : fully backed-off log P(v | state s)
    next_state[s, v] : longest-suffix context state after consuming v

so backoff never happens on the device: fusion is two gathers a beam
step, and each beam carries one int32 state id, a function of its label
prefix alone (exact under prefix merging). Estimation is interpolated
absolute discounting,

    P(v | h) = max(c(h,v) - D, 0) / c(h)  +  D * T(h) / c(h) * P(v | h')

grounded in a unigram interpolated with the uniform distribution. The
counting and the table build are the JAX module's, line for line, in
float64 numpy, so the tables are bit-equal to the JAX package's; the
tables are torch tensors on the CPU, and `NgramLM.to(device)` moves them.
The artifact format (`save_ngram` / `load_ngram`: an .npz of the two
tables and a .meta.json) is the JAX package's, so either package loads
the other's files.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

BOS_ID = 0  # the blank id doubles as BOS (models/lm.py)


class NgramLM(NamedTuple):
    """Dense tables: see the module docstring."""
    lp: torch.Tensor          # (S, V) float32 log P(v | s)
    next_state: torch.Tensor  # (S, V) int32
    start: int                # state id of the sentence-start context

    def to(self, device) -> "NgramLM":
        """The same tables on `device`."""
        return NgramLM(self.lp.to(device), self.next_state.to(device),
                       self.start)


def train_ngram(seqs, order: int, vocab_size: int, *,
                discount: float = 0.75, bos: int = BOS_ID) -> NgramLM:
    """Count, discount, and compile an n-gram LM to dense tables (on the
    CPU).

    seqs: iterable of token-id sequences (transcripts; ids < vocab_size,
    never containing `bos`). order >= 1.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    D = float(discount)
    if not (0.0 < D < 1.0):
        raise ValueError("discount must be in (0, 1)")

    # --- counting ----------------------------------------------------------
    counts: dict[tuple, dict[int, int]] = {(): {}}
    for seq in seqs:
        toks = [int(t) for t in seq]
        for t in toks:
            if not (0 <= t < vocab_size) or t == bos:
                raise ValueError(f"token {t} invalid for the LM vocab")
        hist = (bos,) if order > 1 else ()
        for t in toks:
            for n in range(len(hist) + 1):
                h = hist[n:]
                counts.setdefault(h, {})
                counts[h][t] = counts[h].get(t, 0) + 1
            hist = (hist + (t,))[-(order - 1):] if order > 1 else ()

    # suffix-close the state set (a backoff target must exist)
    states = set(counts)
    for h in list(states):
        for i in range(1, len(h)):
            states.add(h[i:])
    states.add(())
    if order > 1:
        states.add((bos,))
    # shortest-first so each state's suffix row is finished before use
    state_list = sorted(states, key=lambda h: (len(h), h))
    sid = {h: i for i, h in enumerate(state_list)}
    S = len(state_list)

    lp = np.zeros((S, vocab_size), np.float64)
    for i, h in enumerate(state_list):
        c = counts.get(h, {})
        total = sum(c.values())
        if h == ():
            if total == 0:
                p = np.full(vocab_size, 1.0 / vocab_size)
            else:
                p = np.zeros(vocab_size)
                for v, n in c.items():
                    p[v] = max(n - D, 0.0) / total
                p += (D * len(c) / total) / vocab_size  # uniform ground
        else:
            base = np.exp(lp[sid[h[1:]]])
            if total == 0:
                p = base
            else:
                p = np.zeros(vocab_size)
                for v, n in c.items():
                    p[v] = max(n - D, 0.0) / total
                p += (D * len(c) / total) * base
        lp[i] = np.log(np.maximum(p, 1e-30))

    nxt = np.zeros((S, vocab_size), np.int32)
    for i, h in enumerate(state_list):
        for v in range(vocab_size):
            cand = (h + (v,))[-(order - 1):] if order > 1 else ()
            while cand not in sid:
                cand = cand[1:]
            nxt[i, v] = sid[cand]

    start = sid[(bos,)] if order > 1 else sid[()]
    return NgramLM(lp=torch.from_numpy(lp.astype(np.float32)),
                   next_state=torch.from_numpy(nxt), start=start)


def sequence_logprob(lm: NgramLM, seq) -> float:
    """Host-side log P(seq) under the compiled tables (tests/rescoring)."""
    lp = lm.lp.cpu().numpy()
    nxt = lm.next_state.cpu().numpy()
    s, total = lm.start, 0.0
    for t in seq:
        total += float(lp[s, int(t)])
        s = int(nxt[s, int(t)])
    return total


def _paths(path: str) -> tuple[str, str]:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".meta.json"


def save_ngram(lm: NgramLM, path: str):
    npz, meta = _paths(path)
    np.savez(npz[:-4], lp=lm.lp.cpu().numpy(),
             next_state=lm.next_state.cpu().numpy())
    with open(meta, "w") as f:
        json.dump({"start": int(lm.start),
                   "vocab_size": int(lm.lp.shape[1])}, f)


def load_ngram(path: str, device: str | torch.device = "cpu") -> NgramLM:
    npz, meta_p = _paths(path)
    data = np.load(npz)
    with open(meta_p) as f:
        meta = json.load(f)
    return NgramLM(
        lp=torch.from_numpy(np.asarray(data["lp"], np.float32)),
        next_state=torch.from_numpy(np.asarray(data["next_state"],
                                               np.int32)),
        start=int(meta["start"])).to(device)
