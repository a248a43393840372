"""Length-bucketed batching with static shapes (copy of
`rnn_transducer_tpu/data/bucketing.py`).

The reference pipeline sorts/buckets utterances by length
(BASELINE.json configs[2]: "bucketed batching"). Utterances are padded to
a small fixed set of (max_frames, max_labels) buckets, so a decode or a
step sees a few shapes only (the decode CLI warms each one before it
times it).
"""

from __future__ import annotations

import collections
from collections.abc import Iterable, Iterator

import numpy as np


class BucketBatcher:
    """Groups (feats, labels) examples into fixed-shape padded batches.

    buckets: ascending ((max_frames, max_labels), ...). An example goes to
    the smallest bucket that fits; examples that fit no bucket are dropped
    (counted in `n_dropped` — no silent truncation).
    """

    def __init__(self, buckets, batch_size: int, blank: int = 0):
        self.buckets = sorted(tuple(b) for b in buckets)
        self.batch_size = batch_size
        self.blank = blank
        self.n_dropped = 0
        self._pending: dict[tuple, list] = collections.defaultdict(list)

    def _bucket_for(self, n_frames: int, n_labels: int):
        for b in self.buckets:
            if n_frames <= b[0] and n_labels <= b[1]:
                return b
        return None

    def add(self, feats: np.ndarray, labels: np.ndarray):
        """feats: (T, F) float32; labels: (U,) int32.

        Returns (feats, feat_lens, labels, label_lens, n_valid) when a
        bucket fills, else None.
        """
        b = self._bucket_for(len(feats), len(labels))
        if b is None:
            self.n_dropped += 1
            return None
        self._pending[b].append((feats, labels))
        if len(self._pending[b]) == self.batch_size:
            return self._emit(b)
        return None

    def _emit(self, b, n_valid: int | None = None):
        items = self._pending.pop(b)
        B = len(items)
        max_t, max_u = b
        F = items[0][0].shape[1]
        feats = np.zeros((B, max_t, F), np.float32)
        labels = np.full((B, max_u), self.blank, np.int32)
        feat_lens = np.zeros((B,), np.int32)
        label_lens = np.zeros((B,), np.int32)
        for i, (f, l) in enumerate(items):
            feats[i, : len(f)] = f
            labels[i, : len(l)] = l
            feat_lens[i] = len(f)
            label_lens[i] = len(l)
        return feats, feat_lens, labels, label_lens, (
            B if n_valid is None else n_valid)

    def flush(self) -> Iterator[tuple]:
        """Emit remaining partial batches, padded (cyclically) to full size.

        The trailing element of each yielded tuple is the count of real
        (non-padding) rows, so eval can exclude the repeats from WER/RTF.
        """
        for b in list(self._pending):
            items = self._pending[b]
            if not items:
                continue
            n_valid = len(items)
            for i in range(self.batch_size - n_valid):
                items.append(items[i % n_valid])
            yield self._emit(b, n_valid)


def bucket_stream(examples: Iterable[tuple[np.ndarray, np.ndarray]],
                  buckets, batch_size: int, blank: int = 0,
                  drain: bool = True, with_valid: bool = False
                  ) -> Iterator[tuple]:
    """Stream (feats, labels) examples into fixed-shape padded batches.

    With `with_valid`, yields 5-tuples (feats, feat_lens, labels,
    label_lens, n_valid) where n_valid counts real rows (padding repeats in
    drained partial batches are excluded); otherwise the 4-tuple batch.
    """
    batcher = BucketBatcher(buckets, batch_size, blank)
    for feats, labels in examples:
        out = batcher.add(feats, labels)
        if out is not None:
            yield out if with_valid else out[:4]
    if drain:
        for out in batcher.flush():
            yield out if with_valid else out[:4]
