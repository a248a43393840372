"""Synthetic batches (copy of `rnn_transducer_tpu/data/synthetic.py`).

Numpy only, so a batch drawn from one seed is the same array in both
packages:

  * `random_batch` - noise features and random labels with realistic
    length distributions, for throughput runs;
  * `learnable_batch` - features that encode the label sequence (each label
    paints a frequency pattern over a few frames), for training runs whose
    loss must fall.
"""

from __future__ import annotations

import numpy as np


def random_batch(rng: np.random.Generator, batch: int, max_frames: int,
                 max_labels: int, input_dim: int, vocab: int, blank: int = 0,
                 min_frames: int | None = None):
    min_frames = min_frames or max(max_frames // 2, 1)
    feat_lens = rng.integers(min_frames, max_frames + 1,
                             size=batch).astype(np.int32)
    label_lens = rng.integers(max(1, max_labels // 2), max_labels + 1,
                              size=batch).astype(np.int32)
    feats = rng.normal(size=(batch, max_frames, input_dim)).astype(np.float32)
    labels = rng.integers(1, vocab, size=(batch, max_labels)).astype(np.int32)
    t = np.arange(max_frames)[None, :, None]
    feats = np.where(t < feat_lens[:, None, None], feats, 0.0)
    u = np.arange(max_labels)[None, :]
    labels = np.where(u < label_lens[:, None], labels, blank)
    return feats, feat_lens, labels, label_lens


def learnable_batch(rng: np.random.Generator, batch: int, n_labels: int,
                    input_dim: int, vocab: int, frames_per_label: int = 4,
                    noise: float = 0.1, blank: int = 0):
    """Each label paints a one-hot-ish pattern over `frames_per_label` frames."""
    labels = rng.integers(1, vocab, size=(batch, n_labels)).astype(np.int32)
    T = n_labels * frames_per_label
    feats = rng.normal(size=(batch, T, input_dim)).astype(np.float32) * noise
    for b in range(batch):
        for i, lab in enumerate(labels[b]):
            sl = slice(i * frames_per_label, (i + 1) * frames_per_label)
            feats[b, sl, int(lab) % input_dim] += 3.0
    feat_lens = np.full((batch,), T, np.int32)
    label_lens = np.full((batch,), n_labels, np.int32)
    return feats, feat_lens, labels, label_lens
